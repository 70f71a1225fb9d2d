"""String-factorized sector E_pq ops on the (Na, Nb) string grid.

Port of auto_oo_tpu/ops/grid.py.  The (n_alpha, n_beta) sector basis is a
product of alpha and beta occupation-string lists: every determinant is
A_i | B_j.  Laid out as an (Na, Nb) STRING GRID, the spin components of
E_pq act one-sidedly:

  (E_pq^alpha x)[i, j] = sgnA[pq, i] * tB[pq, j] * x[srcA[pq, i], j]
  (E_pq^beta  x)[i, j] = tA[pq, i] * sgnB[pq, j] * x[i, srcB[pq, j]]

a row gather (alpha) and a row gather of the transpose (beta), with
rank-1 sign corrections: the Jordan-Wigner parity of a same-spin
excitation factorizes exactly into a same-spin part (sgn) and an
other-spin part (t = (-1)^{# other-spin electrons between the two
modes}).  ``phi_all`` runs ``gather_rows_scaled`` of ops/grid_kernels.py
on both spin halves (the beta half on a transposed copy of the grid);
``epq_sum`` runs ``gather_reduce`` on the alpha half and
``gather_reduce_cols`` on the beta half, both in the grid's layout.

Layout contract: statevectors here are GRID-ordered flat vectors — index
g = i * Nb + j for determinant A_i | B_j — NOT the canonical ascending
determinant order of fermion.sector_basis.  ``to_grid`` / ``from_grid``
convert (one permutation per vector).
"""

import copy
from itertools import combinations

import numpy as np
import torch

from ..config import get_device
from . import fermion
from .grid_kernels import (gather_reduce, gather_reduce_cols,
                           gather_rows_scaled)


class GridMaps:
    """String-factorized E_pq maps over the (Na, Nb) sector grid, as
    tensors on one device.

    srcA/sgnA: (n2, Na) alpha-string source ranks / signs (0 = invalid)
    tB:        (n2, Nb) beta parity correction for the ALPHA component
    srcB/sgnB: (n2, Nb) beta-string source ranks / signs
    tA:        (n2, Na) alpha parity correction for the BETA component
    g2s:       (Ds,) grid rank -> canonical (sorted) rank permutation:
               x_grid = x_sorted[g2s]
    s2g:       (Ds,) inverse: x_sorted = x_grid[s2g]

    The src tables are int32 (the kernels' index type), with int64 copies
    for the plain versions' indexing; the int8 sign tables are converted
    once to the working ``dtype`` at construction, and once more per
    other dtype on first use (``tables``).  ``full_pairs`` is False for
    ``pair_slice``'d maps, whose adjoint is not the pair transpose."""

    def __init__(self, srcA, sgnA, tB, srcB, sgnB, tA, g2s, s2g,
                 device=None, dtype=torch.float64):
        device = get_device(device)
        self.device = device
        self.full_pairs = True

        def idx(a, dt):
            return torch.as_tensor(np.array(a), device=device).to(dt)

        self.srcA = idx(srcA, torch.int32)
        self.srcB = idx(srcB, torch.int32)
        self.srcA_long = self.srcA.long()
        self.srcB_long = self.srcB.long()
        self._signs = tuple(idx(a, torch.int8)
                            for a in (sgnA, tB, sgnB, tA))
        self.g2s = idx(g2s, torch.int64)
        self.s2g = idx(s2g, torch.int64)
        self._scales = {}
        self.scales(dtype)

    def scales(self, dtype):
        """(sgnA, tB, sgnB, tA) in ``dtype``, converted once per dtype."""
        hit = self._scales.get(dtype)
        if hit is None:
            hit = self._scales[dtype] = tuple(a.to(dtype)
                                              for a in self._signs)
        return hit

    def tables(self, like):
        """(srcA, sgnA, tB, srcB, sgnB, tA) for an operand ``like``: int32
        src for the card's kernels, int64 src for the CPU's plain
        versions, scales in the operand's dtype."""
        if like.device.type == "cpu":
            sa, sb = self.srcA_long, self.srcB_long
        else:
            sa, sb = self.srcA, self.srcB
        sgnA, tB, sgnB, tA = self.scales(like.dtype)
        return sa, sgnA, tB, sb, sgnB, tA

    @property
    def sgnA(self):
        return self._signs[0]

    @property
    def tB(self):
        return self._signs[1]

    @property
    def sgnB(self):
        return self._signs[2]

    @property
    def tA(self):
        return self._signs[3]

    @property
    def n2(self):
        return self.srcA.shape[0]

    @property
    def Na(self):
        return self.srcA.shape[1]

    @property
    def Nb(self):
        return self.srcB.shape[1]

    @property
    def dim(self):
        return self.g2s.shape[0]

    def pair_perm(self):
        """The (p,q) -> (q,p) pair-index involution (E_pq^T = E_qp)."""
        ncas = int(round(self.n2 ** 0.5))
        k = torch.arange(self.n2, device=self.device)
        return (k % ncas) * ncas + k // ncas


def spin_strings(ncas, n_occ, spin, up_then_down=False):
    """Ascending occupation strings of one spin: integers with bits only
    at that spin's mode positions (big-endian full-space convention of
    ops/fermion.py)."""
    nm = 2 * ncas
    out = np.fromiter(
        (sum(1 << (nm - 1 - fermion.mode_of(p, spin, ncas, up_then_down))
             for p in occ)
         for occ in combinations(range(ncas), n_occ)),
        dtype=np.int64)
    if not out.size:
        out = np.zeros(1, dtype=np.int64)
    return np.sort(out)


def _one_spin_maps(ncas, strings, spin, up_then_down):
    """(src, sgn) over one spin's string list for all ncas^2 (p, q),
    restricted to the strings of the acting spin."""
    nm = 2 * ncas
    n2 = ncas * ncas
    N = strings.size
    src = np.zeros((n2, N), dtype=np.int32)
    sgn = np.zeros((n2, N), dtype=np.int8)
    idx = np.arange(N, dtype=np.int64)
    for p in range(ncas):
        for q in range(ncas):
            k = p * ncas + q
            P = fermion.mode_of(p, spin, ncas, up_then_down)
            Q = fermion.mode_of(q, spin, ncas, up_then_down)
            if P == Q:
                src[k] = idx
                sgn[k] = fermion.occ_bit(strings, P, nm)
                continue
            bitP = 1 << (nm - 1 - P)
            bitQ = 1 << (nm - 1 - Q)
            valid = ((strings & bitP) != 0) & ((strings & bitQ) == 0)
            source = np.where(valid, strings ^ bitP ^ bitQ, strings[0])
            sq = fermion._parity_below(source, Q, nm)
            sp = fermion._parity_below(source ^ (valid * bitQ), P, nm)
            pos = np.searchsorted(strings, source)
            if not np.all(strings[pos[valid]] == source[valid]):
                raise AssertionError("E_pq left the sector string list")
            src[k] = np.where(valid, pos, 0)
            sgn[k] = np.where(valid, sq * sp, 0)
    return src, sgn


def _cross_parity(ncas, strings, spin, up_then_down):
    """t[pq, j] = (-1)^{# `spin`-electrons of string j strictly between
    the two modes of pair pq of the OTHER spin} — the rank-1 other-spin
    factor of the Jordan-Wigner parity."""
    nm = 2 * ncas
    n2 = ncas * ncas
    other = 1 - spin
    t = np.ones((n2, strings.size), dtype=np.int8)
    for p in range(ncas):
        for q in range(ncas):
            if p == q:
                continue
            k = p * ncas + q
            P = fermion.mode_of(p, other, ncas, up_then_down)
            Q = fermion.mode_of(q, other, ncas, up_then_down)
            t[k] = (fermion._parity_below(strings, Q, nm)
                    * fermion._parity_below(strings, P, nm))
    return t


def _nelec_split(nelecas):
    if isinstance(nelecas, (tuple, list)):
        return int(nelecas[0]), int(nelecas[1])
    nb = int(nelecas) // 2
    return int(nelecas) - nb, nb


def grid_perms(ncas, nelecas, up_then_down=False):
    """Host-side (numpy) string lists and grid<->canonical permutations:
    (A, B, g2s, s2g) with x_grid = x_sorted[g2s], x_sorted = x_grid[s2g]."""
    na, nb = _nelec_split(nelecas)
    A = spin_strings(ncas, na, 0, up_then_down)
    B = spin_strings(ncas, nb, 1, up_then_down)
    grid_dets = (A[:, None] | B[None, :]).ravel()
    # order[r] = grid rank of the r-th smallest determinant, so
    # x_sorted[r] = x_grid[order[r]] (s2g = order) and g2s is its inverse
    order = np.argsort(grid_dets, kind="stable")
    g2s = np.empty(order.size, dtype=np.int32)
    g2s[order] = np.arange(order.size, dtype=np.int32)
    s2g = order.astype(np.int32)
    return A, B, g2s, s2g


def grid_tables(ncas, nelecas, up_then_down=False):
    """The host (numpy) tables of ``GridMaps``, by field name."""
    A, B, g2s, s2g = grid_perms(ncas, nelecas, up_then_down)
    srcA, sgnA = _one_spin_maps(ncas, A, 0, up_then_down)
    srcB, sgnB = _one_spin_maps(ncas, B, 1, up_then_down)
    return dict(srcA=srcA, sgnA=sgnA,
                tB=_cross_parity(ncas, B, 1, up_then_down),
                srcB=srcB, sgnB=sgnB,
                tA=_cross_parity(ncas, A, 0, up_then_down),
                g2s=g2s, s2g=s2g)


def build_grid_maps(ncas, nelecas, up_then_down=False, device=None,
                    dtype=torch.float64):
    """GridMaps for the (n_alpha, n_beta) sector of ncas spatial
    orbitals, on ``device`` with sign tables in ``dtype``."""
    return GridMaps(**grid_tables(ncas, nelecas, up_then_down),
                    device=device, dtype=dtype)


def to_grid(x, gm):
    """Canonical (ascending-determinant) order -> grid order, last axis."""
    return x[..., gm.g2s]


def from_grid(x, gm):
    """Grid order -> canonical order, last axis."""
    return x[..., gm.s2g]


def pair_slice(gm, lo, hi):
    """GridMaps restricted to pair rows [lo, hi): the kernels read n2
    from the table shapes, so the sliced maps drive the same code on a
    subset of pairs.  Their VJP is not the pair transpose
    (``full_pairs=False``)."""
    sliced = copy.copy(gm)
    sliced.full_pairs = False
    for name in ("srcA", "srcA_long", "srcB", "srcB_long"):
        setattr(sliced, name, getattr(gm, name)[lo:hi])
    sliced._signs = tuple(a[lo:hi] for a in gm._signs)
    sliced._scales = {dt: tuple(a[lo:hi] for a in v)
                      for dt, v in gm._scales.items()}
    return sliced


def _phi_impl(x, gm):
    srcA, sgnA, tB, srcB, sgnB, tA = gm.tables(x)
    xg = x.reshape(x.shape[:-1] + (gm.Na, gm.Nb))
    pa = gather_rows_scaled(xg, srcA, sgnA, tB)
    # beta half on one transposed contiguous copy of the grid (the layout
    # of the TPU wrapper; a fused two-spin kernel can gather in-row)
    xt = xg.transpose(-1, -2).contiguous()
    pb = gather_rows_scaled(xt, srcB, sgnB, tA)
    phi = pa + pb.transpose(-1, -2)
    return phi.reshape(x.shape[:-1] + (gm.n2, gm.dim))


def _epq_impl(Y, gm):
    srcA, sgnA, tB, srcB, sgnB, tA = gm.tables(Y)
    Yg = Y.reshape(Y.shape[:-1] + (gm.Na, gm.Nb))
    out = gather_reduce(Yg, srcA, sgnA, tB)
    # the beta half gathers inside the rows of Yg: no transposed copy
    out += gather_reduce_cols(Yg, srcB, sgnB, tA)
    return out.reshape(Y.shape[:-2] + (gm.dim,))


def _need_full_pairs(gm):
    if not gm.full_pairs:
        raise NotImplementedError(
            "the VJP of pair-sliced grid maps comes with the streamed "
            "phi_rows/_phi_chunk callers (a later PR of the port)")


class _Phi(torch.autograd.Function):
    """phi_all with the full-pair VJP: sum_k E_k^T ct_k = epq_sum(ct[perm])
    (E_pq^T = E_qp), so the backward runs the same kernels."""

    @staticmethod
    def forward(ctx, x, gm):
        ctx.gm = gm
        return _phi_impl(x.contiguous(), gm)

    @staticmethod
    def backward(ctx, ct):
        gm = ctx.gm
        _need_full_pairs(gm)
        return _EpqSum.apply(ct[..., gm.pair_perm(), :], gm), None


class _EpqSum(torch.autograd.Function):
    """epq_sum with the full-pair VJP: VJP(g) = phi_all(g)[perm]."""

    @staticmethod
    def forward(ctx, Y, gm):
        ctx.gm = gm
        return _epq_impl(Y.contiguous(), gm)

    @staticmethod
    def backward(ctx, g):
        gm = ctx.gm
        _need_full_pairs(gm)
        return _Phi.apply(g, gm)[..., gm.pair_perm(), :], None


def phi_all(x, gm):
    """Phi[..., pq, :] = E_pq x for all pairs of the maps; x and the
    result are GRID-ordered flat vectors ((..., Ds) -> (..., n2, Ds)).
    Both spin halves run ``gather_rows_scaled``."""
    return _Phi.apply(x, gm)


def epq_sum(Y, gm):
    """out = sum_pq E_pq Y[..., pq, :] — the reduction half of the
    Hamiltonian apply.  Y (..., n2, Ds) and the result (..., Ds) are
    grid-ordered.  The alpha half runs ``gather_reduce``, the beta half
    ``gather_reduce_cols`` on the same Y."""
    return _EpqSum.apply(Y, gm)


# a full Phi = E_pq x for all ncas^2 pairs is (n2, D).  Above this byte
# budget per materialized pair block the JAX package streams the pair
# axis (ops/hamiltonian.py, ops/rdms.py); the port raises there until the
# streamed callers are ported.
_PAIR_CHUNK_BYTES = 1 << 30


def _pair_chunk(B, D, n2, itemsize):
    per_pair = B * D * itemsize
    if n2 * per_pair <= _PAIR_CHUNK_BYTES:
        return n2
    return max(1, int(_PAIR_CHUNK_BYTES // per_pair))
