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
modes}).  Every Phi (``phi_all``, ``phi_rows`` and the streamed and
hosted passes) is built by ``gather_two_spin`` of ops/grid_kernels.py,
both spin halves in one pass over the grid's rows; ``epq_sum`` runs
``gather_reduce`` on the alpha half and ``gather_reduce_cols`` on the
beta half, both in the grid's layout.

Layout contract: statevectors here are GRID-ordered flat vectors — index
g = i * Nb + j for determinant A_i | B_j — NOT the canonical ascending
determinant order of fermion.sector_basis.  ``to_grid`` / ``from_grid``
convert (one permutation per vector).

Where one (n2, D) Phi exceeds its 1 GB block ((14e,14o): 18.5 GB in
f64) the callers stream it over grid A-rows (``phi_rows``,
``ham_apply_rows``, ``rdms_rows``, ``transition_rdms_rows``; sizes from
``stream_plan``): the alpha half gathers rows of the whole x with
row-sliced tables, the beta half gathers inside the chunk's rows (one
``gather_two_spin`` launch per chunk).

One spin component of Phi (``phi_all(x, gm, spin=0 or 1)``, the
spin-resolved RDMs' one-particle part) runs ``gather_rows_scaled``: the
alpha half on the grid state, the beta half on one contiguous transposed
copy of it, whose result stays in that transposed layout (index
j * Na + i; ``transpose_grid`` gives the bra in the same order), so no
(n2, D) Phi is ever transposed.  A complex state runs each kernel on its
real and imaginary parts (contiguous copies): the maps' coefficients are
real, so E(Re x + i Im x) = E Re x + i E Im x.

S^- = sum_p a^dag_{p,beta} a_{p,alpha} factorizes over the spin strings
as E_pq does (``sminus_grid_maps``): per orbital a row gather, a column
gather and a rank-1 sign, so <S^2> = ||S^- psi||^2 + Sz^2 - Sz runs on
the grid state with O(ncas (Na' + Nb')) tables (``s2_expectation_grid``).
These gathers are plain indexing, as they are XLA gathers in the JAX
package.
"""

import copy
from itertools import combinations
from typing import NamedTuple

import numpy as np
import torch

from ..config import get_device
from . import fermion
from .grid_kernels import (gather_reduce, gather_reduce_cols,
                           gather_rows_scaled, gather_two_spin,
                           reduce_cols_lists, two_spin_tables)
from .linalg import gram_last


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
    other dtype on first use (``tables``).  ``pairs`` is None for maps
    of all n^2 pairs, else the pair rows of the full maps these hold
    (``pair_slice``, ``transposed``); derived tables are cached on the
    object (``_cache``)."""

    def __init__(self, srcA, sgnA, tB, srcB, sgnB, tA, g2s, s2g,
                 device=None, dtype=torch.float64):
        device = get_device(device)
        self.device = device
        self.pairs = None
        self._full = self
        self._cache = {}

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

    def _src(self, like):
        """(srcA, srcB): int32 for the card's kernels, int64 for the CPU's
        plain versions."""
        if like.device.type == "cpu":
            return self.srcA_long, self.srcB_long
        return self.srcA, self.srcB

    def tables(self, like):
        """(srcA, sgnA, tB, srcB, sgnB, tA) for an operand ``like``: src as
        ``_src`` gives it, scales in the operand's dtype."""
        sa, sb = self._src(like)
        sgnA, tB, sgnB, tA = self.scales(like.dtype)
        return sa, sgnA, tB, sb, sgnB, tA

    def phi_tables(self, like):
        """(srcA, sgnA, tB, srcB, sgnB, tA) for ``gather_two_spin_plain``
        on an operand ``like``: src as ``_src`` gives it, the int8 sign
        tables as held (the plain version promotes them exactly)."""
        sa, sb = self._src(like)
        sgnA, tB, sgnB, tA = self._signs
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
        """The (p,q) -> (q,p) pair-index involution (E_pq^T = E_qp) of the
        full maps."""
        n2 = self._full.n2
        ncas = int(round(n2 ** 0.5))
        k = torch.arange(n2, device=self.device)
        return (k % ncas) * ncas + k // ncas

    def _cached(self, key, make):
        hit = self._cache.get(key)
        if hit is None:
            hit = self._cache[key] = make()
        return hit

    def select(self, pairs):
        """The maps of the pair rows ``pairs`` (int64, rows of these
        maps), as contiguous tables."""
        sel = copy.copy(self)
        sel.pairs = pairs if self.pairs is None else self.pairs[pairs]
        sel._cache = {}
        for name in ("srcA", "srcA_long", "srcB", "srcB_long"):
            setattr(sel, name, getattr(self, name).index_select(0, pairs))
        sel._signs = tuple(a.index_select(0, pairs) for a in self._signs)
        sel._scales = {dt: tuple(a.index_select(0, pairs) for a in v)
                       for dt, v in self._scales.items()}
        return sel

    def col_lists(self):
        """The beta maps' compacted column lists, the tables of
        ``gather_reduce_cols`` on the card (``reduce_cols_lists`` of srcB
        and sgnB), built once per maps."""
        return self._cached("col_lists",
                            lambda: reduce_cols_lists(self.srcB, self.sgnB))

    def two_spin_tables(self):
        """The tables of ``gather_two_spin``
        (``grid_kernels.two_spin_tables``: int8 codes of each sign and
        parity pair, int16 beta source columns), built once per maps."""
        return self._cached("two_spin_tables", lambda: two_spin_tables(
            self.srcA, self.sgnA, self.tB, self.srcB, self.sgnB, self.tA))

    def transposed(self):
        """The maps of E_qp for each pair pq of these maps: E_pq^T = E_qp,
        so the adjoint of a grid op on these maps is the other grid op on
        the transposed maps, for any subset of pairs."""
        def make():
            perm = self.pair_perm()
            return self._full.select(perm if self.pairs is None
                                     else perm[self.pairs])
        return self._cached("transposed", make)


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


def grid_strings(ncas, nelecas, up_then_down=False):
    """The (A, B) alpha and beta string lists of the sector grid."""
    na, nb = _nelec_split(nelecas)
    return (spin_strings(ncas, na, 0, up_then_down),
            spin_strings(ncas, nb, 1, up_then_down))


def grid_perms(ncas, nelecas, up_then_down=False):
    """Host-side (numpy) string lists and grid<->canonical permutations:
    (A, B, g2s, s2g) with x_grid = x_sorted[g2s], x_sorted = x_grid[s2g]."""
    A, B = grid_strings(ncas, nelecas, up_then_down)
    grid_dets = (A[:, None] | B[None, :]).ravel()
    # order[r] = grid rank of the r-th smallest determinant, so
    # x_sorted[r] = x_grid[order[r]] (s2g = order) and g2s is its inverse;
    # the determinants are distinct, so any sort gives the same order
    order = np.argsort(grid_dets)
    del grid_dets
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


def inverse_alpha_maps(gm):
    """Host (numpy) inverse of the alpha E_pq row maps: dst[k, m] = the
    output row that reads source row m for pair k, dsg[k, m] its sign,
    0/0 where no output row does.  Each pair's row map is a partial
    injection (an excitation bijects occupation subsets), so the inverse
    exists; the hosted H-apply's alpha scatter reads it
    (ops/grid_hosted.py).  Cached on ``gm``."""
    def make():
        srcA = gm.srcA.cpu().numpy()
        sgnA = gm.sgnA.cpu().numpy()
        dst = np.zeros_like(srcA)
        dsg = np.zeros_like(sgnA)
        ks, iis = np.nonzero(sgnA != 0)
        dst[ks, srcA[ks, iis]] = iis
        dsg[ks, srcA[ks, iis]] = sgnA[ks, iis]
        return dst, dsg
    return gm._cached("inverse_alpha", make)


def pair_slice(gm, lo, hi):
    """GridMaps restricted to pair rows [lo, hi): the kernels read n2
    from the table shapes, so the sliced maps drive the same code on a
    subset of pairs.  Cached on ``gm``."""
    return gm._cached(("pairs", lo, hi), lambda: gm.select(
        torch.arange(lo, hi, device=gm.device)))


def _real_parts(fn, x):
    """fn(x) for a real x; for a complex x, fn of its contiguous real and
    imaginary parts, recombined (every grid op is linear with real
    coefficients)."""
    if not x.is_complex():
        return fn(x)
    return torch.complex(fn(x.real.contiguous()), fn(x.imag.contiguous()))


def _phi_impl(x, gm):
    def phi(v):
        vg = v.reshape(v.shape[:-1] + (gm.Na, gm.Nb))
        return gather_two_spin(vg, gm.two_spin_tables(), 0, gm.Na)
    return _real_parts(phi, x).reshape(x.shape[:-1] + (gm.n2, gm.dim))


def _epq_impl(Y, gm):
    def epq(V):
        srcA, sgnA, tB, srcB, sgnB, tA = gm.tables(V)
        Vg = V.reshape(V.shape[:-1] + (gm.Na, gm.Nb))
        out = gather_reduce(Vg, srcA, sgnA, tB)
        # the beta half gathers inside the rows of Vg (no transposed copy)
        # and adds into out
        gather_reduce_cols(Vg, srcB, sgnB, tA, out=out,
                           lists=gm.col_lists())
        return out
    return _real_parts(epq, Y).reshape(Y.shape[:-2] + (gm.dim,))


class _Phi(torch.autograd.Function):
    """phi_all with its VJP: sum_k E_k^T ct_k = epq_sum(ct) on the
    transposed maps (E_pq^T = E_qp), so the backward runs the same
    kernels, for all pairs or a slice of them."""

    @staticmethod
    def forward(ctx, x, gm):
        ctx.gm = gm
        return _phi_impl(x.contiguous(), gm)

    @staticmethod
    def backward(ctx, ct):
        return _EpqSum.apply(ct, ctx.gm.transposed()), None


class _EpqSum(torch.autograd.Function):
    """epq_sum with its VJP: E_k^T g = phi_all(g) on the transposed
    maps."""

    @staticmethod
    def forward(ctx, Y, gm):
        ctx.gm = gm
        return _epq_impl(Y.contiguous(), gm)

    @staticmethod
    def backward(ctx, g):
        return _Phi.apply(g, ctx.gm.transposed()), None


def phi_all(x, gm, spin=None):
    """Phi[..., pq, :] = E_pq x for all pairs of the maps; x and the
    result are GRID-ordered flat vectors ((..., Ds) -> (..., n2, Ds)).
    One ``gather_two_spin`` builds both spin halves (two for a complex x,
    its real and imaginary parts).

    ``spin`` 0 or 1 gives one spin component E_pq^sigma x through
    ``gather_rows_scaled`` (no VJP): spin 0 in grid order, spin 1 in the
    TRANSPOSED grid order (index j * Na + i), from a contiguous
    transposed copy of x; contract it with ``transpose_grid`` of the
    bra."""
    if spin is None:
        return _Phi.apply(x, gm)
    if spin not in (0, 1):
        raise ValueError(f"spin must be None, 0 or 1, got {spin!r}")

    def one_spin(v):
        srcA, sgnA, tB, srcB, sgnB, tA = gm.tables(v)
        vg = v.reshape(v.shape[:-1] + (gm.Na, gm.Nb))
        if spin == 0:
            return gather_rows_scaled(vg.contiguous(), srcA, sgnA, tB)
        return gather_rows_scaled(vg.transpose(-1, -2).contiguous(), srcB,
                                  sgnB, tA)
    return _real_parts(one_spin, x).reshape(x.shape[:-1]
                                            + (gm.n2, gm.dim))


def transpose_grid(x, gm):
    """A GRID-ordered x (..., Ds) in the transposed grid order (index
    j * Na + i), the order of ``phi_all(x, gm, spin=1)``."""
    lead = x.shape[:-1]
    return x.reshape(lead + (gm.Na, gm.Nb)).transpose(-1, -2).reshape(
        lead + (gm.dim,))


def epq_sum(Y, gm):
    """out = sum_pq E_pq Y[..., pq, :] — the reduction half of the
    Hamiltonian apply.  Y (..., n2, Ds) and the result (..., Ds) are
    grid-ordered.  The alpha half runs ``gather_reduce``, the beta half
    ``gather_reduce_cols`` on the same Y."""
    return _EpqSum.apply(Y, gm)


# a full Phi = E_pq x for all ncas^2 pairs is (n2, D): 18.5 GB in f64 at
# (14e,14o).  Above this byte budget per materialized pair block the
# callers (ops/hamiltonian.py, ops/rdms.py, models/oo_pqc.py) stream Phi
# over grid A-rows: the JAX package's rule, so every sector takes the same
# route in both packages.
_PAIR_CHUNK_BYTES = 1 << 30

# the JAX package's budget for the row-streamed H-apply's pair-blocked Y
# buffers; on the CPU a pair block gets a fifth of it
_Y_BUDGET_BYTES = 10 << 30

# block-sized buffers the row-streamed route is sized for (the JAX
# package's count, kept so both packages cut the same sectors into the
# same chunks).  Live at once: Y, a Phi chunk and its C2 product; the
# Phi chunk is one buffer since gather_two_spin writes both halves in
# place (the TPU layout held a second, transposed half), so two shares
# are left to the caching allocator's fragmentation
_LIVE_BLOCKS = 5


def _pair_chunk(B, D, n2, itemsize):
    per_pair = B * D * itemsize
    if n2 * per_pair <= _PAIR_CHUNK_BYTES:
        return n2
    return max(1, int(_PAIR_CHUNK_BYTES // per_pair))


class StreamPlan(NamedTuple):
    """Sizes of the row-streamed route."""
    row_chunk: int    # grid A-rows per Phi chunk
    pair_block: int   # pairs per Y block of the H-apply
    budget: object    # device bytes they were sized from (None: CPU)


def _even(n, most):
    """The size of ceil(n / most) equal pieces of n (most within [1, n])."""
    most = max(1, min(n, int(most)))
    return -(-n // -(-n // most))


def stream_plan(gm, B=1, itemsize=8, resident=0):
    """The row chunk and pair block for B states of ``itemsize`` bytes.

    On the card: the free device memory (cudaMemGetInfo's free bytes plus
    the caching allocator's unused reserve) less the ``resident`` bytes
    the caller keeps, shared by _LIVE_BLOCKS buffers; a Phi chunk
    (B, n2, rows, Nb) and a Y block (B, pairs, D) each get one share, and
    Na and n2 are cut into equal pieces.  On the CPU: the JAX package's
    1 GB Phi chunk and a fifth of its Y budget.  Sizes are chosen once, up
    front; nothing retries smaller on an out-of-memory error."""
    n2, Na, Nb, D = gm.n2, gm.Na, gm.Nb, gm.dim
    if gm.device.type == "cuda":
        free = (torch.cuda.mem_get_info(gm.device)[0]
                + torch.cuda.memory_reserved(gm.device)
                - torch.cuda.memory_allocated(gm.device))
        budget = max(0, free - int(resident))
        rows_bytes = pairs_bytes = budget // _LIVE_BLOCKS
    else:
        budget = None
        rows_bytes, pairs_bytes = _PAIR_CHUNK_BYTES, _Y_BUDGET_BYTES // 5
    return StreamPlan(_even(Na, rows_bytes // (B * n2 * Nb * itemsize)),
                      _even(n2, pairs_bytes // (B * D * itemsize)), budget)


def _row_chunks(Na, row_chunk):
    return [(r0, min(Na, r0 + row_chunk)) for r0 in range(0, Na, row_chunk)]


def _row_tables(gm, like, r0, r1):
    """(srcA, sgnA, tA) of grid A-rows [r0, r1) for an operand ``like``,
    as contiguous tensors (the card's kernels refuse views); cached on
    ``gm``."""
    def make():
        srcA, sgnA, _, _, _, tA = gm.tables(like)
        return tuple(a[:, r0:r1].contiguous() for a in (srcA, sgnA, tA))
    return gm._cached(("rows", r0, r1, like.device.type, like.dtype), make)


def _phi_chunk(xg, gm, r0, r1):
    """The (..., n2, r1 - r0, Nb) block of E_pq x for grid A-rows
    [r0, r1), from the whole contiguous grid xg (..., Na, Nb).  Both spin
    parts are row-local in their output: alpha gathers rows of the whole
    x, beta gathers inside the chunk's own rows; one ``gather_two_spin``
    makes each element of Phi once, with no transposed copy (two for a
    complex xg, its real and imaginary parts)."""
    return _real_parts(
        lambda v: gather_two_spin(v, gm.two_spin_tables(), r0, r1), xg)


class _PhiRows(torch.autograd.Function):
    """phi_rows with its VJP: the cotangent block, zero outside its rows,
    through epq_sum on the transposed maps (E_pq^T = E_qp)."""

    @staticmethod
    def forward(ctx, x, gm, r0, r1):
        ctx.gm, ctx.rows = gm, (r0, r1)
        x = x.contiguous()
        return _phi_chunk(x.reshape(x.shape[:-1] + (gm.Na, gm.Nb)), gm, r0,
                          r1)

    @staticmethod
    def backward(ctx, ct):
        gm = ctx.gm
        r0, r1 = ctx.rows
        full = ct.new_zeros(ct.shape[:-2] + (gm.Na, gm.Nb))
        full[..., r0:r1, :] = ct
        return (_EpqSum.apply(full.reshape(ct.shape[:-2] + (gm.dim,)),
                              gm.transposed()), None, None, None)


def phi_rows(x, gm, r0, r1):
    """Phi restricted to grid A-rows [r0, r1): the (..., n2, rows, Nb)
    block of E_pq x for every pair of the maps, from the whole
    GRID-ordered x (..., D).  Streaming over rows makes one pass over
    Phi, where streaming over pairs (``ham_apply_chunked``) rebuilds Phi
    blocks O(n2 / chunk) times."""
    return _PhiRows.apply(x, gm, r0, r1)


def assemble_rdms(gamma_flat, corr, ncas):
    """(gamma, Gamma), chemist order, from gamma_flat[pq] = <E_pq> and
    the gram corr[(q,p),(r,s)] = <E_qp psi|E_rs psi> = <E_pq E_rs>
    (e_pqrs = E_pq E_rs - delta_qr E_ps)."""
    gamma = gamma_flat.reshape(ncas, ncas)
    corr = corr.reshape(ncas, ncas, ncas, ncas)
    delta = torch.eye(ncas, dtype=gamma.dtype, device=gamma.device)
    Gamma = (corr.permute(1, 0, 2, 3)
             - torch.einsum("qr,ps->pqrs", delta, gamma))
    return gamma, Gamma


def ham_apply_rows(c1eff_flat, C2, x, gm, row_chunk, pair_block=None):
    """sum_pq E_pq [sum_rs C2 E_rs + c1eff] x with Phi streamed over grid
    A-rows: each Phi chunk is built once per pair block and contracted at
    once (one GEMM), so the gathers make ceil(n2 / pair_block) passes over
    Phi.  Y exists only as a (..., pair_block, D) buffer; ``pair_block``
    None means all n2 pairs.  ``stream_plan`` sizes both.  x (..., D) and
    the result are GRID-ordered.  (The JAX package runs the chunks under
    lax.scan to pin XLA's peak memory; here an eager loop frees each chunk
    before the next.)"""
    n2, Na, Nb = gm.n2, gm.Na, gm.Nb
    pair_block = n2 if pair_block is None else pair_block
    x = x.contiguous()
    lead = x.shape[:-1]
    xg = x.reshape(lead + (Na, Nb))
    C2 = C2.to(x.dtype)
    c1 = c1eff_flat.to(x.dtype)
    out = torch.zeros_like(x)
    chunks = _row_chunks(Na, row_chunk)
    for lo in range(0, n2, pair_block):
        hi = min(n2, lo + pair_block)
        Y = torch.empty(lead + (hi - lo, Na, Nb), dtype=x.dtype,
                        device=x.device)
        for r0, r1 in chunks:
            phi_c = _phi_chunk(xg, gm, r0, r1)
            yc = torch.matmul(C2[lo:hi],
                              phi_c.reshape(lead + (n2, (r1 - r0) * Nb)))
            # free the chunk before the next one is made
            del phi_c
            yc = yc.reshape(lead + (hi - lo, r1 - r0, Nb))
            Y[..., r0:r1, :] = yc.addcmul_(c1[lo:hi, None, None],
                                           xg[..., None, r0:r1, :])
            del yc
        out += epq_sum(Y.reshape(lead + (hi - lo, gm.dim)),
                       pair_slice(gm, lo, hi))
        del Y
    return out


def rdms_rows(psi, gm, ncas, row_chunk):
    """(gamma, Gamma) of a real or complex GRID-ordered state with Phi
    streamed over grid A-rows: each chunk of Phi is made once and
    consumed by the (n2, L) x (L, n2) gram; one pass over Phi, one chunk
    live.  The accumulators are f64 whatever the state's dtype (the JAX
    package's hosted RDMs; an f32 state's grams are ``gram_last``'s); a
    complex state's bra side is conjugated and the real part taken."""
    n2 = gm.n2
    psig = psi.contiguous().reshape(gm.Na, gm.Nb)
    gamma = psi.new_zeros(n2, dtype=torch.float64)
    corr = psi.new_zeros((n2, n2), dtype=torch.float64)
    for r0, r1 in _row_chunks(gm.Na, row_chunk):
        phi_c = _phi_chunk(psig, gm, r0, r1).reshape(n2, -1)
        gamma += gram_last(phi_c, psig[r0:r1].reshape(-1).conj()).real
        corr += gram_last(phi_c.conj(), phi_c).real
        del phi_c
    return assemble_rdms(gamma, corr, ncas)


def transition_rdms_rows(psi, tpsi, gm, ncas, row_chunk):
    """Transition-RDM rows of a real GRID-ordered state and tangent with
    Phi streamed over grid A-rows (the per-tangent Hessian row where a
    full (n2, D) Phi does not fit):

        dgamma[pq]   = (E_pq tpsi).psi + (E_pq psi).tpsi
        dcorr[pq,rs] = <E_qp tpsi|E_rs psi> + <E_qp psi|E_rs tpsi>

    the pair order of the fused route's dense formulas.  Both Phi chunks
    are made once per row chunk.  Returns (dgamma (n2,), dcorr (n2, n2)),
    f64 accumulators whatever the states' dtype (an f32 pair's grams are
    ``gram_last``'s)."""
    n2 = gm.n2
    psig = psi.contiguous().reshape(gm.Na, gm.Nb)
    tpsig = tpsi.contiguous().reshape(gm.Na, gm.Nb)
    dgamma = psi.new_zeros(n2, dtype=torch.float64)
    dcorr = psi.new_zeros((n2, n2), dtype=torch.float64)
    for r0, r1 in _row_chunks(gm.Na, row_chunk):
        phi_p = _phi_chunk(psig, gm, r0, r1).reshape(n2, -1)
        phi_t = _phi_chunk(tpsig, gm, r0, r1).reshape(n2, -1)
        dgamma += (gram_last(phi_t, psig[r0:r1].reshape(-1))
                   + gram_last(phi_p, tpsig[r0:r1].reshape(-1)))
        A = gram_last(phi_t, phi_p)
        dcorr += A + A.T
        del phi_p, phi_t
    return dgamma, dcorr


def ham_apply_chunked(c1eff_flat, C2, x, gm, chunk):
    """sum_pq E_pq [sum_rs C2 E_rs + c1eff] x with the pair axis streamed:
    Phi and Y exist only as (..., chunk, D) blocks, and the inner Phi
    blocks are rebuilt once per outer block (n2 / chunk extra passes)."""
    n2 = gm.n2
    C2 = C2.to(x.dtype)
    c1 = c1eff_flat.to(x.dtype)
    out = torch.zeros_like(x)
    for lo in range(0, n2, chunk):
        hi = min(n2, lo + chunk)
        Y = c1[lo:hi, None] * x[..., None, :]
        for lo2 in range(0, n2, chunk):
            hi2 = min(n2, lo2 + chunk)
            Y = Y + torch.matmul(C2[lo:hi, lo2:hi2],
                                 phi_all(x, pair_slice(gm, lo2, hi2)))
        out = out + epq_sum(Y, pair_slice(gm, lo, hi))
    return out


def rdms_chunked(psi, gm, ncas, chunk):
    """(gamma, Gamma) of a real GRID-ordered state with the pair axis of
    the Phi gram streamed: two (chunk, D) blocks live, Phi blocks rebuilt
    O((n2 / chunk)^2) times."""
    n2 = gm.n2
    gamma = psi.new_empty(n2)
    corr = psi.new_empty((n2, n2))
    for lo in range(0, n2, chunk):
        hi = min(n2, lo + chunk)
        phi_a = phi_all(psi, pair_slice(gm, lo, hi))
        gamma[lo:hi] = phi_a @ psi
        for lo2 in range(0, n2, chunk):
            hi2 = min(n2, lo2 + chunk)
            phi_b = (phi_a if lo2 == lo
                     else phi_all(psi, pair_slice(gm, lo2, hi2)))
            corr[lo:hi, lo2:hi2] = phi_a @ phi_b.T
    return assemble_rdms(gamma, corr, ncas)


class SMinusGridMaps(NamedTuple):
    """Per-orbital string-factorized maps of S^-: sector (na, nb) ->
    (na-1, nb+1), on one device.  Target-indexed: for target grid cell
    (i', j') and orbital p the source cell is (srcAm[p, i'], srcBp[p, j'])
    with sign fA[p, i'] * fB[p, j'] (0 marks an invalid transfer)."""

    srcAm: torch.Tensor  # (ncas, Na_t) int64 alpha source rank
    fA: torch.Tensor     # (ncas, Na_t) int8 alpha sign factor
    srcBp: torch.Tensor  # (ncas, Nb_t) int64 beta source rank
    fB: torch.Tensor     # (ncas, Nb_t) int8 beta sign factor


def sminus_grid_maps(ncas, nelecas, up_then_down=False, device=None):
    """SMinusGridMaps of the (na, nb) sector on ``device``, or None when
    S^- is the zero map (na = 0 or nb = ncas).

    The Jordan-Wigner sign of a^dag_{p beta} a_{p alpha} splits into an
    alpha-string factor, parity_below(A, P_alpha) * parity_below(A',
    P_beta) with A = A' + p, and a beta-string factor, parity_below(B,
    P_alpha) * parity_below(B, P_beta) with B' = B + p."""
    na, nb = _nelec_split(nelecas)
    if na - 1 < 0 or nb + 1 > ncas:
        return None
    nm = 2 * ncas
    A = spin_strings(ncas, na, 0, up_then_down)
    At = spin_strings(ncas, na - 1, 0, up_then_down)
    B = spin_strings(ncas, nb, 1, up_then_down)
    Bt = spin_strings(ncas, nb + 1, 1, up_then_down)
    srcAm = np.zeros((ncas, At.size), dtype=np.int64)
    fA = np.zeros((ncas, At.size), dtype=np.int8)
    srcBp = np.zeros((ncas, Bt.size), dtype=np.int64)
    fB = np.zeros((ncas, Bt.size), dtype=np.int8)
    for p in range(ncas):
        Pa = fermion.mode_of(p, 0, ncas, up_then_down)
        Pb = fermion.mode_of(p, 1, ncas, up_then_down)
        bita = 1 << (nm - 1 - Pa)
        bitb = 1 << (nm - 1 - Pb)
        # alpha: the target string A' lacks p, the source is A' + p
        validA = (At & bita) == 0
        srcA_full = np.where(validA, At | bita, A[0])
        pos = np.minimum(np.searchsorted(A, srcA_full), A.size - 1)
        validA &= A[pos] == srcA_full
        sA = (fermion._parity_below(srcA_full, Pa, nm)
              * fermion._parity_below(At, Pb, nm))
        srcAm[p] = np.where(validA, pos, 0)
        fA[p] = np.where(validA, sA, 0)
        # beta: the target string B' holds p, the source is B' - p
        validB = (Bt & bitb) != 0
        srcB_full = np.where(validB, Bt ^ bitb, B[0])
        posB = np.minimum(np.searchsorted(B, srcB_full), B.size - 1)
        validB &= B[posB] == srcB_full
        sB = (fermion._parity_below(srcB_full, Pa, nm)
              * fermion._parity_below(srcB_full, Pb, nm))
        srcBp[p] = np.where(validB, posB, 0)
        fB[p] = np.where(validB, sB, 0)
    device = get_device(device)
    return SMinusGridMaps(*(torch.as_tensor(a, device=device)
                            for a in (srcAm, fA, srcBp, fB)))


def sminus_apply_grid(psi_grid, sm):
    """v = S^- psi on the grid: psi_grid (..., Na, Nb) -> (..., Na', Nb').
    Per orbital one row gather, one column gather and the rank-1 sign
    applied in place (a row scale, then a column scale), accumulated into
    one target-grid buffer: the peak is that buffer plus one gathered
    rows block and one target block."""
    dt = psi_grid.dtype
    ncas, Na_t = sm.srcAm.shape
    acc = psi_grid.new_zeros(psi_grid.shape[:-2] + (Na_t, sm.srcBp.shape[1]))
    for p in range(ncas):
        cell = psi_grid.index_select(-2, sm.srcAm[p]).index_select(
            -1, sm.srcBp[p])
        cell.mul_(sm.fA[p].to(dt)[:, None]).mul_(sm.fB[p].to(dt))
        acc.add_(cell)
        del cell
    return acc


def s2_expectation_grid(psi, gm, sm, nelecas):
    """<S^2> of a grid-sector state, ||S^- psi||^2 + Sz^2 - Sz.  A 1-D
    ``psi`` is in canonical (sorted) order and is converted here; a 2-D
    (Na, Nb) one is the grid state itself (no D-sized permutation).  The
    sum of squares is one float64 reduction."""
    na, nb = _nelec_split(nelecas)
    sz = 0.5 * (na - nb)
    if sm is None:
        return torch.tensor(sz * sz - sz, dtype=torch.float64)
    if psi.dim() == 1:
        psi = to_grid(psi, gm).reshape(gm.Na, gm.Nb)
    v = sminus_apply_grid(psi, sm).reshape(-1)
    return torch.linalg.vecdot(v, v).real + sz * sz - sz
