"""String-grid gate program: sector circuits as row-block Givens updates.

Port of auto_oo_tpu/simulator/grid_program.py.  Every compiled gate pairs
determinants via a FIXED bit flip; on the (Na, Nb) string grid of a
particle sector the alpha and beta parts of that flip act on the two grid
axes independently, and the Jordan-Wigner sign of each pair factorizes
exactly as sign(i, j) = sA(i) * sB(j).  So one gate is a rotation between
two SUBGRIDS:

    Psi[A_src x B_src]  <-cos/sin->  Psi[A_dst x B_dst]

applied as row gathers, small column ops and row scatter-adds.  The gate
step is functional (out-of-place ``index_copy`` / ``index_add``), so
``apply`` is differentiable by autograd and torch.func.

The optimizer's derivatives do not go through autograd: the sweeps of
simulator/program.py (``apply_with_jacobian``, ``hessian_dot`` and, where
the (n_tangents, D) stacks do not fit ((16e,16o): 14 x 1.3 GB),
``apply_pair`` / ``pair_row``) run on this program's row-block
operations.

``factorize_program`` builds this program from a flat sector
``GateProgram`` (a prebuilt full-space program projected onto the sector
by simulator/sector.py), checking the product structure and the exact
rank-1 sign split of every gate: a gate that does not factorize raises
at construction.

Layout contract: statevectors are GRID-ordered flat (Na * Nb,) vectors,
matching ops/grid.py; simulator/circuit.py converts to the canonical
sorted-determinant order only at public API boundaries.
"""

import numpy as np
import torch

from ..config import get_device
from ..ops import fermion
from .program import _SweepProgram


class _GridGate:
    __slots__ = ("Ai_src", "Ai_dst", "sA", "Bj_src", "Bj_dst", "sB",
                 "alpha_identity", "beta_identity", "half", "param",
                 "empty")


def _spin_mask(ncas, spin, up_then_down=False):
    nm = 2 * ncas
    m = 0
    for p in range(ncas):
        m |= 1 << (nm - 1 - fermion.mode_of(p, spin, ncas, up_then_down))
    return m


def _require(cond, msg):
    if not cond:
        raise ValueError(msg)


def _factorize_gate(ia_det, ib_det, sign, A, B, amask, bmask):
    """Split one gate's determinant pairs into alpha x beta structure.

    Returns a _GridGate with indices into the A / B string lists (empty
    when the gate has no pair)."""
    g = _GridGate()
    if ia_det.size == 0:
        g.empty = True
        return g
    g.empty = False
    fa = int((ia_det[0] ^ ib_det[0]) & amask)
    fb = int((ia_det[0] ^ ib_det[0]) & bmask)
    _require(np.all((ia_det ^ ib_det) == (fa | fb)),
             "gate flip mask is not constant")
    a_src = ia_det & amask
    b_src = ia_det & bmask
    A_list = np.unique(a_src)
    B_list = np.unique(b_src)
    ka, kb = A_list.size, B_list.size
    _require(ia_det.size == ka * kb, "gate pairs are not a product grid")
    i = np.searchsorted(A_list, a_src)
    j = np.searchsorted(B_list, b_src)
    S = np.zeros((ka, kb), dtype=np.int64)
    S[i, j] = np.rint(sign).astype(np.int64)
    _require(np.all(S != 0), "product grid has holes")
    # exact rank-1 split of the +-1 sign matrix
    sA = S[:, 0]
    sB = S[0, :] * S[0, 0]      # so that sA[0] * sB[0] = S[0, 0]
    _require(np.array_equal(np.outer(sA, sB), S),
             "gate sign does not factorize alpha x beta")
    g.Ai_src = np.searchsorted(A, A_list)
    g.Ai_dst = np.searchsorted(A, A_list ^ fa)
    g.Bj_src = np.searchsorted(B, B_list)
    g.Bj_dst = np.searchsorted(B, B_list ^ fb)
    _require(np.all(g.Ai_dst < A.size) and np.all(g.Bj_dst < B.size)
             and np.array_equal(A[g.Ai_src], A_list)
             and np.array_equal(A[g.Ai_dst], A_list ^ fa)
             and np.array_equal(B[g.Bj_src], B_list)
             and np.array_equal(B[g.Bj_dst], B_list ^ fb),
             "gate strings left the sector string lists")
    g.sA = sA.astype(np.int8)
    g.sB = sB.astype(np.int8)
    g.alpha_identity = (fa == 0 and ka == A.size)
    g.beta_identity = (fb == 0 and kb == B.size)
    return g


def factorize_program(program, basis_dets, ncas):
    """GridGateProgram, on the program's device, from a flat sector
    GateProgram (simulator/program.py) whose (ia, ib) are ranks into
    ``basis_dets``, the canonical sorted sector basis (interleaved spin
    ordering)."""
    from ..ops.grid import grid_perms

    basis_dets = np.asarray(basis_dets, dtype=np.int64)
    amask = _spin_mask(ncas, 0)
    bmask = _spin_mask(ncas, 1)
    # (na, nb) from any basis determinant
    na = int(fermion.popcount(np.asarray([basis_dets[0] & amask]))[0])
    nb = int(fermion.popcount(np.asarray([basis_dets[0] & bmask]))[0])
    A, B, g2s, s2g = grid_perms(ncas, (na, nb))
    gates = []
    for gi in range(len(program.half)):
        g = _factorize_gate(basis_dets[program.ia[gi]],
                            basis_dets[program.ib[gi]], program.sign[gi],
                            A, B, amask, bmask)
        g.half = float(program.half[gi])
        g.param = int(program.param[gi])
        gates.append(g)
    return GridGateProgram(gates, program.n_params,
                           int(s2g[program.init_idx]), A.size, B.size,
                           device=program.device)


# a gate's (ka, kb) sign matrix of more elements than this is kept as its
# rank-1 factors: dense, the 45 of the (16e,16o) H16 chain would hold
# 12 GB of the card (3432 x 12870 and larger per gate)
_DENSE_SIGNS_MAX = 1 << 21


class GridGateProgram(_SweepProgram):
    """Unrolled grid-space circuit over ``n_params`` full parameters.

    Each gate's tables are O(Na + Nb) integers, held on ``device``; the
    rank-1 sign matrices are built once per dtype on first use (dense up
    to _DENSE_SIGNS_MAX elements, else as their two factors)."""

    def __init__(self, gates, n_params, init_idx, Na, Nb, device=None):
        self.gates = [g for g in gates if not g.empty]
        self.n_params = int(n_params)
        self.init_idx = int(init_idx)
        self.Na = int(Na)
        self.Nb = int(Nb)
        self.dim = self.Na * self.Nb
        self.device = get_device(device)
        self._shape = (self.Na, self.Nb)
        self._init_sweeps([g.half for g in self.gates],
                          [g.param for g in self.gates])

        def dev(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=self.device)

        self._tabs = [(dev(g.Ai_src), dev(g.Ai_dst), dev(g.Bj_src),
                       dev(g.Bj_dst)) for g in self.gates]
        self._sgn = {}

    def device_tables(self):
        """Per gate: (Ai_src, Ai_dst, Bj_src, Bj_dst) index tensors."""
        return self._tabs

    def _signs(self, dtype):
        """Per gate: the (ka, kb) sign matrix sA x sB in ``dtype``, or for
        a large gate its factors (sA (ka, 1), sB (1, kb))."""
        hit = self._sgn.get(dtype)
        if hit is None:
            hit = self._sgn[dtype] = []
            for g in self.gates:
                a, b = (torch.as_tensor(v.astype(np.float64)).to(
                    device=self.device, dtype=dtype) for v in (g.sA, g.sB))
                hit.append(a[:, None] * b[None, :]
                           if a.numel() * b.numel() <= _DENSE_SIGNS_MAX
                           else (a[:, None], b[None, :]))
        return hit

    @staticmethod
    def _sgn_mul(sgn, x):
        """sgn * x for a sign matrix or its factors (the signs are +-1, so
        both give the same bits)."""
        if isinstance(sgn, tuple):
            return (x * sgn[0]) * sgn[1]
        return sgn * x

    def _blocks(self, X, gi):
        """The (va, vb) blocks of X that gate ``gi`` rotates."""
        g = self.gates[gi]
        Ai_src, Ai_dst, Bj_src, Bj_dst = self._tabs[gi]
        if g.beta_identity:
            return X.index_select(-2, Ai_src), X.index_select(-2, Ai_dst)
        if g.alpha_identity:
            return X.index_select(-1, Bj_src), X.index_select(-1, Bj_dst)
        return (X.index_select(-2, Ai_src).index_select(-1, Bj_src),
                X.index_select(-2, Ai_dst).index_select(-1, Bj_dst))

    def _put(self, X, gi, da, db, add):
        """X with the gate's blocks replaced by (add=False) or increased
        by (add=True) da / db; out of place."""
        g = self.gates[gi]
        Ai_src, Ai_dst, Bj_src, Bj_dst = self._tabs[gi]
        if g.beta_identity or g.alpha_identity:
            dim, ia, ib = ((-2, Ai_src, Ai_dst) if g.beta_identity
                           else (-1, Bj_src, Bj_dst))
            if add:
                return X.index_add(dim, ia, da).index_add(dim, ib, db)
            return X.index_copy(dim, ia, da).index_copy(dim, ib, db)
        # subgrid: scatter the (ka, kb) blocks into zero (ka, Nb) row
        # blocks, then row scatter-add (A_src/A_dst disjoint, or columns
        # disjoint — a delta-add is safe in every case)
        rows = X.shape[:-2] + (Ai_src.shape[0], self.Nb)
        DA = torch.zeros(rows, dtype=X.dtype, device=X.device).index_copy(
            -1, Bj_src, da)
        DB = torch.zeros(rows, dtype=X.dtype, device=X.device).index_copy(
            -1, Bj_dst, db)
        return X.index_add(-2, Ai_src, DA).index_add(-2, Ai_dst, DB)

    def _gate_step(self, Psi, gi, c, s, sgn):
        """Apply gate ``gi`` with rotation (c, s) to (..., Na, Nb) grids;
        (c, -s) applies the INVERSE (the rotations are orthogonal)."""
        va, vb = self._blocks(Psi, gi)
        ss = self._sgn_mul(sgn, s)
        g = self.gates[gi]
        if g.beta_identity or g.alpha_identity:
            return self._put(Psi, gi, c * va - ss * vb, ss * va + c * vb,
                             add=False)
        cm1 = c - 1.0
        return self._put(Psi, gi, cm1 * va - ss * vb, ss * va + cm1 * vb,
                         add=True)
