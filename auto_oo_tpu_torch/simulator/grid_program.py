"""String-grid gate program: sector circuits as row-block Givens updates.

Port of auto_oo_tpu/simulator/grid_program.py.  Every compiled gate pairs
determinants via a FIXED bit flip; on the (Na, Nb) string grid of a
particle sector the alpha and beta parts of that flip act on the two grid
axes independently, and the Jordan-Wigner sign of each pair factorizes
exactly as sign(i, j) = sA(i) * sB(j).  So one gate is a rotation between
two SUBGRIDS:

    Psi[A_src x B_src]  <-cos/sin->  Psi[A_dst x B_dst]

applied as row gathers, small column ops and row scatter-adds.  Where
nothing records through the operands the sweeps step each gate in place
(ops/gate_kernels.py: one kernel launch a step on the card, the plain
``index_copy_`` / ``index_add_`` on the CPU); under autograd, a
forward-mode dual or a torch.func transform the step is functional
(out-of-place ``index_copy`` / ``index_add``), so ``apply`` stays
differentiable.

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

import math

import numpy as np
import torch
import torch.autograd.forward_ad as _fwad
from torch._C import _functorch

from ..config import get_device
from ..ops import fermion
from ..ops import gate_kernels as _gk
from ..utils import observe as _observe
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


def _pairs_disjoint(g):
    """Whether every element of the grid is in at most one of the gate's
    pairs: no table repeats an entry, and the source and destination pairs
    share no row or no column (the condition under which the gate kernels
    step the pairs in place, one thread a pair)."""
    tabs = (g.Ai_src, g.Ai_dst, g.Bj_src, g.Bj_dst)
    if any(np.unique(t).size != np.size(t) for t in tabs):
        return False
    return (np.intersect1d(g.Ai_src, g.Ai_dst).size == 0
            or np.intersect1d(g.Bj_src, g.Bj_dst).size == 0)


def _recorded(tensors):
    """Whether an autograd graph, a forward-mode dual or a torch.func
    transform records through any of ``tensors``."""
    grad = torch.is_grad_enabled()
    for t in tensors:
        if t is None:
            continue
        if ((grad and t.requires_grad)
                or _functorch.is_functorch_wrapped_tensor(t)
                or _fwad.unpack_dual(t).tangent is not None):
            return True
    return False


def _own(x, shape):
    """A contiguous copy of x in ``shape``, for a sweep to step in place."""
    return x.reshape(shape).clone(memory_format=torch.contiguous_format)


class GridGateProgram(_SweepProgram):
    """Unrolled grid-space circuit over ``n_params`` full parameters.

    Each gate's tables (``gate_kernels.GateTables``) are O(Na + Nb)
    integers, held on ``device``; the rank-1 sign matrices are built once
    per dtype on first use (dense up to _DENSE_SIGNS_MAX elements, else as
    their two factors).  Construction checks that each gate's pairs are
    disjoint.

    Where nothing records through the operands (no autograd graph, dual or
    torch.func transform), the sweeps step the gates in place with the
    gate kernels (ops/gate_kernels.py): each sweep copies the operands it
    changes once at entry, never a caller's tensor, and each gate step is
    one launch on the card.  Otherwise the functional step of
    simulator/program.py runs (counted as ``functional_gate_steps``)."""

    def __init__(self, gates, n_params, init_idx, Na, Nb, device=None):
        self.gates = [g for g in gates if not g.empty]
        for i, g in enumerate(self.gates):
            _require(_pairs_disjoint(g),
                     f"gate {i} (parameter {g.param}): its source and "
                     "destination pairs overlap")
        self.n_params = int(n_params)
        self.init_idx = int(init_idx)
        self.Na = int(Na)
        self.Nb = int(Nb)
        self.dim = self.Na * self.Nb
        self.device = get_device(device)
        self._shape = (self.Na, self.Nb)
        self._init_sweeps([g.half for g in self.gates],
                          [g.param for g in self.gates])
        self._gt = [_gk.GateTables(g, self.Na, self.Nb, self.device,
                                   _DENSE_SIGNS_MAX) for g in self.gates]
        self._max_ka = max((t.ka for t in self._gt), default=0)

    def device_tables(self):
        """Per gate: (Ai_src, Ai_dst, Bj_src, Bj_dst) index tensors."""
        return [(t.Ai_src, t.Ai_dst, t.Bj_src, t.Bj_dst) for t in self._gt]

    def _signs(self, dtype):
        """Per gate: the (ka, kb) sign matrix sA x sB in ``dtype``, or for
        a large gate its factors (sA (ka, 1), sB (1, kb))."""
        return [t.signs(dtype) for t in self._gt]

    _sgn_mul = staticmethod(_gk.sgn_mul)

    def _blocks(self, X, gi):
        """The (va, vb) blocks of X that gate ``gi`` rotates."""
        return _gk.blocks(X, self._gt[gi])

    def _put(self, X, gi, da, db, add):
        """X with the gate's blocks replaced by (add=False) or increased
        by (add=True) da / db; out of place."""
        return _gk.put(X, self._gt[gi], da, db, add)

    def _gate_step(self, Psi, gi, c, s, sgn):
        """Apply gate ``gi`` with rotation (c, s) to (..., Na, Nb) grids;
        (c, -s) applies the INVERSE (the rotations are orthogonal)."""
        _observe.count("functional_gate_steps")
        va, vb = self._blocks(Psi, gi)
        ss = self._sgn_mul(sgn, s)
        if not self._gt[gi].subgrid:
            return self._put(Psi, gi, c * va - ss * vb, ss * va + c * vb,
                             add=False)
        cm1 = c - 1.0
        return self._put(Psi, gi, cm1 * va - ss * vb, ss * va + cm1 * vb,
                         add=True)

    # ---- the in-place sweeps (the same sweeps as simulator/program.py's,
    # ---- each gate step one gate-kernel launch on the card) ----------------

    def _grids(self, X, per_lane=1):
        return X.view(-1, per_lane, self.Na, self.Nb)

    def _trig_rows(self, theta, dtype):
        """(cos, sin) of every gate's half angle in ``dtype``, (n_gates, L):
        row gi holds the L lanes' values (L = 1 for one theta)."""
        n = len(self._half)
        return tuple(t.reshape(n, -1).to(dtype).contiguous()
                     for t in self._trig(theta))

    def apply(self, theta, psi=None):
        if not self._half or _recorded((theta, psi)):
            return super().apply(theta, psi)
        lanes = theta.shape[:-1]
        Psi = (self.initial_state(theta.dtype, lanes) if psi is None
               else _own(psi, lanes + (self.dim,)))
        P = self._grids(Psi)
        cos_t, sin_t = self._trig_rows(theta, P.dtype)
        for gi, tab in enumerate(self._gt):
            _gk.gate_rotate(P, tab, cos_t[gi], sin_t[gi])
        return Psi

    def apply_with_jacobian(self, theta, params_idx):
        if not self._half or _recorded((theta,)):
            return super().apply_with_jacobian(theta, params_idx)
        nt = len(params_idx)
        lanes = theta.shape[:-1]
        psi = self.initial_state(theta.dtype, lanes)
        J = torch.zeros(lanes + (nt, self.dim), dtype=psi.dtype,
                        device=psi.device)
        P, D = self._grids(psi), self._grids(J, nt)
        cos_t, sin_t = self._trig_rows(theta, P.dtype)
        half = self._half_dev.to(P.dtype)
        tang = self._tangent_of_gate(params_idx)
        for gi, tab in enumerate(self._gt):
            ti = int(tang[gi])
            if ti >= 0:
                _gk.gate_generator_add(D[:, ti:ti + 1], P, tab, half[gi])
            _gk.gate_rotate(D, tab, cos_t[gi], sin_t[gi])
            _gk.gate_rotate(P, tab, cos_t[gi], sin_t[gi])
        return psi, J

    def apply_pair(self, theta, v, psi=None):
        if not self._half or _recorded((theta, v, psi)):
            return super().apply_pair(theta, v, psi)
        psi = (self.initial_state(theta.dtype) if psi is None
               else _own(psi, (self.dim,)))
        P = self._grids(psi)
        cos_t, sin_t = self._trig_rows(theta, P.dtype)
        da, live = self._pair_coefs(v)
        da = da.to(P.dtype)
        delta = None
        for gi, tab in enumerate(self._gt):
            if live[gi]:
                if delta is None:
                    delta = torch.zeros_like(psi)
                    D = self._grids(delta)
                _gk.gate_generator_add(D, P, tab, da[gi])
            if delta is not None:
                _gk.gate_rotate(D, tab, cos_t[gi], sin_t[gi])
            _gk.gate_rotate(P, tab, cos_t[gi], sin_t[gi])
        if delta is None:
            delta = torch.zeros_like(psi)
        return psi, delta

    def pair_row(self, theta, v, a, b, psi=None, delta=None):
        if not self._half or _recorded((theta, v, a, b, psi, delta)):
            return super().pair_row(theta, v, a, b, psi, delta)
        if psi is None:
            psi, delta = self.apply_pair(theta, v)
        out = torch.zeros(self.n_params, dtype=psi.dtype, device=psi.device)
        cos_t, sin_t = self._trig_rows(theta, psi.dtype)
        da, live = self._pair_coefs(v)
        da = da.to(psi.dtype)
        n = len(self._half)
        first = live.index(True) if True in live else n
        P, Q = (self._grids(_own(x, (self.dim,))) for x in (psi, a))
        # Delta and CtD feed nothing below the first generator term: they
        # are copied only where a sweep reaches one
        D = E = None
        if first < n:
            D, E = (self._grids(_own(x, (self.dim,))) for x in (delta, b))
        part = psi.new_empty(self._max_ka)
        for gi in reversed(range(n)):
            p = int(self._param[gi])
            _gk.gate_adjoint_step(
                P, Q, D if gi >= first else None, E if gi >= first else None,
                self._gt[gi], cos_t[gi], sin_t[gi],
                out=out[p:p + 1].view(1, 1), h=self._half[gi],
                ti=0 if live[gi] else -1, coef=da[gi], part=part)
        return out

    def hessian_dot(self, theta, w, psi, J, params_idx):
        if not self._half or _recorded((theta, w, psi, J)):
            return super().hessian_dot(theta, w, psi, J, params_idx)
        nt = len(params_idx)
        lanes = theta.shape[:-1]
        out = torch.zeros(lanes + (nt, nt), dtype=psi.dtype,
                          device=psi.device)
        if nt == 0:
            return out
        L = math.prod(lanes)
        P = self._grids(_own(psi, (L, self.dim)))
        E = self._grids(_own(w, (L, self.dim)))
        D = self._grids(_own(J, (L, nt, self.dim)), nt)
        Q = torch.zeros_like(D)
        O = out.view(L, nt, nt)
        cos_t, sin_t = self._trig_rows(theta, P.dtype)
        half = self._half_dev.to(P.dtype)
        tang = self._tangent_of_gate(params_idx)
        part = P.new_empty(L * nt * self._max_ka)
        for gi in reversed(range(len(self._half))):
            ti = int(tang[gi])
            _gk.gate_adjoint_step(
                P, Q, D, E, self._gt[gi], cos_t[gi], sin_t[gi],
                out=O[:, :, ti] if ti >= 0 else None, h=self._half[gi],
                ti=ti, coef=half[gi], part=part)
        return out
