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

The optimizer's derivatives do not go through autograd.  Two explicit
sweeps carry every circuit tangent at once, batched on a leading axis:

* ``apply_with_jacobian``: (psi, J) in one forward sweep — per gate
  (angle a = half * theta_p), Psi' = R Psi and
  Delta_i' = R (Delta_i + [p is tangent i] half G Psi), with G the
  gate's rotation generator.  This is the JAX package's ``_pair_core``
  with a batched Delta; it equals jax.jacfwd of ``apply``.
* ``hessian_dot``: d^2 <w, psi(theta)> / dtheta^2 in one reverse sweep
  that rebuilds each intermediate (Psi, Delta) by the inverse rotations
  instead of storing it — the backward of the JAX package's
  ``apply_pair_adjoint`` seeded with ct_psi = 0, ct_delta = w for every
  tangent at once.  It equals jax.jacfwd(jax.grad(<psi, w>)).

Where the (n_tangents, D) stacks do not fit ((16e,16o): 14 x 1.3 GB,
with the circuit-Hessian sweep's out-of-place temporaries beside them),
the same two sweeps run for ONE tangent direction v, with O(D) memory:

* ``apply_pair``: (psi, J v), the forward of the JAX package's
  ``apply_pair_adjoint`` (``_pair_core``);
* ``pair_row``: grad_theta [<psi(theta), a> + <J(theta) v, b>], its
  backward seeded with ct_psi = a, ct_delta = b.  With a = 2 H J v and
  b = 2 H psi that is one row of the circuit Hessian of <psi|H|psi>.

Layout contract: statevectors are GRID-ordered flat (Na * Nb,) vectors,
matching ops/grid.py; simulator/circuit.py converts to the canonical
sorted-determinant order only at public API boundaries.
"""

import numpy as np
import torch

from ..config import get_device
from ..ops import fermion


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


# a gate's (ka, kb) sign matrix of more elements than this is kept as its
# rank-1 factors: dense, the 45 of the (16e,16o) H16 chain would hold
# 12 GB of the card (3432 x 12870 and larger per gate)
_DENSE_SIGNS_MAX = 1 << 21


class GridGateProgram:
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
        self._half = [float(g.half) for g in self.gates]
        self._param = np.array([g.param for g in self.gates], dtype=np.int64)
        self._half_dev = torch.tensor(self._half, dtype=torch.float64,
                                      device=self.device)
        self._param_dev = torch.as_tensor(self._param, device=self.device)

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

    def initial_state(self, dtype=torch.float64):
        psi = torch.zeros(self.dim, dtype=dtype, device=self.device)
        psi[self.init_idx] = 1.0
        return psi

    def _trig(self, theta):
        angles = self._half_dev.to(theta.dtype) * theta[self._param_dev]
        return torch.cos(angles), torch.sin(angles)

    def _tangent_of_gate(self, params_idx):
        """Per gate: the tangent row of its parameter, or -1 when the
        parameter has no tangent (a redundant parameter held at 0)."""
        t_of = np.full(self.n_params, -1, dtype=np.int64)
        t_of[np.asarray(params_idx, dtype=np.int64)] = np.arange(
            len(params_idx))
        return t_of[self._param]

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

    def _g_add(self, Dst, Src, gi, coef, sgn):
        """Dst + coef * G Src, where G is the gate's rotation GENERATOR
        (per pair: (va, vb) -> (-sgn*vb, sgn*va), zero elsewhere)."""
        va, vb = self._blocks(Src, gi)
        cs = self._sgn_mul(sgn, coef)
        return self._put(Dst, gi, -cs * vb, cs * va, add=True)

    def _g_dot(self, Ct, Y, gi, sgn):
        """<Ct, G Y> over the trailing (Na, Nb) axes (batch-broadcast)."""
        cta, ctb = self._blocks(Ct, gi)
        ya, yb = self._blocks(Y, gi)
        return ((ctb * self._sgn_mul(sgn, ya)).sum(dim=(-2, -1))
                - (cta * self._sgn_mul(sgn, yb)).sum(dim=(-2, -1)))

    def apply(self, theta, psi=None):
        """|psi(theta)> over the GRID-ordered sector basis; theta holds
        the ``n_params`` full parameters."""
        if psi is None:
            psi = self.initial_state(theta.dtype)
        if not self.gates:
            return psi
        cos_t, sin_t = self._trig(theta)
        sgn = self._signs(psi.dtype)
        Psi = psi.reshape(self.Na, self.Nb)
        for gi in range(len(self.gates)):
            Psi = self._gate_step(Psi, gi, cos_t[gi], sin_t[gi], sgn[gi])
        return Psi.reshape(-1)

    def apply_with_jacobian(self, theta, params_idx):
        """(psi, J): the GRID-ordered state and its Jacobian J[i] =
        d psi / d theta[params_idx[i]], shape (len(params_idx), D)."""
        nt = len(params_idx)
        psi = self.initial_state(theta.dtype)
        Psi = psi.reshape(self.Na, self.Nb)
        Delta = torch.zeros((nt, self.Na, self.Nb), dtype=psi.dtype,
                            device=psi.device)
        if not self.gates:
            return psi, Delta.reshape(nt, -1)
        cos_t, sin_t = self._trig(theta)
        sgn = self._signs(psi.dtype)
        tang = self._tangent_of_gate(params_idx)
        for gi in range(len(self.gates)):
            c, s, ti = cos_t[gi], sin_t[gi], int(tang[gi])
            if ti >= 0:
                Delta[ti] = self._g_add(Delta[ti], Psi, gi,
                                        self._half[gi], sgn[gi])
            Delta = self._gate_step(Delta, gi, c, s, sgn[gi])
            Psi = self._gate_step(Psi, gi, c, s, sgn[gi])
        return Psi.reshape(-1), Delta.reshape(nt, -1)

    def _pair_coefs(self, v):
        """Per gate: da = half * v[param] on the device, and on the host
        the gates whose da is not zero (one sync) — a sweep skips the
        generator terms of the others, and carries no Delta before the
        first of them (Delta is zero there)."""
        da = self._half_dev.to(v.dtype) * v[self._param_dev]
        return da, (da != 0).tolist()

    def apply_pair(self, theta, v, psi=None):
        """(|psi(theta)>, J(theta) v) over the GRID-ordered sector basis
        for one direction v of the ``n_params`` full parameters, in one
        forward sweep: per gate, Delta' = R (Delta + da G Psi) and
        Psi' = R Psi (equals torch.func.jvp of ``apply``)."""
        if psi is None:
            psi = self.initial_state(theta.dtype)
        if not self.gates:
            return psi, torch.zeros_like(psi)
        cos_t, sin_t = self._trig(theta)
        sgn = self._signs(psi.dtype)
        da, live = self._pair_coefs(v)
        Psi = psi.reshape(self.Na, self.Nb)
        Delta = None
        for gi in range(len(self.gates)):
            c, s, sg = cos_t[gi], sin_t[gi], sgn[gi]
            if live[gi]:
                Delta = self._g_add(torch.zeros_like(Psi) if Delta is None
                                    else Delta, Psi, gi, da[gi], sg)
            if Delta is not None:
                Delta = self._gate_step(Delta, gi, c, s, sg)
            Psi = self._gate_step(Psi, gi, c, s, sg)
        if Delta is None:
            Delta = torch.zeros_like(Psi)
        return Psi.reshape(-1), Delta.reshape(-1)

    def pair_row(self, theta, v, a, b, psi=None, delta=None):
        """grad_theta [<psi(theta), a> + <J(theta) v, b>] over the
        ``n_params`` full parameters, for GRID-ordered a, b (real states),
        in one reverse sweep that rebuilds each (Psi, Delta) by the inverse
        rotations (the backward of the JAX package's
        ``apply_pair_adjoint``).  ``psi``, ``delta`` are ``apply_pair(theta,
        v)``, computed here when not given."""
        if psi is None:
            psi, delta = self.apply_pair(theta, v)
        out = torch.zeros(self.n_params, dtype=psi.dtype, device=psi.device)
        if not self.gates:
            return out
        cos_t, sin_t = self._trig(theta)
        sgn = self._signs(psi.dtype)
        da, live = self._pair_coefs(v)
        first = live.index(True) if True in live else len(live)
        shape = (self.Na, self.Nb)
        Psi, Delta = psi.reshape(shape), delta.reshape(shape)
        CtP, CtD = a.reshape(shape), b.reshape(shape)
        rows = []
        for gi in reversed(range(len(self.gates))):
            c, s, h, sg = cos_t[gi], sin_t[gi], self._half[gi], sgn[gi]
            if gi < first:
                # below the first generator term Delta is zero and CtD
                # feeds nothing: only (Psi, CtP) go on
                rows.append(h * self._g_dot(CtP, Psi, gi, sg))
                Psi = self._gate_step(Psi, gi, c, -s, sg)
                CtP = self._gate_step(CtP, gi, c, -s, sg)
                continue
            # d/d theta_p at POST-gate states: both outputs respond with
            # their own G-image (G commutes with R)
            rows.append(h * (self._g_dot(CtP, Psi, gi, sg)
                             + self._g_dot(CtD, Delta, gi, sg)))
            # rebuild the pre-gate pair by the inverse rotation
            Psi = self._gate_step(Psi, gi, c, -s, sg)
            Delta = self._gate_step(Delta, gi, c, -s, sg)
            if live[gi]:
                Delta = self._g_add(Delta, Psi, gi, -da[gi], sg)
            # transport the cotangents: J^T = [[R^T, -da G R^T], [0, R^T]]
            CtP = self._gate_step(CtP, gi, c, -s, sg)
            CtD = self._gate_step(CtD, gi, c, -s, sg)
            if live[gi]:
                CtP = self._g_add(CtP, CtD, gi, -da[gi], sg)
        return out.index_add_(0, self._param_dev, torch.stack(rows[::-1]))

    def hessian_dot(self, theta, w, psi, J, params_idx):
        """H[i, j] = d^2 <w, psi(theta)> / d theta_i d theta_j over the
        tangents ``params_idx``, given psi and J = apply_with_jacobian
        at the same theta and a GRID-ordered w (real states)."""
        nt = len(params_idx)
        out = torch.zeros((nt, nt), dtype=psi.dtype, device=psi.device)
        if not self.gates:
            return out
        cos_t, sin_t = self._trig(theta)
        sgn = self._signs(psi.dtype)
        tang = self._tangent_of_gate(params_idx)
        Psi = psi.reshape(self.Na, self.Nb)
        Delta = J.reshape(nt, self.Na, self.Nb)
        CtD = w.reshape(self.Na, self.Nb)
        CtP = torch.zeros_like(Delta)
        for gi in reversed(range(len(self.gates))):
            c, s, ti = cos_t[gi], sin_t[gi], int(tang[gi])
            h = self._half[gi]
            sg = sgn[gi]
            if ti >= 0:
                # d/d theta_p at POST-gate states: both outputs respond
                # with their own G-image (G commutes with R)
                out[:, ti] += h * (self._g_dot(CtP, Psi, gi, sg)
                                   + self._g_dot(CtD, Delta, gi, sg))
            # rebuild the pre-gate pair by the inverse rotation
            Psi = self._gate_step(Psi, gi, c, -s, sg)
            Delta = self._gate_step(Delta, gi, c, -s, sg)
            if ti >= 0:
                Delta[ti] = self._g_add(Delta[ti], Psi, gi, -h, sg)
            # transport the cotangents: J^T = [[R^T, -da G R^T], [0, R^T]]
            CtP = self._gate_step(CtP, gi, c, -s, sg)
            CtD = self._gate_step(CtD, gi, c, -s, sg)
            if ti >= 0:
                CtP[ti] = self._g_add(CtP[ti], CtD, gi, -h, sg)
        return out
