"""Flat gate program: a circuit as pair rotations on one state vector.

Port of auto_oo_tpu/simulator/program.py.  Each compiled gate
(simulator/gates.py) pairs basis states (ia, ib) with a Jordan-Wigner
sign and rotates every pair by the same angle:

    psi[ia] <- cos(h) psi[ia] - sgn sin(h) psi[ib]
    psi[ib] <- sgn sin(h) psi[ia] + cos(h) psi[ib],  h = half * theta_p

The JAX package pads every gate to a common pair count and runs one
``lax.scan``; the port keeps each gate's exact (ia, ib, sign) as its own
tensors and loops over the gates on the host.  The padding repeats a
gate's first pair, which gives duplicate indices in one scatter: XLA
writes those deterministically, PyTorch on CUDA does not promise an
order.  ``deferred_device`` and ``device_arrays`` exist in the JAX
package only to keep the tables out of XLA constants, so they have no
counterpart here: the tables go to ``device`` at construction.

``_SweepProgram`` holds the sweeps that this program and the sector
grid's ``GridGateProgram`` (simulator/grid_program.py) share, written
against each program's block operations:

* ``apply``: |psi(theta)>;
* ``apply_with_jacobian``: (psi, J) in one forward sweep — per gate
  (angle a = half * theta_p), Psi' = R Psi and
  Delta_i' = R (Delta_i + [p is tangent i] half G Psi), with G the
  gate's rotation generator.  It equals jax.jacfwd of ``apply``;
* ``hessian_dot``: d^2 <w, psi(theta)> / dtheta^2 in one reverse sweep
  that rebuilds each intermediate (Psi, Delta) by the inverse rotations
  instead of storing it; it equals jax.jacfwd(jax.grad(<psi, w>));
* ``apply_pair`` / ``pair_row``: the same two sweeps for ONE tangent
  direction v, with O(D) memory (the hosted route of the grid).

The gate step is functional (out-of-place ``index_copy`` /
``index_add``), so ``apply`` is differentiable by autograd and
torch.func.  ``GridGateProgram`` runs the same sweeps in place (the gate
kernels, ops/gate_kernels.py) wherever nothing records through the
operands, and these functional ones where something does.

``apply``, ``apply_with_jacobian`` and ``hessian_dot`` also take a stack
of parameter vectors theta (B, n_params), one per geometry of a batch or
per line-search trial: each gate's (cos, sin) is then a (B,) column
broadcast over that lane's state (B, ...) or tangent batch (B, nt, ...),
and every output gains the leading axis B.
"""

import numpy as np
import torch

from ..config import get_device
from ..utils import observe as _observe


class _SweepProgram:
    """Forward, tangent and reverse sweeps over a list of rotation gates.

    A subclass sets ``n_params``, ``init_idx``, ``dim``, ``device`` and
    ``_shape`` (the state's shape inside a sweep), calls ``_init_sweeps``
    with the swept gates' angle multipliers and parameter slots, and
    provides per swept gate ``gi``: ``_blocks(X, gi)`` (the two blocks of
    X the gate rotates), ``_put(X, gi, da, db, add)`` (X with them
    replaced or increased, out of place), ``_signs(dtype)``,
    ``_sgn_mul(sgn, x)`` and ``_gate_step(X, gi, c, s, sgn)``."""

    def _init_sweeps(self, half, param):
        self._half = [float(h) for h in half]
        self._param = np.asarray(param, dtype=np.int64)
        self._half_dev = torch.tensor(self._half, dtype=torch.float64,
                                      device=self.device)
        self._param_dev = torch.as_tensor(self._param, device=self.device)
        self._axes = tuple(range(-len(self._shape), 0))

    def initial_state(self, dtype=torch.float64, lanes=()):
        psi = torch.zeros(tuple(lanes) + (self.dim,), dtype=dtype,
                          device=self.device)
        # fill_ of a view: item assignment would upload the scalar from
        # the host, which waits for the card
        psi[..., self.init_idx].fill_(1.0)
        return psi

    def _trig(self, theta):
        """(cos, sin) of every swept gate's half angle: (n_gates,) for one
        theta, (n_gates, B, 1, ..., 1) for a stack of B (the trailing ones
        broadcast over a lane's state; ``_lane_cs`` adds one for a tangent
        axis)."""
        angles = self._half_dev.to(theta.dtype) * theta[..., self._param_dev]
        if theta.dim() > 1:
            angles = angles.T.reshape(angles.shape[::-1]
                                      + (1,) * len(self._shape))
        return torch.cos(angles), torch.sin(angles)

    @staticmethod
    def _lane_cs(c, s):
        """Per-lane (cos, sin) columns for a tangent batch (B, nt, ...)
        of a stack (a scalar pair for one theta is returned as it is)."""
        if c.dim() == 0:
            return c, s
        return c[:, None], s[:, None]

    def _tangent_of_gate(self, params_idx):
        """Per gate: the tangent row of its parameter, or -1 when the
        parameter has no tangent (a redundant parameter held at 0)."""
        t_of = np.full(self.n_params, -1, dtype=np.int64)
        t_of[np.asarray(params_idx, dtype=np.int64)] = np.arange(
            len(params_idx))
        return t_of[self._param]

    def _g_add(self, Dst, Src, gi, coef, sgn):
        """Dst + coef * G Src, where G is the gate's rotation GENERATOR
        (per pair: (va, vb) -> (-sgn*vb, sgn*va), zero elsewhere)."""
        va, vb = self._blocks(Src, gi)
        cs = self._sgn_mul(sgn, coef)
        return self._put(Dst, gi, -cs * vb, cs * va, add=True)

    def _g_dot(self, Ct, Y, gi, sgn):
        """<Ct, G Y> over the trailing state axes (batch-broadcast)."""
        cta, ctb = self._blocks(Ct, gi)
        ya, yb = self._blocks(Y, gi)
        return ((ctb * self._sgn_mul(sgn, ya)).sum(dim=self._axes)
                - (cta * self._sgn_mul(sgn, yb)).sum(dim=self._axes))

    def apply(self, theta, psi=None):
        """|psi(theta)> as a flat (dim,) vector; theta holds the
        ``n_params`` full parameters (a (B, n_params) stack gives (B,
        dim))."""
        lanes = theta.shape[:-1]
        if psi is None:
            psi = self.initial_state(theta.dtype, lanes)
        if not self._half:
            return psi
        cos_t, sin_t = self._trig(theta)
        sgn = self._signs(psi.dtype)
        Psi = psi.reshape(lanes + self._shape)
        for gi in range(len(self._half)):
            Psi = self._gate_step(Psi, gi, cos_t[gi], sin_t[gi], sgn[gi])
        return Psi.reshape(lanes + (-1,))

    def apply_with_jacobian(self, theta, params_idx):
        """(psi, J): the state and its Jacobian J[i] =
        d psi / d theta[params_idx[i]], shape (len(params_idx), dim); for
        a (B, n_params) stack, (B, dim) and (B, len(params_idx), dim)."""
        nt = len(params_idx)
        lanes = theta.shape[:-1]
        # the tangent axis of Delta, after the lane axis of a stack
        tx = (slice(None),) * len(lanes)
        psi = self.initial_state(theta.dtype, lanes)
        Psi = psi.reshape(lanes + self._shape)
        Delta = torch.zeros(lanes + (nt,) + self._shape, dtype=psi.dtype,
                            device=psi.device)
        if not self._half:
            return psi, Delta.reshape(lanes + (nt, -1))
        cos_t, sin_t = self._trig(theta)
        sgn = self._signs(psi.dtype)
        tang = self._tangent_of_gate(params_idx)
        for gi in range(len(self._half)):
            c, s, ti = cos_t[gi], sin_t[gi], int(tang[gi])
            if ti >= 0:
                Delta[tx + (ti,)] = self._g_add(Delta[tx + (ti,)], Psi, gi,
                                                self._half[gi], sgn[gi])
            Delta = self._gate_step(Delta, gi, *self._lane_cs(c, s),
                                    sgn[gi])
            Psi = self._gate_step(Psi, gi, c, s, sgn[gi])
        return Psi.reshape(lanes + (-1,)), Delta.reshape(lanes + (nt, -1))

    def _pair_coefs(self, v):
        """Per gate: da = half * v[param] on the device, and on the host
        the gates whose da is not zero (one sync) — a sweep skips the
        generator terms of the others, and carries no Delta before the
        first of them (Delta is zero there)."""
        da = self._half_dev.to(v.dtype) * v[self._param_dev]
        _observe.count("host_syncs")
        return da, (da != 0).tolist()

    def apply_pair(self, theta, v, psi=None):
        """(|psi(theta)>, J(theta) v) for one direction v of the
        ``n_params`` full parameters, in one forward sweep: per gate,
        Delta' = R (Delta + da G Psi) and Psi' = R Psi (equals
        torch.func.jvp of ``apply``)."""
        if psi is None:
            psi = self.initial_state(theta.dtype)
        if not self._half:
            return psi, torch.zeros_like(psi)
        cos_t, sin_t = self._trig(theta)
        sgn = self._signs(psi.dtype)
        da, live = self._pair_coefs(v)
        Psi = psi.reshape(self._shape)
        Delta = None
        for gi in range(len(self._half)):
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
        ``n_params`` full parameters, for real a, b in the program's
        order, in one reverse sweep that rebuilds each (Psi, Delta) by
        the inverse rotations (the backward of the JAX package's
        ``apply_pair_adjoint``).  ``psi``, ``delta`` are
        ``apply_pair(theta, v)``, computed here when not given."""
        if psi is None:
            psi, delta = self.apply_pair(theta, v)
        out = torch.zeros(self.n_params, dtype=psi.dtype, device=psi.device)
        if not self._half:
            return out
        cos_t, sin_t = self._trig(theta)
        sgn = self._signs(psi.dtype)
        da, live = self._pair_coefs(v)
        first = live.index(True) if True in live else len(live)
        Psi, Delta = psi.reshape(self._shape), delta.reshape(self._shape)
        CtP, CtD = a.reshape(self._shape), b.reshape(self._shape)
        rows = []
        for gi in reversed(range(len(self._half))):
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
        at the same theta and a real w in the program's order; a stack of
        B (theta, w, psi, J) gives (B, nt, nt)."""
        nt = len(params_idx)
        lanes = theta.shape[:-1]
        tx = (slice(None),) * len(lanes)
        out = torch.zeros(lanes + (nt, nt), dtype=psi.dtype,
                          device=psi.device)
        if not self._half:
            return out
        cos_t, sin_t = self._trig(theta)
        sgn = self._signs(psi.dtype)
        tang = self._tangent_of_gate(params_idx)
        Psi = psi.reshape(lanes + self._shape)
        Delta = J.reshape(lanes + (nt,) + self._shape)
        CtD = w.reshape(lanes + self._shape)
        CtP = torch.zeros_like(Delta)

        def tb(X):
            # a lane's state against its tangent batch
            return X[:, None] if lanes else X

        for gi in reversed(range(len(self._half))):
            c, s, ti = cos_t[gi], sin_t[gi], int(tang[gi])
            ct, st = self._lane_cs(c, s)
            h = self._half[gi]
            sg = sgn[gi]
            if ti >= 0:
                # d/d theta_p at POST-gate states: both outputs respond
                # with their own G-image (G commutes with R)
                out[tx + (slice(None), ti)] += h * (
                    self._g_dot(CtP, tb(Psi), gi, sg)
                    + self._g_dot(tb(CtD), Delta, gi, sg))
            # rebuild the pre-gate pair by the inverse rotation
            Psi = self._gate_step(Psi, gi, c, -s, sg)
            Delta = self._gate_step(Delta, gi, ct, -st, sg)
            if ti >= 0:
                Delta[tx + (ti,)] = self._g_add(Delta[tx + (ti,)], Psi, gi,
                                                -h, sg)
            # transport the cotangents: J^T = [[R^T, -da G R^T], [0, R^T]]
            CtP = self._gate_step(CtP, gi, ct, -st, sg)
            CtD = self._gate_step(CtD, gi, c, -s, sg)
            if ti >= 0:
                CtP[tx + (ti,)] = self._g_add(CtP[tx + (ti,)], CtD, gi, -h,
                                              sg)
        return out


class GateProgram(_SweepProgram):
    """A circuit of pair-rotation gates over a ``dim``-dimensional vector
    (the full 4^ncas space, or a sector's ranks).

    Host attributes (numpy), one entry per gate in circuit order:
      ia, ib:   lists of each gate's paired indices (int64), unpadded
      sign:     list of each gate's pair signs (float64)
      half:     (n_gates,) angle multipliers
      param:    (n_gates,) parameter slot per gate
      n_real_pairs: (n_gates,) pairs per gate
      gate_meta: (name, wires, param) per gate, for ``draw_circuit``
      n_params, init_idx, dim
    The sweeps run the gates with at least one pair, from index tables
    on ``device``; the sign vectors are converted once per dtype on
    first use."""

    def __init__(self, gates, n_params, init_idx, dim, device=None):
        self.n_params = int(n_params)
        self.init_idx = int(init_idx)
        self.dim = int(dim)
        self.device = get_device(device)
        self.gate_meta = [(getattr(g, "name", None),
                           getattr(g, "wires", None), int(g.param))
                          for g in gates]
        self.ia = [np.asarray(g.ia, dtype=np.int64) for g in gates]
        self.ib = [np.asarray(g.ib, dtype=np.int64) for g in gates]
        self.sign = [np.asarray(g.sign, dtype=np.float64) for g in gates]
        self.half = np.array([float(g.half) for g in gates],
                             dtype=np.float64)
        self.param = np.array([int(g.param) for g in gates], dtype=np.int64)
        self.n_real_pairs = np.array([a.size for a in self.ia],
                                     dtype=np.int64)
        self._live = [i for i in range(len(gates)) if self.ia[i].size]
        self._tabs = [tuple(torch.as_tensor(t[i], device=self.device)
                            for t in (self.ia, self.ib))
                      for i in self._live]
        self._sgn = {}
        self._shape = (self.dim,)
        self._init_sweeps(self.half[self._live], self.param[self._live])

    def _signs(self, dtype):
        """Per swept gate: its sign vector in ``dtype``."""
        hit = self._sgn.get(dtype)
        if hit is None:
            hit = self._sgn[dtype] = [
                torch.as_tensor(self.sign[i]).to(device=self.device,
                                                 dtype=dtype)
                for i in self._live]
        return hit

    @staticmethod
    def _sgn_mul(sgn, x):
        return sgn * x

    def _blocks(self, X, gi):
        ia, ib = self._tabs[gi]
        return X.index_select(-1, ia), X.index_select(-1, ib)

    def _put(self, X, gi, da, db, add):
        # ia and ib of one gate are disjoint (a fixed bit flip maps the
        # pattern to its complement), so the two writes never collide
        ia, ib = self._tabs[gi]
        if add:
            return X.index_add(-1, ia, da).index_add(-1, ib, db)
        return X.index_copy(-1, ia, da).index_copy(-1, ib, db)

    def _gate_step(self, X, gi, c, s, sgn):
        """Apply gate ``gi`` with rotation (c, s) to (..., dim) states;
        (c, -s) applies the INVERSE (the rotations are orthogonal)."""
        va, vb = self._blocks(X, gi)
        ss = sgn * s
        return self._put(X, gi, c * va - ss * vb, ss * va + c * vb,
                         add=False)
