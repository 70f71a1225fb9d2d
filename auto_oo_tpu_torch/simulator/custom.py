"""The sweeps of a callable ansatz, from autodiff over the callable.

A callable ansatz is any theta -> statevector function over the full
4^ncas space, real or complex (the reference's arbitrary-QNode
capability, pqc.py:163; the JAX package's ``Parameterized_circuit(...,
ansatz=fn, theta_shape=n)``).  It has no gate program, so the five
sweeps that ``OO_pqc``'s Newton core asks of a circuit
(simulator/program.py ``_SweepProgram``) come from ``torch.func`` over
the callable, as the JAX core's ``jax.jacfwd`` / ``jax.grad`` over
``pqc._state_impl`` (auto_oo_tpu/models/oo_pqc.py:255-322):

* ``apply``: fn(theta);
* ``apply_with_jacobian``: (psi, J) with J = ``torch.func.jacfwd`` of the
  state; a complex state is differentiated through its real view
  (``torch.view_as_real``), since jacfwd takes real outputs only;
* ``hessian_dot``: the Hessian of Re<w, psi(theta)> = Re sum psi conj(w),
  ``jacfwd(grad(...))``;
* ``apply_pair``: (psi, J v) by ``torch.func.jvp``;
* ``pair_row``: the gradient of Re<a, psi(theta)> + Re<b, J(theta) v>,
  i.e. grad Re<a, psi> plus the Hessian of Re<b, psi> applied to v
  (forward over reverse).

``apply``, ``apply_with_jacobian`` and ``hessian_dot`` also take a stack
of parameter vectors (B, n), one per geometry of a batch or line-search
trial, as the gate programs' sweeps do: the callable runs once per lane
and the results are stacked.

Every inner product conjugates the bra side (a, b, w) and takes the real
part, so a complex state's derivatives are those of the real energy
Re<psi|H|psi>.  A callable that calls the port's own ``GateProgram.apply``
goes through these transforms: the gate step's out-of-place
``index_copy`` / ``index_add`` have batching and forward-mode rules.
"""

import torch


def _dot_re(x, w):
    """Re sum x conj(w) (x, w real or complex)."""
    return (x * w.conj()).real.sum()


def _per_lane(fn, theta, *args):
    """fn(theta, *args) for one theta; for a stack theta (B, n), fn of
    each lane (with the lane's row of every arg) with the outputs stacked
    (a tuple output stacked element by element)."""
    if theta.dim() == 1:
        return fn(theta, *args)
    outs = [fn(theta[b], *(a[b] for a in args))
            for b in range(theta.shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


class CallableSweep:
    """The sweeps of ``OO_pqc``'s core over a callable ``fn`` of a real
    parameter vector, returning a (dim,) state."""

    def __init__(self, fn, dim):
        self.fn = fn
        self.dim = int(dim)

    def apply(self, theta):
        """|psi(theta)> = fn(theta)."""
        return _per_lane(self.fn, theta)

    def _real_view(self, theta):
        psi = self.fn(theta)
        return (torch.view_as_real(psi) if psi.is_complex() else psi), psi

    def apply_with_jacobian(self, theta, params_idx):
        """(psi, J): J[i] = d psi / d theta[params_idx[i]], shape
        (len(params_idx), dim), in psi's dtype."""
        if theta.dim() > 1:
            return _per_lane(lambda t: self.apply_with_jacobian(
                t, params_idx), theta)
        Jr, psi = torch.func.jacfwd(self._real_view, has_aux=True)(theta)
        # (dim, n) real, or (dim, 2, n) for the real view of a complex psi
        J = Jr.movedim(-1, 0)
        if psi.is_complex():
            J = torch.view_as_complex(J.contiguous())
        idx = torch.as_tensor(params_idx, dtype=torch.int64,
                              device=J.device)
        return psi, J.index_select(0, idx)

    def hessian_dot(self, theta, w, psi, J, params_idx):
        """H[i, j] = d^2 Re<w, psi(theta)> / d theta_i d theta_j over the
        tangents ``params_idx`` (psi and J are not needed)."""
        if theta.dim() > 1:
            return _per_lane(lambda t, wl: self.hessian_dot(
                t, wl, None, None, params_idx), theta, w)
        H = torch.func.jacfwd(torch.func.grad(
            lambda t: _dot_re(self.fn(t), w)))(theta)
        idx = torch.as_tensor(params_idx, dtype=torch.int64,
                              device=H.device)
        return H.index_select(0, idx).index_select(1, idx)

    def apply_pair(self, theta, v):
        """(|psi(theta)>, J(theta) v)."""
        return torch.func.jvp(self.fn, (theta,), (v.to(theta.dtype),))

    def pair_row(self, theta, v, a, b, psi=None, delta=None):
        """grad_theta [Re<a, psi(theta)> + Re<b, J(theta) v>] over all
        parameters; the second term (the Hessian of
        Re<b, psi> times v) is skipped where v is zero (one host sync)."""
        row = torch.func.grad(lambda t: _dot_re(self.fn(t), a))(theta)
        if bool(v.any()):
            row = row + torch.func.jvp(
                torch.func.grad(lambda t: _dot_re(self.fn(t), b)),
                (theta,), (v.to(theta.dtype),))[1]
        return row
