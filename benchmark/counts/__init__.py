"""Frozen operation and byte counts of the benchmark's cells.

Copies, as they stand, of the program's counts (so that a later change
to the program cannot move the yardstick it is measured by), and the
count of the gradient-only step, which the program lacks:

* ``grad_hess_flops``, ``update_flops``, ``nr_iteration_flops`` and
  ``armijo_trials``: ``auto_oo_tpu_torch/utils/flops.py``;
* ``two_spin_bytes``: ``auto_oo_tpu_torch/ops/grid_kernels.py``;
* ``scatter_bytes``: ``chip_smoke.py``;
* ``grad_step_flops``: new, by the same conventions.

``pairs_per_apply`` counts the rotated pairs of one application of the
gate fabric on the string grid from the active space alone.
"""

from math import comb

import torch

#: H100 SXM5 80GB datasheet peaks at 700 W: FP64 tensor core, HBM3
FP64_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12
#: FLOPs of a dense symmetric eigendecomposition with eigenvectors per n^3
EIGH_FLOPS_PER_N3 = 9.0


def pairs_per_apply(ncas, n_layers):
    """Rotated pairs of one application of the np_fabric circuit on the
    (C(n, n/2), C(n, n/2)) grid of a half-filled active space: every block
    of every layer, the first layer's idle blocks too (the program applies
    them at angle 0).  A block on orbitals (p, p+1) rotates c = C(n-2,
    n/2-1) strings with p filled and p+1 empty against their partners:
    c^2 pairs of its double excitation and c N pairs on each spin of its
    orbital rotation."""
    nel = ncas // 2
    N = comb(ncas, nel)
    c = comb(ncas - 2, nel - 1)
    blocks = n_layers * (ncas - 1)
    return blocks * (c * c + 2 * c * N)


def grad_hess_flops(ncas, D, nt, nk, nao, ns, pairs):
    """One grad+Hessian call (copy of utils/flops.grad_hess_flops)."""
    n2 = ncas * ncas
    P = pairs
    f = 0.0
    f += 8.0 * P * (1 + 2 * nt)
    ham = 2.0 * n2 * n2 * D + 10.0 * n2 * D
    f += ham * (1 + nt)
    f += 2.0 * nt * D + 2.0 * D
    f += 2.0 * nt * nt * D
    f += 24.0 * P * nt
    f += 4.0 * n2 * D + 2.0 * n2 * n2 * D
    f += 4.0 * n2 * D * nt + 2.0 * nt * n2 * n2 * D + 4.0 * nt * n2 * D
    f += 8.0 * nao ** 5
    f += 2.0 * (ns ** 4) * (nao ** 2)
    f += 2.0 * nt * (ns ** 2) * (nao ** 2)
    return f


def update_flops(ncas, D, nt, nk, nao, ns, pairs, n_trials=1):
    """The eigh solve and ``n_trials`` Armijo trials (copy of
    utils/flops.update_flops, eigh)."""
    n = nt + nk
    solve = EIGH_FLOPS_PER_N3 * n ** 3
    n2 = ncas * ncas
    trial = (40.0 * nao ** 3 + 8.0 * (nao ** 4) * ns
             + 8.0 * pairs
             + 2.0 * n2 * n2 * D + 6.0 * n2 * D)
    return solve + n_trials * trial


def nr_iteration_flops(shapes, n_trials=1):
    """One damped-Newton iteration, grad_hess + update, of the problem
    ``shapes`` = (ncas, D, n_theta, n_kappa, nao, ns, pairs)."""
    return grad_hess_flops(*shapes) + update_flops(*shapes,
                                                   n_trials=n_trials)


def grad_step_flops(shapes):
    """One gradient-only step (``energy_and_gradient`` and the update): the
    state sweep (8 P), H psi (2 n2^2 D + 10 n2 D), the energy (2 D), the
    adjoint sweep (a reverse sweep, ~3x primal: 24 P), Phi = E_pq psi and
    the RDM gram (4 n2 D + 2 n2^2 D), the AO -> MO transform of the
    Hamiltonian's coefficients (8 nao^5), and where orbitals rotate the
    Fock gradient (2 ns^4 nao^2)."""
    ncas, D, nt, nk, nao, ns, pairs = shapes
    n2 = ncas * ncas
    f = 8.0 * pairs + 24.0 * pairs
    f += 2.0 * n2 * n2 * D + 10.0 * n2 * D + 2.0 * D
    f += 4.0 * n2 * D + 2.0 * n2 * n2 * D
    f += 8.0 * nao ** 5
    if nk:
        f += 2.0 * (ns ** 4) * (nao ** 2)
    return f


def armijo_trials(t, beta, lmax=20):
    """The trials a host line search ran to take step t (1, then beta
    times the last; t = 0: all lmax failed)."""
    if t == 0:
        return lmax
    step = 1.0
    for k in range(1, lmax + 1):
        if step == t:
            return k
        step *= beta
    raise ValueError(f"t = {t!r} is no Armijo step of beta = {beta!r}")


def _decode(code):
    return (code & 3).to(torch.int8) - 1, ((code >> 2) & 3).to(torch.int8) - 1


def two_spin_bytes(x_shape, itemsize, tables, r0, r1):
    """Bytes gather_two_spin must move for grid rows [r0, r1) of an x of
    ``x_shape`` (..., Na, Nb) with its compact ``tables`` (srcA, codeA,
    srcB, codeB): Phi written once, each row of x it reads read once, the
    tables read once (copy of grid_kernels.two_spin_bytes, the bound)."""
    Na, Nb = x_shape[-2:]
    B = 1
    for d in x_shape[:-2]:
        B *= d
    srcA, codeA, srcB, codeB = tables
    n2, Nbp = srcB.shape
    row = Nb * itemsize
    valid = _decode(codeA[:, r0:r1])[0] != 0
    src = srcA[:, r0:r1][valid].long()
    rows = torch.cat([src, torch.arange(r0, r1, device=src.device)])
    alpha = srcA.element_size() + codeA.element_size()
    beta = srcB.element_size() + codeB.element_size()
    return (B * n2 * (r1 - r0) * row + B * int(torch.unique(rows).numel())
            * row + n2 * ((r1 - r0) * alpha + Nbp * beta))


def scatter_bytes(y_shape, itemsize, src, s, t, r0):
    """Bytes scatter_rows must move for a Y of ``y_shape`` (..., n2, R, Nb)
    holding grid rows [r0, r0 + R): the Y rows of the pairs whose source
    lies in the window once, each acc row such a pair reaches read and
    written once, the tables once (copy of chip_smoke.scatter_bytes)."""
    R, Nb = y_shape[-2:]
    B = 1
    for d in y_shape[:-3]:
        B *= d
    hit = (s != 0) & (src >= r0) & (src < r0 + R)
    rows = int(hit.any(0).sum())
    tables = sum(v.numel() * v.element_size() for v in (src, s, t))
    return B * (int(hit.sum()) + 2 * rows) * Nb * itemsize + tables
