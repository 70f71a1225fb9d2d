"""Active-space Hamiltonian apply: |chi> -> H|chi>.

Port of auto_oo_tpu/ops/hamiltonian.py.  With
H = sum_pq c1_pq E_pq + sum_pqrs c2_pqrs e_pqrs (chemist order):

    Phi[rs]   = E_rs chi                       (ops/rdms.apply_epq_all)
    Y[pq]     = sum_rs C2[(pq),(rs)] Phi[rs]   (one (n^2, n^2) matmul)
    Y[pq]    += c1eff[pq] * chi                (rank-1 broadcast)
    H chi     = sum_pq E_pq Y[pq]              (the E_pq reduction)

where c1eff = c1 - sum_t c2[p,t,t,s] absorbs the -delta_qr E_ps term of
e_pqrs = E_pq E_rs - delta_qr E_ps.  On the string grid (GridMaps) Phi
is the gather_two_spin kernel and the reduction the gather_reduce
kernels; in the full space (FlatMaps) both are element gathers in plain
PyTorch (ops/rdms.py), as the JAX package's flat branch is plain XLA.
The maps carry the mode ordering (``rdms.build_flat_maps(ncas,
up_then_down)``).  chi may be complex: the coefficients are cast to its
dtype, and on the grid each kernel runs on its real and imaginary parts.
"""

import torch

from .grid import _pair_chunk, epq_sum, ham_apply_rows, stream_plan
from .rdms import FlatMaps, _check_maps, apply_epq_all, epq_sum_flat


def c1_effective(c1, c2):
    """Absorb the -delta_qr E_ps contraction of chemist e_pqrs into an
    effective one-body coefficient (reference active_space.py:57-84)."""
    return c1 - torch.einsum("ptts->ps", c2)


def ham_apply(c1eff, c2, chi, ncas, maps, plan=None):
    """H|chi> (without the c0 constant); chi (D,) or (B, D), in the maps'
    order like the result (GRID order for GridMaps).  On the grid, given
    a ``plan`` (a grid.StreamPlan), or where one (B, n^2, D) Phi does not
    fit its block, Phi streams over grid A-rows into pair-blocked Y
    buffers (grid.ham_apply_rows) sized by ``plan`` (default
    grid.stream_plan at this call)."""
    _check_maps(maps)
    flat = isinstance(maps, FlatMaps)
    n2 = ncas * ncas
    batched = chi.dim() == 2
    x = chi if batched else chi[None, :]
    B, D = x.shape
    C2 = c2.reshape(n2, n2).to(x.dtype)
    c1f = c1eff.reshape(n2).to(x.dtype)
    if not flat and (plan is not None
                     or _pair_chunk(B, D, n2, x.element_size()) < n2):
        plan = plan or stream_plan(maps, B, x.element_size())
        out = ham_apply_rows(c1f, C2, x, maps, plan.row_chunk,
                             plan.pair_block)
    else:
        Y = (torch.matmul(C2, apply_epq_all(x, ncas, maps))
             + c1f[None, :, None] * x[:, None])
        out = epq_sum_flat(Y, maps) if flat else epq_sum(Y, maps)
    return out if batched else out[0]


def energy_quadratic(c0, c1, c2, psi, ncas, maps):
    """E = c0 + Re<psi|H|psi> through the apply (equals
    transforms.energy_from_rdms on the RDMs of psi)."""
    return c0 + (psi.conj() @ ham_apply(c1_effective(c1, c2), c2, psi,
                                        ncas, maps)).real
