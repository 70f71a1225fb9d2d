"""Spin-summed RDMs from a sector statevector on the string grid.

Port of the grid branches of auto_oo_tpu/ops/rdms.py
(``apply_epq_all`` and ``rdms_from_state``):

1. Phi[p,q] = E_pq |psi> for ALL (p,q) at once (ops/grid.phi_all — the
   gather_two_spin kernel, both spin halves in one launch);
2. gamma = Phi @ psi                                    (one matvec)
3. <E_pq E_rs> = <E_qp psi | E_rs psi> = Phi @ Phi^T    (one matmul)
4. Gamma = that matrix minus the delta_qr gamma_ps contraction term
   (e_pqrs = E_pq E_rs - delta_qr E_ps).

The JAX package's ``gram_last`` / ``small_matmul_free_last`` sliced the
large state axis only to bound the TPU's f64-emulation temporaries; here
they are plain ``torch.matmul``.  States are real (the built-in ansatze
are orthogonal circuits on a real start); the full-space flat maps come
in a later PR of the port.
"""

from .grid import (GridMaps, _pair_chunk, assemble_rdms, phi_all,
                   rdms_rows, stream_plan, to_grid)


def _require_grid(maps):
    if not isinstance(maps, GridMaps):
        raise NotImplementedError(
            "the port runs the sector string grid only; the full-space "
            "flat E_pq maps come in a later PR")


def apply_epq_all(psi, ncas, maps):
    """Phi[..., p*ncas+q, :] = E_pq |psi> for all pairs, shape
    (..., ncas^2, D); psi and the result are GRID-ordered."""
    _require_grid(maps)
    return phi_all(psi, maps)


def rdms_from_gram(phi, psi, ncas):
    """(gamma, Gamma) from Phi = E_pq psi and psi (one order for both)."""
    # corr[(q,p),(r,s)] = <E_qp psi|E_rs psi> = <psi|E_pq E_rs|psi>
    return assemble_rdms(phi @ psi, phi @ phi.T, ncas)


def rdms_from_state(psi, ncas, maps, grid_order=False, plan=None):
    """Spin-summed restricted (gamma, Gamma), chemist ordering, of a real
    sector state.  psi arrives in canonical order and is converted once,
    unless ``grid_order`` (the gram and dot are invariant under any
    common permutation of both operands).  Given a ``plan`` (a
    grid.StreamPlan), or where one (n^2, D) Phi does not fit its block,
    Phi streams over grid A-rows (grid.rdms_rows) in chunks of
    ``plan.row_chunk`` rows (default grid.stream_plan)."""
    _require_grid(maps)
    if not grid_order:
        psi = to_grid(psi, maps)
    if plan is not None or _pair_chunk(1, psi.shape[-1], maps.n2,
                                       psi.element_size()) < maps.n2:
        plan = plan or stream_plan(maps, 1, psi.element_size())
        return rdms_rows(psi, maps, ncas, plan.row_chunk)
    return rdms_from_gram(apply_epq_all(psi, ncas, maps), psi, ncas)
