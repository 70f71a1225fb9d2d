"""Spin-summed RDMs from a sector statevector on the string grid.

Port of the grid branches of auto_oo_tpu/ops/rdms.py
(``apply_epq_all`` and ``rdms_from_state``):

1. Phi[p,q] = E_pq |psi> for ALL (p,q) at once (ops/grid.phi_all — the
   gather_rows_scaled kernel on both spin halves);
2. gamma = Phi @ psi                                    (one matvec)
3. <E_pq E_rs> = <E_qp psi | E_rs psi> = Phi @ Phi^T    (one matmul)
4. Gamma = that matrix minus the delta_qr gamma_ps contraction term
   (e_pqrs = E_pq E_rs - delta_qr E_ps).

The JAX package's ``gram_last`` / ``small_matmul_free_last`` sliced the
large state axis only to bound the TPU's f64-emulation temporaries; here
they are plain ``torch.matmul``.  States are real (the built-in ansatze
are orthogonal circuits on a real start); the full-space flat maps and
the (14e,14o)-scale streamed route come in later PRs of the port.
"""

import torch

from .grid import GridMaps, _pair_chunk, phi_all, to_grid


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
    gamma = (phi @ psi).reshape(ncas, ncas)
    # corr[(q,p),(r,s)] = <E_qp psi|E_rs psi> = <psi|E_pq E_rs|psi>
    corr = (phi @ phi.T).reshape(ncas, ncas, ncas, ncas)
    delta = torch.eye(ncas, dtype=gamma.dtype, device=gamma.device)
    Gamma = (corr.permute(1, 0, 2, 3)
             - torch.einsum("qr,ps->pqrs", delta, gamma))
    return gamma, Gamma


def rdms_from_state(psi, ncas, maps, grid_order=False):
    """Spin-summed restricted (gamma, Gamma), chemist ordering, of a real
    sector state.  psi arrives in canonical order and is converted once,
    unless ``grid_order`` (the gram and dot are invariant under any
    common permutation of both operands)."""
    _require_grid(maps)
    if not grid_order:
        psi = to_grid(psi, maps)
    if _pair_chunk(1, psi.shape[-1], maps.n2,
                   psi.element_size()) < maps.n2:
        raise NotImplementedError(
            "Phi does not fit one materialized block here; the row-"
            "streamed RDMs (grid.rdms_rows) come with the streamed "
            "phi_rows/_phi_chunk callers in a later PR of the port")
    return rdms_from_gram(apply_epq_all(psi, ncas, maps), psi, ncas)
