"""Integral transforms and active-space reduction.

Port of auto_oo_tpu/ops/transforms.py (reference oo_energy.py:21-51 and
utils/active_space.py:111-212).  Every function also takes a stack of
problems with leading batch dims (one per geometry of a batch, or per
line-search trial), which replaces the JAX package's vmap; the index
sets (occ, act) are shared by the stack.
"""

import torch

from ..utils.misc import index_tensor


def int1e_transform(int1e_ao, mo_coeff):
    """C^T h C (reference oo_energy.py:44)."""
    if mo_coeff.dim() > 2:
        return mo_coeff.mT @ int1e_ao @ mo_coeff
    return mo_coeff.T @ int1e_ao @ mo_coeff


def int2e_transform(int2e_ao, mo_coeff):
    """Uniform 4-index transform of the chemist-ordered ERI tensor as four
    chained one-index transforms (each contracts the leading index and
    cycles the axes)."""
    M = int2e_ao
    if mo_coeff.dim() > 2:
        for _ in range(4):
            M = torch.einsum("...ijkl,...im->...jklm", M, mo_coeff)
        return M
    for _ in range(4):
        M = torch.tensordot(M, mo_coeff, dims=([0], [0]))
    return M


def _take(x, idx_by_axis):
    """x restricted to the index sets of its trailing axes (one device
    index tensor per axis, None keeps an axis whole)."""
    n = len(idx_by_axis)
    for k, idx in enumerate(idx_by_axis):
        if idx is not None:
            x = x.index_select(k - n, idx)
    return x


def active_space_integrals(one_body, two_body, occ_idx, act_idx):
    """Core-constant / effective-1-body / active-2-body reduction
    (chemist ordering; reference utils/active_space.py:111-174)."""
    act = index_tensor(list(act_idx), one_body.device)
    g_act = _take(two_body, (act, act, act, act))
    h_act = _take(one_body, (act, act))
    if len(occ_idx) == 0:
        core = one_body.new_zeros(one_body.shape[:-2])
        return core, h_act, g_act
    occ = index_tensor(list(occ_idx), one_body.device)
    g_oo = _take(two_body, (occ, occ, occ, occ))
    core = (2.0 * torch.diagonal(_take(one_body, (occ, occ)), dim1=-2,
                                 dim2=-1).sum(-1)
            + 2.0 * torch.einsum("...iijj->...", g_oo)
            - torch.einsum("...ijji->...", g_oo))
    h_eff = (h_act
             + 2.0 * torch.einsum("...pqii->...pq",
                                  _take(two_body, (act, act, occ, occ)))
             - torch.einsum("...piiq->...pq",
                            _take(two_body, (act, occ, occ, act))))
    return core, h_eff, g_act


def molecular_hamiltonian_coefficients(nuclear_repulsion, one_body, two_body,
                                       occ_idx=None, act_idx=None):
    """(c0, c1, c2) with c2 = 0.5 * active two-body tensor
    (reference utils/active_space.py:177-212)."""
    if occ_idx is None and act_idx is None:
        c0 = torch.as_tensor(nuclear_repulsion, dtype=one_body.dtype,
                             device=one_body.device)
        return c0, one_body, 0.5 * two_body
    core, h_eff, g_act = active_space_integrals(
        one_body, two_body, occ_idx, act_idx)
    return core + nuclear_repulsion, h_eff, 0.5 * g_act


def energy_from_rdms(c0, c1, c2, one_rdm, two_rdm):
    """E = c0 + sum c1*gamma + sum c2*Gamma (reference oo_energy.py:178);
    one energy per problem of a stack."""
    if one_rdm.dim() > 2:
        return (c0 + torch.sum(c1 * one_rdm, dim=(-2, -1))
                + torch.sum(c2 * two_rdm, dim=(-4, -3, -2, -1)))
    return c0 + torch.sum(c1 * one_rdm) + torch.sum(c2 * two_rdm)
