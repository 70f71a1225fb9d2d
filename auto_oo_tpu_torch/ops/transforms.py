"""Integral transforms and active-space reduction.

Port of auto_oo_tpu/ops/transforms.py (reference oo_energy.py:21-51 and
utils/active_space.py:111-212).
"""

import numpy as np
import torch


def int1e_transform(int1e_ao, mo_coeff):
    """C^T h C (reference oo_energy.py:44)."""
    return mo_coeff.T @ int1e_ao @ mo_coeff


def int2e_transform(int2e_ao, mo_coeff):
    """Uniform 4-index transform of the chemist-ordered ERI tensor as four
    chained one-index transforms (each contracts the leading index and
    cycles the axes)."""
    M = int2e_ao
    for _ in range(4):
        M = torch.tensordot(M, mo_coeff, dims=([0], [0]))
    return M


def active_space_integrals(one_body, two_body, occ_idx, act_idx):
    """Core-constant / effective-1-body / active-2-body reduction
    (chemist ordering; reference utils/active_space.py:111-174)."""
    act = np.asarray(list(act_idx), dtype=np.int64)
    g_act = two_body[np.ix_(act, act, act, act)]
    if len(occ_idx) == 0:
        core = torch.zeros((), dtype=one_body.dtype, device=one_body.device)
        return core, one_body[np.ix_(act, act)], g_act
    occ = np.asarray(list(occ_idx), dtype=np.int64)
    g_oo = two_body[np.ix_(occ, occ, occ, occ)]
    core = (2.0 * one_body[occ, occ].sum()
            + 2.0 * torch.einsum("iijj->", g_oo)
            - torch.einsum("ijji->", g_oo))
    h_eff = (one_body[np.ix_(act, act)]
             + 2.0 * torch.einsum("pqii->pq",
                                  two_body[np.ix_(act, act, occ, occ)])
             - torch.einsum("piiq->pq",
                            two_body[np.ix_(act, occ, occ, act)]))
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
    """E = c0 + sum c1*gamma + sum c2*Gamma (reference oo_energy.py:178)."""
    return c0 + torch.sum(c1 * one_rdm) + torch.sum(c2 * two_rdm)
