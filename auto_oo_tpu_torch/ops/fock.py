"""Closed-form orbital derivatives: generalized Fock matrix, analytic
gradient 2(F - F^T) and analytic orbital Hessian.

Port of auto_oo_tpu/ops/fock.py (reference oo_energy.py:238-402).  The
RDM arguments of the Fock matrix and the gradient may carry leading batch
dims (one RDM pair per circuit tangent in the mixed Hessian block), which
replaces the JAX package's vmap.
"""

import numpy as np
import torch


def _idx(ix):
    return np.asarray(list(ix), dtype=np.int64)


def fock_core(int1e_mo, int2e_mo, occ_idx):
    """F^I_mn = h_mn + sum_i (2 g_mnii - g_mi i n)
    (reference oo_energy.py:272-284)."""
    if len(occ_idx) == 0:
        return int1e_mo
    occ = _idx(occ_idx)
    g_tilde = (2.0 * torch.einsum("mnii->mn",
                                  int2e_mo[:, :, occ][:, :, :, occ])
               - torch.einsum("miin->mn", int2e_mo[:, occ][:, :, occ, :]))
    return int1e_mo + g_tilde


def fock_active(int2e_mo, one_rdm, act_idx):
    """F^A_mn = sum_vw gamma_vw (g_mnvw - 0.5 g_mwvn)
    (reference oo_energy.py:286-298)."""
    act = _idx(act_idx)
    g_tilde = (int2e_mo[:, :, act][:, :, :, act]
               - 0.5 * int2e_mo[:, :, act, :][:, act, :, :].permute(
                   0, 3, 2, 1))
    return torch.einsum("...vw,mnvw->...mn", one_rdm, g_tilde)


def fock_generalized(int1e_mo, int2e_mo, one_rdm, two_rdm, occ_idx, act_idx):
    """Generalized Fock matrix (reference oo_energy.py:238-270)."""
    fc = fock_core(int1e_mo, int2e_mo, occ_idx)
    fa = fock_active(int2e_mo, one_rdm, act_idx)
    occ = _idx(occ_idx)
    act = _idx(act_idx)
    F = torch.zeros(one_rdm.shape[:-2] + int1e_mo.shape,
                    dtype=int1e_mo.dtype, device=int1e_mo.device)
    if len(occ):
        F[..., occ, :] = 2.0 * (fc[:, occ] + fa[..., :, occ]).transpose(
            -1, -2)
    g_act3 = int2e_mo[:, :, :, act][:, :, act, :][:, act, :, :]
    F[..., act, :] = (torch.einsum("nw,...vw->...vn", fc[:, act], one_rdm)
                      + torch.einsum("...vwxy,nwxy->...vn", two_rdm, g_act3))
    return F


def analytic_gradient_from_integrals(int1e_mo, int2e_mo, one_rdm, two_rdm,
                                     occ_idx, act_idx):
    """G = 2 (F - F^T) (reference oo_energy.py:300-309)."""
    F = fock_generalized(int1e_mo, int2e_mo, one_rdm, two_rdm,
                         occ_idx, act_idx)
    return 2.0 * (F - F.transpose(-1, -2))


def full_rdms(one_rdm, two_rdm, occ_idx, act_idx, nao):
    """Promote active-space RDMs to the full orbital space
    (reference oo_energy.py:342-379)."""
    occ = _idx(occ_idx)
    act = _idx(act_idx)
    kw = dict(dtype=one_rdm.dtype, device=one_rdm.device)
    one_full = torch.zeros((nao, nao), **kw)
    two_full = torch.zeros((nao,) * 4, **kw)
    no = len(occ)
    if no:
        one_full[occ, occ] = 2.0
    one_full[np.ix_(act, act)] = one_rdm
    if no:
        eye = torch.eye(no, **kw)
        two_full[np.ix_(occ, occ, occ, occ)] = (
            4.0 * torch.einsum("ij,kl->ijkl", eye, eye)
            - 2.0 * torch.einsum("il,jk->ijkl", eye, eye))
        two_full[np.ix_(occ, occ, act, act)] = 2.0 * torch.einsum(
            "wv,ij->ijwv", one_rdm, eye)
        two_full[np.ix_(act, act, occ, occ)] = 2.0 * torch.einsum(
            "wv,ij->wvij", one_rdm, eye)
        two_full[np.ix_(occ, act, act, occ)] = -torch.einsum(
            "wv,ij->iwvj", one_rdm, eye)
        two_full[np.ix_(act, occ, occ, act)] = -torch.einsum(
            "wv,ij->vjiw", one_rdm, eye)
    two_full[np.ix_(act, act, act, act)] = two_rdm
    return one_full, two_full


def y_matrix(int2e_mo, two_full):
    """Y_pqrs = sum_mn [(G_pmrn + G_pmnr) g_qmns + G_prmn g_qsmn]
    (reference oo_energy.py:381-393).  Dense O(nao^6) form; the Hessian
    below uses the blocked form instead."""
    y0 = torch.einsum("pmrn,qmns->pqrs", two_full, int2e_mo)
    y1 = torch.einsum("pmnr,qmns->pqrs", two_full, int2e_mo)
    y2 = torch.einsum("prmn,qsmn->pqrs", two_full, int2e_mo)
    return y0 + y1 + y2


def analytic_hessian_from_integrals(int1e_mo, int2e_mo, one_rdm, two_rdm,
                                    occ_idx, act_idx):
    """(1-P_pq)(1-P_rs)[2 gamma_pr h_qs - (F_pr+F_rp) delta_qs + 2 Y_pqrs]
    (reference oo_energy.py:311-340), in the blocked form of the JAX
    package: the full-space RDMs vanish unless every index is in occ+act,
    so Y costs O(ns^4 nao^2) instead of O(nao^6)."""
    nao = int1e_mo.shape[0]
    sub = tuple(occ_idx) + tuple(act_idx)
    ns = len(sub)
    no = len(occ_idx)
    sub_a = np.asarray(sub, dtype=np.int64)
    one_sub, two_sub = full_rdms(one_rdm, two_rdm,
                                 tuple(range(no)), tuple(range(no, ns)), ns)
    g_qmns = int2e_mo[:, sub_a][:, :, sub_a, :]          # (nao,ns,ns,nao)
    g_qsmn = int2e_mo[:, :, sub_a][:, :, :, sub_a]       # (nao,nao,ns,ns)
    y0 = torch.einsum("pmrn,qmns->pqrs", two_sub, g_qmns)
    y1 = torch.einsum("pmnr,qmns->pqrs", two_sub, g_qmns)
    y2 = torch.einsum("prmn,qsmn->pqrs", two_sub, g_qsmn)
    h0_sub = (2.0 * torch.einsum("pr,qs->pqrs", one_sub, int1e_mo)
              + 2.0 * (y0 + y1 + y2))                    # (ns,nao,ns,nao)
    all_i = np.arange(nao)
    h0 = torch.zeros((nao,) * 4, dtype=int1e_mo.dtype,
                     device=int1e_mo.device)
    h0[np.ix_(sub_a, all_i, sub_a, all_i)] = h0_sub
    F = fock_generalized(int1e_mo, int2e_mo, one_rdm, two_rdm,
                         occ_idx, act_idx)
    Fs = F + F.T
    h0 = h0 - torch.einsum("pr,qs->pqrs", Fs,
                           torch.eye(nao, dtype=F.dtype, device=F.device))
    return (h0 - h0.permute(0, 1, 3, 2)
            - h0.permute(1, 0, 2, 3)
            + h0.permute(1, 0, 3, 2))


def full_hessian_to_matrix(full_hess, params_idx, nao):
    """Project the (nao,nao,nao,nao) Hessian onto non-redundant tril pairs
    (reference oo_energy.py:395-402)."""
    rows, cols = np.tril_indices(nao, k=-1)
    part = full_hess[rows, cols, :, :][:, rows, cols]
    idx = np.asarray(params_idx, dtype=np.int64)
    return part[np.ix_(idx, idx)]
