"""Closed-form orbital derivatives: generalized Fock matrix, analytic
gradient 2(F - F^T) and analytic orbital Hessian.

Port of auto_oo_tpu/ops/fock.py (reference oo_energy.py:238-402).  The
RDM arguments of the Fock matrix and the gradient may carry leading batch
dims (one RDM pair per circuit tangent in the mixed Hessian block), and
the integrals may too (one set per geometry of a batch); the two sets of
leading dims broadcast, which replaces the JAX package's vmap.  The index
sets are device tensors made once (``utils.misc.index_tensor``).
"""

import numpy as np
import torch

from ..utils.misc import index_tensor


def _dev(ix, like):
    return index_tensor(list(ix), like.device)


def _last4(x, a, b, c, d):
    """x with its trailing four axes permuted as (a, b, c, d)."""
    lead = tuple(range(x.dim() - 4))
    return x.permute(lead + tuple(x.dim() - 4 + k for k in (a, b, c, d)))


def fock_core(int1e_mo, int2e_mo, occ_idx):
    """F^I_mn = h_mn + sum_i (2 g_mnii - g_mi i n)
    (reference oo_energy.py:272-284)."""
    if len(occ_idx) == 0:
        return int1e_mo
    occ = _dev(occ_idx, int1e_mo)
    g_tilde = (2.0 * torch.einsum(
        "...mnii->...mn", int2e_mo.index_select(-2, occ).index_select(-1, occ))
        - torch.einsum("...miin->...mn",
                       int2e_mo.index_select(-3, occ).index_select(-2, occ)))
    return int1e_mo + g_tilde


def fock_active(int2e_mo, one_rdm, act_idx):
    """F^A_mn = sum_vw gamma_vw (g_mnvw - 0.5 g_mwvn)
    (reference oo_energy.py:286-298)."""
    act = _dev(act_idx, int2e_mo)
    g_tilde = (int2e_mo.index_select(-2, act).index_select(-1, act)
               - 0.5 * _last4(int2e_mo.index_select(-2, act).index_select(
                   -3, act), 0, 3, 2, 1))
    return torch.einsum("...vw,...mnvw->...mn", one_rdm, g_tilde)


def fock_generalized(int1e_mo, int2e_mo, one_rdm, two_rdm, occ_idx, act_idx):
    """Generalized Fock matrix (reference oo_energy.py:238-270)."""
    fc = fock_core(int1e_mo, int2e_mo, occ_idx)
    fa = fock_active(int2e_mo, one_rdm, act_idx)
    act = _dev(act_idx, int1e_mo)
    lead = torch.broadcast_shapes(one_rdm.shape[:-2], int1e_mo.shape[:-2])
    F = torch.zeros(lead + int1e_mo.shape[-2:], dtype=int1e_mo.dtype,
                    device=int1e_mo.device)
    if len(occ_idx):
        occ = _dev(occ_idx, int1e_mo)
        F[..., occ, :] = 2.0 * (fc.index_select(-1, occ)
                                + fa.index_select(-1, occ)).transpose(-1, -2)
    g_act3 = (int2e_mo.index_select(-3, act).index_select(-2, act)
              .index_select(-1, act))
    F[..., act, :] = (torch.einsum("...nw,...vw->...vn",
                                   fc.index_select(-1, act), one_rdm)
                      + torch.einsum("...vwxy,...nwxy->...vn", two_rdm,
                                     g_act3))
    return F


def analytic_gradient_from_integrals(int1e_mo, int2e_mo, one_rdm, two_rdm,
                                     occ_idx, act_idx):
    """G = 2 (F - F^T) (reference oo_energy.py:300-309)."""
    F = fock_generalized(int1e_mo, int2e_mo, one_rdm, two_rdm,
                         occ_idx, act_idx)
    return 2.0 * (F - F.transpose(-1, -2))


def _sub_rdms(one_rdm, two_rdm, no):
    """``full_rdms`` over the (no + na) orbitals occ = 0..no-1, act =
    no..: the blocks are slices, so leading batch dims are kept."""
    na = one_rdm.shape[-1]
    ns = no + na
    lead = one_rdm.shape[:-2]
    kw = dict(dtype=one_rdm.dtype, device=one_rdm.device)
    one = torch.zeros(lead + (ns, ns), **kw)
    two = torch.zeros(lead + (ns,) * 4, **kw)
    one[..., no:, no:] = one_rdm
    two[..., no:, no:, no:, no:] = two_rdm
    if no:
        eye = torch.eye(no, **kw)
        one[..., :no, :no] = 2.0 * eye
        two[..., :no, :no, :no, :no] = (
            4.0 * torch.einsum("ij,kl->ijkl", eye, eye)
            - 2.0 * torch.einsum("il,jk->ijkl", eye, eye))
        two[..., :no, :no, no:, no:] = 2.0 * torch.einsum(
            "...wv,ij->...ijwv", one_rdm, eye)
        two[..., no:, no:, :no, :no] = 2.0 * torch.einsum(
            "...wv,ij->...wvij", one_rdm, eye)
        two[..., :no, no:, no:, :no] = -torch.einsum(
            "...wv,ij->...iwvj", one_rdm, eye)
        two[..., no:, :no, :no, no:] = -torch.einsum(
            "...wv,ij->...vjiw", one_rdm, eye)
    return one, two


def full_rdms(one_rdm, two_rdm, occ_idx, act_idx, nao):
    """Promote active-space RDMs to the full orbital space
    (reference oo_energy.py:342-379): ``_sub_rdms`` over occ + act,
    embedded at those orbitals."""
    one, two = _sub_rdms(one_rdm, two_rdm, len(occ_idx))
    sub = _dev(tuple(occ_idx) + tuple(act_idx), one_rdm)
    for k in range(1, 3):
        one = one.new_zeros(one.shape[:-k] + (nao,) + one.shape[
            one.dim() - k + 1:]).index_copy(-k, sub, one)
    for k in range(1, 5):
        two = two.new_zeros(two.shape[:-k] + (nao,) + two.shape[
            two.dim() - k + 1:]).index_copy(-k, sub, two)
    return one, two


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
    nao = int1e_mo.shape[-1]
    sub = tuple(occ_idx) + tuple(act_idx)
    no = len(occ_idx)
    sub_d = _dev(sub, int1e_mo)
    one_sub, two_sub = _sub_rdms(one_rdm, two_rdm, no)
    g_qmns = int2e_mo.index_select(-3, sub_d).index_select(-2, sub_d)
    g_qsmn = int2e_mo.index_select(-2, sub_d).index_select(-1, sub_d)
    y0 = torch.einsum("...pmrn,...qmns->...pqrs", two_sub, g_qmns)
    y1 = torch.einsum("...pmnr,...qmns->...pqrs", two_sub, g_qmns)
    y2 = torch.einsum("...prmn,...qsmn->...pqrs", two_sub, g_qsmn)
    h0_sub = (2.0 * torch.einsum("...pr,...qs->...pqrs", one_sub, int1e_mo)
              + 2.0 * (y0 + y1 + y2))                    # (ns,nao,ns,nao)
    # embed the occ+act rows of axes 0 and 2 into the nao-space tensor
    lead = h0_sub.shape[:-4]
    kw = dict(dtype=h0_sub.dtype, device=h0_sub.device)
    h0 = torch.zeros(lead + (len(sub), nao, nao, nao), **kw).index_copy(
        -2, sub_d, h0_sub)
    h0 = torch.zeros(lead + (nao,) * 4, **kw).index_copy(-4, sub_d, h0)
    F = fock_generalized(int1e_mo, int2e_mo, one_rdm, two_rdm,
                         occ_idx, act_idx)
    Fs = F + F.mT
    h0 = h0 - torch.einsum("...pr,qs->...pqrs", Fs,
                           torch.eye(nao, dtype=F.dtype, device=F.device))
    return (h0 - _last4(h0, 0, 1, 3, 2)
            - _last4(h0, 1, 0, 2, 3)
            + _last4(h0, 1, 0, 3, 2))


def full_hessian_to_matrix(full_hess, params_idx, nao):
    """Project the (nao,nao,nao,nao) Hessian onto non-redundant tril pairs
    (reference oo_energy.py:395-402)."""
    rows, cols = (_dev(ix, full_hess) for ix in np.tril_indices(nao, k=-1))
    part = full_hess[..., rows, cols, :, :][..., rows, cols]
    idx = _dev(params_idx, full_hess)
    return part.index_select(-2, idx).index_select(-1, idx)
