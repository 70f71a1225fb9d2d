"""Two-step CASSCF reference solver (host side, numpy).

Replaces the ``pyscf.mcscf.CASSCF`` oracle the reference tests rely on
(reference moldata_pyscf.py:87-105, test_oo_pqc.py:160-185).
Alternates FCI in the active space with damped-Newton orbital rotations using
the closed-form generalized-Fock gradient/Hessian.  Serves as the
independent host-side check for the TPU-side OO machinery in
auto_oo_tpu.models (which is implemented separately in JAX).
"""

import numpy as np
from scipy.linalg import expm

from . import fci as _fci


def _fock_core(h1, g2, occ):
    if len(occ) == 0:
        return h1.copy()
    return (h1 + 2.0 * np.einsum("mnii->mn", g2[:, :, occ][:, :, :, occ])
            - np.einsum("miin->mn", g2[:, occ][:, :, occ, :]))


def _fock_active(g2, gamma, act):
    g_tilde = (g2[:, :, act][:, :, :, act]
               - 0.5 * np.transpose(g2[:, :, act, :][:, act, :, :],
                                    (0, 3, 2, 1)))
    return np.einsum("vw,mnvw->mn", gamma, g_tilde)


def _fock_generalized(h1, g2, gamma, Gamma, occ, act):
    fc = _fock_core(h1, g2, occ)
    fa = _fock_active(g2, gamma, act)
    F = np.zeros_like(h1)
    F[occ, :] = 2.0 * (fc[:, occ] + fa[:, occ]).T
    g_act3 = g2[:, :, :, act][:, :, act, :][:, act, :, :]
    F[act, :] = (np.einsum("nw,vw->vn", fc[:, act], gamma)
                 + np.einsum("vwxy,nwxy->vn", Gamma, g_act3))
    return F


def _full_rdms(gamma, Gamma, occ, act, nao):
    one = np.zeros((nao, nao))
    one[occ, occ] = 2.0
    one[np.ix_(act, act)] = gamma
    two = np.zeros((nao,) * 4)
    no = len(occ)
    if no:
        eye = np.eye(no)
        two[np.ix_(occ, occ, occ, occ)] = (
            4.0 * np.einsum("ij,kl->ijkl", eye, eye)
            - 2.0 * np.einsum("il,jk->ijkl", eye, eye))
        two[np.ix_(occ, occ, act, act)] = 2.0 * np.einsum(
            "wv,ij->ijwv", gamma, eye)
        two[np.ix_(act, act, occ, occ)] = 2.0 * np.einsum(
            "wv,ij->wvij", gamma, eye)
        two[np.ix_(occ, act, act, occ)] = -np.einsum("wv,ij->iwvj", gamma, eye)
        two[np.ix_(act, occ, occ, act)] = -np.einsum("wv,ij->vjiw", gamma, eye)
    two[np.ix_(act, act, act, act)] = Gamma
    return one, two


def orbital_gradient_hessian(h1, g2, gamma, Gamma, occ, act):
    """Full-space analytic orbital gradient 2(F - F^T) and Hessian.

    Blocked Y evaluation (as in auto_oo_tpu.ops.fock): the full-space RDMs
    vanish unless every index is in occ+act, so the Y contraction is
    O(ns^4 nao^2) instead of O(nao^6)."""
    nao = h1.shape[0]
    F = _fock_generalized(h1, g2, gamma, Gamma, occ, act)
    grad = 2.0 * (F - F.T)
    sub = np.concatenate([np.asarray(occ, dtype=int),
                          np.asarray(act, dtype=int)])
    ns = len(sub)
    no = len(occ)
    one_sub, two_sub = _full_rdms(gamma, Gamma, np.arange(no),
                                  np.arange(no, ns), ns)
    g_qmns = g2[:, sub][:, :, sub, :]
    g_qsmn = g2[:, :, sub][:, :, :, sub]
    y0 = np.einsum("pmrn,qmns->pqrs", two_sub, g_qmns, optimize=True)
    y1 = np.einsum("pmnr,qmns->pqrs", two_sub, g_qmns, optimize=True)
    y2 = np.einsum("prmn,qsmn->pqrs", two_sub, g_qsmn, optimize=True)
    h0_sub = (2.0 * np.einsum("pr,qs->pqrs", one_sub, h1)
              + 2.0 * (y0 + y1 + y2))
    h0 = np.zeros((nao,) * 4)
    all_i = np.arange(nao)
    h0[np.ix_(sub, all_i, sub, all_i)] = h0_sub
    Fs = F + F.T
    h0 -= np.einsum("pr,qs->pqrs", Fs, np.eye(nao))
    hess = (h0 - h0.transpose(0, 1, 3, 2) - h0.transpose(1, 0, 2, 3)
            + h0.transpose(1, 0, 3, 2))
    return grad, hess


def transform_integrals(h1_ao, g2_ao, C):
    h1 = C.T @ h1_ao @ C
    g2 = np.einsum("pi,pqrs->iqrs", C, g2_ao, optimize=True)
    g2 = np.einsum("qj,iqrs->ijrs", C, g2, optimize=True)
    g2 = np.einsum("rk,ijrs->ijks", C, g2, optimize=True)
    g2 = np.einsum("sl,ijks->ijkl", C, g2, optimize=True)
    return h1, g2


def nonredundant_pairs(occ, act, virt, freeze_active=False):
    """Lower-triangle (row > col) index pairs of non-redundant rotations."""
    nao = len(occ) + len(act) + len(virt)
    occ_s, act_s, virt_s = set(occ), set(act), set(virt)
    pairs = []
    for li, ri in zip(*np.tril_indices(nao, -1)):
        if li in occ_s and ri in occ_s:
            continue
        if li in virt_s and ri in virt_s:
            continue
        if freeze_active and li in act_s and ri in act_s:
            continue
        pairs.append((li, ri))
    return np.array(pairs, dtype=int)


class CASSCF:
    """Two-step CASSCF: FCI in the active space + damped NR orbital steps.

    After run(): e_tot, mo_coeff, converged, mo_energy(None)."""

    def __init__(self, mol, hf, ncas, nelecas, fix_singlet=True,
                 conv_tol=1e-11, max_cycle=200):
        self.mol = mol
        self.hf = hf
        self.ncas = ncas
        self.nelecas = nelecas
        self.fix_singlet = fix_singlet
        self.conv_tol = conv_tol
        self.max_cycle = max_cycle
        self.e_tot = None
        self.e_states = None  # per-root energies at the final orbitals (SA)
        self.mo_coeff = None
        self.converged = False
        self.weights = None  # state-average weights (None = ground state)

    def _active_idx(self):
        ne_act = (sum(self.nelecas)
                  if isinstance(self.nelecas, (tuple, list))
                  else self.nelecas)
        ncore = (self.mol.nelectron - ne_act) // 2
        occ = np.arange(ncore)
        act = ncore + np.arange(self.ncas)
        virt = np.arange(ncore + self.ncas, self.mol.nao)
        return occ, act, virt

    def run(self):
        mol = self.mol
        h1_ao = mol.intor("int1e_kin") + mol.intor("int1e_nuc")
        g2_ao = mol.intor("int2e")
        enuc = mol.get_enuc()
        C = self.hf.mo_coeff.copy()
        occ, act, virt = self._active_idx()
        pairs = nonredundant_pairs(occ, act, virt, freeze_active=False)
        e_old = np.inf
        n_roots = 1 if self.weights is None else len(self.weights)

        C_prev = C.copy()
        max_step = 0.5
        for it in range(self.max_cycle):
            h1, g2 = transform_integrals(h1_ao, g2_ao, C)
            core, h_eff, g_act = _fci.active_space_integrals_np(
                h1, g2, occ, act)
            res = _fci.solve_cas(core + enuc, h_eff, 0.5 * g_act, self.ncas,
                                 self.nelecas, n_roots=n_roots,
                                 fix_singlet=self.fix_singlet)
            if self.weights is None:
                e_tot = res.e_tot[0]
                gamma, Gamma = _fci.rdms_from_vec(res.vecs_full[0], self.ncas)
            else:
                e_tot = float(np.dot(self.weights, res.e_tot))
                gamma = np.zeros((self.ncas, self.ncas))
                Gamma = np.zeros((self.ncas,) * 4)
                for w, vec in zip(self.weights, res.vecs_full):
                    g1, g2r = _fci.rdms_from_vec(vec, self.ncas)
                    gamma += w * g1
                    Gamma += w * g2r
            self._last_fci = res

            # trust-region backoff: a step that RAISED the (FCI-resolved)
            # energy is rejected — retry from the previous orbitals with a
            # halved step cap; a successful step slowly re-expands it
            if e_tot > e_old + 1e-12 and max_step > 1e-4:
                C = C_prev.copy()
                max_step *= 0.5
                continue
            max_step = min(0.5, max_step * 1.5)

            grad4, hess4 = orbital_gradient_hessian(
                h1, g2, gamma, Gamma, occ, act)
            pi, pj = pairs[:, 0], pairs[:, 1]
            g_vec = grad4[pi, pj]
            H_mat = hess4[pi[:, None], pj[:, None], pi[None, :], pj[None, :]]
            if np.max(np.abs(g_vec)) < 1e-9 and abs(e_tot - e_old) < self.conv_tol:
                self.converged = True
                e_old = e_tot
                break
            # augmented Newton step
            w, V = np.linalg.eigh(H_mat)
            if w[0] < 1e-6:
                H_mat = H_mat + (1e-6 + 1.1 * abs(w[0])) * np.eye(len(pairs))
                w, V = np.linalg.eigh(H_mat)
            step = -V @ ((V.T @ g_vec) / w)
            # step-size damping (cap adapted by the trust region above)
            nrm = np.max(np.abs(step))
            if nrm > max_step:
                step = step * (max_step / nrm)
            kappa = np.zeros_like(h1)
            for (i, j), s in zip(pairs, step):
                kappa[i, j] = s
                kappa[j, i] = -s
            C_prev = C.copy()
            C = C @ expm(-kappa)
            e_old = e_tot
        self.e_tot = float(e_old)
        self.e_states = [float(e) for e in
                         np.atleast_1d(self._last_fci.e_tot)[:n_roots]]
        self.mo_coeff = C
        return self
