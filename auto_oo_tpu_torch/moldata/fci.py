"""Determinant-basis FCI / CASCI solver (host side, numpy/scipy).

Provides the reference-solver capability the reference package obtained from
``pyscf.fci`` / ``mcscf`` (reference moldata_pyscf.py:63-105):
exact diagonalization of the (active-space) Hamiltonian in a fixed
(n_alpha, n_beta) sector, with optional singlet selection mirroring
``fci.addons.fix_spin_`` (ss=0), plus 1-/2-RDM extraction for CASSCF.
"""

import numpy as np
from scipy import sparse
from scipy.sparse.linalg import eigsh

from ..ops import fermion


def active_space_integrals_np(h1, g2, occ_idx, act_idx):
    """Numpy twin of the in-device active-space reduction
    (reference utils/active_space.py:111-174): returns (core constant,
    effective 1-body over active, active 2-body block), chemist ordering."""
    occ = np.asarray(occ_idx, dtype=int)
    act = np.asarray(act_idx, dtype=int)
    core = (2.0 * np.sum(h1[occ, occ])
            + 2.0 * np.einsum("iijj->", g2[np.ix_(occ, occ, occ, occ)])
            - np.einsum("ijji->", g2[np.ix_(occ, occ, occ, occ)]))
    h_eff = (h1[np.ix_(act, act)]
             + 2.0 * np.einsum("pqii->pq", g2[np.ix_(act, act, occ, occ)])
             - np.einsum("piiq->pq", g2[np.ix_(act, occ, occ, act)]))
    g_act = g2[np.ix_(act, act, act, act)]
    return core, h_eff, g_act


def build_cas_hamiltonian(c0, c1, c2, ncas):
    """Sparse CAS Hamiltonian H = c0 + sum c1 E_pq + sum c2 e_pqrs over the
    full 2^(2 ncas) space, built with grouped sparse products:
    sum_pqrs c2 E_pq E_rs = sum_pq E_pq (sum_rs c2[p,q,r,s] E_rs)."""
    D = 1 << (2 * ncas)
    epq = [[fermion.epq_sparse(p, q, ncas) for q in range(ncas)]
           for p in range(ncas)]
    H = sparse.identity(D, format="csr") * c0
    # effective one-body including the -delta_qr E_ps contraction term
    c1_eff = c1 - np.einsum("ptts->ps", c2)
    for p in range(ncas):
        for q in range(ncas):
            if c1_eff[p, q] != 0.0:
                H = H + c1_eff[p, q] * epq[p][q]
    for p in range(ncas):
        for q in range(ncas):
            S_pq = None
            for r in range(ncas):
                for s in range(ncas):
                    w = c2[p, q, r, s]
                    if w == 0.0:
                        continue
                    S_pq = w * epq[r][s] if S_pq is None else S_pq + w * epq[r][s]
            if S_pq is not None:
                H = H + epq[p][q] @ S_pq
    return H.tocsr()


class CASResult:
    """Eigen-solution of a CAS problem. Vectors live in the full
    2^(2 ncas)-dim space (statevector layout) for direct comparison with
    the circuit simulator."""

    def __init__(self, e_tot, vecs_full, s2_expect, ncas, nelecas):
        self.e_tot = e_tot
        self.vecs_full = vecs_full
        self.s2 = s2_expect
        self.ncas = ncas
        self.nelecas = nelecas


def solve_cas(c0, c1, c2, ncas, nelecas, n_roots=1, fix_singlet=True,
              dense_cutoff=4097):
    """Diagonalize the CAS Hamiltonian in the particle-number sector.

    Returns a CASResult with `n_roots` states (singlets only when
    fix_singlet), sorted by energy."""
    basis = fermion.sector_basis(ncas, nelecas)
    H = build_cas_hamiltonian(c0, c1, c2, ncas)
    Hs = fermion.project_sector(H, basis).toarray() if len(basis) < dense_cutoff \
        else fermion.project_sector(H, basis)
    s2_full = fermion.s2_sparse(ncas)
    s2s = fermion.project_sector(s2_full, basis)

    want = n_roots + (6 if fix_singlet else 0)
    if sparse.issparse(Hs):
        k = min(want + 4, Hs.shape[0] - 2)
        w, v = eigsh(Hs, k=k, which="SA")
        order = np.argsort(w)
        w, v = w[order], v[:, order]
    else:
        w, v = np.linalg.eigh(Hs)

    energies, vecs, s2list = [], [], []
    for i in range(len(w)):
        s2_val = float(v[:, i] @ (s2s @ v[:, i]))
        if fix_singlet and s2_val > 1e-6:
            continue
        energies.append(float(w[i]))
        vecs.append(v[:, i])
        s2list.append(s2_val)
        if len(energies) == n_roots:
            break
    if len(energies) < n_roots:
        raise RuntimeError(
            f"solve_cas found only {len(energies)} "
            f"{'singlet ' if fix_singlet else ''}roots of the {n_roots} "
            f"requested (sector dim {len(basis)}); state-averaged results "
            "would silently mis-average")
    D = 1 << (2 * ncas)
    full = np.zeros((len(vecs), D))
    for i, vec in enumerate(vecs):
        full[i, basis] = vec
    return CASResult(np.array(energies), full, np.array(s2list),
                     ncas, nelecas)


def rdms_from_vec(vec_full, ncas):
    """Spin-summed active-space 1-/2-RDMs from a full-space vector:
    gamma_pq = <E_pq>, Gamma_pqrs = <e_pqrs> (chemist order), via the
    Phi = E_rs |psi> intermediate (the same formulation the TPU kernel in
    ops/rdms.py uses)."""
    src, sign = fermion.epq_gather(ncas)
    phi = np.einsum("pqsd,pqsd->pqd", sign, vec_full[src])
    gamma = phi @ vec_full
    # <E_pq E_rs> = <E_qp psi | E_rs psi>
    corr = np.einsum("qpd,rsd->pqrs", phi, phi)
    delta = np.eye(ncas)
    Gamma = corr - np.einsum("qr,ps->pqrs", delta, gamma)
    return gamma, Gamma
