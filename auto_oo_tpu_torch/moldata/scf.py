"""Restricted / restricted open-shell Hartree-Fock with DIIS (host, numpy).

Provides the reference-solver capability the reference package pulled from
PySCF (``mol.RHF().run()``, reference moldata_pyscf.py:58).
ROHF extends it to charged/open-shell molecules (the reference, via PySCF,
could run those too; its own code only ever exercised closed shells) so
odd-electron active spaces like the formaldimine-cation (3e,3o) doublet —
the BASELINE.json north-star configuration — start from proper
restricted-open orbitals.
"""

import numpy as np


class RHF:
    """Closed-shell SCF.  After ``run()``: e_tot, mo_coeff, mo_energy,
    mo_occ, converged."""

    def __init__(self, mol, conv_tol=1e-11, max_cycle=200, diis_space=8):
        self.mol = mol
        self.conv_tol = conv_tol
        self.max_cycle = max_cycle
        self.diis_space = diis_space
        self.e_tot = None
        self.mo_coeff = None
        self.mo_energy = None
        self.mo_occ = None
        self.converged = False

    def run(self):
        mol = self.mol
        S = mol.intor("int1e_ovlp")
        hcore = mol.intor("int1e_kin") + mol.intor("int1e_nuc")
        g = mol.intor("int2e")
        enuc = mol.get_enuc()
        nocc = mol.nelectron // 2
        if mol.nelectron % 2:
            raise ValueError("RHF requires an even number of electrons")

        # symmetric orthogonalization
        w, v = np.linalg.eigh(S)
        X = v @ np.diag(w ** -0.5) @ v.T

        def fock(D):
            J = np.einsum("pqrs,rs->pq", g, D, optimize=True)
            K = np.einsum("prqs,rs->pq", g, D, optimize=True)
            return hcore + J - 0.5 * K

        def density(F):
            Fp = X.T @ F @ X
            e, cp = np.linalg.eigh(Fp)
            C = X @ cp
            Cocc = C[:, :nocc]
            return 2.0 * Cocc @ Cocc.T, C, e

        D, C, e_mo = density(hcore)
        e_old = 0.0
        errs, focks = [], []
        for cycle in range(self.max_cycle):
            F = fock(D)
            # DIIS extrapolation on the orthonormal-basis error FDS - SDF
            err = X.T @ (F @ D @ S - S @ D @ F) @ X
            errs.append(err)
            focks.append(F)
            if len(errs) > self.diis_space:
                errs.pop(0)
                focks.pop(0)
            if len(errs) > 1:
                n = len(errs)
                B = -np.ones((n + 1, n + 1))
                B[n, n] = 0.0
                for i in range(n):
                    for j in range(n):
                        B[i, j] = np.vdot(errs[i], errs[j])
                rhs = np.zeros(n + 1)
                rhs[n] = -1.0
                try:
                    c = np.linalg.solve(B, rhs)[:n]
                    F = sum(ci * Fi for ci, Fi in zip(c, focks))
                except np.linalg.LinAlgError:
                    pass
            D, C, e_mo = density(F)
            e_elec = 0.5 * np.einsum("pq,pq->", D, hcore + fock(D))
            e_tot = e_elec + enuc
            if abs(e_tot - e_old) < self.conv_tol and cycle > 1:
                self.converged = True
                break
            e_old = e_tot
        self.e_tot = float(e_tot)
        self.mo_coeff = C
        self.mo_energy = e_mo
        self.mo_occ = np.array([2.0] * nocc + [0.0] * (mol.nao - nocc))
        return self


class ROHF:
    """Restricted open-shell SCF (Roothaan effective Fock, DIIS).

    One spatial-orbital set with nb doubly- and (na - nb) singly-occupied
    orbitals — the right starting orbitals for open-shell CASSCF/OO-VQE
    (one mo_coeff matrix, like the closed-shell path).  After ``run()``:
    e_tot, mo_coeff, mo_energy, mo_occ, converged."""

    def __init__(self, mol, conv_tol=1e-11, max_cycle=300, diis_space=8):
        self.mol = mol
        self.conv_tol = conv_tol
        self.max_cycle = max_cycle
        self.diis_space = diis_space
        self.e_tot = None
        self.mo_coeff = None
        self.mo_energy = None
        self.mo_occ = None
        self.converged = False

    def run(self):
        mol = self.mol
        S = mol.intor("int1e_ovlp")
        hcore = mol.intor("int1e_kin") + mol.intor("int1e_nuc")
        g = mol.intor("int2e")
        enuc = mol.get_enuc()
        na, nb = mol.nelec
        nao = mol.nao

        w, v = np.linalg.eigh(S)
        X = v @ np.diag(w ** -0.5) @ v.T

        def coulomb(D):
            return np.einsum("pqrs,rs->pq", g, D, optimize=True)

        def exchange(D):
            return np.einsum("prqs,rs->pq", g, D, optimize=True)

        def effective_fock(C):
            """Roothaan's single effective Fock in the ORTHONORMAL basis:
            closed/open/virtual blocks of (Fa+Fb)/2, with the
            closed-open block from Fb and the open-virtual block from Fa
            (the couplings that zero at convergence)."""
            Ca, Cb = C[:, :na], C[:, :nb]
            Da = Ca @ Ca.T
            Db = Cb @ Cb.T
            Jt = coulomb(Da + Db)
            Ka = exchange(Da)
            Kb = exchange(Db)
            Fa = hcore + Jt - Ka
            Fb = hcore + Jt - Kb
            e_elec = 0.5 * (np.einsum("pq,pq->", Da + Db, hcore)
                            + np.einsum("pq,pq->", Da, Fa)
                            + np.einsum("pq,pq->", Db, Fb))
            # orthonormal-basis block assembly via MO projectors
            Fa_p = X.T @ Fa @ X
            Fb_p = X.T @ Fb @ X
            Fc_p = 0.5 * (Fa_p + Fb_p)
            Cp = np.linalg.solve(X, C)          # orthonormal-basis MOs
            Pc = Cp[:, :nb] @ Cp[:, :nb].T      # closed
            Po = Cp[:, nb:na] @ Cp[:, nb:na].T  # open
            Pv = np.eye(nao) - Pc - Po          # virtual
            R = (Pc @ Fc_p @ Pc + Po @ Fc_p @ Po + Pv @ Fc_p @ Pv
                 + Pc @ Fb_p @ Po + Po @ Fb_p @ Pc
                 + Po @ Fa_p @ Pv + Pv @ Fa_p @ Po
                 + Pc @ Fc_p @ Pv + Pv @ Fc_p @ Pc)
            return R, e_elec + enuc

        # core-Hamiltonian initial guess
        e0, cp = np.linalg.eigh(X.T @ hcore @ X)
        C = X @ cp
        e_old = 0.0
        errs, Rs = [], []
        e_tot = 0.0
        e_mo = e0
        for cycle in range(self.max_cycle):
            R, e_tot = effective_fock(C)
            Cp = np.linalg.solve(X, C)
            Docc = Cp[:, :na] @ Cp[:, :na].T
            err = R @ Docc - Docc @ R
            errs.append(err)
            Rs.append(R)
            if len(errs) > self.diis_space:
                errs.pop(0)
                Rs.pop(0)
            if len(errs) > 1:
                n = len(errs)
                B = -np.ones((n + 1, n + 1))
                B[n, n] = 0.0
                for i in range(n):
                    for j in range(n):
                        B[i, j] = np.vdot(errs[i], errs[j])
                rhs = np.zeros(n + 1)
                rhs[n] = -1.0
                try:
                    c = np.linalg.solve(B, rhs)[:n]
                    R = sum(ci * Ri for ci, Ri in zip(c, Rs))
                except np.linalg.LinAlgError:
                    pass
            e_mo, cp = np.linalg.eigh(R)
            C = X @ cp
            if abs(e_tot - e_old) < self.conv_tol and cycle > 1:
                self.converged = True
                break
            e_old = e_tot
        self.e_tot = float(e_tot)
        self.mo_coeff = C
        self.mo_energy = e_mo
        self.mo_occ = np.array([2.0] * nb + [1.0] * (na - nb)
                               + [0.0] * (nao - na))
        return self
