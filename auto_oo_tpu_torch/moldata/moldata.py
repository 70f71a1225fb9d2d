"""Moldata: the host-side molecular data facade.

API mirror of the reference ``Moldata_pyscf``
(reference moldata_pyscf.py:19-105) with identical
attributes (int1e_ao, int2e_ao, overlap, oao_coeff, nuc, nao, hf, fci,
casci, casscf, sa_casscf) and methods (get_active_space_idx, run_rhf,
run_fci, run_casci, run_casscf, run_sa_casscf) — but self-contained: the
integrals and reference solvers are computed by this package's own engine
instead of PySCF.
"""

import numpy as np

from .mole import Mole
from .scf import RHF, ROHF
from .casscf import CASSCF
from . import fci as _fci


def ao_to_oao(ovlp):
    """Orthogonalized atomic orbitals in terms of atomic orbitals: S^{-1/2}
    (reference moldata_pyscf.py:13)."""
    w, v = np.linalg.eigh(ovlp)
    return v @ np.diag(w ** (-0.5)) @ v.T


def _fix(fix_singlet, nelecas):
    """Singlet selection is meaningless in an open-shell (n_a != n_b)
    sector (every state there has S >= |n_a - n_b|/2), so it is
    auto-disabled for tuple active spaces."""
    if (isinstance(nelecas, (tuple, list))
            and nelecas[0] != nelecas[1]):
        return False
    return bool(fix_singlet)


class _FCIResult:
    """Mimics the bits of pyscf's FCI object the reference uses
    (``.e_tot`` after kernel, reference test_moldata_pyscf.py:95-104)."""

    def __init__(self, e_tot, vecs_full, s2):
        self.e_tot = e_tot if len(e_tot) > 1 else float(e_tot[0])
        self.vecs_full = vecs_full
        self.s2 = s2


class Moldata:
    """Host molecular data: geometry, AO integrals, reference solvers."""

    def __init__(self, geometry, basis, **kwargs):
        self.mol = Mole(geometry, basis=basis, **kwargs).build()
        self.basis = basis
        self.int1e_ao = self.mol.intor("int1e_kin") + self.mol.intor(
            "int1e_nuc")
        self.overlap = self.mol.intor("int1e_ovlp")
        self.oao_coeff = ao_to_oao(self.overlap)
        self.nuc = self.mol.get_enuc()
        self.nao = self.overlap.shape[0]
        self.hf = None
        self.fci = None
        self.casci = None
        self.casscf = None
        self.sa_casscf = None
        self._int2e = None

    @property
    def int2e_ao(self):
        if self._int2e is None:
            self._int2e = self.mol.intor("int2e")
        return self._int2e

    def get_active_space_idx(self, ncas, nelecas):
        """occ/act/virt spatial-orbital index partition
        (reference moldata_pyscf.py:42-56).  ``nelecas`` may be an
        (n_alpha, n_beta) tuple (open-shell active space over a
        closed-shell core)."""
        ne_act = (sum(nelecas) if isinstance(nelecas, (tuple, list))
                  else nelecas)
        nelecore = self.mol.nelectron - ne_act
        if nelecore % 2 == 1:
            raise ValueError("odd number of core electrons")
        occ_idx = np.arange(nelecore // 2)
        act_idx = (occ_idx[-1] + 1 + np.arange(ncas)
                   if len(occ_idx) > 0 else np.arange(ncas))
        virt_idx = np.arange(act_idx[-1] + 1, self.mol.nao)
        return occ_idx, act_idx, virt_idx

    def run_rhf(self, verbose=0):
        """RHF for closed shells; ROHF (one spatial-orbital set, singly
        occupied open shell) when the molecule has spin != 0 — mirrors
        what PySCF's scf.RHF does for open-shell moles."""
        if self.hf is None:
            cls = ROHF if self.mol.spin else RHF
            self.hf = cls(self.mol).run()

    def run_fci(self, n_roots=1, fix_singlet=1, verbose=0):
        """Full CI over all orbitals (CAS = full space)."""
        self.run_rhf()
        h1, g2 = self._mo_ints(self.hf.mo_coeff)
        nelec = (self.mol.nelec if self.mol.spin
                 else self.mol.nelectron)
        res = _fci.solve_cas(self.nuc, h1, 0.5 * g2, self.nao,
                             nelec, n_roots=n_roots,
                             fix_singlet=_fix(fix_singlet, nelec))
        self.fci = _FCIResult(res.e_tot, res.vecs_full, res.s2)

    def run_casci(self, ncas, nelecas, n_roots=1, mo=None, fix_singlet=1,
                  verbose=0):
        self.run_rhf()
        C = self.hf.mo_coeff if mo is None else mo
        occ_idx, act_idx, _ = self.get_active_space_idx(ncas, nelecas)
        h1, g2 = self._mo_ints(C)
        core, h_eff, g_act = _fci.active_space_integrals_np(
            h1, g2, occ_idx, act_idx)
        res = _fci.solve_cas(core + self.nuc, h_eff, 0.5 * g_act, ncas,
                             nelecas, n_roots=n_roots,
                             fix_singlet=_fix(fix_singlet, nelecas))
        self.casci = _FCIResult(res.e_tot, res.vecs_full, res.s2)

    def run_casscf(self, ncas, nelecas, fix_singlet=1, verbose=0):
        self.run_rhf()
        solver = CASSCF(self.mol, self.hf, ncas, nelecas,
                        fix_singlet=_fix(fix_singlet, nelecas))
        self.casscf = solver.run()

    def run_sa_casscf(self, ncas, nelecas, fix_singlet=1, verbose=0):
        """State-averaged CASSCF with weights [0.5, 0.5]
        (reference moldata_pyscf.py:96-105)."""
        self.run_rhf()
        solver = CASSCF(self.mol, self.hf, ncas, nelecas,
                        fix_singlet=_fix(fix_singlet, nelecas))
        solver.weights = [0.5, 0.5]
        self.sa_casscf = solver.run()

    def _mo_ints(self, C):
        h1 = C.T @ self.int1e_ao @ C
        g2 = np.einsum("pi,pqrs->iqrs", C, self.int2e_ao, optimize=True)
        g2 = np.einsum("qj,iqrs->ijrs", C, g2, optimize=True)
        g2 = np.einsum("rk,ijrs->ijks", C, g2, optimize=True)
        g2 = np.einsum("sl,ijks->ijkl", C, g2, optimize=True)
        return h1, g2


#: Drop-in alias for code written against the reference's class name.
Moldata_pyscf = Moldata
