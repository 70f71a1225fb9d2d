"""OO_energy: orbital-rotated energy functional with analytic derivatives.

Port of auto_oo_tpu/models/oo_energy.py (reference oo_energy.py:121-474):
the molecule's AO integrals and OAO coefficients as float64 tensors on
one device, the OAO->MO coefficient matrix ``oao_mo_coeff`` (the
optimization variable), the occ/act/virt partition and the non-redundant
rotation indices; energies E = c0 + sum h~ gamma + sum g Gamma after the
AO->MO transforms (ops/transforms.py), kappa rotations through
``expm(-kappa)``, and the closed-form Fock gradient and Hessian
(ops/fock.py).  ``energy_from_kappa`` is differentiable by autograd and
torch.func.

``orbital_optimization`` is the JAX package's fixed-RDM damped-Newton
orbital loop as an eager host loop: one analytic gradient and Hessian per
step, the augmented eigh solve, an Armijo line search with one scalar
sync per trial, and the fold of kappa into ``oao_mo_coeff``.
"""

import numpy as np
import torch

from ..config import DTYPE, get_device
from ..ops import fock as _fock
from ..ops import kappa as _kappa
from ..ops import transforms as _tr
from ..ops.linalg import expm
from ..utils.newton_raphson import damped_newton_step_pure


def mo_ao_to_mo_oao(mo_coeff, overlap):
    """AO-MO -> OAO-MO coefficients: S^{1/2} C (reference
    oo_energy.py:54-60; numpy, host side)."""
    w, v = np.linalg.eigh(np.asarray(overlap))
    s_half = v @ np.diag(w ** 0.5) @ v.T
    return s_half @ np.asarray(mo_coeff)


class OO_energy:
    """Orbital data of an orbital-optimized energy (reference
    oo_energy.py:121), on ``device``."""

    def __init__(self, mol, ncas, nelecas, oao_mo_coeff=None,
                 freeze_active=False, interface=None, device=None):
        self.device = get_device(device)

        def dev(a):
            return torch.as_tensor(a, dtype=DTYPE, device=self.device)

        if oao_mo_coeff is None:
            mol.run_rhf()
            oao_mo_coeff = mo_ao_to_mo_oao(mol.hf.mo_coeff, mol.overlap)
        self.oao_mo_coeff = dev(oao_mo_coeff)
        self.interface = "torch"

        self.int1e_ao = dev(mol.int1e_ao)
        self.int2e_ao = dev(mol.int2e_ao)
        self.overlap = mol.overlap
        self.oao_coeff = dev(mol.oao_coeff)
        self.nuc = float(mol.nuc)
        self.nao = int(mol.nao)
        self.basis = getattr(mol, "basis", None)

        self.ncas = ncas
        self.nelecas = nelecas
        occ, act, virt = mol.get_active_space_idx(ncas, nelecas)
        # the JAX package accepts such a space and its gathers clamp the
        # missing orbitals onto the last one; the port refuses it
        if len(occ) + len(act) > self.nao:
            raise ValueError(
                f"{len(occ)} core + {len(act)} active orbitals exceed the "
                f"{self.nao} orbitals of basis {mol.basis!r}")
        self.occ_idx, self.act_idx, self.virt_idx = occ, act, virt
        self._occ = tuple(int(i) for i in occ)
        self._act = tuple(int(i) for i in act)

        self.freeze_active = freeze_active
        self.params_idx = _kappa.non_redundant_indices(
            occ, act, virt, freeze_active)
        self.n_kappa = len(self.params_idx)
        self._params_idx_dev = torch.as_tensor(
            np.asarray(self.params_idx, dtype=np.int64), device=self.device)
        self._tril_size = self.nao * (self.nao - 1) // 2

    @property
    def mo_coeff(self):
        """AO-MO coefficients, derived from oao_mo_coeff
        (reference oo_energy.py:173-176)."""
        return self.oao_coeff @ self.oao_mo_coeff

    def kappa_vector_to_matrix(self, kappa):
        """Packed non-redundant kappa -> skew-symmetric matrix
        (reference oo_energy.py:213-219)."""
        total = torch.zeros(self._tril_size, dtype=kappa.dtype,
                            device=kappa.device)
        total = total.index_put((self._params_idx_dev,), kappa)
        return _kappa.vector_to_skew_symmetric(total, self.nao)

    def kappa_matrix_to_vector(self, kappa_matrix):
        """Skew-symmetric matrix -> packed non-redundant vector
        (reference oo_energy.py:221-224)."""
        return _kappa.skew_symmetric_to_vector(
            kappa_matrix)[self._params_idx_dev]

    def kappa_to_mo_coeff(self, kappa):
        """expm(-kappa_matrix) (reference oo_energy.py:226-230)."""
        return expm(-self.kappa_vector_to_matrix(kappa))

    def get_transformed_mo(self, mo_coeff, kappa):
        """mo_coeff @ expm(-kappa) (reference oo_energy.py:232-236)."""
        return mo_coeff @ self.kappa_to_mo_coeff(kappa)

    # -- energy -----------------------------------------------------------

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=DTYPE, device=self.device)

    def get_active_integrals(self, mo_coeff):
        """(c0, c1, c2) Hamiltonian coefficients at given MOs
        (reference oo_energy.py:204-211)."""
        mo_coeff = self._tensor(mo_coeff)
        h1 = _tr.int1e_transform(self.int1e_ao, mo_coeff)
        g2 = _tr.int2e_transform(self.int2e_ao, mo_coeff)
        return _tr.molecular_hamiltonian_coefficients(
            self.nuc, h1, g2, self._occ, self._act)

    def energy_from_mo_coeff(self, mo_coeff, one_rdm, two_rdm):
        """E = c0 + sum c1 gamma + sum c2 Gamma (reference
        oo_energy.py:178-197)."""
        c0, c1, c2 = self.get_active_integrals(mo_coeff)
        return _tr.energy_from_rdms(c0, c1, c2, self._tensor(one_rdm),
                                    self._tensor(two_rdm))

    def energy_from_kappa(self, kappa, one_rdm, two_rdm):
        """E(kappa) at fixed RDMs, the autograd entry point (reference
        oo_energy.py:199-202)."""
        mo = self.mo_coeff @ self.kappa_to_mo_coeff(kappa)
        return self.energy_from_mo_coeff(mo, one_rdm, two_rdm)

    # -- analytic derivatives --------------------------------------------

    def fock_core(self, int1e_mo, int2e_mo):
        return _fock.fock_core(int1e_mo, int2e_mo, self._occ)

    def fock_active(self, int2e_mo, one_rdm):
        return _fock.fock_active(int2e_mo, one_rdm, self._act)

    def fock_generalized(self, int1e_mo, int2e_mo, one_rdm, two_rdm):
        return _fock.fock_generalized(int1e_mo, int2e_mo, one_rdm, two_rdm,
                                      self._occ, self._act)

    def analytic_gradient_from_integrals(self, int1e_mo, int2e_mo,
                                         one_rdm, two_rdm):
        return _fock.analytic_gradient_from_integrals(
            int1e_mo, int2e_mo, one_rdm, two_rdm, self._occ, self._act)

    def analytic_hessian_from_integrals(self, int1e_mo, int2e_mo,
                                        one_rdm, two_rdm):
        return _fock.analytic_hessian_from_integrals(
            int1e_mo, int2e_mo, one_rdm, two_rdm, self._occ, self._act)

    def full_rdms(self, one_rdm, two_rdm):
        return _fock.full_rdms(one_rdm, two_rdm, self._occ, self._act,
                               self.nao)

    def y_matrix(self, int2e_mo, two_full):
        return _fock.y_matrix(int2e_mo, two_full)

    def _integrals(self, mo_coeff):
        mo = self.mo_coeff if mo_coeff is None else self._tensor(mo_coeff)
        return (_tr.int1e_transform(self.int1e_ao, mo),
                _tr.int2e_transform(self.int2e_ao, mo))

    def analytic_gradient(self, one_rdm, two_rdm, mo_coeff=None):
        """2(F - F^T) at given RDMs (reference oo_energy.py:404-413)."""
        return self.analytic_gradient_from_integrals(
            *self._integrals(mo_coeff), self._tensor(one_rdm),
            self._tensor(two_rdm))

    def analytic_hessian(self, one_rdm, two_rdm, mo_coeff=None):
        """Full 4-index orbital Hessian (reference oo_energy.py:415-424)."""
        return self.analytic_hessian_from_integrals(
            *self._integrals(mo_coeff), self._tensor(one_rdm),
            self._tensor(two_rdm))

    def full_hessian_to_matrix(self, full_hess):
        """Project onto non-redundant pairs (reference
        oo_energy.py:395-402)."""
        return _fock.full_hessian_to_matrix(full_hess, self.params_idx,
                                            self.nao)

    # -- orbital-only optimization ---------------------------------------

    def _orbital_step(self, oao_mo_coeff, one_rdm, two_rdm, alpha, beta, mu,
                      rho, lambda_min):
        """One damped-Newton orbital step at fixed RDMs (the JAX package's
        ``_orbital_step_fn``): the analytic gradient and Hessian at the
        MOs ``oao_coeff @ oao_mo_coeff``, the augmented solve and Armijo
        search on E(kappa), and the fold of kappa into the OAO
        coefficients.  Returns (new_oao, energy_after, lowest_eig)."""
        mo = self.oao_coeff @ oao_mo_coeff
        h1 = _tr.int1e_transform(self.int1e_ao, mo)
        g2 = _tr.int2e_transform(self.int2e_ao, mo)
        grad4 = self.analytic_gradient_from_integrals(h1, g2, one_rdm,
                                                      two_rdm)
        hess4 = self.analytic_hessian_from_integrals(h1, g2, one_rdm,
                                                     two_rdm)
        grad = self.kappa_matrix_to_vector(grad4)
        hess = self.full_hessian_to_matrix(hess4)

        def objective(kappa_flat):
            mo_k = mo @ expm(-self.kappa_vector_to_matrix(kappa_flat))
            c0, c1, c2 = self.get_active_integrals(mo_k)
            return _tr.energy_from_rdms(c0, c1, c2, one_rdm, two_rdm)

        kappa0 = torch.zeros(self.n_kappa, dtype=mo.dtype, device=mo.device)
        new_kappa, lowest, _, e_after = damped_newton_step_pure(
            objective, kappa0, grad, hess, alpha=alpha, beta=beta, mu=mu,
            rho=rho, lambda_min=lambda_min)
        new_oao = oao_mo_coeff @ expm(-self.kappa_vector_to_matrix(
            new_kappa))
        return new_oao, e_after, lowest

    def orbital_optimization(self, one_rdm, two_rdm, conv_tol=1e-8,
                             max_iterations=100, verbose=0, alpha=1e-4,
                             beta=0.5, mu=1e-6, rho=1.1, lambda_min=1e-6,
                             **kwargs):
        """Damped-Newton orbital optimization at fixed RDMs
        (reference oo_energy.py:426-474).  Returns the energy trajectory;
        updates self.oao_mo_coeff in place (warm-start semantics)."""
        one_rdm = self._tensor(one_rdm)
        two_rdm = self._tensor(two_rdm)
        energy_l = []
        if verbose:
            e0 = float(self.energy_from_mo_coeff(self.mo_coeff, one_rdm,
                                                 two_rdm))
            print(f"Starting energy: {e0:.12f}")
        for n in range(max_iterations):
            new_oao, energy, _ = self._orbital_step(
                self.oao_mo_coeff, one_rdm, two_rdm, alpha, beta, mu, rho,
                lambda_min)
            self.oao_mo_coeff = new_oao
            energy_l.append(float(energy))
            if verbose:
                print(f"iter = {n:03}, energy = {energy_l[-1]:.12f}")
            if n > 1 and abs(energy_l[-1] - energy_l[-2]) < conv_tol:
                if verbose:
                    print("Orbital optimization finished.")
                    print("E_fin =", energy_l[-1])
                break
        return energy_l
