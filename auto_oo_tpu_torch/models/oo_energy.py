"""OO_energy: the orbital side of the orbital-optimized energy.

Port of the parts of auto_oo_tpu/models/oo_energy.py (reference
oo_energy.py:121-474) that OO_pqc builds on: the molecule's AO integrals
and OAO coefficients as float64 tensors on one device, the OAO->MO
coefficient matrix ``oao_mo_coeff`` (the optimization variable), the
occ/act/virt partition and the non-redundant rotation indices.  Energies
and the closed-form orbital derivatives are in ops/transforms.py and
ops/fock.py.

``orbital_optimization`` (the fixed-RDM orbital loop) comes in a later PR
of the port.
"""

import numpy as np
import torch

from ..config import DTYPE, get_device
from ..ops import kappa as _kappa


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

    @property
    def mo_coeff(self):
        """AO-MO coefficients, derived from oao_mo_coeff
        (reference oo_energy.py:173-176)."""
        return self.oao_coeff @ self.oao_mo_coeff

    def orbital_optimization(self, one_rdm, two_rdm, **kwargs):
        raise NotImplementedError(
            "orbital_optimization comes in a later PR of the port")
