"""Molecule container: geometry + basis -> AO integrals.

Owns the capability the reference obtained from ``pyscf.gto.Mole``
(reference moldata_pyscf.py:28-35): builds the AO overlap,
core-Hamiltonian (kinetic + nuclear attraction) and chemist-ordered
two-electron integral tensors for a molecule, entirely in-repo.
"""

import numpy as np

from .geometry import CHARGES, nuclear_repulsion, parse_geometry
from .basis import build_shells
from . import integrals as _ints


class Mole:
    """Host-side molecule: integrals are numpy arrays, computed lazily."""

    def __init__(self, atom, basis="sto-3g", unit="angstrom", charge=0,
                 spin=None):
        self.symbols, self.coords = parse_geometry(atom, unit=unit)
        self.charges = np.array([CHARGES[s] for s in self.symbols])
        self.charge = charge
        self.nelectron = int(self.charges.sum()) - charge
        # spin = n_alpha - n_beta (pyscf convention); defaults to the
        # lowest multiplicity compatible with the electron count
        self.spin = int(self.nelectron % 2 if spin is None else spin)
        if (self.spin < 0 or (self.nelectron + self.spin) % 2
                or self.spin > self.nelectron):
            raise ValueError(
                f"spin={self.spin} incompatible with "
                f"{self.nelectron} electrons (need 0 <= spin = "
                f"n_alpha - n_beta <= nelectron, same parity)")
        self.basis = basis
        self.shells = build_shells(self.symbols, self.coords, basis)
        self._s = self._t = self._v = self._norms = self._eri = None

    def build(self):
        self._compute_1e()
        return self

    @property
    def nao(self):
        return sum(sh.nsph for sh in self.shells)

    def _compute_1e(self):
        if self._s is None:
            s, t, v, norms = _ints.one_electron_integrals(
                self.shells, self.charges, self.coords)
            self._s, self._t, self._v, self._norms = s, t, v, norms

    def intor(self, name):
        """PySCF-style integral accessor ('int1e_ovlp', 'int1e_kin',
        'int1e_nuc', 'int2e')."""
        if name in ("int1e_ovlp", "int1e_kin", "int1e_nuc"):
            self._compute_1e()
            return {"int1e_ovlp": self._s, "int1e_kin": self._t,
                    "int1e_nuc": self._v}[name]
        if name == "int2e":
            if self._eri is None:
                self._compute_1e()
                self._eri = _ints.eri(self.shells, self._norms)
            return self._eri
        raise ValueError(f"unknown integral {name}")

    @property
    def nelec(self):
        """(n_alpha, n_beta)."""
        na = (self.nelectron + self.spin) // 2
        return na, self.nelectron - na

    def get_enuc(self):
        return nuclear_repulsion(self.charges, self.coords)
