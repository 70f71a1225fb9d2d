from .moldata import Moldata, Moldata_pyscf, ao_to_oao
from .mole import Mole
from .scf import RHF
from .casscf import CASSCF

__all__ = ["Moldata", "Moldata_pyscf", "ao_to_oao", "Mole", "RHF", "CASSCF"]
