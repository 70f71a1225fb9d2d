from ..simulator.circuit import Parameterized_circuit
from .oo_energy import OO_energy, mo_ao_to_mo_oao
from .oo_pqc import OO_pqc

__all__ = ["Parameterized_circuit", "OO_energy", "OO_pqc",
           "mo_ao_to_mo_oao"]
