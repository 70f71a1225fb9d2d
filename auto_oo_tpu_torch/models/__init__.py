from ..simulator.circuit import Parameterized_circuit
from .oo_energy import OO_energy, mo_ao_to_mo_oao
from .oo_pqc import OO_pqc
from .noisy_oo_pqc import Noisy_OO_pqc
from .berry import BerryPhaseLoop
from ..ops import rdms as _rdms


def s2(ncas, nelecas=None, device=None):
    """Dense S^2 over the 2^(2 ncas) space (reference
    utils/active_space.py:243-248; the operator does not depend on
    nelecas, accepted for signature parity)."""
    return _rdms.s2_matrix(ncas, device)


def sz(ncas, device=None):
    """Dense S_z (reference utils/active_space.py:250-253)."""
    return _rdms.sz_matrix(ncas, device)


def fermionic_cas_hamiltonian(c0, c1, c2, restricted=True,
                              up_then_down=False):
    """Active-space Hamiltonian H = c0 + sum c1 E_pq + sum c2 e_pqrs as a
    scipy sparse matrix over the 2^(2 ncas) space (reference
    utils/active_space.py:215-240 returned an OpenFermion operator; here
    the matrix in the simulator basis).  Restricted, interleaved spins
    only, as in the JAX package."""
    if not restricted or up_then_down:
        raise NotImplementedError(
            "only restricted, interleaved-spin Hamiltonians supported")
    from ..moldata import fci as _fci
    from ..utils.misc import to_numpy

    c1 = to_numpy(c1)
    return _fci.build_cas_hamiltonian(float(to_numpy(c0)), c1,
                                      to_numpy(c2), c1.shape[0])


__all__ = ["Parameterized_circuit", "OO_energy", "OO_pqc", "Noisy_OO_pqc",
           "mo_ao_to_mo_oao", "s2", "sz", "fermionic_cas_hamiltonian",
           "BerryPhaseLoop"]
