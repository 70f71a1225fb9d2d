"""Particle-sector projection of a full-space gate program.

Port of ``sector_basis_and_rank`` and ``project_program`` of
auto_oo_tpu/simulator/sector.py.  Every supported gate conserves
(N_alpha, N_beta), so amplitudes outside the Hartree-Fock sector stay
exactly zero, and projecting a circuit onto the sector is a host-side
reindexing: each gate keeps the pairs with both ends in the sector,
remapped to sector ranks.  ``Parameterized_circuit(..., sector=True)``
projects a prebuilt full-space ``GateProgram`` this way, then factorizes
it onto the string grid (simulator/grid_program.factorize_program).
"""

import numpy as np

from ..ops import fermion
from .gates import PairGate
from .program import GateProgram


def sector_basis_and_rank(ncas, nelecas):
    """(basis, rank): determinant indices of the (n_alpha, n_beta) sector
    (ascending) and the full-space -> sector-rank inverse map (-1 outside
    the sector)."""
    basis = fermion.sector_basis(ncas, nelecas)
    rank = np.full(1 << (2 * ncas), -1, dtype=np.int64)
    rank[basis] = np.arange(len(basis))
    return basis, rank


def project_program(program, ncas, nelecas):
    """GateProgram over the sector basis, on the program's device: each
    gate's pairs restricted to those with both ends in the sector (a gate
    that conserves the sector keeps a pair fully inside or fully outside)
    and remapped to ranks.  Raises ValueError for a gate pair that
    crosses the sector or an initial state outside it.

    Returns (sector_program, basis)."""
    basis, rank = sector_basis_and_rank(ncas, nelecas)
    if program.dim != rank.size:
        raise ValueError(f"program dim {program.dim} is not the full "
                         f"4^{ncas} space")
    gates = []
    for ia, ib, sign, half, param in zip(program.ia, program.ib,
                                         program.sign, program.half,
                                         program.param):
        inside = rank[ia] >= 0
        if np.any(rank[ib[inside]] < 0) or np.any(rank[ib[~inside]] >= 0):
            raise ValueError("gate pair crosses the particle sector")
        gates.append(PairGate(rank[ia[inside]], rank[ib[inside]],
                              sign[inside], half, param))
    init_idx = int(rank[program.init_idx])
    if init_idx < 0:
        raise ValueError("initial state outside the sector")
    return (GateProgram(gates, program.n_params, init_idx, len(basis),
                        device=program.device), basis)
