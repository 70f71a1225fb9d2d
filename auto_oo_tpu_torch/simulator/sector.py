"""Particle-sector projection of a full-space gate program.

Port of ``sector_basis_and_rank`` and ``project_program`` of
auto_oo_tpu/simulator/sector.py.  Every supported gate conserves
(N_alpha, N_beta), so amplitudes outside the Hartree-Fock sector stay
exactly zero, and projecting a circuit onto the sector is a host-side
reindexing: each gate keeps the pairs with both ends in the sector,
remapped to sector ranks.  ``Parameterized_circuit(..., sector=True)``
projects a prebuilt full-space ``GateProgram`` this way, then factorizes
it onto the string grid (simulator/grid_program.factorize_program).

``sector_sminus_maps`` / ``s2_expectation_sector`` are the JAX package's
flat cross-sector S^- tables and <S^2> over the sector's canonical
basis: O(ncas * D_target) tables, the reference the string-factorized
grid form (ops/grid.sminus_grid_maps) is held to.
"""

import numpy as np
import torch

from ..config import get_device
from ..ops import fermion
from ..ops.grid import _nelec_split
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


def sector_sminus_maps(ncas, nelecas, device=None):
    """Cross-sector gather maps of S^- = sum_p a^dag_{p,down} a_{p,up} on a
    sector state, (n_a, n_b) -> (n_a - 1, n_b + 1): (src, sign) of shape
    (ncas, D_target), int64 and int8 on ``device``, so that (T_p psi)[i] =
    sign[p, i] * psi[src[p, i]] over the target sector's determinants;
    None where the target sector does not exist (S^- psi = 0)."""
    basis = fermion.sector_basis(ncas, nelecas)
    na, nb = _nelec_split(nelecas)
    if na - 1 < 0 or nb + 1 > ncas:
        return None
    nm = 2 * ncas
    tbasis = fermion.sector_basis(ncas, (na - 1, nb + 1))
    src = np.zeros((ncas, len(tbasis)), dtype=np.int64)
    sign = np.zeros((ncas, len(tbasis)), dtype=np.int8)
    for p in range(ncas):
        P = fermion.mode_of(p, 1, ncas, False)   # p, down (created)
        Q = fermion.mode_of(p, 0, ncas, False)   # p, up (annihilated)
        bitP = 1 << (nm - 1 - P)
        bitQ = 1 << (nm - 1 - Q)
        valid = ((tbasis & bitP) != 0) & ((tbasis & bitQ) == 0)
        source = np.where(valid, tbasis ^ bitP ^ bitQ, basis[0])
        sq = fermion._parity_below(source, Q, nm)
        sp = fermion._parity_below(source ^ bitQ, P, nm)
        pos = np.minimum(np.searchsorted(basis, source), len(basis) - 1)
        valid = valid & (basis[pos] == source)
        src[p] = np.where(valid, pos, 0)
        sign[p] = np.where(valid, sq * sp, 0)
    device = get_device(device)
    return (torch.as_tensor(src, device=device),
            torch.as_tensor(sign, device=device))


def s2_expectation_sector(psi_s, sminus_maps, nelecas):
    """<S^2> of a canonical-order sector state: ||S^- psi||^2 + Sz^2 - Sz
    (S^+ = (S^-)^dagger, Sz = (n_a - n_b) / 2 exact on the sector)."""
    na, nb = _nelec_split(nelecas)
    sz = 0.5 * (na - nb)
    if sminus_maps is None:
        return torch.tensor(sz * sz - sz, dtype=torch.float64)
    src, sign = sminus_maps
    v = (psi_s[src] * sign.to(psi_s.dtype)).sum(0)
    return torch.linalg.vecdot(v, v).real + sz * sz - sz
