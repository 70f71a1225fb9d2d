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

Spin-resolved RDMs of a sector state (``rdms_from_sector_state_
unrestricted``): gamma from the per-spin E_pq components (on the grid
``phi_all(spin=s)``, the gather_rows_scaled kernel; over the flat sector
maps of ``sector_epq_maps`` an element gather), Gamma from one gram per
spin signature of the pair-annihilation vectors W_rs psi = a_r a_s psi,
which leave the sector for (n_a-2, n_b), (n_a, n_b-2) and (n_a-1,
n_b-1): ``sector_pair_annihilation_maps`` builds their (pairs, src,
sign) on the device with ``torch.searchsorted`` over the sector basis,
where the JAX package runs one numpy pass per pair on the host.  The
sector basis convention is interleaved; up-then-down RDMs come from
``fermion.reorder_unrestricted_rdms``.
"""

import numpy as np
import torch

from ..config import get_device
from ..ops import fermion
from ..ops.grid import GridMaps, _nelec_split, phi_all, to_grid, transpose_grid
from ..ops.linalg import gram_last
from ..ops.rdms import FlatMaps
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


def sector_epq_maps(ncas, nelecas, up_then_down=False, device=None):
    """FlatMaps of the E_pq over the sector basis ((2, ncas^2, D_sector)
    int32 ranks and int8 signs): the full-space maps restricted and
    rank-remapped (E_pq conserves the sector), computed directly on the
    basis determinants with searchsorted, no 4^ncas array."""
    basis = fermion.sector_basis(ncas, nelecas)
    nm = 2 * ncas
    n2 = ncas * ncas
    Ds = len(basis)
    src = np.zeros((2, n2, Ds), dtype=np.int32)
    sign = np.zeros((2, n2, Ds), dtype=np.int8)
    idx = np.arange(Ds, dtype=np.int64)
    for s in range(2):
        for p in range(ncas):
            for q in range(ncas):
                P = fermion.mode_of(p, s, ncas, up_then_down)
                Q = fermion.mode_of(q, s, ncas, up_then_down)
                k = p * ncas + q
                if P == Q:
                    src[s, k] = idx
                    sign[s, k] = fermion.occ_bit(basis, P, nm)
                    continue
                bitP = 1 << (nm - 1 - P)
                bitQ = 1 << (nm - 1 - Q)
                valid = ((basis & bitP) != 0) & ((basis & bitQ) == 0)
                source = np.where(valid, basis ^ bitP ^ bitQ, basis[0])
                sq = fermion._parity_below(source, Q, nm)
                sp = fermion._parity_below(source ^ bitQ, P, nm)
                pos = np.searchsorted(basis, source)
                if not np.all(basis[pos[valid]] == source[valid]):
                    raise AssertionError("E_pq left the sector")
                src[s, k] = np.where(valid, pos, 0)
                sign[s, k] = np.where(valid, sq * sp, 0)
    return FlatMaps(src, sign, device=device)


def _parity_below(x, mode, nm):
    """(-1)^{number of occupied modes k < mode} of int64 determinants x
    (< 2^32), as int8 +-1 on x's device: the popcount's parity by
    XOR-folding."""
    if mode == 0:
        return torch.ones_like(x, dtype=torch.int8)
    v = x >> (nm - mode)
    for shift in (16, 8, 4, 2, 1):
        v = v ^ (v >> shift)
    return (1 - 2 * (v & 1)).to(torch.int8)


def sector_pair_annihilation_maps(ncas, nelecas, device=None):
    """Cross-sector gather maps of W_rs = a_r a_s on a sector state.

    W_rs leaves the (n_a, n_b) sector: annihilating two ups lands in
    (n_a-2, n_b), two downs in (n_a, n_b-2), one of each in (n_a-1,
    n_b-1).  For each target group ("uu", "dd", "ud") present, (pairs,
    src, sign): pairs a (k, 2) int64 tensor of the ordered mode pairs
    (r, s) of that spin signature, src (k, D_target) int32 ranks INTO THE
    SOURCE (canonical) BASIS and sign (k, D_target) int8, so that
    (a_r a_s psi)[i] = sign * psi[src] over the target sector's
    determinants; all on ``device``, built there from the sorted sector
    basis by ``torch.searchsorted``.  Interleaved mode ordering (mode 2p =
    spatial p up), the sector basis convention."""
    device = get_device(device)
    basis = torch.as_tensor(fermion.sector_basis(ncas, nelecas),
                            device=device)
    last = basis.numel() - 1
    na, nb = _nelec_split(nelecas)
    nm = 2 * ncas
    ups = [2 * p for p in range(ncas)]
    downs = [2 * p + 1 for p in range(ncas)]
    specs = {
        "uu": ((na - 2, nb),
               [(r, s) for r in ups for s in ups if r != s]),
        "dd": ((na, nb - 2),
               [(r, s) for r in downs for s in downs if r != s]),
        "ud": ((na - 1, nb - 1),
               [(r, s) for r in ups for s in downs]
               + [(r, s) for r in downs for s in ups]),
    }
    groups = {}
    for name, ((ta, tb), pairs) in specs.items():
        if ta < 0 or tb < 0 or ta > ncas or tb > ncas or not pairs:
            continue
        tbasis = torch.as_tensor(fermion.sector_basis(ncas, (ta, tb)),
                                 device=device)
        src = torch.empty((len(pairs), tbasis.numel()), dtype=torch.int32,
                          device=device)
        sign = torch.empty((len(pairs), tbasis.numel()), dtype=torch.int8,
                           device=device)
        for i, (r, s) in enumerate(pairs):
            br = 1 << (nm - 1 - r)
            bs = 1 << (nm - 1 - s)
            det = tbasis | (br | bs)
            valid = ((tbasis & br) == 0) & ((tbasis & bs) == 0)
            sg = (_parity_below(det, s, nm)
                  * _parity_below(det ^ bs, r, nm))
            pos = torch.searchsorted(basis, det).clamp_(max=last)
            valid &= basis[pos] == det
            src[i] = torch.where(valid, pos, 0)
            sign[i] = torch.where(valid, sg, 0)
        groups[name] = (torch.as_tensor(pairs, dtype=torch.int64,
                                        device=device), src, sign)
    return groups


def rdms_from_sector_state_unrestricted(psi_s, epq_maps, pair_maps, ncas):
    """Spin-resolved (unrestricted) RDMs over 2 ncas spin-orbitals of a
    canonical-order sector state (real or complex), float64: gamma_pq =
    <a^dag_p a_q> (same-spin blocks from the per-spin E_pq components;
    the cross-spin blocks are exactly zero on a sector state), Gamma_pqrs
    = <a^dag_p a^dag_q a_r a_s> from the block-diagonal W gram over the
    cross-sector maps (``sector_pair_annihilation_maps``).  ``epq_maps``
    is the circuit's GridMaps (``phi_all(spin=s)``, the gather_rows_scaled
    kernel on the card) or the flat ``sector_epq_maps``.  Equals
    ops/rdms.rdms_from_state_unrestricted on the embedded full-space
    vector."""
    nm = 2 * ncas
    n2 = ncas * ncas
    dev = psi_s.device
    pq = torch.arange(n2, device=dev)
    p, q = pq // ncas, pq % ncas
    gamma = torch.zeros((nm, nm), dtype=torch.float64, device=dev)
    if isinstance(epq_maps, GridMaps):
        psi_g = to_grid(psi_s, epq_maps)
        for s, bra in ((0, psi_g), (1, transpose_grid(psi_g, epq_maps))):
            phi = phi_all(psi_g, epq_maps, spin=s)
            gamma[2 * p + s, 2 * q + s] = gram_last(phi, bra.conj()).real
            del phi
    elif isinstance(epq_maps, FlatMaps):
        for s in range(2):
            phi = (psi_s.index_select(-1, epq_maps.src[s].reshape(-1))
                   .reshape(n2, -1) * epq_maps.sign[s])
            gamma[2 * p + s, 2 * q + s] = gram_last(phi,
                                                    psi_s.conj()).real
    else:
        raise TypeError(f"expected GridMaps or FlatMaps, got "
                        f"{type(epq_maps).__name__}")
    Gamma = torch.zeros((nm,) * 4, dtype=torch.float64, device=dev)
    for pairs, src, sign in pair_maps.values():
        # the sign taken in place: at (14e,14o) W of the (6, 6) sector is
        # 392 x 3003^2 f64, 28.3 GB, and a second one would not fit a card
        W = psi_s.index_select(-1, src.reshape(-1)).reshape(src.shape)
        W.mul_(sign)
        C = gram_last(W.conj(), W).real        # <W_a psi|W_b psi>
        del W
        X, Y = pairs[:, 0], pairs[:, 1]
        # Gamma[p,q,r,s] = C[idx(q,p), idx(r,s)]: row a is W_{qp} with
        # (q, p) = (X[a], Y[a]), column b is W_{rs} = (X[b], Y[b])
        Gamma[Y[:, None], X[:, None], X[None, :], Y[None, :]] = C
    return gamma, Gamma
