"""Ansatz factories: UCC(S)D, GateFabric (np_fabric), k-UpCCD.

Port of auto_oo_tpu/simulator/ansatze.py: excitation enumeration, the HF
state, the GateFabric layout and its redundant parameters, k-UpCCD wire
groups, the gate sign conventions, and the flat ``GateProgram`` builders
(simulator/program.py) of the full-space route.  Sector circuits of the
built-in ansatze are built directly on the string grid instead
(simulator/grid_gates.py); the builders here also take a sector basis
(``dets``), for a sector circuit's flat program.
"""

import numpy as np
import torch

from ..config import DTYPE
from ..ops import fermion
from . import gates as G
from .program import GateProgram

# Sign/order conventions pinned by golden-statevector calibration in the
# JAX package (scripts/calibrate_gates.py): do not change independently.
FD_SIGN = 1.0          # FermionicDoubleExcitation angle sign
FS_SIGN = 1.0          # FermionicSingleExcitation angle sign
DE_SIGN = 1.0          # DoubleExcitation angle sign
OR_SIGN = 1.0          # OrbitalRotation angle sign
OR_STRING = True       # OrbitalRotation includes JW string parity
FABRIC_ORBROT_FIRST = False  # block order: DoubleExcitation then OrbitalRotation


def excitations(electrons, orbitals, delta_sz=0):
    """Spin-conserving single and double excitations of the HF state, in
    the qml.qchem.excitations enumeration order (reference pqc.py:123).

    ``electrons`` may be an (n_alpha, n_beta) tuple for an OPEN-SHELL
    reference determinant (alpha on even modes, beta on odd — matching
    ops/fermion.hf_bitstring)."""
    sz = np.array([0.5 if i % 2 == 0 else -0.5 for i in range(orbitals)])
    if isinstance(electrons, (tuple, list)):
        na, nb = int(electrons[0]), int(electrons[1])
        occ = sorted([2 * i for i in range(na)]
                     + [2 * i + 1 for i in range(nb)])
        virt = [m for m in range(orbitals) if m not in occ]
    else:
        occ = list(range(electrons))
        virt = list(range(electrons, orbitals))
    singles = [[r, p]
               for r in occ
               for p in virt
               if sz[p] - sz[r] == delta_sz]
    doubles = [[s, r, q, p]
               for i, s in enumerate(occ)
               for r in occ[i + 1:]
               for j, q in enumerate(virt)
               for p in virt[j + 1:]
               if (sz[p] + sz[q] - sz[r] - sz[s]) == delta_sz]
    return singles, doubles


def hf_state(electrons, orbitals):
    """Occupation vector of the HF determinant (reference pqc.py:131)."""
    _, vec = fermion.hf_bitstring(orbitals // 2, electrons)
    return vec


def _finalize_program(gate_list, n_params, init_det, nm, dets=None,
                      device=None):
    """Assemble a GateProgram on ``device``.  With ``dets`` (a sorted
    determinant subset, e.g. a particle-sector basis) the gate (ia, ib)
    determinant values are rank-remapped into the subset and the program
    runs on the small vector: sector programs are built this way in
    O(D_sector), never materializing 4^ncas tables."""
    if dets is None:
        return GateProgram(gate_list, n_params, init_det, 1 << nm,
                           device=device)
    dets = np.asarray(dets, dtype=np.int64)
    for g in gate_list:
        ia = np.searchsorted(dets, g.ia)
        ib = np.searchsorted(dets, g.ib)
        ok = ((ia < len(dets)) & (ib < len(dets)))
        assert np.all(ok) and np.all(dets[ia] == g.ia) \
            and np.all(dets[ib] == g.ib), "gate pair leaves the subset"
        g.ia = ia.astype(np.int32)
        g.ib = ib.astype(np.int32)
    init = int(np.searchsorted(dets, init_det))
    assert init < len(dets) and dets[init] == init_det, \
        "initial determinant outside the subset"
    return GateProgram(gate_list, n_params, init, len(dets), device=device)


def uccd_program(ncas, nelecas, add_singles=False, dets=None, device=None):
    """UCC doubles (optionally + singles) ansatz.

    Parameter layout matches qml.UCCSD (reference pqc.py:69-76): with
    singles, theta = [singles..., doubles...]; the circuit applies all
    doubles first, then singles.  Without singles, theta = [doubles...]
    (reference ansatze/uccd.py:105-114)."""
    nm = 2 * ncas
    singles, doubles = excitations(nelecas, nm)
    init_idx, _ = fermion.hf_bitstring(ncas, nelecas)
    ns = len(singles) if add_singles else 0
    gate_list = []
    for i, (s, r, q, p) in enumerate(doubles):
        gate_list.append(G.fermionic_double_pairs(
            p, q, r, s, nm, param=ns + i, half=0.5, sign_flip=FD_SIGN,
            dets=dets))
    if add_singles:
        for j, (r, p) in enumerate(singles):
            gate_list.append(G.fermionic_single_pairs(
                p, r, nm, param=j, half=0.5, sign_flip=FS_SIGN,
                dets=dets))
    return _finalize_program(gate_list, ns + len(doubles), init_idx, nm,
                             dets, device)


def gatefabric_layout(n_qubits):
    """Wire blocks of one GateFabric layer: offset-0 bricks then offset-2
    bricks (n_qubits//2 - 1 blocks per layer)."""
    blocks = [list(range(i, i + 4)) for i in range(0, n_qubits - 3, 4)]
    blocks += [list(range(i, i + 4)) for i in range(2, n_qubits - 3, 4)]
    return blocks


def gatefabric_full_shape(n_layers, n_qubits):
    return (n_layers, n_qubits // 2 - 1, 2)


def gatefabric_redundant_idx(ncas, nelecas):
    """Flat indices of theta entries redundant when starting from HF: the
    first-layer offset-0 bricks acting entirely within the occupied or
    entirely within the virtual qubits (reference pqc.py:144-158, with
    the JAX package's fix that keeps the one brick straddling the
    occupied/virtual boundary).  Open-shell references eliminate
    nothing."""
    if isinstance(nelecas, (tuple, list)):
        if nelecas[0] != nelecas[1]:
            return []
        nelecas = int(nelecas[0]) * 2
    n_qubits = 2 * ncas
    if n_qubits <= 4:
        return []
    candidate = list(range(0, 2 * (nelecas // 4)))
    if ncas % 2 == 0:
        candidate += list(range(2 * ((n_qubits - nelecas) // 4),
                                2 * (n_qubits // 4)))
    redundant = []
    for x in candidate:
        lo = 4 * (x // 2)            # offset-0 brick of flat entry x
        all_occupied = lo + 3 < nelecas
        all_virtual = lo >= nelecas
        if (all_occupied or all_virtual) and x not in redundant:
            redundant.append(x)
    return redundant


def gatefabric_program(ncas, nelecas, n_layers, include_pi=False,
                       dets=None, device=None):
    """GateFabric over the FULL theta of shape (L, n_blocks, 2); parameter
    slot = flat index.  Block gate Q(theta, phi) = DoubleExcitation(theta)
    then OrbitalRotation(phi) (order calibrated against goldens)."""
    nm = 2 * ncas
    if include_pi:
        raise NotImplementedError("include_pi=True variant not implemented")
    blocks = gatefabric_layout(nm)
    init_idx, _ = fermion.hf_bitstring(ncas, nelecas)
    gate_list = []
    n_blocks = len(blocks)
    for layer in range(n_layers):
        for b, wires in enumerate(blocks):
            p_theta = (layer * n_blocks + b) * 2
            de = G.double_excitation_pairs(wires, nm, p_theta,
                                           sign_flip=DE_SIGN, dets=dets)
            orot = G.orbital_rotation_pairs(wires, nm, p_theta + 1,
                                            sign_flip=OR_SIGN,
                                            with_string=OR_STRING,
                                            dets=dets)
            if FABRIC_ORBROT_FIRST:
                gate_list.extend(orot)
                gate_list.append(de)
            else:
                gate_list.append(de)
                gate_list.extend(orot)
    return _finalize_program(gate_list, n_layers * n_blocks * 2, init_idx,
                             nm, dets, device)


def generalized_pair_doubles(wires):
    """Pair coupled-cluster double excitation wire groups
    (reference ansatze/kUpCCD.py:16-33)."""
    return [[list(wires[r:r + 2]), list(wires[p:p + 2])]
            for r in range(0, len(wires) - 1, 2)
            for p in range(0, len(wires) - 1, 2)
            if p != r]


def kupccd_program(ncas, nelecas, k=1, dets=None, device=None):
    """k-Unitary Pair CC Generalized Doubles: k repetitions of all pair
    doubles (reference ansatze/kUpCCD.py:94-130).  theta shape (k, n_pd),
    flattened row-major into parameter slots."""
    nm = 2 * ncas
    if nm < 4 or nm % 2:
        raise ValueError("requires an even number of qubits >= 4")
    d_wires = generalized_pair_doubles(list(range(nm)))
    init_idx, _ = fermion.hf_bitstring(ncas, nelecas)
    gate_list = []
    for layer in range(k):
        for i, (w1, w2) in enumerate(d_wires):
            s, r = w1[0], w1[-1]
            q, p = w2[0], w2[-1]
            gate_list.append(G.fermionic_double_pairs(
                p, q, r, s, nm, param=layer * len(d_wires) + i,
                half=0.5, sign_flip=FD_SIGN, dets=dets))
    return _finalize_program(gate_list, k * len(d_wires), init_idx, nm,
                             dets, device)


def _flat_theta(theta, program):
    return torch.as_tensor(theta, dtype=DTYPE,
                           device=program.device).reshape(-1)


def uccd_circuit(theta, ncas, nelecas, add_singles=False, device=None):
    """UCC(S)D ansatz statevector, the flat-API equivalent of the
    reference's ``uccd_circuit`` (reference __init__.py:4, pqc.py:69-76):
    the real float64 vector of dimension 4^ncas (interleaved JW
    ordering), on ``device``."""
    program = uccd_program(ncas, nelecas, add_singles=add_singles,
                           device=device)
    return program.apply(_flat_theta(theta, program))


def gatefabric_circuit(theta, ncas, nelecas, n_layers=1, device=None):
    """GateFabric (NP-fabric) ansatz statevector, the flat-API equivalent
    of the reference's ``gatefabric_circuit`` (pqc.py:79-84).  ``theta``
    is the FULL parameter tensor of shape gatefabric_full_shape(n_layers,
    2*ncas) (no redundant-parameter elimination at this level)."""
    program = gatefabric_program(ncas, nelecas, n_layers, device=device)
    return program.apply(_flat_theta(theta, program))
