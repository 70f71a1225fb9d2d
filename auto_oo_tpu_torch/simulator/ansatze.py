"""Ansatz tables: excitation enumeration, HF state, GateFabric layout and
redundant parameters, k-UpCCD wire groups, gate sign conventions.

The host-side (numpy) half of auto_oo_tpu/simulator/ansatze.py, split
from its flat GateProgram builders: the port builds its circuits directly
on the sector string grid (simulator/grid_gates.py).
"""

import numpy as np

from ..ops import fermion

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


def generalized_pair_doubles(wires):
    """Pair coupled-cluster double excitation wire groups
    (reference ansatze/kUpCCD.py:16-33)."""
    return [[list(wires[r:r + 2]), list(wires[p:p + 2])]
            for r in range(0, len(wires) - 1, 2)
            for p in range(0, len(wires) - 1, 2)
            if p != r]
