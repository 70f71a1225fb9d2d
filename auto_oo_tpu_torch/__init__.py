"""auto_oo_tpu_torch: the PyTorch / CUDA port of auto_oo_tpu.

Orbital-optimized VQE with exact hybrid gradients and Hessians, written in
PyTorch for one NVIDIA H100 (and the CPU), beside the JAX package it is
held against.  It imports torch, numpy and scipy, never jax.  Modules and
public names mirror auto_oo_tpu, so each counterpart is found under the
same name.

The port runs the damped-Newton path (``Parameterized_circuit``,
``OO_pqc.full_optimization``) and the first-order one
(``OO_pqc.gradient_optimization``: Adam with orbital relaxations) in the
full space (``sector=False``, the default: a flat gate program and
element gathers in plain PyTorch) and on the sector string grid
(``sector=True``) up to (16e,16o), where its
grid-gather kernels are CUDA on the card (ops/grid_kernels.py,
csrc/grid_gather.cu).  The Berry-phase workflow (``BerryPhaseLoop``: tracking around a
geometry loop, the Thouless state transfer on the card), the noisy
optimizer (``Noisy_OO_pqc``), the spin diagnostics
(``Parameterized_circuit.s2_expectation``), ``utils.observe.Monitor``
and ``utils.checkpoint`` run as in the JAX package, and so do the
geometry batches (``parallel.GeometryBatch``,
``BerryPhaseLoop.run_batched``) and the on-device Newton loop
(``full_optimization(device_loop=True)``), on one card.  The row-gather
mechanism probes
(ops/gather_mechanisms.py, csrc/gather_mechanisms.cu) run from their own
entry point,
``python -m auto_oo_tpu_torch.scripts.experiment_gather_mechanisms``.
"""

from . import config  # noqa: F401  (TF32 off before anything runs)

from .moldata import Moldata, Moldata_pyscf, ao_to_oao
from .utils import NewtonStep, get_formal_geo
from .ops.kappa import (
    vector_to_skew_symmetric,
    skew_symmetric_to_vector,
    non_redundant_indices,
)
from .ops.transforms import (
    int1e_transform,
    int2e_transform,
    molecular_hamiltonian_coefficients,
)
from .ops.linalg import expm
from .simulator.ansatze import gatefabric_circuit, uccd_circuit
from .simulator.circuit import Parameterized_circuit, dirac_notation
from .models import (BerryPhaseLoop, Noisy_OO_pqc, OO_energy, OO_pqc,
                     fermionic_cas_hamiltonian, mo_ao_to_mo_oao, s2, sz)

__all__ = [
    "Moldata", "Moldata_pyscf", "ao_to_oao",
    "NewtonStep", "get_formal_geo",
    "vector_to_skew_symmetric", "skew_symmetric_to_vector",
    "non_redundant_indices",
    "int1e_transform", "int2e_transform",
    "molecular_hamiltonian_coefficients", "expm",
    "Parameterized_circuit", "OO_energy", "OO_pqc", "mo_ao_to_mo_oao",
    "Noisy_OO_pqc", "BerryPhaseLoop", "s2", "sz",
    "fermionic_cas_hamiltonian",
    "uccd_circuit", "gatefabric_circuit", "dirac_notation",
]
