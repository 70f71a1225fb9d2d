"""Global numerical configuration for auto_oo_tpu_torch.

The port works in float64 (``DTYPE``), but for the float32 Hessian blocks
of ``OO_pqc(precision="mixed")``; every tensor it creates names its
dtype, and the global default dtype is left alone (the port's tests share
a process with the JAX package's).

The port runs on the card: every entry point (``Parameterized_circuit``,
``OO_energy`` / ``OO_pqc``, ``GridMaps`` / ``build_grid_maps``, the grid
gates, ``GridProgram``, ``from_jax``) puts its tensors on
``DEFAULT_DEVICE``, ``"cuda"``, unless the caller passes ``device="cpu"``
or calls ``set_device("cpu")``.  The port never moves to the CPU because
CUDA is missing: without a card, a call that names no device fails where
its first tensor is made.

TF32 is switched off for matmuls and convolutions, and float32 matmuls
run at "highest" precision: the JAX package measured that low-precision
float32 dots derail the damped-Newton trajectory by 8e-2 Ha
(auto_oo_tpu/models/oo_pqc.py:132-140), and TF32 keeps even fewer
mantissa bits than the single-pass bfloat16 dots measured there.
"""

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

#: Floating point dtype of energies, integrals, parameters and states.
DTYPE = torch.float64

#: CODATA-2010 Bohr radius in Angstrom (matches PySCF's param.BOHR so that
#: geometries specified in Angstrom reproduce reference energies to 1e-10 Ha).
BOHR = 0.52917721092

#: Git-ignored directory at the repository root that receives every
#: library the port compiles (the CUDA kernels, the native ERI engine).
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")

#: the device of every entry point that is given none
DEFAULT_DEVICE = torch.device("cuda")

_DEVICE = DEFAULT_DEVICE


def set_device(device):
    """Set the process default device (``"cpu"``, ``"cuda"``, ...)."""
    global _DEVICE
    _DEVICE = torch.device(device)


def get_device(device=None):
    """``device`` as a torch.device, or the process default if None."""
    return _DEVICE if device is None else torch.device(device)
