"""Dense linear algebra of the optimizer: the matrix exponential of the
orbital rotation and the symmetric eigendecomposition of the Newton step.

Port of auto_oo_tpu/ops/linalg.py without its TPU workarounds (scalar f64
trig guards, the Taylor expm, the Jacobi eigh and the iterative Newton
direction): on the card and the CPU alike, PyTorch's own routines are
exact in float64.
"""

import torch


def expm(A):
    """Matrix exponential."""
    return torch.linalg.matrix_exp(A)


def eigh(A):
    """(eigenvalues ascending, eigenvectors) of a symmetric matrix."""
    return torch.linalg.eigh(A)
