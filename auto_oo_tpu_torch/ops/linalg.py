"""Dense linear algebra of the optimizer: the matrix exponential of the
orbital rotation and the symmetric eigendecomposition of the Newton step.

Port of auto_oo_tpu/ops/linalg.py without its TPU workarounds (scalar f64
trig guards, the Taylor expm, the Jacobi eigh and the iterative Newton
direction): on the card and the CPU alike, PyTorch's own routines are
exact in float64.

``gram_last`` is the contraction over a state axis that the mixed
precision mode (``OO_pqc(precision="mixed")``) runs in float32.
"""

import torch

# terms of one float32 sum over a state axis: the card's GEMMs add a
# thread's terms in one chain, whose rounding grows like eps * sqrt(terms)
# (1e-4 relative at 10^7 terms, the length of one (16e,16o) chunk), so
# longer sums are cut into pieces whose float32 sums are added in float64
_F32_TERMS = 1 << 12

# float32 elements of the pieces' partial sums held at once
_F32_PARTIALS = 1 << 24


def expm(A):
    """Matrix exponential."""
    return torch.linalg.matrix_exp(A)


def eigh(A):
    """(eigenvalues ascending, eigenvectors) of a symmetric matrix."""
    return torch.linalg.eigh(A)


def gram_last(A, B):
    """A @ B^T, or A @ B for a vector B, over the last axis (the state
    axis): A (..., M, K), B (N, K) or (K,).  Float64 operands take one
    matmul.  Float32 ones are multiplied in float32 over pieces of at
    least ``_F32_TERMS`` terms (more where the M x N partial sums of all
    pieces would pass ``_F32_PARTIALS`` elements), and the pieces' sums
    are added in float64: the result is float64, the products and the
    sums inside a piece float32."""
    vec = B.dim() == 1
    if A.dtype == torch.float64:
        return A @ (B if vec else B.T)
    Bm = B[None] if vec else B
    K = A.shape[-1]
    A2 = A.reshape(-1, K)
    M, N = A2.shape[0], Bm.shape[0]
    piece = max(_F32_TERMS, -(-K // max(1, _F32_PARTIALS // (M * N))))
    m = K // piece
    out = A2.new_zeros((M, N), dtype=torch.float64)
    if m:
        Ap = A2[:, :m * piece].reshape(M, m, piece).transpose(0, 1)
        Bp = Bm[:, :m * piece].reshape(N, m, piece).permute(1, 2, 0)
        out += torch.bmm(Ap, Bp).sum(0, dtype=torch.float64)
    if m * piece < K:
        out += A2[:, m * piece:] @ Bm[:, m * piece:].T
    out = out.reshape(A.shape[:-1] + (N,))
    return out[..., 0] if vec else out
