"""The two string-grid gather kernels: CUDA for the card, plain PyTorch
for the CPU.

Port of auto_oo_tpu/ops/pallas_grid.py (``gather_rows_scaled`` and
``gather_reduce``).  The CUDA source is ``csrc/grid_gather.cu``; its
header comment says what bounds each kernel on an H100 and what the
design does about it.  The library is compiled with ``nvcc`` at first
use (ops/cuda_build.py).

Dispatch is by the device of the operand, and nothing else: a CPU tensor
runs the plain version beside each kernel; a CUDA tensor launches the
kernel, or raises (no nvcc, a failed build, a refused launch, an
unsupported dtype, layout or shape).  No path falls back from the card
to the plain version or to the CPU.

``LAUNCHES`` counts, per kernel, the launches made through the wrappers
(never the plain versions), so a run can show which kernels its main
path went through.
"""

import os

import torch

from .cuda_build import CSRC_DIR, I32, I64, PTR, CudaLibrary

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}

#: the kernel library, built from csrc/grid_gather.cu at first use
LIBRARY = CudaLibrary(
    os.path.join(CSRC_DIR, "grid_gather.cu"),
    {f"grid_{kern}_{sfx}": [PTR, PTR, PTR, PTR, PTR, I64, I32, I32, I32, I32,
                            PTR]
     for kern in ("gather_rows_scaled", "gather_reduce")
     for sfx in _SUFFIX.values()})

#: launches of each CUDA kernel through its wrapper (plain runs excluded)
LAUNCHES = {"gather_rows_scaled": 0, "gather_reduce": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---- plain versions (the CPU path and the on-card reference) -------------


def gather_rows_scaled_plain(x, src, s, t):
    """out[..., k, i, j] = (x[..., src[k, i], j] * s[k, i]) * t[k, j]."""
    return x[..., src, :] * s[:, :, None] * t[:, None, :]


def gather_reduce_plain(Y, src, s, t):
    """out[..., i, j] = sum_k (Y[..., k, src[k, i], j] * s[k, i]) * t[k, j]."""
    rows = torch.arange(src.shape[0], device=src.device)[:, None]
    G = Y[..., rows, src, :]
    return (G * s[:, :, None] * t[:, None, :]).sum(dim=-3)


# ---- wrappers --------------------------------------------------------------


def _check(name, a, src, s, t, lead_ndim):
    """Validate the kernel operands; returns (B, Ns, Nb)."""
    if a.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {a.dtype} is not float64/float32")
    for nm, v in (("s", s), ("t", t)):
        if v.dtype != a.dtype:
            raise TypeError(f"{name}: {nm} has dtype {v.dtype}, operand "
                            f"{a.dtype}")
    if src.dtype != torch.int32:
        raise TypeError(f"{name}: src must be int32 on the card, got "
                        f"{src.dtype}")
    for nm, v in (("operand", a), ("src", src), ("s", s), ("t", t)):
        if v.device != a.device:
            raise ValueError(f"{name}: {nm} is on {v.device}, operand on "
                             f"{a.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name}: {nm} is not contiguous")
    if a.dim() < lead_ndim:
        raise ValueError(f"{name}: operand needs at least {lead_ndim} dims")
    n2, Na = src.shape
    if s.shape != (n2, Na):
        raise ValueError(f"{name}: s shape {tuple(s.shape)} != src shape "
                         f"{(n2, Na)}")
    Ns, Nb = a.shape[-2], a.shape[-1]
    if t.shape != (n2, Nb):
        raise ValueError(f"{name}: t shape {tuple(t.shape)} != {(n2, Nb)}")
    B = 1
    for d in a.shape[:a.dim() - lead_ndim]:
        B *= d
    return B, Ns, Nb


def _launch(kern, dtype, *args):
    LIBRARY.launch(f"grid_{kern}_{_SUFFIX[dtype]}", *args)
    LAUNCHES[kern] += 1


def gather_rows_scaled(x, src, s, t):
    """out[..., k, i, j] = (x[..., src[k, i], j] * s[k, i]) * t[k, j].

    x (..., Ns, Nb); src (n2, Na) (int32 on the card); s (n2, Na);
    t (n2, Nb) -> (..., n2, Na, Nb).  Invalid entries carry src = 0,
    s = 0.  CPU tensors take the plain version; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return gather_rows_scaled_plain(x, src, s, t)
    if x.device.type != "cuda":
        raise NotImplementedError(f"gather_rows_scaled on {x.device}")
    B, Ns, Nb = _check("gather_rows_scaled", x, src, s, t, 2)
    n2, Na = src.shape
    out = torch.empty(x.shape[:-2] + (n2, Na, Nb), dtype=x.dtype,
                      device=x.device)
    _launch("gather_rows_scaled", x.dtype, x.data_ptr(), src.data_ptr(),
            s.data_ptr(), t.data_ptr(), out.data_ptr(), B, n2, Ns, Na, Nb,
            torch.cuda.current_stream(x.device).cuda_stream)
    return out


def gather_reduce(Y, src, s, t):
    """out[..., i, j] = sum_k (Y[..., k, src[k, i], j] * s[k, i]) * t[k, j].

    Y (..., n2, Ns, Nb); src/s (n2, Na); t (n2, Nb) -> (..., Na, Nb).
    CPU tensors take the plain version; CUDA tensors the kernel."""
    if Y.device.type == "cpu":
        return gather_reduce_plain(Y, src, s, t)
    if Y.device.type != "cuda":
        raise NotImplementedError(f"gather_reduce on {Y.device}")
    B, Ns, Nb = _check("gather_reduce", Y, src, s, t, 3)
    n2, Na = src.shape
    if Y.shape[-3] != n2:
        raise ValueError(f"gather_reduce: Y has {Y.shape[-3]} pairs, maps "
                         f"{n2}")
    out = torch.empty(Y.shape[:-3] + (Na, Nb), dtype=Y.dtype,
                      device=Y.device)
    _launch("gather_reduce", Y.dtype, Y.data_ptr(), src.data_ptr(),
            s.data_ptr(), t.data_ptr(), out.data_ptr(), B, n2, Ns, Na, Nb,
            torch.cuda.current_stream(Y.device).cuda_stream)
    return out
