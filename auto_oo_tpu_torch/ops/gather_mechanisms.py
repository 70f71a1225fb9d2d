"""Row-gather mechanism probes: CUDA for the card, plain PyTorch for the
CPU.

Port of the three Pallas kernels of scripts/experiment_gather_mechanisms.py
(``gather_a``, ``gather_b``, ``gather_c``).  Each computes

    out[k, i, :] = x[src[k, i], :] * s[k, i]

with x (ns, nb), src (n2, na) int32, s (n2, na) -> out (n2, na, nb), and
differs only in how a source row reaches the SM (the CUDA source
``csrc/gather_mechanisms.cu`` says what bounds each kernel and what its
design does about it):

* ``gather_a``: 1-D bulk row copies (TMA, no tensor map) into a 2-stage
  shared-memory ring;
* ``gather_b``: a column slab of x resident in shared memory;
* ``gather_c``: one 8-row aligned bulk copy per row, selecting row r % 8
  (the 8x-traffic control).

``gather_rows_plain`` is the plain version (the script's "xla take").
Inputs follow the script's padding rules: nb % 128 == 0, na % 8 == 0,
ns % 8 == 0.

Dispatch is by the device of ``x`` only: a CPU tensor runs the plain
version; a CUDA tensor launches the kernel or raises (no nvcc, a failed
build, a refused launch, an unsupported dtype, layout or shape).
``LAUNCHES`` counts the kernel launches made through the wrappers.
"""

import ctypes
import os

import torch

from .cuda_build import CSRC_DIR, I32, PTR, CudaLibrary

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}

_ARGS_A = [PTR, PTR, PTR, PTR, I32, I32, I32, I32, PTR]
_ARGS_B = [PTR, PTR, PTR, PTR, I32, I32, I32, I32, I32, PTR]

#: the kernel library, built from csrc/gather_mechanisms.cu at first use
LIBRARY = CudaLibrary(
    os.path.join(CSRC_DIR, "gather_mechanisms.cu"),
    {"gm_smem_optin": [ctypes.POINTER(ctypes.c_int)],
     **{f"gm_gather_{v}_{sfx}": (_ARGS_B if v == "b" else _ARGS_A)
        for v in "abc" for sfx in _SUFFIX.values()}})

#: launches of each CUDA kernel through its wrapper (plain runs excluded)
LAUNCHES = {"gather_a": 0, "gather_b": 0, "gather_c": 0}

# bytes of one stage of the A / C ring the stage size aims at: 2 stages
# leave room for 3 resident blocks per SM, whose copies overlap
_STAGE_BYTES = 32 * 1024
# rows per stage at most (the TPU kernels' R)
_MAX_STAGE_ROWS = 8
# mbarriers at the head of the ring (kBarrierBytes in the source)
_BARRIER_BYTES = 128
# the widest slab of B: one row segment per thread of a 256-thread block
_MAX_SLAB_W = 256


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def smem_limit():
    """The opt-in dynamic shared memory of one block on the current
    device, in bytes."""
    LIBRARY.load()
    out = ctypes.c_int(0)
    code = LIBRARY.lib.gm_smem_optin(ctypes.byref(out))
    if code != 0:
        raise RuntimeError(f"gm_smem_optin failed: cudaError {code}")
    return out.value


# ---- launch plans (pure functions of the shapes; the CPU tests reach them)


def stage_rows(block_rows, nb, itemsize, limit):
    """Rows per stage of the A (block_rows 1) / C (block_rows 8) ring:
    as many as fit _STAGE_BYTES, 1..8, and the 2-stage ring must fit the
    ``limit`` bytes of shared memory."""
    unit = block_rows * nb * itemsize
    rows = max(1, min(_MAX_STAGE_ROWS, _STAGE_BYTES // unit))
    need = _BARRIER_BYTES + 2 * rows * unit
    if need > limit:
        raise ValueError(
            f"a 2-stage ring of {block_rows}-row blocks of {nb} columns "
            f"needs {need} bytes of shared memory; the card offers {limit}")
    return rows


def slab_width(ns, nb, itemsize, limit):
    """Columns W of B's resident slab (ns, W): a power of two, 16..256,
    the widest whose slab fits half the ``limit`` (two resident blocks
    per SM), or all of it where even W = 16 needs more than half."""
    need = ns * 16 * itemsize
    if need > limit:
        raise ValueError(
            f"x slab of 16 columns ({ns} rows) needs {need} bytes of "
            f"shared memory; the card offers {limit}")
    budget = limit // 2 if need <= limit // 2 else limit
    W = 16
    while W < _MAX_SLAB_W and W < nb and ns * 2 * W * itemsize <= budget:
        W *= 2
    return W


# ---- plain version (the CPU path and the on-card reference) -------------


def gather_rows_plain(x, src, s):
    """out[k, i, :] = x[src[k, i], :] * s[k, i]."""
    return x[src.long()] * s[:, :, None]


# ---- wrappers --------------------------------------------------------------


def _check(name, x, src, s, bulk):
    """Validate the kernel operands; returns (ns, nb, n2, na)."""
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {x.dtype} is not float64/float32")
    if s.dtype != x.dtype:
        raise TypeError(f"{name}: s has dtype {s.dtype}, x {x.dtype}")
    if src.dtype != torch.int32:
        raise TypeError(f"{name}: src must be int32 on the card, got "
                        f"{src.dtype}")
    for nm, v in (("x", x), ("src", src), ("s", s)):
        if v.device != x.device:
            raise ValueError(f"{name}: {nm} is on {v.device}, x on "
                             f"{x.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name}: {nm} is not contiguous")
    if x.dim() != 2 or src.dim() != 2 or s.shape != src.shape:
        raise ValueError(f"{name}: needs x (ns, nb) and src, s (n2, na); "
                         f"got {tuple(x.shape)}, {tuple(src.shape)}, "
                         f"{tuple(s.shape)}")
    ns, nb = x.shape
    n2, na = src.shape
    if bulk and ((nb * x.element_size()) % 16 or x.data_ptr() % 16):
        raise ValueError(f"{name}: the bulk copies need rows of x that are "
                         f"16-byte multiples at 16-byte aligned addresses; "
                         f"a row is {nb * x.element_size()} bytes")
    if nb % 128 or na % 8 or ns % 8:
        raise ValueError(f"{name}: needs nb % 128 == 0, na % 8 == 0 and "
                         f"ns % 8 == 0 (the script's padding); got ns={ns}, "
                         f"nb={nb}, na={na}")
    return ns, nb, n2, na


def _gather(variant, x, src, s):
    name = f"gather_{variant}"
    if x.device.type == "cpu":
        return gather_rows_plain(x, src, s)
    if x.device.type != "cuda":
        raise NotImplementedError(f"{name} on {x.device}")
    ns, nb, n2, na = _check(name, x, src, s, bulk=variant != "b")
    out = torch.empty((n2, na, nb), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    item = x.element_size()
    if variant == "b":
        plan = slab_width(ns, nb, item, smem_limit())
        args = (ns, n2, na, nb, plan)
    else:
        plan = stage_rows(8 if variant == "c" else 1, nb, item,
                          smem_limit())
        args = (n2, na, nb, plan)
    LIBRARY.launch(f"gm_{name}_{_SUFFIX[x.dtype]}", x.data_ptr(),
                   src.data_ptr(), s.data_ptr(), out.data_ptr(), *args,
                   torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES[name] += 1
    return out


def gather_a(x, src, s):
    """out[k, i, :] = x[src[k, i], :] * s[k, i] through bulk row copies
    into a double-buffered shared-memory ring (CUDA tensors); the plain
    version on CPU tensors."""
    return _gather("a", x, src, s)


def gather_b(x, src, s):
    """The same gather with a column slab of x resident in shared memory
    (CUDA tensors); the plain version on CPU tensors."""
    return _gather("b", x, src, s)


def gather_c(x, src, s):
    """The same gather through one 8-row aligned bulk copy per row (8x
    read traffic; CUDA tensors); the plain version on CPU tensors."""
    return _gather("c", x, src, s)
