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
* ``gather_b``: a column slab of x split by rows across the shared memory
  of a thread-block cluster, read remotely (distributed shared memory);
* ``gather_c``: one 8-row aligned 2-D tensor-map TMA box per output row
  segment in a deep ring, selecting row r % 8 (the 8x-traffic control).

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
from typing import NamedTuple

import torch

from .cuda_build import CSRC_DIR, I32, PTR, CudaLibrary

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}

_ARGS_A = [PTR, PTR, PTR, PTR, I32, I32, I32, I32, PTR]
_ARGS_BC = [PTR, PTR, PTR, PTR, I32, I32, I32, I32, I32, I32, PTR]

#: the kernel library, built from csrc/gather_mechanisms.cu at first use
LIBRARY = CudaLibrary(
    os.path.join(CSRC_DIR, "gather_mechanisms.cu"),
    {"gm_smem_optin": [ctypes.POINTER(ctypes.c_int)],
     "gm_occupancy": [I32, I32, I32, I32, I32, ctypes.POINTER(ctypes.c_int)],
     **{f"gm_gather_{v}_{sfx}": (_ARGS_A if v == "a" else _ARGS_BC)
        for v in "abc" for sfx in _SUFFIX.values()}})

#: launches of each CUDA kernel through its wrapper (plain runs excluded)
LAUNCHES = {"gather_a": 0, "gather_b": 0, "gather_c": 0}

# bytes of one stage of the A ring the stage size aims at: 2 stages leave
# room for 3 resident blocks per SM, whose copies overlap
_STAGE_BYTES = 32 * 1024
# rows per stage of A at most (the TPU kernels' R)
_MAX_STAGE_ROWS = 8
# mbarriers at the head of A's ring (kBarrierBytes in the source)
_BARRIER_BYTES = 128
# B: the cluster size of the plan (the cluster-size sweep in PERF.md: on
# an H100, 8 ties with 4 at ncas = 12 f64 and leads in f32; 16 holds
# fewer SMs), the largest cluster Hopper allows (non-portable above 8),
# the widest slab, and the output rows of one index tile (kTileRows)
B_CLUSTER = 8
MAX_CLUSTER = 16
_MAX_SLAB_W = 256
_TILE_ROWS = 256
# C: mbarriers and per-stage indices before the ring (kHeadBytesC), the
# widest box row (kMaxRowBytesC), stages at most (kMaxStagesC) and their
# step (one per consumer warp), and the resident blocks per SM the ring
# is sized for
_HEAD_BYTES_C = 1024
_MAX_ROW_BYTES_C = 1024
_MAX_STAGES_C = 16
_STAGE_STEP_C = 4
_BLOCKS_PER_SM_C = 3
# the tensor map's box: at most 256 elements per dimension
_MAX_BOX = 256


class PlanB(NamedTuple):
    cluster: int        # blocks per cluster
    W: int              # columns of the slab x[:, c0:c0+W]
    rows_per_block: int  # source rows of each block's share
    smem: int           # dynamic shared memory of one block, bytes


class PlanC(NamedTuple):
    Wc: int             # columns of the 8-row box
    stages: int         # boxes in the ring
    smem: int           # dynamic shared memory of one block, bytes


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


def held(variant, dtype, ns, plan):
    """What the current device holds of a plan at once: for ``"b"`` the
    clusters, for ``"c"`` the blocks per SM (0: none, the plan cannot
    launch)."""
    LIBRARY.load()
    f64 = int(dtype == torch.float64)
    args = ((ns, plan.cluster, plan.W) if variant == "b"
            else (plan.Wc, plan.stages, 0))
    out = ctypes.c_int(0)
    code = LIBRARY.lib.gm_occupancy(ord(variant), f64, *args,
                                    ctypes.byref(out))
    if code != 0:
        raise RuntimeError(f"gm_occupancy({variant}) refused {plan}: "
                           f"cudaError {code}")
    return out.value


# ---- launch plans (pure functions of the shapes; the CPU tests reach them)


def stage_rows(nb, itemsize, limit):
    """Rows per stage of the A ring: as many as fit _STAGE_BYTES, 1..8,
    and the 2-stage ring must fit the ``limit`` bytes of shared memory."""
    unit = nb * itemsize
    rows = max(1, min(_MAX_STAGE_ROWS, _STAGE_BYTES // unit))
    need = _BARRIER_BYTES + 2 * rows * unit
    if need > limit:
        raise ValueError(
            f"a 2-stage ring of rows of {nb} columns needs {need} bytes of "
            f"shared memory; the card offers {limit}")
    return rows


def _b_smem(ns, cluster, W, itemsize):
    """B's shared memory per block: its share of the slab and the
    double-buffered (row pointer, scale) tables of an index tile."""
    rows = -(-ns // cluster)
    return rows * W * itemsize + 2 * _TILE_ROWS * (8 + itemsize)


def plan_b(ns, nb, itemsize, limit, cluster=None):
    """B's plan: the cluster size (``cluster``, or B_CLUSTER, doubled up to
    MAX_CLUSTER while even a 16-column slab does not fit), and the widest
    slab W (a power of two, 16..256, dividing nb) whose per-block share of
    ceil(ns / cluster) rows fits the ``limit`` bytes of shared memory.
    Raises where even W = 16 does not fit."""
    if cluster is not None and cluster < 1:
        raise ValueError(f"cluster size {cluster} < 1")
    sizes = [cluster or B_CLUSTER]
    while cluster is None and 2 * sizes[-1] <= MAX_CLUSTER:
        sizes.append(2 * sizes[-1])
    for c in sizes:
        if _b_smem(ns, c, 16, itemsize) <= limit:
            W = 16
            while (2 * W <= _MAX_SLAB_W and nb % (2 * W) == 0
                   and _b_smem(ns, c, 2 * W, itemsize) <= limit):
                W *= 2
            return PlanB(c, W, -(-ns // c), _b_smem(ns, c, W, itemsize))
    need = _b_smem(ns, sizes[-1], 16, itemsize)
    raise ValueError(
        f"a 16-column slab of x ({ns} rows) over a cluster of {sizes[-1]} "
        f"blocks needs {need} bytes of shared memory per block; the card "
        f"offers {limit}")


def plan_c(ns, nb, itemsize, limit):
    """C's plan: the box width Wc (the widest power of two dividing nb
    with Wc <= 256 elements and Wc * itemsize <= 1 KB), and the stages (a
    multiple of 4, 4..16) of the ring that lets _BLOCKS_PER_SM_C blocks
    share one SM.  Raises where the tensor map's rules are broken (rows
    of 16-byte multiples, whole 8-row blocks) or four stages do not fit
    the ``limit``; rows of 16-byte multiples make the inner box one too,
    and Wc keeps to the 256 elements a box dimension may have."""
    if (nb * itemsize) % 16 or ns % 8 or ns < 8:
        raise ValueError(
            f"tensor map of x ({ns}, {nb}) x {itemsize} B: needs rows of "
            f"16-byte multiples and ns a multiple of 8")
    Wc = 1
    while (2 * Wc <= _MAX_BOX and 2 * Wc * itemsize <= _MAX_ROW_BYTES_C
           and nb % (2 * Wc) == 0):
        Wc *= 2
    box = 8 * Wc * itemsize
    fit = (limit // _BLOCKS_PER_SM_C - _HEAD_BYTES_C) // box
    stages = min(_MAX_STAGES_C, fit // _STAGE_STEP_C * _STAGE_STEP_C)
    stages = max(stages, _STAGE_STEP_C)
    smem = _HEAD_BYTES_C + stages * box
    if smem > limit:
        raise ValueError(
            f"a ring of {stages} boxes of {box} bytes needs {smem} bytes of "
            f"shared memory; the card offers {limit}")
    return PlanC(Wc, stages, smem)


# ---- plain version (the CPU path and the on-card reference) -------------


def gather_rows_plain(x, src, s):
    """out[k, i, :] = x[src[k, i], :] * s[k, i]."""
    return x[src.long()] * s[:, :, None]


# ---- wrappers --------------------------------------------------------------


def _check(name, x, src, s):
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
    if (nb * x.element_size()) % 16 or x.data_ptr() % 16:
        raise ValueError(f"{name}: the 16-byte copies need rows of x that "
                         f"are 16-byte multiples at 16-byte aligned "
                         f"addresses; "
                         f"a row is {nb * x.element_size()} bytes")
    if nb % 128 or na % 8 or ns % 8:
        raise ValueError(f"{name}: needs nb % 128 == 0, na % 8 == 0 and "
                         f"ns % 8 == 0 (the script's padding); got ns={ns}, "
                         f"nb={nb}, na={na}")
    return ns, nb, n2, na


def _gather(variant, x, src, s, cluster=None):
    name = f"gather_{variant}"
    if x.device.type == "cpu":
        return gather_rows_plain(x, src, s)
    if x.device.type != "cuda":
        raise NotImplementedError(f"{name} on {x.device}")
    ns, nb, n2, na = _check(name, x, src, s)
    out = torch.empty((n2, na, nb), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    item = x.element_size()
    if variant == "a":
        args = (n2, na, nb, stage_rows(nb, item, smem_limit()))
    elif variant == "b":
        plan = plan_b(ns, nb, item, smem_limit(), cluster)
        args = (ns, n2, na, nb, plan.cluster, plan.W)
    else:
        plan = plan_c(ns, nb, item, smem_limit())
        args = (ns, n2, na, nb, plan.Wc, plan.stages)
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


def gather_b(x, src, s, cluster=None):
    """The same gather with a column slab of x split across the shared
    memory of a thread-block cluster and read remotely (CUDA tensors);
    the plain version on CPU tensors.  ``cluster`` overrides the plan's
    cluster size (any size the card refuses raises)."""
    return _gather("b", x, src, s, cluster)


def gather_c(x, src, s):
    """The same gather through one 8-row aligned 2-D TMA box per output
    row segment (8x read traffic; CUDA tensors); the plain version on CPU
    tensors."""
    return _gather("c", x, src, s)
