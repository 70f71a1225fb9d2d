"""The string-grid gather kernels: CUDA for the card, plain PyTorch for
the CPU.

Port of auto_oo_tpu/ops/pallas_grid.py (``gather_rows_scaled`` and
``gather_reduce``), plus ``gather_two_spin``: both spin halves of Phi in
one kernel, the beta half gathered inside the grid's rows where the TPU
wrappers run ``gather_rows_scaled`` on a transposed copy and add the
result back transposed (pallas_grid.py:259-262, :354-357); it builds Phi
on every route of the port, and ``gather_rows_scaled``, the TPU's row
gather redesigned for Hopper (``plan_rows_scaled``), builds one spin
component of Phi for the spin-resolved RDMs (ops/grid.phi_all(spin=...)),
both Phi halves of the hosted x row-sharded engine's segments, and is
the production variant the row-gather probes time;
``gather_reduce_cols``: the column form of ``gather_reduce``, which
reads the beta half of ``epq_sum`` in the grid's natural layout where
the TPU wrapper first made a transposed copy of Y (pallas_grid.py:270),
walking lists of the maps' valid entries compacted once per maps
(``reduce_cols_lists``) and adding into its caller's output where asked;
and ``scatter_rows``: the alpha half of the hosted H-apply
(auto_oo_tpu/ops/grid_hosted.py:260-262, an XLA scatter there), the
windowed, accumulating form of ``gather_reduce``.  The CUDA source is
``csrc/grid_gather.cu``; its header comment says what bounds each
kernel on an H100 and what the design does about it.  The library is
compiled with ``nvcc`` at first use (ops/cuda_build.py).

Dispatch is by the device of the operand, and nothing else: a CPU tensor
runs the plain version beside each kernel; a CUDA tensor launches the
kernel, or raises (no nvcc, a failed build, a refused launch, an
unsupported dtype, layout or shape).  No path falls back from the card
to the plain version or to the CPU.

``LAUNCHES`` counts, per kernel, the launches made through the wrappers
(never the plain versions), so a run can show which kernels its main
path went through; while spans record (utils/observe.py) each launch is
also a ``kernel`` span named by its kernel.
"""

import os
from typing import NamedTuple, Optional

import torch

from ..utils import observe as _observe
from .cuda_build import CSRC_DIR, I32, I64, PTR, CudaLibrary

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_ARGS = [PTR, PTR, PTR, PTR, PTR, I64, I32, I32, I32, I32]

# gather_rows_scaled: x, src, s, t, out; B; n2, Ns, Na, Nb; the plan
# (vec, threads, unroll, order); the divisor constants of Nb; the stream
_ROWS_ARGS = _ARGS + [I32] * 4 + [I64, I32, PTR]

# gather_two_spin: x, the four compact tables, out; B; n2, Na, Nb, the
# beta tables' padded width, r0, R, the beta source columns' bytes and the
# plan (vec, threads, pairs, staged, line); the stream
_TWO_SPIN_ARGS = [PTR] * 6 + [I64] + [I32] * 12 + [PTR]

# gather_reduce_cols: Y, the five list tensors, t, out; B; n2, Na, Ns, Nc,
# the list tile, the plan (rows, unroll, warps) and add; the stream
_COLS_ARGS = [PTR] * 8 + [I64] + [I32] * 9 + [PTR]

#: the kernel library, built from csrc/grid_gather.cu at first use
LIBRARY = CudaLibrary(
    os.path.join(CSRC_DIR, "grid_gather.cu"),
    {**{f"grid_{kern}_{sfx}": _ARGS + extra + [PTR]
        for kern, extra in (("gather_reduce", [I32, I32, I32]),
                            ("scatter_rows", [I32, I32, I32, I32]))
        for sfx in _SUFFIX.values()},
     **{f"grid_gather_rows_scaled_{sfx}": _ROWS_ARGS
        for sfx in _SUFFIX.values()},
     **{f"grid_gather_two_spin_{sfx}": _TWO_SPIN_ARGS
        for sfx in _SUFFIX.values()},
     **{f"grid_gather_reduce_cols_{sfx}": _COLS_ARGS
        for sfx in _SUFFIX.values()}})

#: launches of each CUDA kernel through its wrapper (plain runs excluded);
#: ops/gate_kernels.py adds its kernels' entries when it is imported
LAUNCHES = {"gather_two_spin": 0, "gather_rows_scaled": 0,
            "gather_reduce": 0, "gather_reduce_cols": 0, "scatter_rows": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---- plain versions (the CPU path and the on-card reference) -------------


def gather_rows_scaled_plain(x, src, s, t):
    """out[..., k, i, j] = (x[..., src[k, i], j] * s[k, i]) * t[k, j]."""
    return x[..., src, :] * s[:, :, None] * t[:, None, :]


def gather_two_spin_plain(x, srcA, sgnA, tB, srcB, sgnB, tA, r0, r1):
    """out[..., k, m, j] = (x[..., srcA[k, r0+m], j] * sgnA[k, r0+m])
    * tB[k, j] + (x[..., r0+m, srcB[k, j]] * sgnB[k, j]) * tA[k, r0+m]:
    the composite the kernel replaces, ``gather_rows_scaled`` on the alpha
    half with row-sliced tables and on a transposed copy of the rows for
    the beta half, added back transposed."""
    pa = gather_rows_scaled_plain(x, srcA[:, r0:r1], sgnA[:, r0:r1], tB)
    zt = x[..., r0:r1, :].transpose(-1, -2).contiguous()
    pb = gather_rows_scaled_plain(zt, srcB, sgnB, tA[:, r0:r1])
    return pa.add_(pb.transpose(-1, -2))


def gather_reduce_plain(Y, src, s, t):
    """out[..., i, j] = sum_k (Y[..., k, src[k, i], j] * s[k, i]) * t[k, j]."""
    rows = torch.arange(src.shape[0], device=src.device)[:, None]
    G = Y[..., rows, src, :]
    return (G * s[:, :, None] * t[:, None, :]).sum(dim=-3)


def gather_reduce_cols_plain(Y, src, s, t, out=None):
    """out[..., a, c] = sum_k (Y[..., k, a, src[k, c]] * s[k, c]) * t[k, a]:
    ``gather_reduce`` on the transposed copy of Y, transposed back; with
    ``out`` the sum is added to it in place (``out += sum``) and out is
    returned."""
    res = gather_reduce_plain(Y.transpose(-1, -2).contiguous(), src, s,
                              t).transpose(-1, -2)
    if out is None:
        return res
    out += res
    return out


def gather_reduce_cols_walk(Y, lists, t):
    """The column form as the card's kernel sums it, in plain PyTorch: each
    tile's list (``reduce_cols_lists``) walked group by group in order,
    each group adding (Y[..., k, :, src] * sign) * t[k, :] into its output
    columns, so every output element is summed over its valid k in
    increasing order.  The reference of the lists' layout; a Python loop
    over the groups, for small maps."""
    Na = Y.shape[-2]
    out = Y.new_zeros(Y.shape[:-3] + (Na, lists.Nc))
    start, pair = lists.start.tolist(), lists.pair.tolist()
    for tile in range(len(start) - 1):
        for g in range(start[tile], start[tile + 1]):
            e = slice(COLS_GROUP * g, COLS_GROUP * (g + 1))
            live = lists.sgn[e] != 0
            src = lists.src[e][live].long()
            c = tile * lists.tile + lists.col[e][live].long()
            sgn = lists.sgn[e][live].to(Y.dtype)
            k = pair[g]
            out[..., c] += (Y[..., k, :, src] * sgn) * t[k, :, None]
    return out


def scatter_rows_plain(acc, Y, src, s, t, dst, dsg, r0):
    """acc[..., dst[k, r0 + m], j] += (Y[..., k, m, j] * dsg[k, r0 + m])
    * t[k, j]: ``index_add_`` through the inverse maps over the window's
    source rows m (the JAX package's ``.at[].add``); returns acc.  Invalid
    entries (dst 0, dsg 0) add zeros to row 0.  ``src`` and ``s`` are the
    kernel's tables, unused here."""
    R = Y.shape[-2]
    contrib = Y * dsg[:, r0:r0 + R, None] * t[:, None, :]
    return acc.index_add_(-2, dst[:, r0:r0 + R].reshape(-1),
                          contrib.reshape(Y.shape[:-3] + (-1, Y.shape[-1])))


# ---- launch plan of gather_reduce -----------------------------------------

#: the most threads per block gather_reduce's plan asks for (the kernel's
#: limit)
REDUCE_BLOCK = 512
# gather_reduce's staged pair lists stay within the default 48 KB
_REDUCE_SMEM = 48 * 1024


class ReducePlan(NamedTuple):
    vec: int      # elements per load along j (16 bytes, or 1)
    rows: int     # output rows per block
    threads: int  # threads per block, a whole number of warps


def _warps(n):
    return -(-n // 32) * 32


def plan_reduce(B, Na, Nb, n2, itemsize, aligned=True):
    """gather_reduce's launch plan.  A block owns ``rows`` output rows with
    all B tangents and all Nb columns; its tasks are (row, tangent,
    vector) triples.  Wide rows take one row per block and split its
    tasks into equal rounds of at most REDUCE_BLOCK threads ((12e,12o) f64,
    B = 1: 462 vectors, 480 threads; (10e,10o) f64, B = 5: 630 tasks in 2
    rounds of 315, 320 threads); narrow rows pack several rows into one
    block.  Loads are 16-byte vectors when every
    row starts on a 16-byte boundary (``aligned`` pointers, Nb a multiple
    of the vector), else scalars."""
    vec = 16 // itemsize
    if not aligned or Nb % vec:
        vec = 1
    per_row = B * (Nb // vec)
    if per_row >= REDUCE_BLOCK:
        rounds = -(-per_row // REDUCE_BLOCK)
        return ReducePlan(vec, 1, _warps(-(-per_row // rounds)))
    per_list = n2 * (12 + itemsize) + (-(-n2 // 32) + 1) * 4
    rows = max(1, min(Na, REDUCE_BLOCK // per_row, _REDUCE_SMEM // per_list))
    return ReducePlan(vec, rows, _warps(rows * per_row))


# ---- launch plan and bytes of gather_rows_scaled ---------------------------

#: the most threads per block gather_rows_scaled takes (the kernel's
#: limit), the slots a lane may keep in flight, and the bytes of the lines
#: each warp's stores start on
ROWS_BLOCK = 512
ROWS_UNROLLS = (1, 2, 4, 8)
ROWS_LINE = 128


class RowsPlan(NamedTuple):
    vec: int      # elements a store: 16 bytes (the kernel also takes 8, 4)
    threads: int  # threads per block, a whole number of warps
    unroll: int   # slots of a lane, all their loads started together
    order: int    # 0: the pair slabs of one chunk index run together;
                  # 1: the chunks of one slab


def rows_elem(Nb, vec, itemsize, align=16):
    """True where gather_rows_scaled loads x and t one element at a time
    (its slots may straddle rows): Nb no multiple of ``vec``, or x or t
    (their pointers' ``align``, bytes) not on ``vec`` elements; else its
    loads are vectors of ``vec`` elements, as its stores are."""
    return bool(Nb % vec or align % (vec * itemsize))


def plan_rows_scaled(B, Ns, Na, Nb, n2, itemsize, align=16):
    """gather_rows_scaled's launch plan for B states of x (Ns, Nb) and
    maps of n2 pairs x Na rows, x and t on ``align`` bytes.  Slots of 16
    bytes where Nb and the pointers allow vector loads of them, else of 8
    (f32 rows of an even Nb), else 16 bytes with loads element by element
    (``rows_elem``: an odd Nb, or x on 8 bytes); 128 threads; 32 bytes of
    slots a lane in flight (64 with element loads); and the block order:
    order 0 (the slabs of one chunk index run together, so the pairs at
    one row i read their source rows from the L2 together) where x does
    not fit half the L2 but the rows one chunk index of all slabs reads,
    n2 rows of x, fit a quarter of it; else order 1 (each slab's chunks
    together: its source rows are read once, in order).  The kernel
    stages nothing in shared memory.  (Swept on an H100 with
    scripts/sweep_rows_scaled.py over slots of 16, 8 and 4 bytes,
    128-512 threads, unroll 1-8 and both orders at the one-spin Phi of
    (10e,10o) to (14e,14o), the (16e,16o) chunk and segment and the
    probes' shapes, f64 and f32: the rule's plan ran within 2.2% of the
    best plan swept at each shape.)"""
    vec = 16 // itemsize
    while vec > 1 and rows_elem(Nb, vec, itemsize, align):
        vec //= 2
    elem = vec == 1
    if elem:
        vec = 16 // itemsize
    unroll = 4 if elem else 32 // (vec * itemsize)
    near = (not two_spin_in_l2(B, Ns, Nb, itemsize)
            and n2 * Nb * itemsize <= _L2_BYTES // 4)
    return RowsPlan(vec, 128, unroll, 0 if near else 1)


def rows_divisor(d):
    """(m, l) such that n // d == (umulhi(n, m) + n) >> l for every 0 <= n
    < 2^31, umulhi the high 32 bits of the 64-bit product (the kernel's
    division of a slab's element index by Nb): l = ceil(log2 d), m =
    floor(2^32 (2^l - d) / d) + 1 < 2^32."""
    if not 1 <= d < 1 << 31:
        raise ValueError(f"gather_rows_scaled: a divisor of {d}")
    l = (d - 1).bit_length()
    return ((1 << 32) * ((1 << l) - d)) // d + 1, l


def rows_scaled_chunks(Na, Nb, itemsize, plan):
    """The blocks one pair slab of Na * Nb elements takes in a
    gather_rows_scaled launch: the slots (vec elements on out's vec-element
    boundaries) that hold its elements, counted from the line at or
    before the first, threads * unroll slots a block (the kernel takes
    at most 2^31 - 1 elements of slots)."""
    line = ROWS_LINE // (plan.vec * itemsize)
    slots = (Na * Nb + 2 * plan.vec - 2) // plan.vec
    return -(-(line - 1 + slots) // (plan.threads * plan.unroll))


def rows_scaled_slot_map(B, n2, Na, Nb, itemsize, plan):
    """The kernel's map of (block, thread, slot) to output elements, in
    numpy, for small shapes (out on a 128-byte line): returns (elements,
    lines), the index in out of every element a slot writes (a slot
    writes the elements of its block's slab it holds) and whether every
    store instruction of a warp (its 32 lanes' u-th slots) starts on a
    ``ROWS_LINE``-byte line of out."""
    import numpy as np

    vec, L = plan.vec, Na * Nb
    line = ROWS_LINE // (vec * itemsize)
    chunk = plan.threads * plan.unroll
    chunks = rows_scaled_chunks(Na, Nb, itemsize, plan)
    # every (slab, chunk) block; the order only says which run together
    p, c = np.divmod(np.arange(B * n2 * chunks), chunks)
    base = p * L
    g0 = base // vec
    tid = np.arange(plan.threads)
    lane_off = (tid // 32) * 32 * plan.unroll + tid % 32
    u = 32 * np.arange(plan.unroll)
    q = (c[:, None, None] * chunk + lane_off[None, :, None] + u[None, None, :]
         - (g0 % line)[:, None, None])
    slot = g0[:, None, None] + q
    n_slots = (base - g0 * vec + L + vec - 1) // vec
    live = (q >= 0) & (q < n_slots[:, None, None])
    el = (slot * vec)[..., None] + np.arange(vec)
    inside = ((el >= base[:, None, None, None])
              & (el < (base + L)[:, None, None, None]) & live[..., None])
    return el[inside], bool((slot[:, ::32, :] % line == 0).all())


class RowsBytes(NamedTuple):
    bound: int             # out written once, each source row of the valid
                           # entries read once, the tables once
    reread: Optional[int]  # the bound plus every further read of a source
                           # row; None where x fits half the L2


def rows_scaled_bytes(x, src, s, t):
    """Bytes gather_rows_scaled must move for x (..., Ns, Nb) and the
    tables src/s (n2, Na), t (n2, Nb): the bound, out (..., n2, Na, Nb)
    written once, each distinct source row of the valid (s != 0) entries
    read once per state and the tables read once (src as the card's
    int32); and, where x does not fit half the L2, the re-read floor: the
    bound plus every valid entry's source row read again past its first
    read, which a kernel reading each entry's row from memory must move
    (where x fits, the re-reads are L2 reads: None).  Entries with s = 0
    read no row of x."""
    Ns, Nb = x.shape[-2:]
    B = x.numel() // max(1, Ns * Nb)
    n2, Na = src.shape
    item = x.element_size()
    rows = src[s != 0]
    distinct = int(torch.unique(rows).numel())
    row = Nb * item
    bound = (B * n2 * Na * row + B * distinct * row
             + n2 * Na * (4 + s.element_size())
             + t.numel() * t.element_size())
    if two_spin_in_l2(B, Ns, Nb, item):
        return RowsBytes(bound, None)
    return RowsBytes(bound, bound + B * (int(rows.numel()) - distinct) * row)


# ---- lists and launch plan of gather_reduce_cols ---------------------------

#: entries per group of gather_reduce_cols' lists: one warp's loads
COLS_GROUP = 32
#: output columns per tile of the lists: COLS_TILE where the maps have at
#: least two such tiles of columns, else COLS_TILE_NARROW (or the width
#: rounded up to a warp, where that is less)
COLS_TILE, COLS_TILE_NARROW = 256, 64
#: gather_reduce_cols' plan: output rows per warp, list groups per step,
#: warps per block (the kernel takes rows 1, 2, 4, 8, unroll 2, 4, 8 with
#: rows * unroll <= 32, and at most 8 warps)
COLS_ROWS, COLS_UNROLL, COLS_WARPS = 2, 4, 4
# warps the grid should hold before rows per warp stop shrinking: 8 per
# SM of the H100's 132
_COLS_FILL = 8 * 132


def cols_tile(Nc):
    """The lists' default tile for Nc output columns.  Swept on an H100
    (scripts/sweep_reduce_cols.py, f64, the wrapper's other choices
    fixed): at (10e,10o) (Nc = 252, B = 5) 64 columns beat 256 (0.0656
    against 0.0889 ms: four tiles give the grid four times the warps and
    each warp a walk a quarter as long); from (12e,12o) (Nc = 924) on 256
    was the best tile or within 0.5% of it (512 pads less but holds
    fewer warps per SM)."""
    if Nc >= 2 * COLS_TILE:
        return COLS_TILE
    return min(COLS_TILE_NARROW, _warps(Nc))


class ColLists(NamedTuple):
    """gather_reduce_cols' compacted tables of (src, s) (n2, Nc): per tile
    of ``tile`` output columns, the valid (s != 0) entries in increasing
    pair k (in increasing column within a pair), each pair's run padded
    to whole groups of COLS_GROUP entries with sign 0 (src 0, col 0)."""
    tile: int
    n2: int
    Nc: int
    src: torch.Tensor    # (E,) int32 source column
    col: torch.Tensor    # (E,) int16 output column within the tile
    sgn: torch.Tensor    # (E,) int8 sign, +-1 (0: padding)
    pair: torch.Tensor   # (E // COLS_GROUP,) int32 pair of each group
    start: torch.Tensor  # (tiles + 1,) int32 first group of each tile


def reduce_cols_lists(src, s, tile=None):
    """The ``ColLists`` of the tables src (n2, Nc) and s (n2, Nc, signs +-1
    or 0 in any dtype; ValueError otherwise), on their device; ``tile``
    defaults to ``cols_tile(Nc)`` columns."""
    n2, Nc = src.shape
    tile = cols_tile(Nc) if tile is None else int(tile)
    if not 1 <= tile <= 32767:
        raise ValueError(f"gather_reduce_cols: a tile of {tile} columns")
    if not bool(((s == 0) | (s == 1) | (s == -1)).all()):
        raise ValueError("gather_reduce_cols: the card's kernel takes "
                         "signs +-1 or 0 in s")
    dev = src.device
    tiles = -(-Nc // tile)
    valid = torch.zeros((n2, tiles * tile), dtype=torch.bool, device=dev)
    valid[:, :Nc] = s != 0
    valid = valid.view(n2, tiles, tile)
    groups = (valid.sum(-1) + COLS_GROUP - 1) // COLS_GROUP  # (n2, tiles)
    per = groups.T.reshape(-1)  # groups of (tile, k), tile-major
    first = (torch.cumsum(per, 0) - per).view(tiles, n2)
    rank = torch.cumsum(valid, -1) - 1
    k, tl, c = torch.nonzero(valid, as_tuple=True)
    pos = first[tl, k] * COLS_GROUP + rank[k, tl, c]
    n_ent = int(per.sum()) * COLS_GROUP
    cols = tl * tile + c
    lsrc = torch.zeros(n_ent, dtype=torch.int32, device=dev)
    lsrc[pos] = src[k, cols].to(torch.int32)
    lcol = torch.zeros(n_ent, dtype=torch.int16, device=dev)
    lcol[pos] = c.to(torch.int16)
    lsgn = torch.zeros(n_ent, dtype=torch.int8, device=dev)
    lsgn[pos] = s[k, cols].to(torch.int8)
    pair = torch.repeat_interleave(
        torch.arange(n2, dtype=torch.int32, device=dev).repeat(tiles), per)
    start = torch.zeros(tiles + 1, dtype=torch.int32, device=dev)
    start[1:] = torch.cumsum(groups.sum(0), 0)
    return ColLists(tile, n2, Nc, lsrc, lcol, lsgn, pair, start)


class ReduceColsPlan(NamedTuple):
    rows: int     # output rows per warp
    unroll: int   # list groups per step (rows * unroll Y loads in flight)
    warps: int    # warps per block


def plan_reduce_cols(B, Na, Nc, tile, itemsize):
    """gather_reduce_cols' launch plan.  A warp owns ``rows`` output rows of
    one column tile (COLS_ROWS, halved while the grid holds fewer than
    _COLS_FILL warps, or while one warp's rows x tile accumulators exceed
    a block's shared memory) and takes ``unroll`` list groups per step;
    a block packs up to COLS_WARPS warps within its shared memory.
    (Swept on an H100 with scripts/sweep_reduce_cols.py over rows 1-8,
    unroll 2-8 and 2-8 warps at tiles of 32-512 columns: 2 rows, 4 groups
    and 4 warps were within 1% of the best plan at the (10e,10o),
    (12e,12o), (14e,14o) and (16e,16o) shapes; every plan of a shape ran
    within 7% of the best from (12e,12o) on, all near the rate at which
    the card fetches the 128-byte lines that the valid entries touch.)
    Raises ValueError when one row of a tile does not fit a block's shared
    memory."""
    if tile * itemsize > _BLOCK_SMEM:
        raise ValueError(f"gather_reduce_cols: a tile of {tile} columns "
                         f"does not fit a block's shared memory")
    tiles = -(-Nc // tile)
    rows = COLS_ROWS
    while rows > 1 and (rows * tile * itemsize > _BLOCK_SMEM
                        or B * tiles * -(-Na // rows) < _COLS_FILL):
        rows //= 2
    unroll = min(COLS_UNROLL, 32 // rows)
    warps = max(1, min(COLS_WARPS, -(-Na // rows),
                       _BLOCK_SMEM // (rows * tile * itemsize)))
    return ReduceColsPlan(rows, unroll, warps)


# ---- tables and launch plan of gather_two_spin ----------------------------

#: the most threads per block gather_two_spin takes, and the bytes of the
#: lines its stores start on where rows are no whole 32-byte sectors
TWO_SPIN_BLOCK = 1024
TWO_SPIN_LINE = 128
#: bytes of one pair's beta tables above which, in f32, each warp copies
#: its columns into shared memory a pair ahead
TWO_SPIN_STAGE = 16 * 1024
# the most dynamic shared memory one block can use on Hopper (227 KB)
_BLOCK_SMEM = 232448
# the H100's L2
_L2_BYTES = 50 * 1024 * 1024
# the widest grid whose beta source columns fit int16
_INT16_COLS = 32767


class TwoSpinTables(NamedTuple):
    """gather_two_spin's compact tables on the card: each sign and parity
    pair packed into one int8 code, (sign + 1) | (parity + 1) << 2, and
    the beta source columns in int16 where Nb <= 32767 (3 bytes per beta
    entry, where the dense tables take 6).  The beta rows are padded to a
    multiple of 16 columns (source 0, sign 0), so that each pair's row
    starts on a 16-byte boundary, where the kernel copies it into shared
    memory in 16-byte pieces."""
    srcA: torch.Tensor   # (n2, Na) int32 alpha source row
    codeA: torch.Tensor  # (n2, Na) int8 code of (sgnA, tA)
    srcB: torch.Tensor   # (n2, Nbp) int16 (int32 past 32767) source column
    codeB: torch.Tensor  # (n2, Nbp) int8 code of (sgnB, tB)


def _code(sign, parity):
    for nm, v in (("sign", sign), ("parity", parity)):
        if not bool(((v == 0) | (v == 1) | (v == -1)).all()):
            raise ValueError(f"gather_two_spin: the card's kernel takes "
                             f"{nm} values +-1 or 0")
    return ((sign.to(torch.int8) + 1)
            | ((parity.to(torch.int8) + 1) << 2)).contiguous()


def _pad_cols(a, width, value):
    out = a.new_full((a.shape[0], width), value)
    out[:, :a.shape[1]] = a
    return out


def two_spin_tables(srcA, sgnA, tB, srcB, sgnB, tA):
    """The ``TwoSpinTables`` of the dense tables (signs and parities +-1 or
    0 in any dtype; ValueError otherwise), on their device."""
    Nb = srcB.shape[1]
    Nbp = -(-Nb // 16) * 16
    wide = torch.int32 if Nb > _INT16_COLS else torch.int16
    return TwoSpinTables(
        srcA.to(torch.int32).contiguous(), _code(sgnA, tA),
        _pad_cols(srcB.to(wide), Nbp, 0),
        _pad_cols(_code(sgnB, tB), Nbp, 1))


def _decode(code):
    return (code & 3).to(torch.int8) - 1, ((code >> 2) & 3).to(torch.int8) - 1


def two_spin_walk(x, tables, r0, r1):
    """gather_two_spin as the card's kernel reads its compact tables, in
    plain PyTorch: the codes decoded to signs and parities, each element
    (x_alpha * sgnA) * tB + (x_beta * sgnB) * tA; the wrapper's CPU path
    and the reference of the tables' layout."""
    Nb = x.shape[-1]
    sgnA, tA = _decode(tables.codeA)
    sgnB, tB = _decode(tables.codeB[:, :Nb])
    return gather_two_spin_plain(x, tables.srcA.long(), sgnA, tB,
                                 tables.srcB[:, :Nb].long(), sgnB, tA, r0,
                                 r1)


class TwoSpinBytes(NamedTuple):
    bound: int             # Phi once, each row of x it needs once, the
                           # compact tables once
    reread: Optional[int]  # the bound plus every further read of an alpha
                           # source row; None where x fits half the L2


def two_spin_in_l2(B, Na, Nb, itemsize):
    """True where all of x (B states of an (Na, Nb) grid) fits half the
    L2, so re-reading a row of x is an L2 read (gather_two_spin's and
    gather_rows_scaled's x alike)."""
    return B * Na * Nb * itemsize <= _L2_BYTES // 2


def two_spin_bytes(x, tables, r0, r1):
    """Bytes gather_two_spin must move for grid rows [r0, r1) of x (...,
    Na, Nb) with its compact ``tables``: the bound, Phi written once, each
    row of x that it reads read once (the valid alpha source rows of the
    window and the window's own rows, for the beta half) and the tables it
    reads once (the window's alpha source and code, 5 bytes an entry, and
    the padded beta rows, the source column's bytes plus one code byte an
    entry); and, where x does not fit half the L2, the re-read floor: the
    bound plus every valid alpha entry's source row read again past its
    first read, which a kernel reading each entry's row from memory must
    move (where x fits, the re-reads are L2 reads and there is no such
    floor: None)."""
    Na, Nb = x.shape[-2:]
    B = x.numel() // (Na * Nb)
    n2, Nbp = tables.srcB.shape
    row = Nb * x.element_size()
    valid = _decode(tables.codeA[:, r0:r1])[0] != 0
    src = tables.srcA[:, r0:r1][valid].long()
    rows = torch.cat([src, torch.arange(r0, r1, device=src.device)])
    alpha = tables.srcA.element_size() + tables.codeA.element_size()
    beta = tables.srcB.element_size() + tables.codeB.element_size()
    bound = (B * n2 * (r1 - r0) * row + B * int(torch.unique(rows).numel())
             * row + n2 * ((r1 - r0) * alpha + Nbp * beta))
    if two_spin_in_l2(B, Na, Nb, x.element_size()):
        return TwoSpinBytes(bound, None)
    again = int(src.numel()) - int(torch.unique(src).numel())
    return TwoSpinBytes(bound, bound + B * again * row)


class TwoSpinPlan(NamedTuple):
    vec: int      # elements per load and store along j (16, 8 or 4 bytes)
    threads: int  # threads per block, a whole number of warps
    pairs: int    # pairs per block
    staged: int   # 1: each warp copies its beta table columns into shared
                  # memory a pair ahead; 0: the tables are read in memory
    line: int     # bytes of the line each row's stores start on


def two_spin_unroll(vec, itemsize):
    """Column slots one lane of gather_two_spin takes per step (the
    kernel's two_spin_unroll): 64 bytes of the row in flight."""
    return max(1, 64 // (vec * itemsize))


def two_spin_smem(Nb, n2, itemsize, plan, idx_bytes=2):
    """Dynamic shared memory of one gather_two_spin block: the row, its
    alpha entries for its pairs and, staged, two buffers of each warp's
    table columns (the kernel's two_spin_smem)."""
    line = plan.line // itemsize
    slots = Nb // plan.vec + line // plan.vec
    step = two_spin_unroll(plan.vec, itemsize)
    rounds = -(-slots // (step * plan.threads))
    width = -(-(32 * step * rounds * plan.vec + line + 16) // 16) * 16
    tables = (2 * width * (plan.threads // 32) * (idx_bytes + 1)
              if plan.staged else 0)
    return (-(-Nb * itemsize // 16) * 16
            + -(-4 * min(plan.pairs, n2) // 16) * 16 + tables)


def two_spin_threads(slots, step):
    """Threads that cover ``slots`` column slots, ``step`` a thread, in
    the fewest rounds of at most TWO_SPIN_BLOCK threads, each round
    equally full."""
    rounds = -(-slots // (step * TWO_SPIN_BLOCK))
    return _warps(-(-slots // (step * rounds)))


def plan_two_spin(B, Na, R, Nb, n2, itemsize, align=16):
    """gather_two_spin's launch plan for B states of an (Na, Nb) grid, R
    rows a launch.  A block stages one row (state, grid row) of x; its
    threads cover the row's column slots (``two_spin_unroll`` a lane, the
    row's stores from a 32-byte sector where rows are whole sectors, else
    a 128-byte line) in equal rounds of at most TWO_SPIN_BLOCK; it takes 5
    pairs where all of x fits half the L2 (staging a row is then an L2
    read, and more blocks keep the SMs busy), else 40 (its staged row is
    then 2.5% of what it writes); in f32, where a pair's beta tables pass
    TWO_SPIN_STAGE bytes ((16e,16o)), its warps copy their columns of them
    into shared memory a pair ahead (an f32 row has twice the columns of
    an f64 row per byte written, so its tables are twice the share of the
    traffic) where the block still fits its shared memory, else the
    threads read them in memory.  Loads and stores are 16 bytes wide
    where Nb and the pointers' ``align`` (bytes) allow, else 8 (f32 at
    (16e,16o): Nb = 12870 is even, no multiple of 4) or one element.
    (Swept on an H100 with scripts/sweep_two_spin.py over threads,
    pairs, staging and lines at the (10e,10o) to (16e,16o) shapes:
    within 2% of the best plan at each.)  Raises ValueError when one row
    does not fit a block's shared memory (Nb above 29,036 in f64 at n2 =
    256, 58,072 in f32)."""
    vec = 16 // itemsize
    while vec > 1 and (Nb % vec or align % (vec * itemsize)):
        vec //= 2
    idx = 4 if Nb > _INT16_COLS else 2
    line = 32 if Nb * itemsize % 32 == 0 else TWO_SPIN_LINE
    slots = Nb // vec + line // (vec * itemsize)
    threads = two_spin_threads(slots, two_spin_unroll(vec, itemsize))
    pairs = min(n2, 5 if two_spin_in_l2(B, Na, Nb, itemsize) else 40)
    Nbp = -(-Nb // 16) * 16
    staged = int(itemsize == 4 and Nbp * (idx + 1) > TWO_SPIN_STAGE)
    plan = TwoSpinPlan(vec, threads, pairs, staged, line)
    if two_spin_smem(Nb, n2, itemsize, plan, idx) > _BLOCK_SMEM:
        plan = plan._replace(staged=0)   # the row alone, where it fits
    if two_spin_smem(Nb, n2, itemsize, plan, idx) > _BLOCK_SMEM:
        raise ValueError(f"gather_two_spin: a row of {Nb} elements "
                         f"({Nb * itemsize} bytes) and its tables do not "
                         f"fit a block's {_BLOCK_SMEM} bytes of shared "
                         f"memory")
    return plan


# ---- wrappers --------------------------------------------------------------


def _check(name, a, src, s, t, lead_ndim, t_axis=-1):
    """Validate the kernel operands (t is (n2, a.shape[t_axis])); returns
    (B, a.shape[-2], a.shape[-1])."""
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
    n2 = src.shape[0]
    if s.shape != src.shape:
        raise ValueError(f"{name}: s shape {tuple(s.shape)} != src shape "
                         f"{tuple(src.shape)}")
    if t.shape != (n2, a.shape[t_axis]):
        raise ValueError(f"{name}: t shape {tuple(t.shape)} != "
                         f"{(n2, a.shape[t_axis])}")
    if lead_ndim == 3 and a.shape[-3] != n2:
        raise ValueError(f"{name}: operand has {a.shape[-3]} pairs, maps "
                         f"{n2}")
    B = 1
    for d in a.shape[:a.dim() - lead_ndim]:
        B *= d
    return B, a.shape[-2], a.shape[-1]


def _launch(kern, dtype, *args):
    with _observe.span("kernel", kern):
        LIBRARY.launch(f"grid_{kern}_{_SUFFIX[dtype]}", *args)
    LAUNCHES[kern] += 1


def _on_card(name, a):
    """True for a CPU operand's plain path, False for the card; raises on
    any other device."""
    if a.device.type == "cpu":
        return False
    if a.device.type != "cuda":
        raise NotImplementedError(f"{name} on {a.device}")
    return True


def _ptrs(*tensors):
    return [v.data_ptr() for v in tensors]


def _stream(a):
    return torch.cuda.current_stream(a.device).cuda_stream


def gather_rows_scaled(x, src, s, t, plan=None):
    """out[..., k, i, j] = (x[..., src[k, i], j] * s[k, i]) * t[k, j].

    x (..., Ns, Nb); src (n2, Na) (int32 on the card); s (n2, Na);
    t (n2, Nb) -> (..., n2, Na, Nb).  Invalid entries carry src = 0,
    s = 0.  CPU tensors take the plain version; CUDA tensors the kernel,
    which equals it as values for finite x.  ``plan`` (a ``RowsPlan``)
    replaces ``plan_rows_scaled``'s, for sweeps."""
    if not _on_card("gather_rows_scaled", x):
        return gather_rows_scaled_plain(x, src, s, t)
    B, Ns, Nb = _check("gather_rows_scaled", x, src, s, t, 2)
    n2, Na = src.shape
    out = torch.empty(x.shape[:-2] + (n2, Na, Nb), dtype=x.dtype,
                      device=x.device)
    if plan is None:
        plan = plan_rows_scaled(B, Ns, Na, Nb, n2, x.element_size(),
                                _align(x, t))
    _launch("gather_rows_scaled", x.dtype, *_ptrs(x, src, s, t, out), B, n2,
            Ns, Na, Nb, *plan, *rows_divisor(max(1, Nb)), _stream(x))
    return out


def _check_two_spin(x, tables):
    """Validate gather_two_spin's operands on the card: x (..., Na, Nb) in
    f64 or f32 and the compact tables of its grid (``TwoSpinTables``: the
    beta ones padded to 16 columns, int16 sources up to 32,767 columns),
    each contiguous, on x's device, starting on 16 bytes; returns (B, Na,
    Nb, n2)."""
    name = "gather_two_spin"
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {x.dtype} is not float64/float32")
    if x.dim() < 2:
        raise ValueError(f"{name}: x needs at least 2 dims")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x is not contiguous")
    Na, Nb = x.shape[-2:]
    n2 = tables.srcA.shape[0]
    Nbp = -(-Nb // 16) * 16
    wide = torch.int32 if Nb > _INT16_COLS else torch.int16
    for nm, dt, width in (("srcA", torch.int32, Na), ("codeA", torch.int8, Na),
                          ("srcB", wide, Nbp), ("codeB", torch.int8, Nbp)):
        v = getattr(tables, nm)
        if v.dtype != dt:
            raise TypeError(f"{name}: table {nm} must be {dt}, got "
                            f"{v.dtype}")
        if (v.shape != (n2, width) or v.device != x.device
                or not v.is_contiguous() or v.data_ptr() % 16):
            raise ValueError(f"{name}: table {nm} {tuple(v.shape)} on "
                             f"{v.device} must be a contiguous {(n2, width)} "
                             f"tensor on {x.device}, on 16 bytes")
    return x.numel() // max(1, Na * Nb), Na, Nb, n2


def _check_window(x, r0, r1):
    if not 0 <= r0 < r1 <= x.shape[-2]:
        raise ValueError(f"gather_two_spin: window [{r0}, {r1}) is not "
                         f"inside the {x.shape[-2]} grid rows")


def _align(*tensors):
    """The largest power of two, at most 16, dividing every address."""
    a = 16
    for v in tensors:
        while v.data_ptr() % a:
            a //= 2
    return a


def gather_two_spin(x, tables, r0, r1, plan=None):
    """Both spin halves of Phi = E_pq x over grid rows [r0, r1):

        out[..., k, m, j] = (x[..., srcA[k, r0+m], j] * sgnA[k, r0+m])
                            * tB[k, j]
                          + (x[..., r0+m, srcB[k, j]] * sgnB[k, j])
                            * tA[k, r0+m]

    x (..., Na, Nb); ``tables`` the grid's ``TwoSpinTables``
    (``GridMaps.two_spin_tables()``, built once per maps) -> (..., n2,
    r1 - r0, Nb).  Invalid entries carry src = 0, sign 0.  CPU tensors
    take the tables' plain walk (``two_spin_walk``); CUDA tensors the
    kernel, which equals it as values.  ``plan`` (a ``TwoSpinPlan``)
    replaces ``plan_two_spin``'s, for sweeps."""
    _check_window(x, r0, r1)
    if not _on_card("gather_two_spin", x):
        return two_spin_walk(x, tables, r0, r1)
    B, Na, Nb, n2 = _check_two_spin(x, tables)
    R = r1 - r0
    out = torch.empty(x.shape[:-2] + (n2, R, Nb), dtype=x.dtype,
                      device=x.device)
    if plan is None:
        plan = plan_two_spin(B, Na, R, Nb, n2, x.element_size(), _align(x))
    _launch("gather_two_spin", x.dtype,
            *_ptrs(x, tables.srcA, tables.codeA, tables.srcB, tables.codeB,
                   out), B, n2, Na, Nb, tables.srcB.shape[1], r0, R,
            tables.srcB.element_size(), *plan, _stream(x))
    return out


def gather_reduce(Y, src, s, t):
    """out[..., i, j] = sum_k (Y[..., k, src[k, i], j] * s[k, i]) * t[k, j].

    Y (..., n2, Ns, Nb); src/s (n2, Na); t (n2, Nb) -> (..., Na, Nb).
    CPU tensors take the plain version; CUDA tensors the kernel."""
    if not _on_card("gather_reduce", Y):
        return gather_reduce_plain(Y, src, s, t)
    B, Ns, Nb = _check("gather_reduce", Y, src, s, t, 3)
    n2, Na = src.shape
    out = torch.empty(Y.shape[:-3] + (Na, Nb), dtype=Y.dtype,
                      device=Y.device)
    plan = plan_reduce(B, Na, Nb, n2, Y.element_size(),
                       Y.data_ptr() % 16 == 0 and t.data_ptr() % 16 == 0)
    _launch("gather_reduce", Y.dtype, *_ptrs(Y, src, s, t, out), B, n2, Ns,
            Na, Nb, *plan, _stream(Y))
    return out


def gather_reduce_cols(Y, src, s, t, out=None, lists=None, plan=None):
    """out[..., a, c] = sum_k (Y[..., k, a, src[k, c]] * s[k, c]) * t[k, a].

    Y (..., n2, Na, Ns); src/s (n2, Nc); t (n2, Na) -> (..., Na, Nc):
    ``gather_reduce`` of the transposed Y, transposed back, read in
    place.  With ``out`` (a contiguous (..., Na, Nc) tensor) the sum is
    added to it in place and out is returned: out + sum, the bits of
    ``out += gather_reduce_cols(...)``.  CPU tensors take the plain
    version; CUDA tensors the kernel, which walks the compacted lists of
    (src, s) (``reduce_cols_lists``: s must hold signs +-1 or 0 there):
    ``lists`` passes them (``GridMaps.col_lists()``, built once per
    maps), None builds them here.  ``plan`` (a ``ReduceColsPlan``) replaces
    ``plan_reduce_cols``'s, for sweeps."""
    if not _on_card("gather_reduce_cols", Y):
        return gather_reduce_cols_plain(Y, src, s, t, out)
    B, Na, Ns = _check("gather_reduce_cols", Y, src, s, t, 3, t_axis=-2)
    n2, Nc = src.shape
    shape = Y.shape[:-3] + (Na, Nc)
    if lists is None:
        lists = reduce_cols_lists(src, s)
    if (lists.n2, lists.Nc) != (n2, Nc) or lists.src.device != Y.device:
        raise ValueError(f"gather_reduce_cols: lists of {lists.n2} pairs x "
                         f"{lists.Nc} columns on {lists.src.device} for "
                         f"tables {tuple(src.shape)} on {Y.device}")
    if out is None:
        out = torch.empty(shape, dtype=Y.dtype, device=Y.device)
        add = 0
    elif (out.dtype != Y.dtype or out.device != Y.device
          or not out.is_contiguous() or out.shape != shape):
        raise ValueError(f"gather_reduce_cols: out {tuple(out.shape)} "
                         f"{out.dtype} must be a contiguous {tuple(shape)} "
                         f"{Y.dtype} tensor on {Y.device}")
    else:
        add = 1
    if plan is None:
        plan = plan_reduce_cols(B, Na, Nc, lists.tile, Y.element_size())
    _launch("gather_reduce_cols", Y.dtype,
            *_ptrs(Y, lists.src, lists.col, lists.sgn, lists.pair,
                   lists.start, t, out), B, n2, Na, Ns, Nc, lists.tile,
            *plan, add, _stream(Y))
    return out


def scatter_rows(acc, Y, src, s, t, dst, dsg, r0):
    """acc[..., i, j] += sum_k (Y[..., k, src[k, i] - r0, j] * s[k, i])
    * t[k, j] over the k whose src[k, i] lies in [r0, r0 + R), in place;
    returns acc.

    The alpha half of the hosted H-apply: Y (..., n2, R, Nb) holds the
    grid rows [r0, r0 + R) in SOURCE rows; src/s (n2, Na) are the alpha
    maps, dst/dsg (n2, Ns) their inverse (``grid.inverse_alpha_maps``),
    t (n2, Nb), acc (..., Na, Nb).  A pair's row map is a partial
    injection, so this equals the scatter acc[..., dst[k, r0 + m], j] +=
    (Y[..., k, m, j] * dsg[k, r0 + m]) * t[k, j].  CPU tensors take the
    plain version (``index_add_`` through dst/dsg); CUDA tensors the
    kernel, which gathers through src/s, sums in increasing k without
    atomics and adds once to acc (the same bits on every launch)."""
    if not _on_card("scatter_rows", Y):
        return scatter_rows_plain(acc, Y, src, s, t, dst, dsg, r0)
    B, R, Nb = _check("scatter_rows", Y, src, s, t, 3)
    n2, Na = src.shape
    if (acc.dtype != Y.dtype or acc.device != Y.device
            or not acc.is_contiguous()
            or acc.shape != Y.shape[:-3] + (Na, Nb)):
        raise ValueError(f"scatter_rows: acc {tuple(acc.shape)} "
                         f"{acc.dtype} must be a contiguous "
                         f"{tuple(Y.shape[:-3] + (Na, Nb))} {Y.dtype} tensor "
                         f"on {Y.device}")
    if (dst.shape != dsg.shape or dst.shape[0] != n2 or r0 < 0
            or r0 + R > dst.shape[1]):
        raise ValueError(f"scatter_rows: window [{r0}, {r0 + R}) and inverse "
                         f"maps {tuple(dst.shape)}, {tuple(dsg.shape)} do not "
                         f"match {n2} pairs")
    plan = plan_reduce(B, Na, Nb, n2, Y.element_size(),
                       all(v.data_ptr() % 16 == 0 for v in (Y, t, acc)))
    _launch("scatter_rows", Y.dtype, *_ptrs(Y, src, s, t, acc), B, n2, R, Na,
            Nb, *plan, r0, _stream(Y))
    return acc
