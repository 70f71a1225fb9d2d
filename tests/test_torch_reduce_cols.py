"""The column form's compacted lists and add mode against the JAX package.

On the card ``gather_reduce_cols`` walks lists built once per maps
(``grid_kernels.reduce_cols_lists``, cached by ``GridMaps.col_lists``):
per tile of output columns, the valid (k, c) entries of the beta maps in
increasing pair k, each pair's run padded to whole groups of 32 with sign
0.  Here, on the CPU, the lists of real maps (full, pair-sliced and
transposed) are checked entry by entry, and a plain PyTorch walk of them
(``gather_reduce_cols_walk``, the kernel's order of sums) is held against
``gather_reduce_cols_plain`` and the JAX package's Pallas
``gather_reduce`` on the transposed Y (interpret mode, as
tests/test_pallas_grid.py runs it), from seeded numpy inputs: 1e-13 of
max |ref| in f64, 1e-5 in f32 (the sums run in other orders).  The add
mode (``out=``) equals out + the plain result bit for bit.  The CUDA
kernel is held against the plain version on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from auto_oo_tpu.ops import pallas_grid as jpg
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.ops import grid, grid_kernels as gk


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's default device is the card; these CPU tests ask for the
    CPU, and restore the default after the module."""
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


SECTORS = [(4, 4), (5, 5), (6, 6), (5, (3, 2))]
# the maps the routes hand the column form: all pairs, a pair block of
# the streamed route, and the transposed maps of the backward pass
VARIANTS = ["full", "slice", "transposed"]
TOL = {np.float64: 1e-13, np.float32: 1e-5}


def _variant(ncas, nelecas, which):
    gm = grid.build_grid_maps(ncas, nelecas)
    if which == "slice":
        return grid.pair_slice(gm, 3, gm.n2 - 4)
    if which == "transposed":
        return gm.transposed()
    return gm


def _tables(gm, dtype):
    """(srcB, sgnB, tA) of ``gm`` in ``dtype`` (int64 src: the CPU's)."""
    _, _, _, srcB, sgnB, tA = gm.tables(torch.zeros((), dtype=dtype))
    return srcB, sgnB, tA


@pytest.mark.parametrize("ncas,nelecas", SECTORS)
@pytest.mark.parametrize("which", VARIANTS)
@pytest.mark.parametrize("tile", [None, 32, 8])
def test_lists_hold_each_valid_entry_once(ncas, nelecas, which, tile):
    """Every valid (k, c) of the beta maps once, with its source column
    and sign, tile by tile in increasing pair k (and column within a
    pair), each pair's run padded to whole groups of 32 by entries of
    sign 0, src 0 and column 0."""
    gm = _variant(ncas, nelecas, which)
    lists = gk.reduce_cols_lists(gm.srcB, gm.sgnB, tile)
    n2, Nc = gm.n2, gm.Nb
    G = gk.COLS_GROUP
    assert lists.tile == (tile or gk.cols_tile(Nc))
    assert (lists.n2, lists.Nc) == (n2, Nc)
    assert (lists.src.dtype, lists.col.dtype, lists.sgn.dtype,
            lists.pair.dtype, lists.start.dtype) == (
        torch.int32, torch.int16, torch.int8, torch.int32, torch.int32)
    tiles = -(-Nc // lists.tile)
    start = lists.start.tolist()
    assert len(start) == tiles + 1 and start[0] == 0
    assert start[-1] * G == lists.src.numel() == lists.sgn.numel()
    assert lists.pair.numel() == start[-1]
    srcB, sgnB = gm.srcB.long(), gm.sgnB
    seen = torch.zeros((n2, Nc), dtype=torch.int64)
    for tl in range(tiles):
        pairs = lists.pair[start[tl]:start[tl + 1]].long()
        # pair order within the tile, and one run of groups per pair
        assert bool((pairs[1:] >= pairs[:-1]).all())
        lo, hi = tl * lists.tile, min(Nc, (tl + 1) * lists.tile)
        for k in range(n2):
            g = (pairs == k).nonzero().flatten() + start[tl]
            n_valid = int((sgnB[k, lo:hi] != 0).sum())
            assert g.numel() == -(-n_valid // G)
            e = (g[:, None] * G + torch.arange(G)).flatten()
            live = lists.sgn[e] != 0
            assert int(live.sum()) == n_valid
            # the live entries lead, in increasing column; the rest pad
            assert bool(live[:n_valid].all())
            assert not bool(lists.src[e][~live].any())
            assert not bool(lists.col[e][~live].any())
            c = lo + lists.col[e][live].long()
            assert bool((c[1:] > c[:-1]).all()) and bool((c < hi).all())
            assert torch.equal(lists.src[e][live].long(), srcB[k, c])
            assert torch.equal(lists.sgn[e][live], sgnB[k, c])
            seen[k, c] += 1
    assert torch.equal(seen, (sgnB != 0).long())


def test_col_lists_cached_per_maps():
    """GridMaps.col_lists builds once per maps object; a pair slice and
    the transposed maps hold their own lists, of their own pairs."""
    gm = grid.build_grid_maps(4, 4)
    lists = gm.col_lists()
    assert gm.col_lists() is lists
    sl, tr = grid.pair_slice(gm, 2, 9), gm.transposed()
    assert sl.col_lists() is sl.col_lists()
    assert sl.col_lists().n2 == 7 and tr.col_lists().n2 == gm.n2
    assert torch.equal(tr.col_lists().src,
                       gk.reduce_cols_lists(tr.srcB, tr.sgnB).src)


@pytest.mark.parametrize("ncas,nelecas", SECTORS)
@pytest.mark.parametrize("which", VARIANTS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_walk_matches_plain_and_pallas(ncas, nelecas, which, dtype):
    """The plain walk of the lists (a tile of 32 columns: several tiles
    on every sector here) equals the plain version and the JAX package's
    Pallas gather_reduce on the transposed Y, with a batch of two."""
    gm = _variant(ncas, nelecas, which)
    srcB, sgnB, tA = _tables(gm, torch.float64 if dtype == np.float64
                             else torch.float32)
    rng = np.random.default_rng(ncas + 10 * gm.n2)
    Y = rng.standard_normal((2, gm.n2, gm.Na, gm.Nb)).astype(dtype)
    Yt = torch.from_numpy(Y)
    walk = gk.gather_reduce_cols_walk(
        Yt, gk.reduce_cols_lists(srcB, sgnB, 32), tA)
    plain = gk.gather_reduce_cols_plain(Yt, srcB, sgnB, tA)
    ref = np.swapaxes(np.asarray(jpg.gather_reduce(
        jnp.swapaxes(jnp.asarray(Y), -1, -2), jnp.asarray(srcB.numpy()),
        jnp.asarray(sgnB.numpy()), jnp.asarray(tA.numpy()),
        interpret=True)), -1, -2)
    assert walk.shape == plain.shape == ref.shape == (2, gm.Na, gm.Nb)
    assert walk.dtype == plain.dtype == Yt.dtype
    scale = np.abs(ref).max()
    np.testing.assert_allclose(walk.numpy(), plain.numpy(), rtol=0,
                               atol=TOL[dtype] * scale)
    np.testing.assert_allclose(walk.numpy(), ref, rtol=0,
                               atol=TOL[dtype] * scale)


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_add_mode_equals_out_plus_plain(lead, dtype):
    """gather_reduce_cols(..., out=o) adds the sum to o in place and
    returns o: o + the plain result, bit for bit, on pair-sliced (6e,6o)
    maps."""
    gm = grid.pair_slice(grid.build_grid_maps(6, 6), 5, 29)
    srcB, sgnB, tA = _tables(gm, dtype)
    rng = np.random.default_rng(31)
    Y = torch.from_numpy(rng.standard_normal(
        lead + (gm.n2, gm.Na, gm.Nb))).to(dtype)
    o0 = torch.from_numpy(rng.standard_normal(lead + (gm.Na, gm.Nb))).to(
        dtype)
    out = o0.clone()
    got = gk.gather_reduce_cols(Y, srcB, sgnB, tA, out=out,
                                lists=gm.col_lists())
    assert got is out
    assert torch.equal(out, o0 + gk.gather_reduce_cols_plain(Y, srcB, sgnB,
                                                             tA))
    assert torch.equal(gk.gather_reduce_cols_plain(Y, srcB, sgnB, tA,
                                                   out=o0.clone()), out)


def test_lists_take_signs_only():
    """The card's lists hold int8 signs: other scales raise."""
    src = torch.zeros((3, 5), dtype=torch.int32)
    s = torch.tensor([[1.0, 0.0, -1.0, 1.0, 0.0]] * 3)
    lists = gk.reduce_cols_lists(src, s)
    assert int((lists.sgn != 0).sum()) == 9
    with pytest.raises(ValueError, match="signs"):
        gk.reduce_cols_lists(src, 0.5 * s)
    with pytest.raises(ValueError, match="tile"):
        gk.reduce_cols_lists(src, s, 0)


@pytest.mark.parametrize("Nc,tile", [
    (6, 32), (20, 32), (36, 64), (252, 64),   # (10e,10o): 64 columns
    (511, 64), (512, 256), (924, 256),        # (12e,12o) and up: 256
    (3432, 256), (12870, 256)])
def test_cols_tile(Nc, tile):
    """The lists' default tile: 256 columns where the maps have two such
    tiles, else 64 (a warp's multiple below that)."""
    assert gk.cols_tile(Nc) == tile


@pytest.mark.parametrize("case,plan", [
    # (B, Na, Nc, tile, itemsize): the main path's calls
    ((5, 252, 252, 64, 8), (2, 4, 4)),        # (10e,10o) f64, B = 5
    ((1, 924, 924, 256, 8), (2, 4, 4)),       # (12e,12o) f64
    ((1, 3432, 3432, 256, 8), (2, 4, 4)),     # (14e,14o) pair block
    ((1, 495, 12870, 256, 8), (2, 4, 4)),     # (16e,16o) hosted chunk
    ((1, 495, 12870, 256, 4), (2, 4, 4)),     # the same in f32
    ((1, 5, 20, 32, 8), (1, 4, 4)),           # a small grid: one row a warp
    ((1, 100, 20000, 8192, 8), (1, 4, 3)),    # shared memory caps warps
])
def test_plan_reduce_cols(case, plan):
    """gather_reduce_cols' plan: rows per warp halved until the grid holds
    _COLS_FILL warps, no more warps than rows, each block within an
    H100's 227 KB of shared memory."""
    p = gk.plan_reduce_cols(*case)
    assert tuple(p) == plan
    B, Na, Nc, tile, item = case
    assert p.rows * p.unroll <= 32 and 1 <= p.warps <= gk.COLS_WARPS
    assert p.warps * p.rows * tile * item <= 232448
    with pytest.raises(ValueError, match="shared memory"):
        gk.plan_reduce_cols(1, 10, 40000, 30000, 8)
