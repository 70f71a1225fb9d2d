"""The port's CUDA kernels on the card (marker ``cuda``).

The grid-gather kernels and the row-gather mechanism probes against their
plain PyTorch versions (the grid kernels also at the row-streamed route's
row-sliced and pair-sliced shapes; the two-spin Phi kernel on the
(10e,10o) and (12e,12o) maps, windows, pair slices, transposed maps and
ragged random maps), the grid ops (fused and row-streamed) and one
Newton core on the card against the same code on the CPU, the streamed
and the hosted Newton cores against the fused one on the card, the
hosted H-apply's alpha scatter against its plain version, the
full-space route's flat sweeps, E_pq maps and H-apply on the card against
the CPU with a (2e,2o) full-space convergence, mixed precision (the
fused Newton core on the card against the CPU, one f32 launch of
``gather_two_spin`` over a stack of 15 states, the Gram form of the
hosted core against the per-tangent one), the gradient-only pipeline
(the hosted ``energy_and_gradient`` and a (2e,2o) ``gradient_optimization``
on the card against the CPU), the Berry workflow (the Thouless transfer
and a sector loop, launching the fused kernels), the grid S^-, the
iterative Newton solver and the noisy optimizer's CUDA generator on the
card against the CPU, the user-defined states (one spin component of
Phi through ``gather_rows_scaled``, complex grid states through both Phi
kernels, spin-resolved sector RDMs and a complex callable's Newton core
on the card against the CPU), the distributed engines on a one-rank
NCCL group (the row-sharded and hosted x row-sharded engines, the
tangent-sharded and 2-D Newton cores and ``GeometryBatch(mesh=)``
against the single-card path, every collective issued), and failed
builds and launches that raise.  This
file imports neither jax nor the JAX package, so it also runs where jax
is not installed;
tests/conftest.py imports jax, so run it on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a GPU every test skips (from the fixture, never at import).

Tolerances: ``gather_two_spin`` rounds its two products and their sum
one by one in the plain version's order, so it equals the plain version
as values (``torch.equal``) in f64 and f32; ``gather_rows_scaled`` takes
the products in the plain version's order, so f64 agrees to the last
bit (1e-15 relative, 1e-6 in f32); ``gather_reduce`` and
``gather_reduce_cols`` sum the pairs in another order (1e-13 relative in
f64, 1e-5 in f32; the column form equals the plain walk of its compacted
lists as values, ``gather_reduce_cols_walk``, which sums in its order);
``scatter_rows`` adds its window's sum to acc once
where ``index_add_`` adds term by term (1e-14 of max |out| in f64, 1e-6
in f32).  The mechanism probes A, B and C take one product per element,
so they equal their plain version bit for bit; B's and C's plans and
refusals on the card are checked here too.
"""

import numpy as np
import pytest
import torch

import auto_oo_tpu_torch as P
from auto_oo_tpu_torch.ops import cuda_build, grid, grid_hosted
from auto_oo_tpu_torch.ops import grid_kernels as gk
from auto_oo_tpu_torch.ops import gather_mechanisms as gm
from auto_oo_tpu_torch.scripts import experiment_gather_mechanisms as exp
from auto_oo_tpu_torch.scripts import sweep_gate_kernels as sgk
from auto_oo_tpu_torch.simulator import grid_gates

# the kernels of the fused and streamed routes (the hosted route runs
# scatter_rows in place of the row form of gather_reduce)
FUSED_KERNELS = ("gather_two_spin", "gather_reduce", "gather_reduce_cols")

TOL = {torch.float64: {"rows": 1e-15, "reduce": 1e-13},
       torch.float32: {"rows": 1e-6, "reduce": 1e-5}}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape))


def _rel_err(out, ref):
    return float((out - ref).abs().max()) / float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_kernels_match_plain(cuda_device, dtype):
    """Both kernels against their plain versions on the card: real
    (4e,4o) maps (both halves, batched) and a ragged random shape."""
    pm = grid.build_grid_maps(4, 4, device=cuda_device)
    srcA, sgnA, tB, srcB, sgnB, tA = pm.tables(
        torch.zeros((), dtype=dtype, device=cuda_device))
    tol = TOL[dtype]
    for seed, (src, s, t, rows, cols) in enumerate(
            ((srcA, sgnA, tB, pm.Na, pm.Nb), (srcB, sgnB, tA, pm.Nb, pm.Na))):
        x = _rand((3, rows, cols), seed).to(cuda_device, dtype)
        Y = _rand((3, pm.n2, rows, cols), 10 + seed).to(cuda_device, dtype)
        before = dict(gk.LAUNCHES)
        a = gk.gather_rows_scaled(x, src, s, t)
        b = gk.gather_reduce(Y, src, s, t)
        torch.cuda.synchronize()
        assert gk.LAUNCHES["gather_rows_scaled"] == \
            before["gather_rows_scaled"] + 1
        assert gk.LAUNCHES["gather_reduce"] == before["gather_reduce"] + 1
        assert _rel_err(a, gk.gather_rows_scaled_plain(
            x, src.long(), s, t)) <= tol["rows"]
        assert _rel_err(b, gk.gather_reduce_plain(
            Y, src.long(), s, t)) <= tol["reduce"]
    # ragged: Na, Nb not multiples of a warp, invalid (src 0, s 0) entries
    rng = np.random.default_rng(7)
    ns, na, nb, n2 = 11, 13, 17, 5
    src = rng.integers(0, ns, size=(n2, na)).astype(np.int32)
    s = rng.standard_normal((n2, na))
    invalid = rng.random((n2, na)) < 0.3
    src[invalid], s[invalid] = 0, 0.0
    src = torch.from_numpy(src).to(cuda_device)
    s = torch.from_numpy(s).to(cuda_device, dtype)
    t = _rand((n2, nb), 8).to(cuda_device, dtype)
    x = _rand((2, 3, ns, nb), 9).to(cuda_device, dtype)
    Y = _rand((2, n2, ns, nb), 10).to(cuda_device, dtype)
    assert _rel_err(gk.gather_rows_scaled(x, src, s, t),
                    gk.gather_rows_scaled_plain(x, src.long(), s, t)) \
        <= tol["rows"]
    assert _rel_err(gk.gather_reduce(Y, src, s, t),
                    gk.gather_reduce_plain(Y, src.long(), s, t)) \
        <= tol["reduce"]


def _rows_case(ns, na, nb, n2, lead, seed, dtype, device, offset=0):
    """Random gather_rows_scaled operands: non-sign s in (-2, 2), invalid
    (src 0, s 0) entries, src reaching row ns - 1, x (lead, ns, nb) a
    contiguous view ``offset`` elements into its storage."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, ns, size=(n2, na)).astype(np.int32)
    src[0, 0] = ns - 1
    s = rng.uniform(-2.0, 2.0, (n2, na))
    invalid = rng.random((n2, na)) < 0.4
    invalid[0, 0] = False
    src[invalid], s[invalid] = 0, 0.0
    shape = lead + (ns, nb)
    buf = _rand((offset + int(np.prod(shape)),), seed + 1).to(device, dtype)
    x = buf[offset:].view(shape)
    return (x, torch.from_numpy(src).to(device),
            torch.from_numpy(s).to(device, dtype),
            _rand((n2, nb), seed + 2).to(device, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_rows_scaled_equals_plain(cuda_device, dtype):
    """gather_rows_scaled equal to its plain version as values (torch.equal)
    on the card, one launch a call: short rows (Nb = 3 and 14), a ragged
    Nb (17) and an odd one (495), leading dims B = 3, an x view that does
    not start on 16 bytes (one-element loads), non-sign s, invalid
    entries, and an x larger than half the L2 (3432 x 3432, the (14e,14o)
    one-spin Phi's); every plan the kernel takes at a ragged shape (16-,
    8- and 4-byte slots, whether or not they divide Nb); a plan the
    kernel does not take raises."""
    cases = [(19, 23, 3, 6, (), 0), (19, 23, 14, 6, (), 0),
             (11, 13, 17, 5, (3,), 0), (40, 37, 495, 7, (), 0),
             (19, 23, 14, 6, (3,), 1), (19, 23, 16, 6, (), 3),
             (3432, 3432, 3432, 4, (), 0)]
    for seed, (ns, na, nb, n2, lead, offset) in enumerate(cases):
        x, src, s, t = _rows_case(ns, na, nb, n2, lead, seed, dtype,
                                  cuda_device, offset)
        before = gk.LAUNCHES["gather_rows_scaled"]
        out = gk.gather_rows_scaled(x, src, s, t)
        torch.cuda.synchronize()
        assert gk.LAUNCHES["gather_rows_scaled"] == before + 1
        ref = gk.gather_rows_scaled_plain(x, src.long(), s, t)
        assert out.shape == ref.shape == lead + (n2, na, nb)
        assert torch.equal(out, ref), (ns, na, nb, lead, offset)
        del x, out, ref
    x, src, s, t = _rows_case(11, 13, 18, 5, (2,), 9, dtype, cuda_device)
    ref = gk.gather_rows_scaled_plain(x, src.long(), s, t)
    for vec in {1, 2, 16 // x.element_size()}:
        for threads in (32, 128, 512):
            for unroll in gk.ROWS_UNROLLS:
                for order in (0, 1):
                    plan = gk.RowsPlan(vec, threads, unroll, order)
                    out = gk.gather_rows_scaled(x, src, s, t, plan=plan)
                    torch.cuda.synchronize()
                    assert torch.equal(out, ref), plan
    for bad in (gk.RowsPlan(8, 128, 4, 0), gk.RowsPlan(3, 128, 4, 0),
                gk.RowsPlan(2, 1024, 4, 0), gk.RowsPlan(2, 128, 3, 0),
                gk.RowsPlan(2, 128, 4, 2)):
        with pytest.raises(RuntimeError, match="cudaError"):
            gk.gather_rows_scaled(x, src, s, t, plan=bad)


def _reduce_case(ns, na, nb, n2, lead, seed, dtype, device, empty=None,
                 signs=False):
    """Random gather_reduce operands of a ragged shape, with invalid
    (src 0, s 0) entries; ``empty`` names one output row (of the row
    form; a column of the column form) with no valid pair; ``signs``
    makes s +-1 (the column form's kernel takes signs only)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, ns, size=(n2, na)).astype(np.int32)
    s = (rng.choice([-1.0, 1.0], (n2, na)) if signs
         else rng.standard_normal((n2, na)))
    invalid = rng.random((n2, na)) < 0.3
    if empty is not None:
        invalid[:, empty] = True
    src[invalid], s[invalid] = 0, 0.0
    return (_rand(lead + (n2, ns, nb), seed + 1).to(device, dtype),
            torch.from_numpy(src).to(device),
            torch.from_numpy(s).to(device, dtype),
            _rand((n2, nb), seed + 2).to(device, dtype))


def _check_reduce(name, args, tol):
    """One launch of the form ``name`` against its plain version."""
    fn = getattr(gk, name)
    plain = getattr(gk, name + "_plain")
    before = gk.LAUNCHES[name]
    out = fn(*args)
    torch.cuda.synchronize()
    assert gk.LAUNCHES[name] == before + 1, name
    Y, src, s, t = args
    ref = plain(Y, src.long(), s, t)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert _rel_err(out, ref) <= tol, name
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_reduce_forms_match_plain(cuda_device, dtype):
    """Both forms of gather_reduce against their plain versions, one
    launch each: the real (4e,4o) maps (both halves, B = 3; the row form
    on the alpha half and on the transposed beta half, the column form on
    the beta half in place and on the transposed alpha half); ragged
    shapes (Nb = 17: scalar loads; Nb = 20: 16-byte vectors with a list
    tail; n2 = 70: three ballot chunks of pairs) with an output row (a
    column) that has no valid pair; and a Y that starts off a 16-byte
    boundary, which the row form reads in scalars."""
    tol = TOL[dtype]["reduce"]
    pm = grid.build_grid_maps(4, 4, device=cuda_device)
    srcA, sgnA, tB, srcB, sgnB, tA = pm.tables(
        torch.zeros((), dtype=dtype, device=cuda_device))
    for seed, (src, s, t, rows, cols) in enumerate(
            ((srcA, sgnA, tB, pm.Na, pm.Nb), (srcB, sgnB, tA, pm.Nb, pm.Na))):
        Y = _rand((3, pm.n2, rows, cols), 20 + seed).to(cuda_device, dtype)
        _check_reduce("gather_reduce", (Y, src, s, t), tol)
        Yc = _rand((3, pm.n2, cols, rows), 30 + seed).to(cuda_device, dtype)
        _check_reduce("gather_reduce_cols", (Yc, src, s, t), tol)
    for ns, na, nb, n2, lead in ((11, 13, 17, 5, (2, 3)),
                                 (9, 10, 20, 70, (2,))):
        Y, src, s, t = _reduce_case(ns, na, nb, n2, lead, 40, dtype,
                                    cuda_device, empty=3)
        out = _check_reduce("gather_reduce", (Y, src, s, t), tol)
        assert not out[..., 3, :].any()
        # the column form (signs in s): Y rows along t, sources along its
        # last axis
        Y, src, s, t = _reduce_case(ns, na, nb, n2, lead, 40, dtype,
                                    cuda_device, empty=3, signs=True)
        Yc = Y.transpose(-1, -2).contiguous()
        out = _check_reduce("gather_reduce_cols", (Yc, src, s, t), tol)
        assert not out[..., :, 3].any()
    # Y one element past a 16-byte boundary
    Y, src, s, t = _reduce_case(9, 10, 20, 7, (2,), 50, dtype, cuda_device)
    buf = torch.empty(Y.numel() + 1, dtype=dtype, device=cuda_device)
    Ys = buf[1:].view(Y.shape)
    Ys.copy_(Y)
    assert Ys.data_ptr() % 16 != 0
    _check_reduce("gather_reduce", (Ys, src, s, t), tol)


def _all_cols_plans(tile, itemsize):
    """Every launch plan of gather_reduce_cols that fits shared memory."""
    return [gk.ReduceColsPlan(r, u, w)
            for r in (1, 2, 4, 8) for u in (2, 4, 8) for w in (1, 3, 8)
            if r * u <= 32 and w * r * tile * itemsize <= 232448]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_reduce_cols_lists_match_plain(cuda_device, dtype):
    """The column form's kernel on its compacted lists: equal to the plain
    walk of the lists as values (the same sums in the same order) and to
    the plain version within 1e-13 (1e-5 in f32) relative, one launch
    each: the (6e,6o) beta maps at tiles of 8 (Nc = 20: a ragged last
    tile) and 32, with B = 2 x 3 and every plan (the same values from
    each); random sign maps (Nc = 37) where two pairs have no valid entry
    in the first tile; the hosted route's ragged last window (a row
    window of Y and of t) in add mode; add mode equal to out + the
    kernel's result bit for bit."""
    tol = TOL[dtype]["reduce"]
    like = torch.zeros((), dtype=dtype, device=cuda_device)
    pm = grid.build_grid_maps(6, 6, device=cuda_device)
    _, _, _, srcB, sgnB, tA = pm.tables(like)
    Y = _rand((2, 3, pm.n2, pm.Na, pm.Nb), 100).to(cuda_device, dtype)
    ref = gk.gather_reduce_cols_plain(Y, srcB.long(), sgnB, tA)
    for tile in (8, 32):
        lists = gk.reduce_cols_lists(srcB, sgnB, tile)
        walk = gk.gather_reduce_cols_walk(Y, lists, tA)
        for plan in [None] + _all_cols_plans(tile, Y.element_size()):
            before = gk.LAUNCHES["gather_reduce_cols"]
            out = gk.gather_reduce_cols(Y, srcB, sgnB, tA, lists=lists,
                                        plan=plan)
            torch.cuda.synchronize()
            assert gk.LAUNCHES["gather_reduce_cols"] == before + 1
            assert torch.equal(out, walk), (tile, plan)
        assert _rel_err(walk, ref) <= tol
    # random sign maps over 37 columns: pairs 1 and 4 have no valid entry
    # in the first tile of 16 columns
    Y, src, s, t = _reduce_case(9, 37, 11, 6, (2,), 101, dtype, cuda_device,
                                signs=True)
    s[1, :16] = 0
    s[4, :16] = 0
    src[s == 0] = 0
    lists = gk.reduce_cols_lists(src, s, 16)
    first = lists.pair[:int(lists.start[1])].tolist()
    assert 1 not in first and 4 not in first and 0 in first
    Yc = Y.transpose(-1, -2).contiguous()
    out = gk.gather_reduce_cols(Yc, src, s, t, lists=lists)
    assert torch.equal(out, gk.gather_reduce_cols_walk(Yc, lists, t))
    assert _rel_err(out, gk.gather_reduce_cols_plain(Yc, src.long(), s,
                                                     t)) <= tol
    # the hosted route: a ragged last window of 7 rows of (6e,6o)'s 20, Y
    # of the window and t's window, added into the window of acc
    r0, r1 = 13, pm.Na
    tA_k = grid._row_tables(pm, like, r0, r1)[2]
    Yw = _rand((pm.n2, r1 - r0, pm.Nb), 102).to(cuda_device, dtype)
    acc0 = _rand((pm.Na, pm.Nb), 103).to(cuda_device, dtype)
    acc = acc0.clone()
    got = gk.gather_reduce_cols(Yw, srcB, sgnB, tA_k, out=acc[r0:r1],
                                lists=pm.col_lists())
    torch.cuda.synchronize()
    assert got.data_ptr() == acc[r0:r1].data_ptr()
    assert torch.equal(acc[:r0], acc0[:r0])
    assert torch.equal(acc[r0:r1], acc0[r0:r1] + gk.gather_reduce_cols(
        Yw, srcB, sgnB, tA_k, lists=pm.col_lists()))
    assert _rel_err(acc[r0:r1], acc0[r0:r1] + gk.gather_reduce_cols_plain(
        Yw, srcB.long(), sgnB, tA_k)) <= tol
    # the card's lists take signs only, and out must match
    with pytest.raises(ValueError, match="signs"):
        gk.gather_reduce_cols(Yw, srcB, 0.5 * sgnB, tA_k)
    with pytest.raises(ValueError, match="out"):
        gk.gather_reduce_cols(Yw, srcB, sgnB, tA_k, out=acc)


def _check_two_spin(xg, maps, r0, r1):
    """One gather_two_spin launch on the card against its plain version
    on the same operands, equal as values (torch.equal; +-0 aside)."""
    tabs = maps.phi_tables(xg)
    before = dict(gk.LAUNCHES)
    out = gk.gather_two_spin(xg, maps.two_spin_tables(), r0, r1)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["gather_two_spin"] == before["gather_two_spin"] + 1
    ref = gk.gather_two_spin_plain(xg, tabs[0].long(), *tabs[1:3],
                                   tabs[3].long(), *tabs[4:], r0, r1)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.equal(out, ref)
    return out


def _random_port_maps(na, nb, n2, seed, device):
    """Port GridMaps of random tables: +-1 signs with ~30% invalid (src 0,
    sign 0) entries, grid row 3 with no valid alpha pair."""
    rng = np.random.default_rng(seed)

    def half(n, empty):
        src = rng.integers(0, n, (n2, n)).astype(np.int32)
        sgn = rng.choice(np.array([-1, 1], np.int8), (n2, n))
        invalid = rng.random((n2, n)) < 0.3
        invalid[:, empty] = True
        src[invalid], sgn[invalid] = 0, 0
        return src, sgn, rng.choice(np.array([-1, 1], np.int8), (n2, n))

    srcA, sgnA, tA = half(na, 3)
    srcB, sgnB, tB = half(nb, 2)
    perm = np.arange(na * nb)
    return grid.GridMaps(srcA, sgnA, tB, srcB, sgnB, tA, perm, perm,
                         device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_two_spin_matches_plain(cuda_device, dtype):
    """gather_two_spin against its plain version, equal as values: the
    (10e,10o) maps with B = 5 and the (12e,12o) maps on the full grid;
    a middle and a ragged last window, a pair slice and the transposed
    maps of (10e,10o); ragged random maps (Nb = 17: scalar loads; Nb = 20;
    n2 = 5 and 70; a row with no valid alpha pair) with leading batch
    dims; an x that starts off a 16-byte boundary (scalar loads)."""
    pm10 = grid.build_grid_maps(10, 10, device=cuda_device, dtype=dtype)
    x = _rand((5, pm10.Na, pm10.Nb), 70).to(cuda_device, dtype)
    _check_two_spin(x, pm10, 0, pm10.Na)
    for maps in (pm10, grid.pair_slice(pm10, 17, 60), pm10.transposed()):
        for r0, r1 in ((100, 137), (222, 252)):
            _check_two_spin(x[:2].contiguous(), maps, r0, r1)
    del x
    pm12 = grid.build_grid_maps(12, 12, device=cuda_device, dtype=dtype)
    _check_two_spin(_rand((pm12.Na, pm12.Nb), 71).to(cuda_device, dtype),
                    pm12, 0, pm12.Na)
    for na, nb, n2, lead in ((13, 17, 5, (2, 3)), (10, 20, 70, (2,))):
        maps = _random_port_maps(na, nb, n2, na, cuda_device)
        xr = _rand(lead + (na, nb), 72).to(cuda_device, dtype)
        for r0, r1 in ((0, na), (na // 3, na), (3, 4)):
            _check_two_spin(xr, maps, r0, r1)
    pm = grid.build_grid_maps(6, 6, device=cuda_device, dtype=dtype)
    buf = torch.empty(pm.dim + 1, dtype=dtype, device=cuda_device)
    xs = buf[1:].view(pm.Na, pm.Nb)
    xs.copy_(_rand((pm.Na, pm.Nb), 73))
    assert xs.data_ptr() % 16 != 0
    _check_two_spin(xs, pm, 0, pm.Na)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_two_spin_plans_and_shapes(cuda_device, dtype):
    """gather_two_spin on every plan class against its plain version,
    equal as values: 32 to 1024 threads (one to several rounds of slots a
    warp), 1 to n2 pairs per block, the beta tables staged by the warps or
    read in memory, stores from 32- to 128-byte lines, on the (10e,10o)
    maps with B = 3 (a middle window, a window ending at Na, R = 1) and
    B = 15 in f32 (a ragged last window), and the (12e,12o) maps (several
    rounds of slots a warp); Nb = 10, 17 and 20 (no multiple
    of the vector; scalar, 8- and 16-byte loads); an x 8 bytes off a
    16-byte boundary."""
    pm = grid.build_grid_maps(10, 10, device=cuda_device)
    x = _rand((3, pm.Na, pm.Nb), 76).to(cuda_device, dtype)
    tabs, compact = pm.phi_tables(x), pm.two_spin_tables()
    for r0, r1 in ((100, 137), (215, 252), (40, 41)):
        ref = gk.gather_two_spin_plain(x, tabs[0].long(), *tabs[1:3],
                                       tabs[3].long(), *tabs[4:], r0, r1)
        assert torch.equal(gk.gather_two_spin(x, compact, r0, r1), ref)
        base = gk.plan_two_spin(3, pm.Na, r1 - r0, pm.Nb, pm.n2,
                                x.element_size())
        for threads, pairs, staged, line in (
                (32, 1, 0, 128), (64, 3, 1, 32), (256, pm.n2, 1, 128),
                (1024, 7, 1, 64), (96, 9, 0, 32)):
            plan = base._replace(threads=threads, pairs=pairs,
                                 staged=staged, line=line)
            out = gk.gather_two_spin(x, compact, r0, r1, plan=plan)
            assert torch.equal(out, ref), plan
    if dtype == torch.float32:
        S = _rand((15, pm.Na, pm.Nb), 77).to(cuda_device, dtype)
        for r0, r1 in ((0, 14), (238, 252)):
            _check_two_spin(S, pm, r0, r1)
    # (12e,12o): several rounds of slots a warp, each warp's own table
    # columns staged, the last warps partly idle
    pm12 = grid.build_grid_maps(12, 12, device=cuda_device)
    x12 = _rand((pm12.Na, pm12.Nb), 79).to(cuda_device, dtype)
    tabs12 = pm12.phi_tables(x12)
    ref = gk.gather_two_spin_plain(x12, tabs12[0].long(), *tabs12[1:3],
                                   tabs12[3].long(), *tabs12[4:], 300, 340)
    base = gk.plan_two_spin(1, pm12.Na, 40, pm12.Nb, pm12.n2,
                            x12.element_size())
    for threads, pairs, staged, line in ((32, 5, 1, 32), (64, 20, 1, 128),
                                         (96, 144, 0, 32), (160, 9, 1, 64)):
        plan = base._replace(threads=threads, pairs=pairs, staged=staged,
                             line=line)
        assert torch.equal(gk.gather_two_spin(
            x12, pm12.two_spin_tables(), 300, 340, plan=plan), ref), plan
    for na, nb, n2 in ((9, 10, 12), (13, 17, 5), (10, 20, 70)):
        maps = _random_port_maps(na, nb, n2, nb, cuda_device)
        xr = _rand((2, na, nb), 78).to(cuda_device, dtype)
        for r0, r1 in ((0, na), (na // 3, na), (3, 4)):
            _check_two_spin(xr, maps, r0, r1)
    buf = torch.empty(3 * pm.dim + 2, dtype=dtype, device=cuda_device)
    xs = buf[16 // x.element_size() // 2:][:3 * pm.dim].view(3, pm.Na,
                                                            pm.Nb)
    xs.copy_(x)
    assert xs.data_ptr() % 16 == 8
    _check_two_spin(xs, pm, 100, 137)


@pytest.mark.cuda
def test_cuda_phi_launches_two_spin_once(cuda_device):
    """On a CUDA operand, phi_all and phi_rows launch gather_two_spin once
    per call and gather_rows_scaled never, and equal the CPU's plain
    path as values."""
    pm_c = grid.build_grid_maps(4, (2, 1), device="cpu")
    pm_g = grid.build_grid_maps(4, (2, 1), device=cuda_device)
    x = _rand((3, pm_c.dim), 74)
    for fn, args in ((grid.phi_all, ()), (grid.phi_rows, (2, 5))):
        before = dict(gk.LAUNCHES)
        out = fn(x.to(cuda_device), pm_g, *args)
        torch.cuda.synchronize()
        assert gk.LAUNCHES["gather_two_spin"] == \
            before["gather_two_spin"] + 1
        assert gk.LAUNCHES["gather_rows_scaled"] == \
            before["gather_rows_scaled"]
        assert torch.equal(out.cpu(), fn(x, pm_c, *args))


@pytest.mark.cuda
def test_cuda_default_device(cuda_device):
    """Constructors given no device= put their tensors on the card."""
    pqc = P.Parameterized_circuit(2, 2, ansatz="ucc", sector=True)
    assert pqc.init_zeros().device.type == "cuda"
    assert grid.build_grid_maps(2, 2).srcA.device.type == "cuda"


@pytest.mark.cuda
def test_cuda_grid_ops_match_cpu(cuda_device):
    """phi_all / epq_sum and their VJPs on the card (kernels) against the
    CPU (plain versions)."""
    pm_c = grid.build_grid_maps(4, (2, 1), device="cpu")
    pm_g = grid.build_grid_maps(4, (2, 1), device=cuda_device)
    x = _rand((2, pm_c.dim), 9)
    Y = _rand((2, pm_c.n2, pm_c.dim), 10)
    np.testing.assert_allclose(grid.phi_all(x.to(cuda_device), pm_g).cpu(),
                               grid.phi_all(x, pm_c), rtol=0, atol=1e-15)
    before = dict(gk.LAUNCHES)
    np.testing.assert_allclose(grid.epq_sum(Y.to(cuda_device), pm_g).cpu(),
                               grid.epq_sum(Y, pm_c), rtol=0, atol=1e-13)
    # both halves read Y in place: one launch of each form
    assert gk.LAUNCHES["gather_reduce"] == before["gather_reduce"] + 1
    assert gk.LAUNCHES["gather_reduce_cols"] == \
        before["gather_reduce_cols"] + 1
    w = _rand((2, pm_c.n2, pm_c.dim), 11)
    grads = []
    for dev, pm in (("cpu", pm_c), (cuda_device, pm_g)):
        xd = x.to(dev, copy=True).requires_grad_(True)
        (grid.phi_all(xd, pm) * w.to(dev)).sum().backward()
        grads.append(xd.grad.cpu())
    np.testing.assert_allclose(grads[1], grads[0], rtol=0, atol=1e-13)


@pytest.mark.cuda
def test_cuda_grad_hess_matches_cpu(cuda_device):
    """One fused grad_hess of (4e,4o) sector np_fabric on the card equals
    the same call on the CPU, and ran both kernels."""
    mol = P.Moldata(P.get_formal_geo(140, 80), "sto-3g")
    theta = 0.3 * np.random.default_rng(0).standard_normal(
        P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                sector=True).theta_shape)
    out = []
    for dev in ("cpu", cuda_device):
        pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                      sector=True, device=dev)
        oo = P.OO_pqc(pqc, mol, 4, 4, freeze_active=True)
        before = dict(gk.LAUNCHES)
        out.append([a.cpu() for a in oo._grad_hess(theta)])
    for name in FUSED_KERNELS:
        assert gk.LAUNCHES[name] > before[name], name
    (e_c, g_c, h_c), (e_g, g_g, h_g) = out
    assert abs(float(e_g) - float(e_c)) < 1e-11
    np.testing.assert_allclose(g_g, g_c, rtol=0, atol=1e-11)
    np.testing.assert_allclose(h_g, h_c, rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_cuda_flat_sweeps_and_ham_apply_match_cpu(cuda_device):
    """The full-space route on the card against the CPU: the flat
    program's state, J and circuit-Hessian sweep, the flat E_pq maps'
    Phi and RDMs, and ham_apply (batched), launching no grid kernel."""
    from auto_oo_tpu_torch.ops import hamiltonian, rdms

    ncas, ne = 4, (2, 1)
    rng = np.random.default_rng(12)
    n_theta = P.Parameterized_circuit(ncas, ne, ansatz="np_fabric",
                                      n_layers=2, device="cpu").theta_shape
    theta = torch.from_numpy(0.4 * rng.standard_normal(n_theta))
    w = torch.from_numpy(rng.standard_normal(4 ** ncas))
    c1 = torch.from_numpy(rng.standard_normal((ncas, ncas)))
    c2 = torch.from_numpy(rng.standard_normal((ncas,) * 4))
    out = []
    for dev in ("cpu", cuda_device):
        pqc = P.Parameterized_circuit(ncas, ne, ansatz="np_fabric",
                                      n_layers=2, device=dev)
        th, maps = theta.to(dev), pqc.epq_maps
        before = dict(gk.LAUNCHES)
        psi, J = pqc._state_and_jacobian_grid(th)
        H = pqc._state_hessian_dot_grid(th, w.to(dev), psi, J)
        phi = rdms.apply_epq_all(psi, ncas, maps)
        g1, g2 = rdms.rdms_from_state(psi, ncas, maps)
        HJ = hamiltonian.ham_apply(
            hamiltonian.c1_effective(c1.to(dev), c2.to(dev)), c2.to(dev), J,
            ncas, maps)
        assert gk.LAUNCHES == before
        out.append([a.cpu() for a in (psi, J, H, phi, g1, g2, HJ)])
    for name, b, a, tol in zip(
            ("psi", "J", "hessian_dot", "Phi", "gamma", "Gamma", "H J"),
            *out, (1e-14, 1e-13, 1e-12, 1e-14, 1e-12, 1e-12, 1e-11)):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


@pytest.mark.cuda
def test_cuda_full_space_converges_to_casscf(cuda_device):
    """(2e,2o) in the full space, built with no sector= and no device=
    (the README quick start), reaches CASSCF on the card within 1e-8 Ha
    on the flat route."""
    mol = P.Moldata(P.get_formal_geo(140, 80), "sto-3g")
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)
    oo = P.OO_pqc(pqc, mol, 2, 2, freeze_active=True)
    assert oo._core["route"] == "flat"
    assert pqc.init_zeros().device.type == "cuda"
    energies, *_ = oo.full_optimization(pqc.init_zeros())
    assert abs(energies[-1] - (-92.74923230445957)) < 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_kernels_at_streamed_shapes(cuda_device, dtype):
    """The kernels at the row-streamed route's shapes against their plain
    versions, one launch each, on the (6e,6o) maps: gather_rows_scaled
    with row-sliced tables (src (n2, rows) against the whole x) for the
    alpha half of a Phi chunk, and on the chunk's transposed rows for the
    beta half; both forms of gather_reduce on a pair-sliced Y with the
    sliced tables.  A ragged row chunk, a batch of two."""
    tol = TOL[dtype]
    pm = grid.build_grid_maps(6, 6, device=cuda_device)
    like = torch.zeros((), dtype=dtype, device=cuda_device)
    r0, r1 = 3, 14
    srcA_k, sgnA_k, tA_k = grid._row_tables(pm, like, r0, r1)
    _, _, tB, srcB, sgnB, _ = pm.tables(like)
    x = _rand((2, pm.Na, pm.Nb), 60).to(cuda_device, dtype)
    xt = x[:, r0:r1].transpose(-1, -2).contiguous()
    for args in ((x, srcA_k, sgnA_k, tB), (xt, srcB, sgnB, tA_k)):
        before = gk.LAUNCHES["gather_rows_scaled"]
        out = gk.gather_rows_scaled(*args)
        torch.cuda.synchronize()
        assert gk.LAUNCHES["gather_rows_scaled"] == before + 1
        ref = gk.gather_rows_scaled_plain(args[0], args[1].long(), *args[2:])
        assert out.shape == ref.shape
        assert _rel_err(out, ref) <= tol["rows"]
    blk = grid.pair_slice(pm, 5, 29)
    srcA, sgnA, tB, srcB, sgnB, tA = blk.tables(like)
    Y = _rand((2, 24, pm.Na, pm.Nb), 61).to(cuda_device, dtype)
    _check_reduce("gather_reduce", (Y, srcA, sgnA, tB), tol["reduce"])
    _check_reduce("gather_reduce_cols", (Y, srcB, sgnB, tA), tol["reduce"])


@pytest.mark.cuda
def test_cuda_streamed_grid_ops_match_cpu(cuda_device):
    """phi_rows and its VJP, the VJP of phi_all on pair-sliced maps, and
    ham_apply_rows / rdms_rows / transition_rdms_rows on the card against
    the CPU."""
    pm_c = grid.build_grid_maps(4, (2, 1), device="cpu")
    pm_g = grid.build_grid_maps(4, (2, 1), device=cuda_device)
    x = _rand((2, pm_c.dim), 62)
    ct = _rand((2, pm_c.n2, 3, pm_c.Nb), 63)
    outs = []
    for dev, pm in (("cpu", pm_c), (cuda_device, pm_g)):
        xd = x.to(dev, copy=True).requires_grad_(True)
        phi = grid.phi_rows(xd, pm, 1, 4)
        (phi * ct.to(dev)).sum().backward()
        g_rows = xd.grad.cpu()
        xd.grad = None
        grid.phi_all(xd, grid.pair_slice(pm, 3, 11)).sum().backward()
        c1 = torch.linspace(-1, 1, pm.n2, dtype=torch.float64, device=dev)
        C2 = torch.outer(c1, c1.flip(0))
        h = grid.ham_apply_rows(c1, C2 + C2.T, xd.detach(), pm, 2, 5)
        rd = grid.rdms_rows(xd.detach()[0], pm, 4, 4)
        tr = grid.transition_rdms_rows(xd.detach()[0], xd.detach()[1], pm,
                                       4, 3)
        outs.append([phi.detach().cpu(), g_rows, xd.grad.cpu(), h.cpu()]
                    + [a.cpu() for a in rd + tr])
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-13)


@pytest.mark.cuda
def test_cuda_streamed_grad_hess_matches_fused(cuda_device):
    """(4e,4o) 6-31G sector np_fabric on the card: grad_hess on the
    streamed route (row chunk 2, pair block 5) equals the fused route's
    on the card, e0 and gradient to 1e-11 and the Hessian to 1e-9, and
    launched all three kernels."""
    mol = P.Moldata(P.get_formal_geo(140, 80), "6-31g")
    theta = 0.3 * np.random.default_rng(64).standard_normal(
        P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                sector=True, device="cpu").theta_shape)
    out = {}
    for route, kw in (("fused", {}),
                      ("streamed",
                       {"stream_plan": grid.StreamPlan(2, 5, None)})):
        pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                      sector=True, device=cuda_device)
        oo = P.OO_pqc(pqc, mol, 4, 4, freeze_active=True, **kw)
        assert oo._core["route"] == route and oo.n_kappa > 0
        before = dict(gk.LAUNCHES)
        out[route] = [a.cpu() for a in oo._grad_hess(theta)]
        torch.cuda.synchronize()
    for name in FUSED_KERNELS:
        assert gk.LAUNCHES[name] > before[name], name
    (e_f, g_f, h_f), (e_s, g_s, h_s) = out["fused"], out["streamed"]
    assert abs(float(e_s) - float(e_f)) < 1e-11
    np.testing.assert_allclose(g_s, g_f, rtol=0, atol=1e-11)
    np.testing.assert_allclose(h_s, h_f, rtol=0, atol=1e-9)


def _injective_case(na, nb, n2, seed, dtype, device):
    """Random alpha-style maps over na rows where each pair's row map is a
    partial injection (as E_pq's is), with their inverse: (src, s, t, dst,
    dsg), invalid entries src 0 / s 0 and dst 0 / dsg 0."""
    rng = np.random.default_rng(seed)
    src = np.zeros((n2, na), dtype=np.int32)
    s = np.zeros((n2, na))
    dst = np.zeros((n2, na), dtype=np.int64)
    dsg = np.zeros((n2, na))
    for k in range(n2):
        rows = np.flatnonzero(rng.random(na) < 0.7)
        srcs = rng.permutation(na)[:rows.size]
        sign = rng.choice([-1.0, 1.0], rows.size)
        src[k, rows], s[k, rows] = srcs, sign
        dst[k, srcs], dsg[k, srcs] = rows, sign
    t = rng.choice([-1.0, 1.0], (n2, nb))
    return (torch.from_numpy(src).to(device),
            torch.from_numpy(s).to(device, dtype),
            torch.from_numpy(t).to(device, dtype),
            torch.from_numpy(dst).to(device),
            torch.from_numpy(dsg).to(device, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_scatter_rows_matches_plain(cuda_device, dtype):
    """The hosted H-apply's alpha scatter against its plain version
    (index_add_ through the inverse maps), within 1e-14 of max |out| in
    f64 (1e-6 in f32: the sums run in another order): the real (6e,6o)
    alpha maps in three windows (the last ragged) on a batch of two, and
    ragged random maps (Nb = 17: scalar loads); the same bits on a second
    launch, and rows with no pair in the window left as they were."""
    tol = 1e-14 if dtype == torch.float64 else 1e-6
    pm = grid.build_grid_maps(6, 6, device=cuda_device)
    like = torch.zeros((), dtype=dtype, device=cuda_device)
    srcA, sgnA, tB = pm.tables(like)[:3]
    dst, dsg = (torch.as_tensor(a, device=cuda_device)
                for a in grid.inverse_alpha_maps(pm))
    cases = [((2,), (srcA, sgnA, tB, dst.long(), dsg.to(dtype)), w)
             for w in ((0, 7), (7, 14), (14, pm.Na))]
    cases += [((), _injective_case(13, 17, 9, 70, dtype, cuda_device), w)
              for w in ((0, 5), (5, 13))]
    for seed, (lead, (src, s, t, d, dg), (r0, r1)) in enumerate(cases):
        n2, na = src.shape
        nb = t.shape[1]
        Y = _rand(lead + (n2, r1 - r0, nb), 80 + seed).to(cuda_device, dtype)
        acc0 = _rand(lead + (na, nb), 90 + seed).to(cuda_device, dtype)
        outs = []
        for _ in range(2):
            before = gk.LAUNCHES["scatter_rows"]
            out = acc0.clone()
            assert gk.scatter_rows(out, Y, src, s, t, d, dg, r0) is out
            torch.cuda.synchronize()
            assert gk.LAUNCHES["scatter_rows"] == before + 1
            outs.append(out)
        assert torch.equal(outs[0], outs[1])
        ref = gk.scatter_rows_plain(acc0.clone(), Y, src, s, t, d, dg, r0)
        assert _rel_err(outs[0], ref) <= tol
        hit = ((s != 0) & (src >= r0) & (src < r1)).any(0)
        assert torch.equal(outs[0][..., ~hit, :], acc0[..., ~hit, :])


@pytest.mark.cuda
def test_cuda_hosted_grad_hess_matches_fused(cuda_device, monkeypatch):
    """(4e,4o) sector np_fabric with the hosting threshold forced to 1
    byte, on the card: the hosted grad_hess (row chunk 3) equals the fused
    one, e0 and gradient to 1e-11 and the Hessian to 1e-9, n_kappa > 0
    (the per-tangent pass with the transition RDMs), and launched the
    three kernels of the hosted passes; the hosted line-search energy
    equals the fused one."""
    mol = P.Moldata(P.get_formal_geo(140, 80), "sto-3g")
    pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                  sector=True, device=cuda_device)
    theta = 0.3 * np.random.default_rng(65).standard_normal(pqc.theta_shape)
    fused = P.OO_pqc(pqc, mol, 4, 4, freeze_active=True)
    out_f = [a.cpu() for a in fused._grad_hess(theta)]
    monkeypatch.setattr(grid_hosted, "_HOSTED_MIN_BYTES", 1)
    oo = P.OO_pqc(pqc, mol, 4, 4, freeze_active=True,
                  stream_plan=grid.StreamPlan(3, 1, None),
                  hosted_form="per_tangent")
    assert oo._core["route"] == "hosted" and oo.n_kappa > 0
    before = dict(gk.LAUNCHES)
    e_h, g_h, h_h = (a.cpu() for a in oo._grad_hess(theta))
    torch.cuda.synchronize()
    for name in ("gather_two_spin", "gather_reduce_cols", "scatter_rows"):
        assert gk.LAUNCHES[name] > before[name], name
    e_f, g_f, h_f = out_f
    assert abs(float(e_h) - float(e_f)) < 1e-11
    np.testing.assert_allclose(g_h, g_f, rtol=0, atol=1e-11)
    np.testing.assert_allclose(h_h, h_f, rtol=0, atol=1e-9)
    assert abs(float(oo.energy_from_parameters(theta))
               - float(fused.energy_from_parameters(theta))) < 1e-12


def _rel(a, b):
    return float((a - b).norm()) / float(b.norm())


@pytest.mark.cuda
def test_cuda_mixed_grad_hess_matches_cpu(cuda_device):
    """One mixed fused grad_hess of (4e,4o) sector np_fabric on the card
    (the kernels' f32 launches) against the same call on the CPU (their
    plain versions): e0 and gradient stay f64 (1e-11), the f32 Hessian
    blocks sum in other orders (1e-5 relative)."""
    mol = P.Moldata(P.get_formal_geo(140, 80), "sto-3g")
    theta = 0.3 * np.random.default_rng(0).standard_normal(
        P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                sector=True).theta_shape)
    out = []
    for dev in ("cpu", cuda_device):
        pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                      sector=True, device=dev)
        oo = P.OO_pqc(pqc, mol, 4, 4, freeze_active=True, precision="mixed")
        before = dict(gk.LAUNCHES)
        out.append([a.cpu() for a in oo._grad_hess(theta)])
    for name in FUSED_KERNELS:
        assert gk.LAUNCHES[name] > before[name], name
    (e_c, g_c, h_c), (e_g, g_g, h_g) = out
    assert h_g.dtype == torch.float64
    assert abs(float(e_g) - float(e_c)) < 1e-11
    np.testing.assert_allclose(g_g, g_c, rtol=0, atol=1e-11)
    assert _rel(h_g, h_c) < 1e-5


@pytest.mark.cuda
def test_cuda_two_spin_state_stack_f32(cuda_device):
    """The Gram route's launch: one gather_two_spin over a (15, Na, Nb)
    f32 stack of states (the (10e,10o) maps; the whole grid, a middle and
    a ragged last window), equal to its plain version as values."""
    pm = grid.build_grid_maps(10, 10, device=cuda_device)
    S = _rand((15, pm.Na, pm.Nb), 75).to(cuda_device, torch.float32)
    for r0, r1 in ((0, pm.Na), (100, 137), (222, 252)):
        out = _check_two_spin(S, pm, r0, r1)
        assert out.shape == (15, pm.n2, r1 - r0, pm.Nb)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_cuda_gram_matches_per_tangent(cuda_device, monkeypatch, precision):
    """(4e,4o) formaldimine (n_kappa > 0) with the hosting threshold forced
    to 1 byte, on the card: the Gram form's grad_hess (the cross sweep
    over the stack, one H psi pass) against the per-tangent form's, to
    rounding in f64 (1e-11, 1e-9) and to f32 resolution in mixed
    precision; the Gram form launched gather_two_spin, the column form
    and the scatter (its H psi pass)."""
    mol = P.Moldata(P.get_formal_geo(140, 80), "sto-3g")
    pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                  sector=True, device=cuda_device)
    theta = 0.3 * np.random.default_rng(66).standard_normal(pqc.theta_shape)
    monkeypatch.setattr(grid_hosted, "_HOSTED_MIN_BYTES", 1)
    out = {}
    for form in ("per_tangent", "gram"):
        oo = P.OO_pqc(pqc, mol, 4, 4, freeze_active=True,
                      precision=precision, hosted_form=form,
                      stream_plan=grid.StreamPlan(3, 1, None))
        assert oo._core["hosted_form"] == form and oo.n_kappa > 0
        before = dict(gk.LAUNCHES)
        out[form] = [a.cpu() for a in oo._grad_hess(theta)]
        torch.cuda.synchronize()
    for name in ("gather_two_spin", "gather_reduce_cols", "scatter_rows"):
        assert gk.LAUNCHES[name] > before[name], name
    (e_t, g_t, h_t), (e_g, g_g, h_g) = out["per_tangent"], out["gram"]
    if precision == "f64":
        assert abs(float(e_g) - float(e_t)) < 1e-11
        np.testing.assert_allclose(g_g, g_t, rtol=0, atol=1e-11)
        np.testing.assert_allclose(h_g, h_t, rtol=0, atol=1e-9)
    else:
        assert abs(float(e_g) - float(e_t)) < 1e-6
        assert _rel(g_g, g_t) < 1e-5
        assert _rel(h_g, h_t) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_cuda_hosted_energy_and_gradient_matches_cpu(cuda_device, monkeypatch,
                                                     precision):
    """(4e,4o) formaldimine (n_kappa > 0) with the hosting threshold forced
    to 1 byte: energy_and_gradient on the card (one hosted (H psi, RDMs)
    pass through the kernels, the adjoint reverse sweep) against the same
    call on the CPU (their plain versions): f64 e0, gradient and RDMs to
    1e-11; mixed, whose pass runs on the f32 state, e0 to 1e-6 and the
    rest to 1e-5 relative; the hosted pass's kernels launched."""
    mol = P.Moldata(P.get_formal_geo(140, 80), "sto-3g")
    theta = 0.3 * np.random.default_rng(67).standard_normal(
        P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                sector=True).theta_shape)
    monkeypatch.setattr(grid_hosted, "_HOSTED_MIN_BYTES", 1)
    out = []
    for dev in ("cpu", cuda_device):
        pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                      sector=True, device=dev)
        oo = P.OO_pqc(pqc, mol, 4, 4, freeze_active=True,
                      precision=precision,
                      stream_plan=grid.StreamPlan(3, 1, None))
        assert oo._core["route"] == "hosted" and oo.n_kappa > 0
        before = dict(gk.LAUNCHES)
        e, g, (g1, G2) = oo.energy_and_gradient(theta)
        out.append([a.cpu() for a in (e, g, g1, G2)])
    for name in ("gather_two_spin", "gather_reduce_cols", "scatter_rows"):
        assert gk.LAUNCHES[name] > before[name], name
    (e_c, g_c, g1_c, G2_c), (e_g, g_g, g1_g, G2_g) = out
    assert g1_g.dtype == G2_g.dtype == torch.float64
    if precision == "f64":
        assert abs(float(e_g) - float(e_c)) < 1e-11
        for a, b in ((g_g, g_c), (g1_g, g1_c), (G2_g, G2_c)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-11)
    else:
        assert abs(float(e_g) - float(e_c)) < 1e-6
        for a, b in ((g_g, g_c), (g1_g, g1_c), (G2_g, G2_c)):
            assert _rel(a, b) < 1e-5


@pytest.mark.cuda
def test_cuda_gradient_optimization_matches_cpu(cuda_device):
    """(2e,2o) ucc in the full space (freeze_active=False), 12 Adam steps
    from init_zeros with an orbital relaxation every 3 (conv_tol 0) on
    the card against the same run on the CPU: the energies to 1e-10 Ha,
    theta to 1e-9 and the OAO coefficients after the relaxations to
    1e-9."""
    mol = P.Moldata(P.get_formal_geo(140, 80), "sto-3g")
    out = []
    for dev in ("cpu", cuda_device):
        pqc = P.Parameterized_circuit(2, 2, ansatz="ucc", device=dev)
        oo = P.OO_pqc(pqc, mol, 2, 2)
        energies, theta = oo.gradient_optimization(
            pqc.init_zeros(), max_iterations=12, learning_rate=0.1,
            orbital_every=3, conv_tol=0)
        out.append((np.asarray(energies), theta.cpu(),
                    oo.oao_mo_coeff.cpu()))
    (e_c, th_c, oao_c), (e_g, th_g, oao_g) = out
    assert len(e_g) == 12 and e_g[-1] < e_g[0]
    np.testing.assert_allclose(e_g, e_c, rtol=0, atol=1e-10)
    np.testing.assert_allclose(th_g, th_c, rtol=0, atol=1e-9)
    np.testing.assert_allclose(oao_g, oao_c, rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_cuda_failed_build_raises(cuda_device, monkeypatch, tmp_path):
    """A source that does not compile raises on the first CUDA call; no
    path falls back to the plain version."""
    bad = tmp_path / "bad.cu"
    bad.write_text("this is not CUDA\n")
    monkeypatch.setattr(gk, "LIBRARY",
                        cuda_build.CudaLibrary(str(bad), gk.LIBRARY.symbols))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    pm = grid.build_grid_maps(2, 2, device=cuda_device)
    x = torch.zeros((pm.Na, pm.Nb), dtype=torch.float64, device=cuda_device)
    before = dict(gk.LAUNCHES)
    srcA, sgnA, tB = pm.tables(x)[:3]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        gk.gather_rows_scaled(x, srcA, sgnA, tB)
    assert gk.LAUNCHES == before


def _ragged(ns, nb, n2, na, seed, dtype, device):
    """Random inputs of a valid ragged shape; src reaches row ns - 1."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, ns, (n2, na)).astype(np.int32)
    src[0, 0] = src[-1, -1] = ns - 1
    return (torch.from_numpy(rng.standard_normal((ns, nb))).to(device, dtype),
            torch.from_numpy(src).to(device),
            torch.from_numpy(rng.standard_normal((n2, na))).to(device, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_mechanisms_match_plain(cuda_device, dtype):
    """A, B and C against the plain gather, bit for bit: the script's
    ncas = 10 and ncas = 12 inputs, and a ragged valid shape (row groups
    that do not divide na, src at row ns - 1).  B also at cluster sizes
    that leave the last blocks of a cluster fewer rows or none (ns = 40
    over 6 and 16 blocks)."""
    cases = [exp.make_inputs(ncas, 1, dtype, cuda_device)[:3]
             for ncas in (10, 12)]
    cases.append(_ragged(24, 384, 7, 40, 11, dtype, cuda_device))
    for args in cases:
        ref = gm.gather_rows_plain(*args)
        for name in ("gather_a", "gather_b", "gather_c"):
            before = gm.LAUNCHES[name]
            out = getattr(gm, name)(*args)
            torch.cuda.synchronize()
            assert gm.LAUNCHES[name] == before + 1
            assert out.dtype == dtype and out.shape == ref.shape
            assert torch.equal(out, ref), name
            del out
        del ref
    args = _ragged(40, 384, 5, 24, 12, dtype, cuda_device)
    ref = gm.gather_rows_plain(*args)
    for cluster in (6, 16):
        out = gm.gather_b(*args, cluster=cluster)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), cluster


@pytest.mark.cuda
def test_cuda_mechanisms_raise(cuda_device):
    """B refuses an x whose 16-column slab does not fit even a cluster of
    16 blocks; A refuses rows that are not 16-byte multiples; neither
    launches."""
    src = torch.zeros((4, 16), dtype=torch.int32, device=cuda_device)
    s = torch.ones((4, 16), dtype=torch.float64, device=cuda_device)
    before = dict(gm.LAUNCHES)
    tall = torch.zeros((32768, 128), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        gm.gather_b(tall, src, s)
    narrow = torch.zeros((16, 3), dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        gm.gather_a(narrow, src, s.float())
    assert gm.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_refused_cluster_size_raises(cuda_device):
    """A cluster size the card refuses (32 blocks; Hopper allows 16)
    raises from the card's own check and launches nothing."""
    x = torch.ones((256, 256), dtype=torch.float64, device=cuda_device)
    src = torch.zeros((4, 16), dtype=torch.int32, device=cuda_device)
    s = torch.ones((4, 16), dtype=torch.float64, device=cuda_device)
    before = dict(gm.LAUNCHES)
    with pytest.raises(RuntimeError, match="gm_gather_b_f64"):
        gm.gather_b(x, src, s, cluster=32)
    assert gm.LAUNCHES == before
    # the refusal leaves no error behind: the next launch runs
    out = gm.gather_b(x, src, s)
    torch.cuda.synchronize()
    assert torch.equal(out, gm.gather_rows_plain(x, src, s))


@pytest.mark.cuda
def test_cuda_berry_transfer_and_sector_loop(cuda_device):
    """The Thouless transfer on the card equals the CPU's to 1e-13 (full
    space and sector basis), and a 4-point (2e,2o) sector Berry loop on
    the card launches the fused route's kernels and gives the CPU loop's
    energies to 1e-10 and its Berry phase."""
    from auto_oo_tpu_torch.models import berry

    rng = np.random.default_rng(3)
    M = np.linalg.qr(rng.standard_normal((3, 3)))[0] + 0.03 * \
        rng.standard_normal((3, 3))
    act = np.arange(3)
    psi = torch.as_tensor(rng.standard_normal(64))
    basis = P.Parameterized_circuit(3, 4, ansatz="ucc", sector=True,
                                    device="cpu").sector_basis
    for state, dets in ((psi, None), (psi[: len(basis)], basis)):
        on_card = berry.transfer_state(state.to(cuda_device), M.T, act, 3,
                                       dets=dets)
        assert on_card.device.type == "cuda"
        np.testing.assert_allclose(
            on_card.cpu(), berry.transfer_state(state, M.T, act, 3,
                                                dets=dets),
            rtol=0, atol=1e-13)
    ts = np.linspace(0, 1, 4)
    geos = [P.get_formal_geo(130 + 10 * np.cos(2 * np.pi * t + np.pi / 20),
                             89.9 + 10 * np.sin(2 * np.pi * t + np.pi / 20))
            for t in ts]
    loops = []
    for dev in ("cpu", cuda_device):
        pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1,
                                      sector=True, device=dev)
        before = dict(gk.LAUNCHES)
        loops.append(P.BerryPhaseLoop(geos, "sto-3g", 2, 2, pqc).run(
            track_steps=4, track_tol=1e-10))
    for name in FUSED_KERNELS:
        assert gk.LAUNCHES[name] > before[name], name
    np.testing.assert_allclose(loops[1].energy_l, loops[0].energy_l,
                               rtol=0, atol=1e-10)
    assert abs(loops[1].berry_phase() - loops[0].berry_phase()) < 1e-10


@pytest.mark.cuda
def test_cuda_s2_grid_matches_cpu(cuda_device):
    """The grid S^- and <S^2> on the card equal the CPU's (a random
    open-shell (4e,4o) state and a (5e,5o) circuit state) to 1e-13, and
    equal the flat cross-sector tables' value."""
    from auto_oo_tpu_torch.simulator import sector

    for ncas, nelec in ((4, (3, 1)), (5, 5)):
        vals = []
        for dev in ("cpu", cuda_device):
            gm = grid.build_grid_maps(ncas, nelec, device=dev)
            sm = grid.sminus_grid_maps(ncas, nelec, device=dev)
            x = _rand(gm.dim, 4).to(dev)
            x = x / x.norm()
            vals.append(float(grid.s2_expectation_grid(x, gm, sm, nelec)))
            vals.append(float(sector.s2_expectation_sector(
                x, sector.sector_sminus_maps(ncas, nelec, device=dev),
                nelec)))
        assert max(vals) - min(vals) < 1e-13, vals
    pqcs = [P.Parameterized_circuit(5, 5, ansatz="np_fabric", n_layers=2,
                                    sector=True, device=dev)
            for dev in ("cpu", cuda_device)]
    theta = 0.3 * _rand(pqcs[0].theta_shape, 6)
    a, b = (float(p.s2_expectation(theta)) for p in pqcs)
    assert abs(a - b) < 1e-13


@pytest.mark.cuda
def test_cuda_user_states_match_cpu(cuda_device):
    """One spin component of Phi launches gather_rows_scaled once (twice
    for a complex state, its real and imaginary parts) and a complex Phi
    gather_two_spin twice, equal to the CPU; the spin-resolved RDMs of a
    sector circuit and of its phased (complex) state, and a complex
    callable's grad_hess, on the card equal the CPU's."""
    pm_c = grid.build_grid_maps(4, (2, 1), device="cpu")
    pm_g = grid.build_grid_maps(4, (2, 1), device=cuda_device)
    x = _rand((2, pm_c.dim), 31) + 1j * _rand((2, pm_c.dim), 32)
    for xs, n in ((x.real.contiguous(), 1), (x, 2)):
        for spin in (0, 1, None):
            name = "gather_two_spin" if spin is None else "gather_rows_scaled"
            before = dict(gk.LAUNCHES)
            out = grid.phi_all(xs.to(cuda_device), pm_g, spin=spin)
            torch.cuda.synchronize()
            assert gk.LAUNCHES[name] == before[name] + n
            assert sum(gk.LAUNCHES.values()) == sum(before.values()) + n
            np.testing.assert_allclose(out.cpu(),
                                       grid.phi_all(xs, pm_c, spin=spin),
                                       rtol=0, atol=1e-15)
    theta = 0.07 * np.arange(P.Parameterized_circuit(
        4, 4, ansatz="np_fabric", n_layers=1, sector=True,
        device="cpu").theta_shape) + 0.1
    res = []
    for dev in ("cpu", cuda_device):
        pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                      sector=True, device=dev)
        psi = pqc.state(theta)
        phase = torch.exp(1j * _rand(psi.shape[0], 33)).to(dev)
        res.append([t.cpu() for t in (
            *pqc.get_rdms(theta, restricted=False),
            *pqc.get_rdms_from_state(psi * phase),
            *pqc.get_rdms_from_state(psi * phase, restricted=False))])
    for a, b in zip(*res):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-13)
    mol = P.Moldata(P.get_formal_geo(140, 80), "sto-3g")
    out = []
    for dev in ("cpu", cuda_device):
        base = P.Parameterized_circuit(2, 2, ansatz="ucc", device=dev).program
        n0 = torch.tensor([0.0] * 8 + [1.0] * 8, dtype=torch.float64,
                          device=dev)

        def fn(th, base=base, n0=n0):
            return base.apply(th[:1]).to(torch.complex128) * torch.exp(
                1j * th[1] * n0)
        pqc = P.Parameterized_circuit(2, 2, ansatz=fn, theta_shape=2,
                                      device=dev)
        oo = P.OO_pqc(pqc, mol, 2, 2)
        out.append([t.cpu() for t in oo._grad_hess([0.3, 0.7])])
    for a, b in zip(*out):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-11)


@pytest.mark.cuda
def test_cuda_iterative_solver_and_noisy(cuda_device):
    """newton_dir_iterative on the card equals the CPU's (the same seeded
    Lanczos start on both) to 1e-10, and falls back to eigh on the card
    where the CPU does; a Noisy_OO_pqc on the card draws from a CUDA
    generator: the same seed gives the same trajectory, and variance 0
    equals full_optimization."""
    from auto_oo_tpu_torch.ops import linalg

    rng = np.random.default_rng(8)
    indefinite = np.concatenate([[-0.5], np.linspace(0.1, 2, 129)])
    for n, w, kw in ((130, indefinite, {}),
                     (64, np.logspace(-4, 0, 64),
                      dict(ns_iters=20, aug=False))):
        Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
        H = torch.as_tensor(Q @ np.diag(w) @ Q.T)
        g = torch.as_tensor(rng.standard_normal(n))
        before = linalg.ITERATIVE_FALLBACKS
        dp_c, low_c = linalg.newton_dir_iterative(g, H, **kw)
        mid = linalg.ITERATIVE_FALLBACKS
        dp_g, low_g = linalg.newton_dir_iterative(g.to(cuda_device),
                                                  H.to(cuda_device), **kw)
        assert linalg.ITERATIVE_FALLBACKS - mid == mid - before
        assert abs(float(low_g) - float(low_c)) < 1e-10
        assert float((dp_g.cpu() - dp_c).norm()) <= 1e-10 * float(
            dp_c.norm())
    mol = P.Moldata(P.get_formal_geo(140, 80), "sto-3g")
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1,
                                  device=cuda_device)
    runs = [P.Noisy_OO_pqc(pqc, mol, 2, 2, freeze_active=True, seed=5)
            .full_noisy_optimization(pqc.init_zeros(), 1e-8,
                                     max_iterations=4, conv_tol=0.0)[0]
            for _ in range(2)]
    assert runs[0] == runs[1]
    zero = P.Noisy_OO_pqc(pqc, mol, 2, 2, freeze_active=True)
    exact = P.OO_pqc(pqc, mol, 2, 2, freeze_active=True)
    np.testing.assert_allclose(
        zero.full_noisy_optimization(pqc.init_zeros(), 0.0)[0],
        exact.full_optimization(pqc.init_zeros())[0], rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def nccl_mesh():
    """A (1, 1) DeviceMesh over a one-rank NCCL group of this process
    (``parallel.make_mesh`` with no group set up), destroyed after the
    module."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    import torch.distributed as dist
    from auto_oo_tpu_torch.parallel import make_mesh

    mesh = make_mesh(shape=(1, 1), names=("tp", "row"), device="cuda")
    assert dist.get_backend() == "nccl"
    yield mesh
    dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_one_rank_nccl_grid_engines(nccl_mesh):
    """The row-sharded and the hosted x row-sharded engines on one NCCL
    rank against the single-card grid passes, (6e,6o) sector: RDMs and
    H psi within 1e-12, energy + gradient within 1e-12 / 1e-10; every
    collective of the engines issued."""
    from auto_oo_tpu_torch.ops import hamiltonian
    from auto_oo_tpu_torch.parallel import (hosted_sharded_fns,
                                            row_sharded_sector_fns)
    from auto_oo_tpu_torch.parallel import distributed as D

    pqc = P.Parameterized_circuit(6, 6, ansatz="np_fabric", n_layers=2,
                                  sector=True, device="cuda")
    oo = P.OO_pqc(pqc, P.Moldata(P.get_formal_geo(140, 80), "sto-3g"), 6,
                  6, freeze_active=True)
    theta = 0.07 * torch.arange(pqc.theta_shape, dtype=torch.float64,
                                device="cuda")
    psi = pqc.state(theta)
    c0, c1, c2 = oo.get_active_integrals(oo.mo_coeff)
    c1e = hamiltonian.c1_effective(c1, c2)
    gm = pqc.sector_maps
    D.reset_collectives()
    eng = row_sharded_sector_fns(pqc, nccl_mesh, axis="row")
    g1, G2 = eng["rdms"](psi)
    g1r, G2r = pqc.get_rdms_from_state(psi)
    assert float((g1 - g1r).abs().max()) < 1e-12
    assert float((G2 - G2r).abs().max()) < 1e-12
    psi_g = grid.to_grid(psi, gm)
    h_ref = hamiltonian.ham_apply(c1e, c2, psi_g, 6, gm)
    h = grid.to_grid(eng["ham_apply"](c1e, c2, psi), gm)
    assert float((h - h_ref).abs().max()) < 1e-12
    e0, grad = eng["energy_gradient"](c0, c1e, c2, theta)
    e_ref, g_ref, _ = oo.energy_and_gradient(theta)
    assert abs(float(e0 - e_ref)) < 1e-12
    assert float((grad - g_ref[:pqc.theta_shape]).abs().max()) < 1e-10
    hs = hosted_sharded_fns(gm, nccl_mesh, axis="row", row_chunk=3)
    xn = hs["rows"](psi_g)
    gam, cor = hs["rdms"](xn)
    g1h, G2h = grid.assemble_rdms(gam, cor, 6)
    assert float((G2h - G2r).abs().max()) < 1e-12
    hh = hs["gather"](hs["ham_apply"](c1e, c2, xn))
    assert float((hh - h_ref).abs().max()) < 1e-12
    assert all(calls > 0 for calls, _bytes in D.COLLECTIVES.values())


@pytest.mark.cuda
def test_cuda_one_rank_nccl_newton_cores(nccl_mesh):
    """The tangent-sharded core (tangents on one axis, the state by grid
    rows on the other), the 2-D engine and GeometryBatch(mesh=) on one
    NCCL rank, (4e,4o) sector, against the single-card core: energy and
    gradient 1e-12, Hessian 1e-10, NR-step energy 1e-10."""
    from auto_oo_tpu_torch.parallel import (GeometryBatch, grid2d_nr_fns,
                                            sharded_grad_hess_fn)

    pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=2,
                                  sector=True, device="cuda")
    mols = [P.Moldata(P.get_formal_geo(a, p), "sto-3g")
            for a, p in ((140, 80), (135, 85))]
    oo = P.OO_pqc(pqc, mols[0], 4, 4, freeze_active=True)
    theta = 0.05 * torch.arange(pqc.theta_shape, dtype=torch.float64,
                                device="cuda")
    e, g, h = oo._grad_hess(theta)
    for gh in (sharded_grad_hess_fn(oo, nccl_mesh, axis="tp",
                                    state_axis="row"),
               grid2d_nr_fns(oo, nccl_mesh)["grad_hess"]):
        e_s, g_s, h_s = gh(theta, oo.oao_mo_coeff)
        assert abs(float(e_s - e)) < 1e-12
        assert float((g_s - g).abs().max()) < 1e-12
        assert float((h_s - h).abs().max()) < 1e-10
    step = grid2d_nr_fns(oo, nccl_mesh)["nr_step"](theta, oo.oao_mo_coeff)
    ref = oo._nr_iteration(theta, oo.oao_mo_coeff, 1e-4, 0.5, 1e-6, 1.1,
                           1e-6)
    assert abs(float(step[3]) - float(ref[3])) < 1e-10
    batch = GeometryBatch(mols, 4, 4, pqc, mesh=nccl_mesh, axis="tp")
    plain = GeometryBatch(mols, 4, 4, pqc)
    got = batch.newton_steps(pqc.init_zeros(), None)
    want = plain.newton_steps(pqc.init_zeros(), None)
    assert float((got[3] - want[3]).abs().max()) < 1e-12


# ---- the gate kernels (ops/gate_kernels.py) --------------------------------
#
# ``sweep_gate_kernels.compare`` holds each kernel to its plain version: the
# stepped operands equal them as values (torch.equal) in f64 and f32, the
# dot products of gate_adjoint_step within the rounding of their sums
# (``dot_bound``; at the (16e,16o) row slice in f32 that is ~2e-3 on sums of
# ~1e6 products that cancel to O(10)), and a second launch gives the same
# bits.


def _check_gate_kernels(tab, dtype, seed, L=2, nt=3):
    _, faults = sgk.compare(tab, dtype, seed, L, nt)
    assert not faults, faults


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_gate_kernels_match_plain_14e14o(cuda_device, dtype):
    """gate_rotate (both directions), gate_generator_add and
    gate_adjoint_step (with and without the (D, E) pair and the generator
    terms) against their plain versions on every gate of the cells'
    (14e,14o) np_fabric grid (3432 x 3432), 2 lanes; each launch counted."""
    prog = grid_gates.build_direct(14, 14, "np_fabric", n_layers=1,
                                   device=cuda_device)
    before = dict(gk.LAUNCHES)
    shapes = set()
    for gi, tab in enumerate(prog._gt):
        _check_gate_kernels(tab, dtype, 100 + gi)
        shapes.add(sgk.gate_shape(tab))
    assert shapes == {"beta-identity", "alpha-identity", "subgrid"}
    n = len(prog._gt)
    assert gk.LAUNCHES["gate_rotate"] == before["gate_rotate"] + 2 * n
    assert gk.LAUNCHES["gate_generator_add"] == \
        before["gate_generator_add"] + n
    assert gk.LAUNCHES["gate_adjoint_step"] == \
        before["gate_adjoint_step"] + 4 * n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_gate_kernels_match_plain_16e16o_rows(cuda_device, dtype):
    """The same on a row slice of the (16e,16o) grid: each gate of the
    cells' (16e,16o) np_fabric circuit cut to 40 row pairs at its full
    12,870-column width."""
    prog = grid_gates.build_direct(16, 16, "np_fabric", n_layers=1,
                                   device="cpu")
    for gi, g in enumerate(prog.gates):
        tab = sgk.row_slice(g, 40, prog.Na, prog.Nb, cuda_device)
        _check_gate_kernels(tab, dtype, 200 + gi, L=1, nt=2)


@pytest.mark.cuda
def test_cuda_gate_sweeps_match_cpu(cuda_device):
    """Every sweep of a (6e,6o) grid program in place on the card against
    the functional sweeps on the CPU (f64, 1e-13 relative): apply with and
    without lanes, apply_with_jacobian, hessian_dot with lanes, apply_pair,
    pair_row with v = 0 (stride-0 zero cotangent) and a live v; no input
    changed; the card's sweeps take the kernels only."""
    from auto_oo_tpu_torch.simulator.program import _SweepProgram as Sweep
    from auto_oo_tpu_torch.utils import observe

    progs = {d: grid_gates.build_direct(6, 6, "np_fabric", n_layers=2,
                                        device=d)
             for d in ("cpu", cuda_device)}
    n = progs["cpu"].n_params
    rng = np.random.default_rng(23)
    th = torch.from_numpy(0.4 * rng.standard_normal(n))
    ths = torch.from_numpy(0.4 * rng.standard_normal((3, n)))
    v = torch.from_numpy(rng.standard_normal(n))
    a, b = (torch.from_numpy(rng.standard_normal(progs["cpu"].dim))
            for _ in range(2))
    pidx = list(range(0, n, 2))

    def sweeps(call, to):
        t, ts, vv, aa, bb = (to(x) for x in (th, ths, v, a, b))
        zero = aa.new_zeros(()).expand(aa.shape)
        psi, J = call("apply_with_jacobian", t, pidx)
        psis, Js = call("apply_with_jacobian", ts, pidx)
        ws = torch.stack([aa, bb, aa])
        inputs = [t, ts, vv, aa, bb, psi, J, psis, Js, ws]
        kept = [x.clone() for x in inputs]
        out = dict(
            apply=call("apply", t), apply_lanes=call("apply", ts), psi=psi,
            J=J, hess=call("hessian_dot", ts, ws, psis, Js, pidx),
            pair=call("apply_pair", t, vv)[1],
            row0=call("pair_row", t, torch.zeros_like(vv), aa, zero, psi,
                      zero),
            row=call("pair_row", t, vv, aa, bb))
        for x, k in zip(inputs, kept):
            assert torch.equal(x, k), "a sweep changed its input"
        return out

    cpu = sweeps(lambda name, *args: getattr(Sweep, name)(progs["cpu"],
                                                         *args),
                 lambda x: x)
    observe.clear()
    was = observe.tracing(True)
    try:
        card = sweeps(lambda name, *args: getattr(progs[cuda_device], name)(
            *args), lambda x: x.to(cuda_device))
        torch.cuda.synchronize()
        counts = observe.counters()
        names = {r.name for r in observe.records()}
    finally:
        observe.tracing(was)
        observe.clear()
    for name, ref in cpu.items():
        assert _rel_err(card[name].cpu(), ref) < 1e-13, name
    assert counts.get("functional_gate_steps", 0) == 0
    assert {"oo/kernel:gate_rotate", "oo/kernel:gate_generator_add",
            "oo/kernel:gate_adjoint_step"} <= names


@pytest.mark.cuda
def test_cuda_gate_sweep_launch_counts(cuda_device):
    """One launch per gate step: a state sweep launches gate_rotate once
    a gate, the Adam step's adjoint sweep (pair_row with v = 0)
    gate_adjoint_step once a gate; under autograd the functional step runs
    and launches nothing."""
    from auto_oo_tpu_torch.utils import observe

    prog = grid_gates.build_direct(6, 6, "np_fabric", n_layers=1,
                                   device=cuda_device)
    n = len(prog._gt)
    th = torch.full((prog.n_params,), 0.1, dtype=torch.float64,
                    device=cuda_device)
    before = dict(gk.LAUNCHES)
    psi = prog.apply(th)
    a = torch.ones_like(psi)
    zero = a.new_zeros(()).expand(a.shape)
    prog.pair_row(th, torch.zeros_like(th), a, zero, psi, zero)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["gate_rotate"] == before["gate_rotate"] + n
    assert gk.LAUNCHES["gate_adjoint_step"] == \
        before["gate_adjoint_step"] + n
    observe.clear()
    was = observe.tracing(True)
    try:
        before = dict(gk.LAUNCHES)
        prog.apply(th.clone().requires_grad_(True)).sum().backward()
        assert observe.counters()["functional_gate_steps"] == n
        assert gk.LAUNCHES == before
    finally:
        observe.tracing(was)
        observe.clear()
