"""The two-spin Phi kernel's plain version against the JAX package.

``gather_two_spin`` builds both spin halves of Phi = E_pq x over a window
of grid rows in one pass, from the compact tables of its grid
(``GridMaps.two_spin_tables``); on the CPU it runs their plain walk
(``two_spin_walk``), which decodes them and runs the plain version, the
composite of the TPU layout (``gather_rows_scaled`` on both halves, the
beta half on a transposed copy of the rows, added back transposed).
Here the walk and that plain version are pinned against the JAX
package on the same seeded numpy inputs: in f64 against its XLA grid ops
(``phi_all`` for the full grid, ``_phi_rows_xla`` for windows) to 1e-14
of max |x| (the signs are +-1 and 0, so only the sum of the halves
rounds), in f32 against its Pallas wrappers in interpret mode
(``phi_all_pallas``, ``phi_rows_pallas``) to 1e-6.  The port's
``_phi_impl`` and ``_phi_chunk``, which now call it, equal the composite
they replaced bit for bit on the CPU.  The CUDA kernel is pinned against
the plain version on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from auto_oo_tpu.ops import grid as jgrid
from auto_oo_tpu.ops import pallas_grid as jpg
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.ops import grid, grid_kernels as gk
from auto_oo_tpu_torch.utils.interop import from_jax


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's default device is the card; these CPU tests ask for the
    CPU, and restore the default after the module."""
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


# a closed-shell and an open-shell sector; windows of their 6 grid rows:
# the full grid, a middle window and the ragged last window of a row
# chunk of 4
SECTORS = [(4, 4), (4, (2, 1))]
WINDOWS = [(0, 6), (2, 4), (4, 6)]


def _maps(ncas, nelecas):
    jm = jgrid.build_grid_maps(ncas, nelecas)
    return jm, from_jax(jm)


def _x(B, dim, seed, dtype):
    shape = (dim,) if B == 1 else (B, dim)
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _plain(x, pm, r0, r1):
    """gather_two_spin_plain on a flat grid-ordered x (..., D)."""
    xg = torch.from_numpy(x).reshape(x.shape[:-1] + (pm.Na, pm.Nb))
    return gk.gather_two_spin_plain(xg, *pm.phi_tables(xg), r0, r1)


@pytest.mark.parametrize("ncas,nelecas", SECTORS)
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("r0,r1", WINDOWS)
def test_two_spin_plain_matches_xla_f64(ncas, nelecas, B, r0, r1):
    jm, pm = _maps(ncas, nelecas)
    x = _x(B, jm.dim, 10 * r0 + B, np.float64)
    out = _plain(x, pm, r0, r1)
    if (r0, r1) == (0, jm.Na):
        ref = np.asarray(jgrid.phi_all(jnp.asarray(x), jm)).reshape(
            x.shape[:-1] + (jm.n2, jm.Na, jm.Nb))
    else:
        ref = np.asarray(jgrid._phi_rows_xla(jnp.asarray(x), jm, r0, r1))
    assert out.shape == ref.shape == x.shape[:-1] + (jm.n2, r1 - r0, jm.Nb)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-14 * np.abs(x).max())


@pytest.mark.parametrize("ncas,nelecas", SECTORS)
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("r0,r1", WINDOWS)
def test_two_spin_plain_matches_pallas_f32(ncas, nelecas, B, r0, r1):
    """f32 against the Pallas wrappers, as the JAX package's Pallas path
    runs them (interpret mode on the CPU)."""
    jm, pm = _maps(ncas, nelecas)
    x = _x(B, jm.dim, 20 * r0 + B, np.float32)
    out = _plain(x, pm, r0, r1)
    if (r0, r1) == (0, jm.Na):
        ref = np.asarray(jpg.phi_all_pallas(jnp.asarray(x), jm,
                                            interpret=True)).reshape(
            x.shape[:-1] + (jm.n2, jm.Na, jm.Nb))
    else:
        ref = np.asarray(jpg.phi_rows_pallas(jnp.asarray(x), jm, r0, r1,
                                             interpret=True))
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def _random_maps(na, nb, n2, seed):
    """JAX GridMaps of random tables: int32 src, +-1 signs with ~30%
    invalid (src 0, sign 0) entries, grid row 3 with no valid alpha pair
    and column 2 with no valid beta pair."""
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
    perm = np.arange(na * nb, dtype=np.int32)
    return jgrid.GridMaps(*(jnp.asarray(a) for a in (
        srcA, sgnA, tB, srcB, sgnB, tA, perm, perm)))


@pytest.mark.parametrize("na,nb,n2", [(13, 17, 5), (10, 20, 70)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_two_spin_plain_ragged_random_maps(na, nb, n2, dtype):
    """Random maps of ragged shapes (the card tests' Nb = 17 and 20,
    n2 = 5 and 70, a row with no valid pair) against the XLA grid op, two
    windows and a batch of two."""
    jm = _random_maps(na, nb, n2, na)
    pm = from_jax(jm)
    x = np.random.default_rng(n2).standard_normal((2, na * nb)).astype(dtype)
    for r0, r1 in ((0, na), (na // 3, na)):
        out = _plain(x, pm, r0, r1)
        ref = np.asarray(jgrid._phi_rows_xla(jnp.asarray(x), jm, r0, r1))
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                   atol=1e-14 * np.abs(x).max()
                                   if dtype == np.float64 else 1e-6)
    # grid row 3 has no valid alpha pair: only the beta half lands there
    beta_only = gk.gather_two_spin_plain(
        torch.from_numpy(x).reshape(2, na, nb), *pm.phi_tables(
            torch.from_numpy(x)), 3, 4)
    x0 = torch.from_numpy(x).reshape(2, na, nb).clone()
    x0[:, :3], x0[:, 4:] = 0, 0
    np.testing.assert_array_equal(
        beta_only.numpy(),
        gk.gather_two_spin_plain(x0, *pm.phi_tables(x0), 3, 4).numpy())


def _old_phi_impl(x, gm):
    """_phi_impl as it ran before gather_two_spin: gather_rows_scaled on
    both halves, the beta half on a transposed copy of the grid."""
    srcA, sgnA, tB, srcB, sgnB, tA = gm.tables(x)
    xg = x.reshape(x.shape[:-1] + (gm.Na, gm.Nb))
    pa = gk.gather_rows_scaled(xg, srcA, sgnA, tB)
    pb = gk.gather_rows_scaled(xg.transpose(-1, -2).contiguous(), srcB,
                               sgnB, tA)
    return (pa + pb.transpose(-1, -2)).reshape(x.shape[:-1]
                                               + (gm.n2, gm.dim))


def _old_phi_chunk(xg, gm, r0, r1):
    """_phi_chunk as it ran before gather_two_spin."""
    srcA_k, sgnA_k, tA_k = grid._row_tables(gm, xg, r0, r1)
    _, _, tB, srcB, sgnB, _ = gm.tables(xg)
    pa = gk.gather_rows_scaled(xg, srcA_k, sgnA_k, tB)
    zt = xg[..., r0:r1, :].transpose(-1, -2).contiguous()
    pb = gk.gather_rows_scaled(zt, srcB, sgnB, tA_k)
    return pa.add_(pb.transpose(-1, -2))


@pytest.mark.parametrize("ncas,nelecas", [(4, 4), (4, (2, 1)), (6, 6)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_phi_impl_and_chunk_equal_old_composite(ncas, nelecas, dtype):
    """The new _phi_impl / _phi_chunk against the composite they replaced,
    bit for bit, on the full maps, a pair slice and the transposed maps
    (the VJP's), B = 1 and 3; no kernel launch is counted on the CPU."""
    pm = grid.build_grid_maps(ncas, nelecas, device="cpu", dtype=dtype)
    before = dict(gk.LAUNCHES)
    chunk = max(1, pm.Na // 3)
    for maps in (pm, grid.pair_slice(pm, 3, 11), pm.transposed()):
        for B in (1, 3):
            x = torch.from_numpy(_x(B, pm.dim, B + maps.n2, np.float64)).to(
                dtype)
            assert torch.equal(grid._phi_impl(x, maps), _old_phi_impl(x, maps))
            xg = x.reshape(x.shape[:-1] + (pm.Na, pm.Nb))
            for r0, r1 in grid._row_chunks(pm.Na, chunk):
                new = grid._phi_chunk(xg, maps, r0, r1)
                assert new.dtype == dtype
                assert torch.equal(new, _old_phi_chunk(xg, maps, r0, r1))
    assert gk.LAUNCHES == before


def _dense():
    """Dense tables of n2 = 3 pairs over a (6, 4) grid: int32 src, int8
    signs and parities, all entries invalid."""
    return [torch.zeros((3, 6), dtype=torch.int32),
            torch.zeros((3, 6), dtype=torch.int8),
            torch.zeros((3, 4), dtype=torch.int8),
            torch.zeros((3, 4), dtype=torch.int32),
            torch.zeros((3, 4), dtype=torch.int8),
            torch.zeros((3, 6), dtype=torch.int8)]


def _operands(dtype=torch.float64):
    """gather_two_spin operands as the card takes them, on the CPU: x
    (2, 6, 4) and the compact tables of ``_dense``, n2 = 3."""
    return (torch.zeros((2, 6, 4), dtype=dtype),
            gk.two_spin_tables(*_dense()))


def test_two_spin_check_accepts_card_operands():
    x, tabs = _operands()
    assert gk._check_two_spin(x, tabs) == (2, 6, 4, 3)
    assert gk._check_two_spin(x.float(), tabs) == (2, 6, 4, 3)


@pytest.mark.parametrize("case,error", [
    ("x float16", TypeError),
    ("src int64", TypeError),
    ("signs float64", TypeError),
    ("x not contiguous", ValueError),
    ("table not contiguous", ValueError),
    ("table shape", ValueError),
    ("table on another device", ValueError),
])
def test_two_spin_check_refuses(case, error):
    """What the kernel does not take raises before any launch: a wrong
    dtype, a compact table of the wrong type, shape or device, a
    non-contiguous operand."""
    x, tabs = _operands()
    if case == "x float16":
        x = x.half()
    elif case == "src int64":
        tabs = tabs._replace(srcA=tabs.srcA.long())
    elif case == "signs float64":
        tabs = tabs._replace(codeB=tabs.codeB.double())
    elif case == "x not contiguous":
        x = torch.zeros((2, 4, 6), dtype=torch.float64).transpose(-1, -2)
    elif case == "table not contiguous":
        tabs = tabs._replace(srcB=torch.zeros((16, 3), dtype=torch.int16).T)
    elif case == "table shape":
        tabs = tabs._replace(codeA=tabs.codeA[:, :5].contiguous())
    else:
        tabs = tabs._replace(codeB=tabs.codeB.to("meta"))
    with pytest.raises(error, match="x |table|dtype"):
        gk._check_two_spin(x, tabs)


@pytest.mark.parametrize("r0,r1", [(-1, 3), (2, 2), (4, 3), (0, 7)])
def test_two_spin_window_out_of_range_raises(r0, r1):
    x, tabs = _operands()
    with pytest.raises(ValueError, match="window"):
        gk.gather_two_spin(x, tabs, r0, r1)


def test_two_spin_other_device_raises():
    """No silent fallback: x on neither the CPU nor the card raises."""
    x, tabs = _operands()
    with pytest.raises(NotImplementedError):
        gk.gather_two_spin(x.to("meta"), tabs._replace(
            **{nm: v.to("meta") for nm, v in tabs._asdict().items()}), 0, 6)


@pytest.mark.parametrize("case,plan", [
    # (B, Na, R, Nb, n2, itemsize, align): the routes' calls, one per class
    ((1, 12870, 495, 12870, 256, 8, 16), (2, 832, 40, 0, 128)),  # 16e f64
    ((15, 12870, 14, 12870, 256, 4, 16), (2, 832, 40, 1, 128)),  # Gram
    ((1, 12870, 990, 12870, 256, 4, 16), (2, 832, 40, 1, 128)),  # f32 pass
    ((1, 3432, 1716, 3432, 196, 8, 16), (2, 448, 40, 0, 32)),    # 14e
    ((1, 3432, 3432, 3432, 196, 4, 16), (4, 224, 40, 0, 32)),    # 14e f32
    ((1, 924, 924, 924, 144, 8, 16), (2, 128, 5, 0, 32)),        # 12e
    ((5, 252, 252, 252, 100, 8, 16), (2, 32, 5, 0, 32)),         # 10e, B=5
    ((6, 13, 13, 17, 5, 8, 16), (1, 32, 5, 0, 128)),   # ragged: scalars
    ((1, 924, 924, 924, 144, 8, 8), (1, 128, 5, 0, 32)),  # unaligned x
    ((2, 252, 37, 252, 100, 4, 8), (2, 32, 5, 0, 128)),   # f32, 8 bytes
    ((1, 10, 1, 20, 9, 8, 16), (2, 32, 5, 0, 32)),        # R = 1
    ((1, 40000, 4, 40000, 256, 4, 16), (4, 864, 40, 0, 32)),  # wide f32
])
def test_plan_two_spin(case, plan):
    """gather_two_spin's plan: the widest loads every row's start allows
    (16 bytes, else 8 or one element), whole warps of at most 1024
    threads covering the row's slots (``two_spin_unroll`` a lane, the
    row's stores from a 32-byte sector where rows are whole sectors, else
    a 128-byte line) in equal rounds, 5 pairs a block where x fits half
    the L2 and 40 beyond, the beta tables staged by the warps in f32 where
    a pair's tables pass TWO_SPIN_STAGE and the block still fits its 227
    KB (an f32 row of 40,000 elements reads them in memory)."""
    p = gk.plan_two_spin(*case)
    assert tuple(p) == plan
    B, Na, R, Nb, n2, item, align = case
    assert Nb % p.vec == 0 and align % (p.vec * item) == 0
    assert p.line == (32 if Nb * item % 32 == 0 else 128)
    assert gk.two_spin_smem(Nb, n2, item, p) <= 232448
    assert p.threads % 32 == 0 and 32 <= p.threads <= gk.TWO_SPIN_BLOCK
    step = gk.two_spin_unroll(p.vec, item)
    slots = Nb // p.vec + p.line // (p.vec * item)
    rounds = -(-slots // (step * p.threads))
    assert rounds == -(-slots // (step * gk.TWO_SPIN_BLOCK))
    assert (p.threads - 32) * step * rounds < slots
    assert p.pairs == min(n2, 5 if B * Na * Nb * item <= 25 << 20 else 40)
    staged = p._replace(staged=1)
    assert p.staged == (item == 4 and -(-Nb // 16) * 16 * 3 > 16384
                        and gk.two_spin_smem(Nb, n2, item, staged) <= 232448)


def test_two_spin_entry_point_takes_the_plan():
    """The C entry point's arguments: x, four tables, out, B, the seven
    sizes (n2, Na, Nb, the padded width, r0, R, the source columns'
    bytes), every field of the plan and the stream."""
    args = gk.LIBRARY.symbols["grid_gather_two_spin_f64"]
    assert args == gk.LIBRARY.symbols["grid_gather_two_spin_f32"]
    assert len(args) == 6 + 1 + 7 + len(gk.TwoSpinPlan._fields) + 1
    assert args[6] is gk.I64 and args[-1] is gk.PTR
    assert all(a is gk.I32 for a in args[7:-1])


def test_plan_two_spin_refuses_rows_beyond_shared_memory():
    """One row of x with its alpha entries beside it must fit a block's
    227 KB: 29,036 f64 elements do at n2 = 256, 29,038 do not (58,072 and
    58,074 in f32)."""
    for item, widest in ((8, 29036), (4, 58072)):
        plan = gk.plan_two_spin(1, widest, 4, widest, 256, item)
        assert gk.two_spin_smem(widest, 256, item, plan) <= 232448
        with pytest.raises(ValueError, match="shared memory"):
            gk.plan_two_spin(1, widest + 2, 4, widest + 2, 256, item)


# ---- the compact tables of the card's kernel ------------------------------


def _maps_cases():
    """Full maps of two sectors, a pair slice and the transposed maps (the
    VJP's), and random maps with invalid entries."""
    out = []
    for ncas, nelecas in ((4, 4), (4, (2, 1)), (6, 6)):
        pm = grid.build_grid_maps(ncas, nelecas, device="cpu")
        out += [pm, grid.pair_slice(pm, 3, 11), pm.transposed()]
    out.append(from_jax(_random_maps(13, 17, 5, 13)))
    return out


@pytest.mark.parametrize("case", range(10))
def test_two_spin_tables_equal_phi_tables(case):
    """The compact tables hold GridMaps.phi_tables entry by entry: the
    source rows and columns, and each code's sign and parity (the beta
    columns in int16 below 32,768 columns, their rows padded to a
    multiple of 16 columns with invalid entries)."""
    pm = _maps_cases()[case]
    srcA, sgnA, tB, srcB, sgnB, tA = pm.phi_tables(torch.zeros(()))
    tabs = pm.two_spin_tables()
    Nb, Nbp = pm.Nb, -(-pm.Nb // 16) * 16
    assert tabs.srcA.dtype == torch.int32 and tabs.srcB.dtype == torch.int16
    assert tabs.codeA.dtype == tabs.codeB.dtype == torch.int8
    assert tabs.srcB.shape == tabs.codeB.shape == (pm.n2, Nbp)
    assert torch.equal(tabs.srcA.long(), srcA)
    assert torch.equal(tabs.srcB[:, :Nb].long(), srcB)
    for code, sign, parity in ((tabs.codeA, sgnA, tA),
                               (tabs.codeB[:, :Nb], sgnB, tB)):
        assert torch.equal((code & 3) - 1, sign)
        assert torch.equal(((code >> 2) & 3) - 1, parity)
        assert code.shape == sign.shape
    # the padding columns: source 0, sign 0
    assert not tabs.srcB[:, Nb:].any()
    assert bool(((tabs.codeB[:, Nb:] & 3) == 1).all())
    assert all(v.is_contiguous() for v in tabs)


def test_two_spin_tables_cached_per_maps():
    """GridMaps.two_spin_tables builds once per maps object; a pair slice
    and the transposed maps hold their own, equal to the full maps' rows."""
    pm = grid.build_grid_maps(4, 4, device="cpu")
    tabs = pm.two_spin_tables()
    assert pm.two_spin_tables() is tabs
    sl = grid.pair_slice(pm, 3, 11)
    assert sl.two_spin_tables() is sl.two_spin_tables()
    for name in tabs._fields:
        assert torch.equal(getattr(sl.two_spin_tables(), name),
                           getattr(tabs, name)[3:11])
        perm = pm.pair_perm()
        assert torch.equal(getattr(pm.transposed().two_spin_tables(), name),
                           getattr(tabs, name)[perm])


def test_two_spin_tables_wide_grid_and_refusals():
    """Past 32,767 columns the beta sources stay int32; the card's codes
    take signs and parities +-1 or 0 only; compact tables of the wrong
    type, shape or alignment raise before any launch."""
    src = torch.tensor([[0, 2, 1]], dtype=torch.int32)
    one = torch.ones((1, 3), dtype=torch.int8)
    assert gk.two_spin_tables(src, one, one, src, one, one).srcB.dtype == \
        torch.int16
    wide = torch.zeros((1, 32768), dtype=torch.int32)
    wide[0, -1] = 32767 + 5
    sw = torch.ones((1, 32768), dtype=torch.int8)
    tabs = gk.two_spin_tables(src, one, sw, wide, sw, one)
    assert tabs.srcB.dtype == torch.int32
    assert int(tabs.srcB[0, -1]) == 32772
    with pytest.raises(ValueError, match="sign values"):
        gk.two_spin_tables(src, 2 * one, one, src, one, one)
    with pytest.raises(ValueError, match="parity values"):
        gk.two_spin_tables(src, one, one, src, one, 3 * one)
    x, good = _operands()
    gk._check_two_spin(x, good)
    for bad, error in ((good._replace(srcB=good.srcB.int()), TypeError),
                       (good._replace(codeA=good.codeA[:, :5].contiguous()),
                        ValueError),
                       (good._replace(codeB=good.codeB.T.contiguous().T),
                        ValueError),
                       (good._replace(srcA=torch.zeros(
                           25, dtype=torch.int32)[1:19].view(3, 6)),
                        ValueError)):
        with pytest.raises(error, match="table"):
            gk._check_two_spin(x, bad)


@pytest.mark.parametrize("ncas,nelecas", SECTORS)
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("r0,r1", WINDOWS)
def test_two_spin_walk_matches_plain_and_jax(ncas, nelecas, B, r0, r1):
    """A plain walk of the compact tables (``two_spin_walk``, the card
    kernel's reading of them) equals gather_two_spin_plain as values, and
    through it the JAX XLA path in f64 (1e-14 of max |x|) and the Pallas
    path in interpret mode in f32 (1e-6)."""
    jm, pm = _maps(ncas, nelecas)
    tabs = pm.two_spin_tables()
    for dtype, seed in ((np.float64, 30), (np.float32, 40)):
        x = _x(B, jm.dim, seed * (r0 + 1) + B, dtype)
        xg = torch.from_numpy(x).reshape(x.shape[:-1] + (pm.Na, pm.Nb))
        walk = gk.two_spin_walk(xg, tabs, r0, r1)
        assert torch.equal(walk, _plain(x, pm, r0, r1))
        if dtype == np.float64:
            ref = np.asarray(jgrid._phi_rows_xla(jnp.asarray(x), jm, r0, r1))
            tol = 1e-14 * np.abs(x).max()
        else:
            ref = np.asarray(jpg.phi_rows_pallas(jnp.asarray(x), jm, r0, r1,
                                                 interpret=True))
            tol = 1e-6
        np.testing.assert_allclose(walk.numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("na,nb,n2", [(13, 17, 5), (10, 20, 70)])
def test_two_spin_walk_ragged_random_maps(na, nb, n2):
    """The walk on random maps of ragged shapes (rows with no valid pair)
    equals the plain version on every window the card tests take."""
    pm = from_jax(_random_maps(na, nb, n2, na))
    x = torch.from_numpy(np.random.default_rng(n2).standard_normal(
        (2, 3, na, nb)))
    for r0, r1 in ((0, na), (na // 3, na), (3, 4)):
        assert torch.equal(
            gk.two_spin_walk(x, pm.two_spin_tables(), r0, r1),
            gk.gather_two_spin_plain(x, *pm.phi_tables(x), r0, r1))


@pytest.mark.parametrize("B", [3, 10000])
def test_two_spin_bytes(B):
    """The bound counts Phi once, the distinct rows of x the window needs
    (valid alpha sources and the window's own rows) once and the compact
    tables the kernel reads once: 5 bytes per alpha entry of the window,
    3 per padded beta entry.  The re-read floor, where x does not fit half
    the L2, adds every valid alpha entry's row past its first read; where
    x fits, there is none."""
    pm = grid.build_grid_maps(6, 6, device="cpu")
    tabs = pm.two_spin_tables()
    x = torch.zeros((1, 1, 1), dtype=torch.float64).expand(B, pm.Na, pm.Nb)
    r0, r1 = 5, 12
    nb = gk.two_spin_bytes(x, tabs, r0, r1)
    row = pm.Nb * 8
    src = pm.srcA[:, r0:r1][pm.sgnA[:, r0:r1] != 0]
    rows = set(src.tolist()) | set(range(r0, r1))
    Nbp = -(-pm.Nb // 16) * 16
    assert nb.bound == (B * pm.n2 * (r1 - r0) * row + B * len(rows) * row
                        + pm.n2 * (5 * (r1 - r0) + 3 * Nbp))
    fits = B * pm.Na * pm.Nb * 8 <= 25 << 20
    assert fits == (B == 3) == gk.two_spin_in_l2(B, pm.Na, pm.Nb, 8)
    if fits:
        assert nb.reread is None
    else:
        assert nb.reread - nb.bound == B * (len(src)
                                            - len(set(src.tolist()))) * row
        assert nb.reread > nb.bound
