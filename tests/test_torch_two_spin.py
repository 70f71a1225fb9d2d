"""The two-spin Phi kernel's plain version against the JAX package.

``gather_two_spin`` builds both spin halves of Phi = E_pq x over a window
of grid rows in one pass; on the CPU it runs its plain version, the
composite of the TPU layout (``gather_rows_scaled`` on both halves, the
beta half on a transposed copy of the rows, added back transposed).
Here that plain version is pinned against the JAX package on the same
seeded numpy inputs: in f64 against its XLA grid ops (``phi_all`` for the
full grid, ``_phi_rows_xla`` for windows) to 1e-14 of max |x| (the signs
are +-1 and 0, so only the sum of the halves rounds), in f32 against its
Pallas wrappers in interpret mode (``phi_all_pallas``, ``phi_rows_pallas``)
to 1e-6.  The port's ``_phi_impl`` and ``_phi_chunk``, which now call it,
equal the composite they replaced bit for bit on the CPU.  The CUDA
kernel is pinned against the plain version on the card in
tests/test_torch_cuda.py.
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


def _operands(dtype=torch.float64):
    """gather_two_spin operands as the card takes them, on the CPU: x
    (2, 6, 4), int32 src, int8 signs, n2 = 3."""
    x = torch.zeros((2, 6, 4), dtype=dtype)
    tabs = [torch.zeros((3, 6), dtype=torch.int32),
            torch.zeros((3, 6), dtype=torch.int8),
            torch.zeros((3, 4), dtype=torch.int8),
            torch.zeros((3, 4), dtype=torch.int32),
            torch.zeros((3, 4), dtype=torch.int8),
            torch.zeros((3, 6), dtype=torch.int8)]
    return x, tabs


def test_two_spin_check_accepts_card_operands():
    x, tabs = _operands()
    assert gk._check_two_spin(x, *tabs) == (2, 6, 4)
    assert gk._check_two_spin(x.float(), *tabs) == (2, 6, 4)


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
    dtype, a table of the wrong type, shape or device, a non-contiguous
    operand."""
    x, tabs = _operands()
    if case == "x float16":
        x = x.half()
    elif case == "src int64":
        tabs[0] = tabs[0].long()
    elif case == "signs float64":
        tabs[4] = tabs[4].double()
    elif case == "x not contiguous":
        x = torch.zeros((2, 4, 6), dtype=torch.float64).transpose(-1, -2)
    elif case == "table not contiguous":
        tabs[3] = torch.zeros((4, 3), dtype=torch.int32).T
    elif case == "table shape":
        tabs[5] = tabs[5][:, :5].contiguous()
    else:
        tabs[2] = tabs[2].to("meta")
    with pytest.raises(error):
        gk._check_two_spin(x, *tabs)


@pytest.mark.parametrize("r0,r1", [(-1, 3), (2, 2), (4, 3), (0, 7)])
def test_two_spin_window_out_of_range_raises(r0, r1):
    x, tabs = _operands()
    with pytest.raises(ValueError, match="window"):
        gk.gather_two_spin(x, *tabs, r0, r1)


def test_two_spin_other_device_raises():
    """No silent fallback: x on neither the CPU nor the card raises."""
    x, tabs = _operands()
    with pytest.raises(NotImplementedError):
        gk.gather_two_spin(x.to("meta"), *(t.to("meta") for t in tabs), 0, 6)


@pytest.mark.parametrize("case,plan", [
    # (B, R, Nb, n2, itemsize, aligned): the routes' calls
    ((1, 495, 12870, 256, 8, True), (2, 1, 512, 29)),   # (16e,16o) chunk
    ((1, 495, 12870, 256, 4, True), (1, 2, 512, 15)),   # f32: Nb % 4 != 0
    ((1, 1716, 3432, 196, 8, True), (2, 2, 512, 40)),   # (14e,14o) chunk
    ((1, 3432, 3432, 196, 4, True), (4, 2, 512, 66)),   # (14e,14o) all, f32
    ((1, 924, 924, 144, 8, True), (2, 2, 256, 15)),     # (12e,12o)
    ((5, 252, 252, 100, 8, True), (2, 2, 64, 15)),      # (10e,10o), B = 5
    ((6, 13, 17, 5, 8, True), (1, 2, 32, 1)),           # ragged: scalars
    ((1, 924, 924, 144, 8, False), (1, 2, 256, 15)),    # unaligned
    ((1, 1, 20, 9, 8, True), (2, 1, 32, 1)),            # one row
])
def test_plan_two_spin(case, plan):
    """gather_two_spin's plan: 16-byte vectors where every row is aligned,
    two staged rows where two such blocks share an SM's 228 KB, whole
    warps of at most 512 threads covering a row (each thread taking
    ``two_spin_unroll`` vectors per step), pairs split until ~32 blocks
    per SM."""
    p = gk.plan_two_spin(*case)
    assert tuple(p) == plan
    B, R, Nb, n2, item, _ = case
    assert 2 * (p.rows * Nb * item + 1024) <= 233472 or p.rows == 1
    assert p.threads % 32 == 0 and 32 <= p.threads <= gk.TWO_SPIN_BLOCK
    step = gk.two_spin_unroll(p.vec, p.rows)
    assert (p.threads == gk.TWO_SPIN_BLOCK
            or (p.threads - 32) * step < Nb // p.vec <= p.threads * step)
    assert p.rows in (1, 2) and p.rows <= R and 1 <= p.pairs <= n2


def test_plan_two_spin_refuses_rows_beyond_shared_memory():
    """One f64 row of 29,057 elements does not fit a block's 227 KB."""
    assert gk.plan_two_spin(1, 4, 29056, 9, 8).rows == 1
    with pytest.raises(ValueError, match="shared memory"):
        gk.plan_two_spin(1, 4, 29057, 9, 8)
