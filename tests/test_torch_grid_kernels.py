"""The port's grid-gather kernels and grid ops against the JAX package.

On the CPU the wrappers run the plain PyTorch versions; these are pinned
against the JAX package's Pallas kernels (interpret mode, as
tests/test_pallas_grid.py runs them) and its XLA grid ops.  The CUDA
kernels are pinned against the plain versions on the card in
tests/test_torch_cuda.py.

Tolerances: the Pallas kernels multiply x * (s * t) and the plain
versions (x * s) * t, so random non-sign scales differ by rounding
(1e-14 in f64, 1e-6 in f32); on the real maps the scales are +-1 and 0
and the products are exact.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from auto_oo_tpu.ops import grid as jgrid
from auto_oo_tpu.ops import pallas_grid as jpg
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.ops import cuda_build, grid, grid_kernels as gk
from auto_oo_tpu_torch.utils.interop import from_jax


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's default device is the card; these CPU tests ask for the
    CPU, and restore the default after the module."""
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


SECTORS = [(2, 2), (4, 4), (4, (2, 1)), (3, 4)]
FIELDS = ("srcA", "sgnA", "tB", "srcB", "sgnB", "tA", "g2s", "s2g")
TOL = {np.float64: 1e-14, np.float32: 1e-6}


def _maps(ncas, nelecas):
    jm = jgrid.build_grid_maps(ncas, nelecas)
    return jm, from_jax(jm)


def _rand(shape, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("ncas,nelecas", SECTORS)
def test_maps_equal_as_integers(ncas, nelecas):
    jm = jgrid.build_grid_maps(ncas, nelecas)
    tabs = grid.grid_tables(ncas, nelecas)
    pm = grid.build_grid_maps(ncas, nelecas)
    for f in FIELDS:
        a = np.asarray(getattr(jm, f))
        np.testing.assert_array_equal(tabs[f], a)
        np.testing.assert_array_equal(getattr(pm, f).numpy(), a)
    assert (pm.n2, pm.Na, pm.Nb, pm.dim) == (jm.n2, jm.Na, jm.Nb, jm.dim)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_gather_rows_scaled_plain_vs_pallas(dtype, lead):
    """Partial rows (Na, Nb not multiples of any block), random src with
    invalid (src 0, s 0) entries, leading batch dims."""
    rng = np.random.default_rng(7)
    ns, na, nb, n2 = 11, 13, 17, 5
    x = rng.standard_normal(lead + (ns, nb)).astype(dtype)
    src = rng.integers(0, ns, size=(n2, na)).astype(np.int32)
    s = rng.standard_normal((n2, na)).astype(dtype)
    invalid = rng.random((n2, na)) < 0.3
    src[invalid], s[invalid] = 0, 0
    t = rng.standard_normal((n2, nb)).astype(dtype)
    ref = np.asarray(jpg.gather_rows_scaled(
        jnp.asarray(x), jnp.asarray(src), jnp.asarray(s), jnp.asarray(t),
        interpret=True))
    out = gk.gather_rows_scaled(torch.from_numpy(x),
                                torch.from_numpy(src).long(),
                                torch.from_numpy(s), torch.from_numpy(t))
    assert out.shape == ref.shape and out.dtype == torch.from_numpy(x).dtype
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("nb", [3, 14, 495])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_gather_rows_scaled_short_rows_vs_pallas(dtype, nb, lead):
    """The shapes the card's kernel packs several rows a warp for: short
    rows (Nb = 3, and 14 as the hosted x row-sharded engine's beta half
    has them), an odd Nb (495, the (16e,16o) hosted chunk's beta half),
    non-sign s, invalid (src 0, s 0) entries, leading batch dims."""
    rng = np.random.default_rng(nb)
    ns, na, n2 = 19, 23, 6
    x = rng.standard_normal(lead + (ns, nb)).astype(dtype)
    src = rng.integers(0, ns, size=(n2, na)).astype(np.int32)
    s = rng.uniform(-2, 2, (n2, na)).astype(dtype)
    invalid = rng.random((n2, na)) < 0.4
    src[invalid], s[invalid] = 0, 0
    t = rng.standard_normal((n2, nb)).astype(dtype)
    ref = np.asarray(jpg.gather_rows_scaled(
        jnp.asarray(x), jnp.asarray(src), jnp.asarray(s), jnp.asarray(t),
        interpret=True))
    out = gk.gather_rows_scaled(torch.from_numpy(x),
                                torch.from_numpy(src).long(),
                                torch.from_numpy(s), torch.from_numpy(t))
    assert out.shape == ref.shape == lead + (n2, na, nb)
    # two products rounded in two orders: within 4 ulp of each other
    np.testing.assert_allclose(out.numpy(), ref,
                               rtol=4 * np.finfo(dtype).eps, atol=0)
    np.testing.assert_array_equal(out.numpy()[..., invalid, :], 0)


# (B, Ns, Na, Nb, n2, itemsize, align, block order): the callers' shapes
ROWS_SHAPES = [
    (1, 252, 252, 252, 100, 8, 16, 1),       # (10e,10o) one-spin Phi
    (1, 924, 924, 924, 144, 4, 16, 1),       # (12e,12o), f32
    (1, 3432, 3432, 3432, 196, 8, 16, 0),    # (14e,14o) one-spin Phi
    (1, 3432, 1716, 3432, 196, 4, 16, 0),    # its streamed chunk, f32
    (1, 12870, 14, 12870, 256, 8, 16, 1),    # sharded segment, alpha
    (1, 12870, 12870, 14, 256, 8, 16, 1),    # sharded segment, beta
    (1, 12870, 495, 12870, 256, 4, 16, 1),   # (16e,16o) chunk, alpha, f32
    (1, 12870, 12870, 495, 256, 8, 16, 0),   # chunk, beta: odd Nb
    (1, 928, 928, 1024, 144, 8, 16, 1),      # probes, ncas = 12
    (3, 11, 13, 17, 5, 4, 16, 1),            # ragged, B = 3
    (1, 11, 13, 18, 5, 8, 8, 1),             # x not on 16 bytes
]


@pytest.mark.parametrize("case", ROWS_SHAPES)
def test_plan_rows_scaled(case):
    """gather_rows_scaled's plan at the callers' shapes: the widest slot
    whose loads are vectors too (16 bytes, 8 for f32 rows of an even Nb),
    else 16-byte slots with loads element by element (an odd Nb, an x on
    8 bytes),
    whole warps within the kernel's 512, an unroll the kernel takes, the
    block order by where x lies (order 0 at (14e,14o) and the (16e,16o)
    chunk's beta half, 1 where x fits half the L2 or its n2 rows pass a
    quarter of it), the slots of a slab within the kernel's 2^31 - 1
    elements; no shared memory is staged, so every plan is within a
    block's 227 KB."""
    B, Ns, Na, Nb, n2, item, align, order = case
    p = gk.plan_rows_scaled(B, Ns, Na, Nb, n2, item, align)
    elem = gk.rows_elem(Nb, p.vec, item, align)
    # the widest slot with vector loads, else 16 bytes of element loads
    widest = max(v for v in (1, 2, 4) if v * item <= 16
                 and (v == 1 or not gk.rows_elem(Nb, v, item, align)))
    assert p.vec == (16 // item if widest == 1 else widest)
    assert elem == (widest == 1)
    assert p.threads % 32 == 0 and 32 <= p.threads <= gk.ROWS_BLOCK
    assert p.unroll in gk.ROWS_UNROLLS and p.order == order
    chunks = gk.rows_scaled_chunks(Na, Nb, item, p)
    assert 0 < chunks * p.threads * p.unroll * p.vec <= 2 ** 31 - 1
    assert B * n2 <= 2 ** 31 - 1


@pytest.mark.parametrize("B,n2,Na,Nb,item", [
    (1, 5, 13, 17, 8), (3, 4, 7, 14, 8), (2, 3, 5, 3, 4), (1, 9, 33, 495, 8),
    (2, 4, 6, 12, 4), (1, 2, 1, 1, 8), (1, 3, 40, 64, 8), (2, 3, 7, 5, 4)])
def test_rows_scaled_slot_map(B, n2, Na, Nb, item):
    """On small shapes, for every plan the kernel takes (vectors of 16, 8
    and 4 bytes, whether or not they divide Nb; 32 to 256 threads, each
    unroll, both orders), the kernel's slot map writes each output
    element exactly once, and every store instruction of a warp starts on
    a 128-byte line of out."""
    for vec in (v for v in (1, 2, 4) if v * item <= 16):
        for threads in (32, 64, 256):
            for unroll in gk.ROWS_UNROLLS:
                for order in (0, 1):
                    plan = gk.RowsPlan(vec, threads, unroll, order)
                    el, lines = gk.rows_scaled_slot_map(B, n2, Na, Nb,
                                                        item, plan)
                    assert lines, plan
                    np.testing.assert_array_equal(
                        np.sort(el), np.arange(B * n2 * Na * Nb))


def test_rows_divisor():
    """The kernel's division of a slab's element index by Nb: exact for
    every index below 2^31 (edges and random ones) at the callers' widths
    and at random divisors."""
    rng = np.random.default_rng(3)
    divisors = [1, 2, 3, 7, 14, 17, 252, 495, 924, 1024, 3432, 12870,
                2 ** 30 + 1, 2 ** 31 - 1] + list(rng.integers(1, 2 ** 31, 200))
    for d in map(int, divisors):
        m, l = gk.rows_divisor(d)
        assert 0 < m < 2 ** 32 and 0 <= l <= 31
        n = np.concatenate([[0, 1, d - 1, d, d + 1, 2 ** 31 - 1],
                            rng.integers(0, 2 ** 31, 500)]).astype(np.uint64)
        n = n[n < 2 ** 31]
        q = ((n * np.uint64(m)) >> np.uint64(32)) + n
        np.testing.assert_array_equal(q >> np.uint64(l), n // np.uint64(d))
    with pytest.raises(ValueError):
        gk.rows_divisor(0)


@pytest.mark.parametrize("ns,big", [(11, False), (3432, True)])
def test_rows_scaled_bytes(ns, big):
    """rows_scaled_bytes against a numpy count: out once, each distinct
    source row of the valid entries once per state, the tables once (src
    as int32); the re-read floor only where x passes half the L2 (x of
    3432 x 3432 f64, 94 MB, as the (14e,14o) one-spin Phi)."""
    rng = np.random.default_rng(ns)
    B, n2, na, nb = (2, 5, 13, 17) if not big else (1, 3, 40, ns)
    x = torch.zeros((B, ns, nb), dtype=torch.float64)
    src = rng.integers(0, ns if not big else 50, size=(n2, na))
    s = rng.standard_normal((n2, na))
    s[rng.random((n2, na)) < 0.3] = 0
    src[s == 0] = 0
    t = torch.zeros((n2, nb), dtype=torch.float64)
    got = gk.rows_scaled_bytes(x, torch.from_numpy(src),
                               torch.from_numpy(s), t)
    valid = src[s != 0]
    distinct = np.unique(valid).size
    bound = (B * n2 * na * nb * 8 + B * distinct * nb * 8
             + n2 * na * (4 + 8) + n2 * nb * 8)
    assert got.bound == bound
    if big:
        assert got.reread == bound + B * (valid.size - distinct) * nb * 8
    else:
        assert got.reread is None


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_gather_reduce_plain_vs_pallas(dtype, lead):
    rng = np.random.default_rng(8)
    ns, na, nb, n2 = 9, 13, 17, 5
    Y = rng.standard_normal(lead + (n2, ns, nb)).astype(dtype)
    src = rng.integers(0, ns, size=(n2, na)).astype(np.int32)
    s = rng.standard_normal((n2, na)).astype(dtype)
    t = rng.standard_normal((n2, nb)).astype(dtype)
    ref = np.asarray(jpg.gather_reduce(
        jnp.asarray(Y), jnp.asarray(src), jnp.asarray(s), jnp.asarray(t),
        interpret=True))
    out = gk.gather_reduce(torch.from_numpy(Y), torch.from_numpy(src).long(),
                           torch.from_numpy(s), torch.from_numpy(t))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=10 * TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_gather_reduce_cols_plain_vs_pallas(dtype, lead):
    """The column form against the JAX package's Pallas gather_reduce on
    the transposed Y (interpret mode), transposed back: ragged widths
    (Na = 17 rows of Ns = 9 sources, Nc = 13 columns), invalid (src 0,
    s 0) entries, one column with no valid pair, leading batch dims."""
    rng = np.random.default_rng(9)
    ns, na, nc, n2 = 9, 17, 13, 5
    Y = rng.standard_normal(lead + (n2, na, ns)).astype(dtype)
    src = rng.integers(0, ns, size=(n2, nc)).astype(np.int32)
    s = rng.standard_normal((n2, nc)).astype(dtype)
    invalid = rng.random((n2, nc)) < 0.3
    invalid[:, 4] = True
    src[invalid], s[invalid] = 0, 0
    t = rng.standard_normal((n2, na)).astype(dtype)
    ref = np.swapaxes(np.asarray(jpg.gather_reduce(
        jnp.swapaxes(jnp.asarray(Y), -1, -2), jnp.asarray(src),
        jnp.asarray(s), jnp.asarray(t), interpret=True)), -1, -2)
    out = gk.gather_reduce_cols(torch.from_numpy(Y),
                                torch.from_numpy(src).long(),
                                torch.from_numpy(s), torch.from_numpy(t))
    assert out.shape == ref.shape == lead + (na, nc)
    assert out.dtype == torch.from_numpy(Y).dtype
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=10 * TOL[dtype])
    np.testing.assert_array_equal(out.numpy()[..., 4], 0)


@pytest.mark.parametrize("case,plan", [
    # (B, Na, Nb, n2, itemsize, aligned): the main path's calls
    ((1, 924, 924, 144, 8, True), (2, 1, 480)),   # (12e,12o) f64
    ((1, 924, 924, 144, 4, True), (4, 2, 480)),   # (12e,12o) f32
    ((5, 252, 252, 100, 8, True), (2, 1, 320)),   # (10e,10o) f64, B = 5
    ((3, 252, 252, 100, 8, True), (2, 1, 384)),   # B = 3
    ((1, 252, 252, 100, 8, True), (2, 4, 512)),   # B = 1: four rows
    ((6, 13, 17, 5, 8, True), (1, 5, 512)),       # ragged: scalars
    ((1, 924, 924, 144, 8, False), (1, 1, 480)),  # unaligned: scalars
    ((1, 4000, 2, 400, 8, True), (2, 6, 32)),     # shared memory caps rows
])
def test_plan_reduce(case, plan):
    """gather_reduce's plan: 16-byte vectors where every row is aligned,
    whole warps, one row per block split into equal rounds for wide rows
    (less than one idle warp per round: 18 of 480 threads at (12e,12o)),
    rows packed for narrow ones, within 48 KB of staged pair lists."""
    p = gk.plan_reduce(*case)
    assert tuple(p) == plan
    B, Na, Nb, n2, item, _ = case
    tasks = p.rows * B * (Nb // p.vec)
    rounds = -(-tasks // p.threads)
    assert p.threads % 32 == 0 and 32 <= p.threads <= 512
    assert rounds * p.threads - tasks < rounds * 32
    per_list = n2 * (12 + item) + (-(-n2 // 32) + 1) * 4
    assert p.rows * per_list <= 48 * 1024


@pytest.mark.parametrize("ncas,nelecas", SECTORS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_phi_all_matches_xla(ncas, nelecas, dtype):
    jm, pm = _maps(ncas, nelecas)
    x = _rand((2, jm.dim), 1, dtype)
    ref = np.asarray(jgrid._phi_all_xla(jnp.asarray(x), jm))
    out = grid.phi_all(torch.from_numpy(x), pm)
    assert out.shape == ref.shape == (2, jm.n2, jm.dim)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("ncas,nelecas", SECTORS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_epq_sum_matches_xla(ncas, nelecas, dtype):
    jm, pm = _maps(ncas, nelecas)
    Y = _rand((3, jm.n2, jm.dim), 2, dtype)
    ref = np.asarray(jgrid._epq_sum_xla(jnp.asarray(Y), jm))
    out = grid.epq_sum(torch.from_numpy(Y), pm)
    assert out.shape == ref.shape == (3, jm.dim)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=10 * TOL[dtype])


def test_phi_all_matches_pallas_wrapper():
    """The port's phi_all against the JAX package's Pallas wrapper
    (interpret mode), f32 as the Pallas path runs it."""
    jm, pm = _maps(4, 4)
    x = _rand((jm.dim,), 3, np.float32)
    ref = np.asarray(jpg.phi_all_pallas(jnp.asarray(x), jm, interpret=True))
    out = grid.phi_all(torch.from_numpy(x), pm)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_epq_sum_matches_pallas_wrapper():
    """The port's epq_sum (row form on the alpha half, column form on the
    beta half) against the JAX package's Pallas wrapper (interpret mode,
    which transposes Y for the beta half), f32 as the Pallas path runs
    it, with a batch of two."""
    jm, pm = _maps(4, 4)
    Y = _rand((2, jm.n2, jm.dim), 13, np.float32)
    ref = np.asarray(jpg.epq_sum_pallas(jnp.asarray(Y), jm, interpret=True))
    out = grid.epq_sum(torch.from_numpy(Y), pm)
    assert out.shape == ref.shape == (2, jm.dim)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_to_from_grid_roundtrip():
    jm, pm = _maps(4, (2, 1))
    x = _rand((jm.dim,), 4)
    g = grid.to_grid(torch.from_numpy(x), pm)
    np.testing.assert_array_equal(g.numpy(),
                                  np.asarray(jgrid.to_grid(x, jm)))
    np.testing.assert_array_equal(grid.from_grid(g, pm).numpy(), x)


def test_linearity_vjps():
    """The full-pair VJPs (E_pq^T = E_qp pair transpose) against jax.grad
    through the XLA grid ops (tests/test_pallas_grid.py's setup)."""
    jm, pm = _maps(3, 2)
    x, w = _rand((jm.dim,), 5), _rand((jm.n2, jm.dim), 6)
    gj = jax.grad(lambda v: jnp.sum(jgrid._phi_all_xla(v, jm) * w))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (grid.phi_all(xt, pm) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-13)

    g, Y = _rand((jm.dim,), 7), _rand((jm.n2, jm.dim), 8)
    sj = jax.grad(lambda v: jnp.sum(jgrid._epq_sum_xla(v, jm) * g))(
        jnp.asarray(Y))
    Yt = torch.from_numpy(Y).requires_grad_(True)
    (grid.epq_sum(Yt, pm) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(Yt.grad.numpy(), np.asarray(sj), rtol=0,
                               atol=1e-13)


def test_pair_slice_forward_and_vjp_raises():
    """pair_slice'd maps: both grid ops and the VJP of phi_all against
    the XLA grid ops on the JAX package's sliced maps."""
    jm, pm = _maps(3, 2)
    sl_j, sl_p = jgrid.pair_slice(jm, 2, 7), grid.pair_slice(pm, 2, 7)
    x = _rand((jm.dim,), 11)
    np.testing.assert_allclose(
        grid.phi_all(torch.from_numpy(x), sl_p).numpy(),
        np.asarray(jgrid._phi_all_xla(jnp.asarray(x), sl_j)),
        rtol=0, atol=1e-14)
    Y = _rand((5, jm.dim), 12)
    np.testing.assert_allclose(
        grid.epq_sum(torch.from_numpy(Y), sl_p).numpy(),
        np.asarray(jgrid._epq_sum_xla(jnp.asarray(Y), sl_j)),
        rtol=0, atol=1e-13)
    # the VJP of the sliced maps is the other grid op on their transposed
    # maps (E_pq^T = E_qp): it equals the XLA grid op's
    ref = jax.grad(lambda v: jnp.sum(jgrid._phi_all_xla(v, sl_j)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    grid.phi_all(xt, sl_p).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-13)


def test_wrappers_reject_other_devices_and_bad_operands():
    """No silent fallback: a tensor on neither the CPU nor the card
    raises, and the card's operand checks reject what the kernels do not
    take."""
    x = torch.zeros((3, 4), device="meta")
    src = torch.zeros((2, 5), dtype=torch.int32, device="meta")
    s = torch.zeros((2, 5), device="meta")
    t = torch.zeros((2, 4), device="meta")
    with pytest.raises(NotImplementedError):
        gk.gather_rows_scaled(x, src, s, t)
    with pytest.raises(NotImplementedError):
        gk.gather_reduce(x[None], src, s, t)
    with pytest.raises(NotImplementedError):
        gk.gather_reduce_cols(x[None], src, s, t)
    xs = torch.zeros((3, 4), dtype=torch.float64)
    ok = (torch.zeros((2, 5), dtype=torch.int32),
          torch.zeros((2, 5), dtype=torch.float64),
          torch.zeros((2, 4), dtype=torch.float64))
    assert gk._check("k", xs, *ok, 2) == (1, 3, 4)
    with pytest.raises(TypeError):
        gk._check("k", xs, ok[0].long(), ok[1], ok[2], 2)
    with pytest.raises(TypeError):
        gk._check("k", xs.half(), *ok, 2)
    with pytest.raises(ValueError):
        gk._check("k", xs, ok[0], ok[1], torch.zeros((2, 5),
                                                     dtype=torch.float64), 2)
    with pytest.raises(ValueError):
        gk._check("k", xs.T, *ok, 2)
    # the column form's t runs along the operand's rows; Y's pair count
    # must match the maps'
    t_rows = torch.zeros((2, 3), dtype=torch.float64)
    assert gk._check("k", xs, *ok[:2], t_rows, 2, t_axis=-2) == (1, 3, 4)
    with pytest.raises(ValueError):
        gk._check("k", xs, *ok, 2, t_axis=-2)
    with pytest.raises(ValueError, match="pairs"):
        gk._check("k", xs.expand(3, 3, 4).contiguous(), *ok, 3)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build, "_NVCC_DEFAULT",
                        str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        gk.LIBRARY.build()
