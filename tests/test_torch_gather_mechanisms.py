"""The port's row-gather mechanism probes against the JAX script's.

scripts/experiment_gather_mechanisms.py (not a package) is loaded from its
file; its Pallas kernels run in interpret mode on the CPU.  Pins:

* ``gather_rows_plain`` equals the script's "xla take" exactly, f32 and
  f64 (one product per element);
* the wrappers ``gather_a/b/c`` on CPU tensors equal the script's own
  ``gather_a/b/c`` exactly (f32: the Pallas kernels are f32 only);
* the K-step harness equals the script's ``repeat_scan`` to 1e-6
  relative in f32 (it sums K gathers);
* the wrappers raise on the padding and dtype violations; the launch
  plans (A's ring, B's cluster and slab, C's box and ring) are pinned at
  the probes' shapes against an H100's 227 KB, and raise where shared
  memory or the tensor map's rules cannot hold them.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import pallas as pl

from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.ops import cuda_build
from auto_oo_tpu_torch.ops import gather_mechanisms as gm
from auto_oo_tpu_torch.ops import grid_kernels as gk
from auto_oo_tpu_torch.scripts import experiment_gather_mechanisms as exp


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's default device is the card; these CPU tests ask for the
    CPU, and restore the default after the module."""
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "experiment_gather_mechanisms.py")

# H100: 227 KB of opt-in shared memory per block
_H100_SMEM = 232448


@pytest.fixture(scope="module")
def jscript():
    spec = importlib.util.spec_from_file_location(
        "_jax_experiment_gather_mechanisms", _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(ns, nb, n2, na, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((ns, nb)),
            rng.integers(0, ns, (n2, na)).astype(np.int32),
            rng.standard_normal((n2, na)))


def _xla_gather(x, src, s):
    return jnp.take(x, src, axis=0) * s[:, :, None]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_equals_xla_take(dtype):
    x, src, s = _inputs(24, 256, 9, 40, seed=3)
    x, s = x.astype(dtype), s.astype(dtype)
    ref = np.asarray(_xla_gather(jnp.asarray(x), jnp.asarray(src),
                                 jnp.asarray(s)))
    out = gm.gather_rows_plain(torch.from_numpy(x), torch.from_numpy(src),
                               torch.from_numpy(s))
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("variant", ["a", "b", "c"])
def test_wrappers_equal_pallas_kernels(jscript, monkeypatch, variant):
    """Each wrapper (plain version on the CPU) against the script's own
    Pallas kernel in interpret mode, at (ns, nb, n2, na) = (16, 128, 4,
    16) f32: exactly equal."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    x, src, s = _inputs(16, 128, 4, 16, seed=5)
    x, s = x.astype(np.float32), s.astype(np.float32)
    ref = np.asarray(getattr(jscript, f"gather_{variant}")(
        jnp.asarray(x), jnp.asarray(src), jnp.asarray(s)))
    before = dict(gm.LAUNCHES)
    out = getattr(gm, f"gather_{variant}")(
        torch.from_numpy(x), torch.from_numpy(src), torch.from_numpy(s))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert gm.LAUNCHES == before  # the plain version launches nothing


def test_repeat_scan_matches_jax(jscript):
    """The port's K-step harness against the script's repeat_scan of the
    xla take, at the script's input draw for a small ncas-like shape
    (ncas = 6: x (24, 128), out (36, 24, 128)); f32 sums over K."""
    K = 5
    x, src, s, cs = exp.make_inputs(6, K)
    assert tuple(x.shape) == (24, 128) and tuple(src.shape) == (36, 24)
    assert x.dtype == torch.float32 and src.dtype == torch.int32
    ref = np.asarray(jscript.repeat_scan(_xla_gather, K)(
        *(jnp.asarray(a.numpy()) for a in (x, src, s, cs))))
    out = exp.repeat_scan(gm.gather_rows_plain, K)(x, src, s, cs).numpy()
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("ncas,expect", [
    (10, (256, 256, 100, 256)),     # out (100, 256, 256): 26 MB in f32
    (12, (928, 1024, 144, 928)),    # out (144, 928, 1024): 547 MB in f32
])
def test_shapes_are_the_scripts(ncas, expect):
    assert exp.shapes(ncas) == expect


def test_wrappers_raise_on_bad_operands():
    """Checks made before any launch: dtype, int32 src, contiguity, the
    16-byte rows of the kernels' copies, and the script's padding."""
    x = torch.zeros((16, 128), dtype=torch.float32)
    src = torch.zeros((4, 16), dtype=torch.int32)
    s = torch.zeros((4, 16), dtype=torch.float32)
    assert gm._check("k", x, src, s) == (16, 128, 4, 16)
    cases = [
        (TypeError, (x.half(), src, s.half())),
        (TypeError, (x, src, s.double())),
        (TypeError, (x, src.long(), s)),
        (ValueError, (torch.zeros((128, 16)).T, src, s)),
        (ValueError, (x, src, s[:, :8])),
        (ValueError, (torch.zeros((16, 3)), src, s)),        # 12-byte rows
        (ValueError, (torch.zeros((16, 132)), src, s)),      # nb % 128
        (ValueError, (torch.zeros((12, 128)), src, s)),      # ns % 8
        (ValueError, (x, torch.zeros((4, 12), dtype=torch.int32),
                      torch.zeros((4, 12)))),               # na % 8
    ]
    for exc, args in cases:
        with pytest.raises(exc):
            gm._check("k", *args)
    with pytest.raises(ValueError, match="16-byte"):
        gm._check("gather_a", torch.zeros((16, 3)), src, s)
    # a tensor on another device type never reaches a kernel
    with pytest.raises(NotImplementedError):
        gm.gather_a(torch.zeros((16, 128), device="meta"), src, s)


def test_launch_plans():
    """Rows per stage of A's ring at the script's shapes on an H100's
    227 KB, and its refusal."""
    # A: 32 KB stages of rows, at most 8 rows
    assert gm.stage_rows(256, 4, _H100_SMEM) == 8
    assert gm.stage_rows(1024, 8, _H100_SMEM) == 4
    with pytest.raises(ValueError, match="shared memory"):
        gm.stage_rows(16384, 8, _H100_SMEM)


# (ns, nb, itemsize) -> (cluster, W, rows per block, shared memory per
# block): the probes' shapes at ncas = 10 and 12 and the ragged shape
_PLANS_B = {
    (256, 256, 4): (8, 256, 32, 32 * 256 * 4 + 2 * 256 * 12),
    (256, 256, 8): (8, 256, 32, 32 * 256 * 8 + 2 * 256 * 16),
    (928, 1024, 4): (8, 256, 116, 116 * 256 * 4 + 2 * 256 * 12),
    (928, 1024, 8): (8, 128, 116, 116 * 128 * 8 + 2 * 256 * 16),
    (24, 384, 4): (8, 128, 3, 3 * 128 * 4 + 2 * 256 * 12),
    (24, 384, 8): (8, 128, 3, 3 * 128 * 8 + 2 * 256 * 16),
}


@pytest.mark.parametrize("shape", sorted(_PLANS_B))
def test_plan_b(shape):
    """B at the probes' shapes: a cluster of 8 holds x whole at ncas = 10
    and a 950 KB column slab at ncas = 12 (W = 256 in f32, 128 in f64),
    each block's share under the H100's 227 KB."""
    ns, nb, item = shape
    plan = gm.plan_b(ns, nb, item, _H100_SMEM)
    assert tuple(plan) == _PLANS_B[shape]
    assert plan.rows_per_block * plan.cluster >= ns
    assert nb % plan.W == 0 and plan.smem <= _H100_SMEM


@pytest.mark.parametrize("cluster,W", [(2, 32), (4, 64), (8, 128), (16, 256)])
def test_plan_b_cluster_sweep(cluster, W):
    """The sweep's plans at ncas = 12 f64: each doubling of the cluster
    halves the rows per block and doubles the slab."""
    plan = gm.plan_b(928, 1024, 8, _H100_SMEM, cluster=cluster)
    assert (plan.cluster, plan.W) == (cluster, W)
    assert plan.rows_per_block == -(-928 // cluster)
    assert plan.smem <= _H100_SMEM


def test_plan_b_grows_the_cluster_then_refuses():
    """Where a 16-column slab does not fit a cluster of 8, B takes 16
    (non-portable); beyond that it raises, as it does for a cluster size
    below 1.  A cluster size the caller names is kept even where the last
    block holds fewer rows (ns = 40 over 6 blocks of 7)."""
    assert tuple(gm.plan_b(16384, 128, 8, _H100_SMEM)) == (
        16, 16, 1024, 1024 * 16 * 8 + 2 * 256 * 16)
    with pytest.raises(ValueError, match="cluster of 16"):
        gm.plan_b(32768, 128, 8, _H100_SMEM)
    with pytest.raises(ValueError, match="cluster of 8"):
        gm.plan_b(16384, 128, 8, _H100_SMEM, cluster=8)
    with pytest.raises(ValueError, match="cluster size"):
        gm.plan_b(256, 256, 8, _H100_SMEM, cluster=0)
    assert gm.plan_b(40, 384, 8, _H100_SMEM, cluster=6).rows_per_block == 7


# (ns, nb, itemsize) -> (Wc, stages, shared memory per block)
_PLANS_C = {
    (256, 256, 4): (256, 8, 1024 + 8 * 8192),
    (256, 256, 8): (128, 8, 1024 + 8 * 8192),
    (928, 1024, 4): (256, 8, 1024 + 8 * 8192),
    (928, 1024, 8): (128, 8, 1024 + 8 * 8192),
    (24, 384, 4): (128, 16, 1024 + 16 * 4096),
    (24, 384, 8): (128, 8, 1024 + 8 * 8192),
}


@pytest.mark.parametrize("shape", sorted(_PLANS_C))
def test_plan_c(shape):
    """C at the probes' shapes: 8-row boxes of at most 1 KB a row, a ring
    of at least 4 stages (a multiple of the 4 consumer warps), three
    blocks to an SM within the H100's 227 KB."""
    ns, nb, item = shape
    plan = gm.plan_c(ns, nb, item, _H100_SMEM)
    assert tuple(plan) == _PLANS_C[shape]
    assert nb % plan.Wc == 0 and plan.Wc <= 256
    assert (plan.Wc * item) % 16 == 0 and plan.Wc * item <= 1024
    assert plan.stages >= 4 and plan.stages % 4 == 0
    assert 3 * plan.smem <= _H100_SMEM


def test_plan_c_refuses_tensor_map_rules():
    """C raises where a tensor map over x cannot be built: rows that are
    not 16-byte multiples, or ns not whole 8-row blocks; or where four
    stages do not fit.  Rows of 16-byte multiples give an inner box of
    16-byte multiples (48-byte rows: 4-column, 16-byte boxes)."""
    with pytest.raises(ValueError, match="16-byte"):
        gm.plan_c(16, 6, 4, _H100_SMEM)       # 24-byte rows
    assert gm.plan_c(16, 12, 4, _H100_SMEM).Wc == 4
    with pytest.raises(ValueError, match="multiple of 8"):
        gm.plan_c(12, 128, 8, _H100_SMEM)
    with pytest.raises(ValueError, match="shared memory"):
        gm.plan_c(928, 1024, 8, 16 * 1024)


def test_load_all_raises_without_nvcc(monkeypatch, tmp_path):
    """Both kernel libraries build through one helper; without nvcc it
    raises (no fallback) and loads nothing."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build, "_NVCC_DEFAULT",
                        str(tmp_path / "no-nvcc"))
    libs = [cuda_build.CudaLibrary(lib.src, lib.symbols)
            for lib in (gk.LIBRARY, gm.LIBRARY)]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load_all(libs)
    assert all(lib.lib is None for lib in libs)
    assert os.path.basename(libs[1].src) == "gather_mechanisms.cu"
    assert os.path.exists(libs[1].src)
