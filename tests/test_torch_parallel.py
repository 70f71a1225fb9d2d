"""The port's meshes, tangent-sharded Newton core, statevector / ERI
sharding and geometry batch on 4 gloo ranks against the JAX package and
the port's own single-device path, on the CPU.

One spawned world of 4 ranks (``parallel.distributed.run_ranks``) runs
every case of this module (tests/torch_parallel_workers.py); the JAX
references come from this process, the JAX package's sharded functions
on the conftest's virtual mesh of the same shape where its own test of
them is in the fast profile, single-device JAX where that test is marked
slow.  Every rank must return the same whole results.

Bounds (tests/test_parallel.py's): the (2e,2o) np_fabric L=1 NR step
(E 1e-9, theta 1e-8) and grad+Hessian (1e-12) on a (1, 4) mesh and on
2 x 2 (tangent, state) ranks (1e-11); the (4e,4o) sector on the grid
kernels, tangent-only (no flat program built), with the state split
by grid rows, and with tangents and state on one axis (1e-11; the NR
step E 1e-11, theta and OAO 1e-9); the AD Hessian (1e-9); the state block (1e-14), RDMs (1e-13;
the sector's equal to the full space's, 1e-12), the ERI transform at
nao = 7 over 4 ranks (padded, 1e-13) and the split forward energy
(1e-11); ``GeometryBatch(mesh=)`` at 2 geometries per rank: energies
1e-10, gradients 1e-9, one Newton step (E 1e-12; theta, OAO, eigenvalue
1e-9) against the JAX batch and per-geometry steps, and the device loop;
``run_batched(mesh=)``.  Against the port's single-device path: values
within 1e-12, Hessians within 1e-10, NR-step energies within 1e-10 Ha.
In this process: ``initialize_distributed()`` is a no-op and
``make_mesh`` sets up a one-rank gloo group.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import jax
import jax.numpy as jnp

import auto_oo_tpu as J
from auto_oo_tpu.models import OO_pqc as JOO
from auto_oo_tpu.models import Parameterized_circuit as JPC
from auto_oo_tpu.parallel import GeometryBatch as JBatch
from auto_oo_tpu.parallel import make_mesh as jmake_mesh
from auto_oo_tpu.parallel import (sharded_energy_fn,
                                  sharded_grad_hess_fn,
                                  sharded_int2e_transform_fn,
                                  sharded_nr_step_fn, sharded_rdms_fn,
                                  sharded_state_fn)
import auto_oo_tpu_torch as P
import auto_oo_tpu_torch.parallel as PP
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.ops import transforms
from auto_oo_tpu_torch.parallel.distributed import run_ranks
from tests.torch_parallel_workers import run_cases

RANKS = 4
STEP = (1e-4, 0.5, 1e-6, 1.1, 1e-6)
GEOS = [(140, 80), (135, 85), (130, 90), (125, 95), (120, 100), (115, 105),
        (145, 75), (150, 70)]
LOOP = [(140, 80), (138, 82), (136, 84), (134, 86), (132, 88)]


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


def _mol():
    return J.Moldata(J.get_formal_geo(140, 80), "sto-3g")


def _jmesh(shape, names):
    return jmake_mesh(shape=shape, names=names,
                      devices=jax.devices()[:RANKS])


@pytest.fixture(scope="module")
def world():
    """(JAX references per case, every rank's results)."""
    refs, cases = {}, []
    cases.append(("mesh", "mesh_layout", {}))
    jpqc = JPC(2, 2, ansatz="np_fabric", n_layers=1)
    joo = JOO(jpqc, _mol(), 2, 2, freeze_active=True)
    mesh14 = _jmesh((1, RANKS), ("dp", "tp"))
    # the tangent-sharded core, full space
    th = jnp.array([0.21, -0.34])
    refs["core_2e2o"] = dict(
        theta=np.asarray(th),
        grad_hess=sharded_grad_hess_fn(joo, mesh14, axis="tp")(
            th, joo.oao_mo_coeff),
        nr_step=sharded_nr_step_fn(joo, mesh14, axis="tp")(
            th, joo.oao_mo_coeff))
    cases.append(("core_2e2o", "tangent_core",
                  dict(ncas=2, sector=False, theta=np.asarray(th),
                       shape=(1, RANKS), names=("dp", "tp"))))
    th2 = jnp.array([0.17, 0.42])
    refs["core_2d"] = dict(
        theta=np.asarray(th2),
        grad_hess=sharded_grad_hess_fn(
            joo, _jmesh((2, 2), ("tp", "sp")), axis="tp",
            state_axis="sp")(th2, joo.oao_mo_coeff),
        nr_step=joo._nr_iteration_jit(th2, joo.oao_mo_coeff, *STEP))
    cases.append(("core_2d", "tangent_core",
                  dict(ncas=2, sector=False, theta=np.asarray(th2),
                       shape=(2, 2), names=("tp", "sp"), state_axis="sp")))
    # the (4e,4o) sector: single-device JAX (its test is slow)
    spqc = JPC(4, 4, ansatz="np_fabric", n_layers=2, sector=True)
    soo = JOO(spqc, _mol(), 4, 4, freeze_active=True)
    th4 = 0.05 * jnp.arange(spqc.theta_shape, dtype=jnp.float64)
    refs["sector"] = dict(
        theta=np.asarray(th4),
        grad_hess=soo._grad_hess_jit(th4, soo.oao_mo_coeff),
        nr_step=soo._nr_iteration_jit(th4, soo.oao_mo_coeff, *STEP))
    common = dict(ncas=4, sector=True, theta=np.asarray(th4), n_layers=2)
    cases.append(("sector_tangent", "tangent_core",
                  dict(common, shape=(1, RANKS), names=("dp", "tp"))))
    cases.append(("sector_state", "tangent_core",
                  dict(common, shape=(2, 2), names=("tp", "row"),
                       state_axis="row")))
    cases.append(("sector_same_axis", "tangent_core",
                  dict(common, shape=(1, RANKS), names=("dp", "tp"),
                       state_axis="tp")))
    # the AD Hessian (its JAX test is slow)
    refs["full_hessian"] = joo.full_hessian(th)
    cases.append(("full_hessian", "full_hessian",
                  dict(theta=np.asarray(th))))
    # statevector and ERI sharding on a (1, 4) mesh
    th_sv = jnp.array([0.37, -0.12])
    rng = np.random.RandomState(11)
    int2e = rng.randn(7, 7, 7, 7)
    mo = np.linalg.qr(rng.randn(7, 7))[0]
    kappa = np.zeros(joo.n_kappa)
    kappa[1] = 0.05
    fpqc = JPC(4, 4, ansatz="np_fabric", n_layers=2)
    refs["statevector"] = dict(
        theta=np.asarray(th_sv), kappa=kappa,
        state=sharded_state_fn(jpqc, mesh14, axis="tp")(th_sv),
        rdms=sharded_rdms_fn(jpqc, mesh14, axis="tp")(th_sv),
        rdms_full_4e4o=fpqc.get_rdms(0.05 * jnp.arange(
            fpqc.theta_shape, dtype=jnp.float64)),
        int2e=sharded_int2e_transform_fn(mesh14, axis="tp")(
            jnp.asarray(int2e), jnp.asarray(mo)),
        energy=sharded_energy_fn(joo, mesh14)(th_sv, jnp.asarray(kappa),
                                              joo.oao_mo_coeff),
        int2e_in=int2e, mo=mo)
    cases.append(("statevector", "statevector",
                  dict(theta=np.asarray(th_sv), int2e=int2e, mo=mo,
                       kappa=kappa)))
    # the geometry batch: single-device JAX (its mesh tests are slow)
    mols = [J.Moldata(J.get_formal_geo(a, p), "sto-3g") for a, p in GEOS]
    jbatch = JBatch(mols, 2, 2, jpqc)
    B = len(mols)
    thetas = np.tile([0.1, -0.2], (B, 1))
    kappas = np.zeros((B, jbatch.oo0.n_kappa))
    oaos = jnp.stack([oo.oao_mo_coeff for oo in jbatch.oo_list])
    refs["batch"] = dict(
        thetas=thetas, kappas=kappas,
        energies=jbatch.energies(jnp.asarray(thetas), jnp.asarray(kappas),
                                 oaos),
        gradients=jbatch.gradients(jnp.asarray(thetas),
                                   jnp.asarray(kappas), oaos),
        steps=[oo._nr_iteration_jit(jpqc.init_zeros(), oo.oao_mo_coeff,
                                    *STEP) for oo in jbatch.oo_list])
    cases.append(("batch", "geometry_batch",
                  dict(geos=GEOS, thetas=thetas, kappas=kappas)))
    cases.append(("run_batched", "run_batched", dict(geos=LOOP)))
    return refs, run_ranks(run_cases, RANKS, cases)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _same_on_ranks(results, name, own=()):
    """Rank 0's results, after checking every rank returned the same but
    for the keys ``own`` (each rank's own block)."""
    first = results[0][name]
    for r in results[1:]:
        for k in first:
            if k not in own:
                jax.tree_util.tree_map(
                    lambda a, b: np.testing.assert_array_equal(a, b),
                    first[k], r[name][k])
    return first


def _port_oo(ncas, sector, n_layers=1):
    pqc = P.Parameterized_circuit(ncas, ncas, ansatz="np_fabric",
                                  n_layers=n_layers, sector=sector)
    return pqc, P.OO_pqc(pqc, P.Moldata(P.get_formal_geo(140, 80), "sto-3g"),
                         ncas, ncas, freeze_active=True)


def test_exports_every_jax_name_without_jax():
    """``auto_oo_tpu_torch.parallel`` exports every name of the JAX
    package's ``parallel.__all__`` plus ``hosted_sharded_fns``; with jax
    blocked, the port's parallel modules, its scale-out scripts, the
    rank side of these tests and chip_smoke.py import, and nothing of jax
    or the JAX package is loaded."""
    import subprocess
    import sys
    import auto_oo_tpu.parallel as JP

    assert set(JP.__all__) | {"hosted_sharded_fns"} == set(PP.__all__)
    assert all(callable(getattr(PP, n)) for n in PP.__all__)
    code = ("import sys; sys.modules['jax'] = None\n"
            "from auto_oo_tpu_torch.parallel import (distributed, "
            "grid_hosted_sharded, grid_sharded, sharding, statevector)\n"
            "from auto_oo_tpu_torch.scripts import (dryrun_multichip, "
            "tutorial_scaleout)\n"
            "import tests.torch_parallel_workers, chip_smoke\n"
            "bad = [m for m, mod in sys.modules.items() if mod is not None "
            "and m.split('.')[0] in ('jax', 'auto_oo_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_initialize_distributed_single_process():
    """No group and nothing set: initialize_distributed is a no-op; a
    multi-process count without a coordinator raises; make_mesh sets up a
    one-rank gloo group of this process on the CPU."""
    assert not dist.is_initialized()
    assert PP.initialize_distributed() is False
    with pytest.raises(ValueError, match="coordinator"):
        PP.initialize_distributed(num_processes=4)
    try:
        mesh = PP.make_mesh(names=("dp", "tp"))
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert mesh.mesh_dim_names == ("dp", "tp")
        assert tuple(mesh.shape) == (1, 1)
        assert PP.initialize_distributed() is False
    finally:
        dist.destroy_process_group()


def test_mesh_and_collectives(world):
    """A 2 x 2 DeviceMesh of the 4 gloo ranks: its axes, and each
    collective of the engines on an axis group."""
    _refs, results = world
    for rank, res in enumerate(results):
        got = res["mesh"]
        assert got["names"] == ("dp", "tp") and got["backend"] == "gloo"
        assert got["world"] == RANKS and got["rank"] == rank
        assert got["sizes"] == (2, 2)
        assert got["local"] == (rank // 2, rank % 2)
        dp, tp = got["local"]
        peers = [2 * dp, 2 * dp + 1]
        np.testing.assert_array_equal(got["gathered"],
                                      np.repeat(peers, 3).astype(float))
        np.testing.assert_array_equal(got["summed"],
                                      np.full(3, float(tp + tp + 2)))
        np.testing.assert_array_equal(got["scattered"],
                                      2 * np.arange(4.0)[2 * tp:2 * tp + 2])
        other = [tp, 2 + tp]
        np.testing.assert_array_equal(
            got["swapped"], [dp + 10 * other[0], dp + 10 * other[1]])
        assert all(c[0] == 1 for c in got["counts"].values())
        assert got["counts"]["all_gather"][1] == 3 * 8
        assert "no 'row'" in got["bad_axis"]


@pytest.mark.parametrize("case", ["core_2e2o", "core_2d"])
def test_tangent_sharded_core_full_space(world, case):
    """The quadratic-form grad+Hessian and NR step of (2e,2o) np_fabric
    L=1 with the tangent rows on 4 ranks (and on 2 x 2 ranks with the
    state split by basis blocks) against the JAX sharded functions and
    the port's single-device core."""
    refs, results = world
    ref, got = refs[case], _same_on_ranks(results, case)
    tol = 1e-12 if case == "core_2e2o" else 1e-11
    for a, b in zip(got["grad_hess"], ref["grad_hess"]):
        assert _err(a, b) < tol
    st, rs = got["nr_step"], ref["nr_step"]
    assert abs(float(st[3]) - float(rs[3])) < 1e-9
    assert _err(st[0], rs[0]) < 1e-8
    _pqc, oo = _port_oo(2, False)
    theta = torch.tensor(ref["theta"])
    e, g, h = oo._grad_hess(theta)
    assert abs(float(got["grad_hess"][0]) - float(e)) < 1e-12
    assert _err(got["grad_hess"][1], g) < 1e-12
    assert _err(got["grad_hess"][2], h) < 1e-10
    port = oo._nr_iteration(theta, oo.oao_mo_coeff, *STEP)
    assert abs(float(st[3]) - float(port[3])) < 1e-10


@pytest.mark.parametrize("case", ["sector_tangent", "sector_state",
                                  "sector_same_axis"])
def test_tangent_sharded_core_sector(world, case):
    """The (4e,4o) sector on the grid kernels (no flat program is built):
    tangent-only on 4 ranks, on 2 x 2 ranks with the state split by grid
    rows (the Armijo trials' energies row-sharded too), and with the
    tangent and state axes naming one axis (the tangents keep it):
    grad+Hessian 1e-11 and one NR step against single-device JAX, and the
    port's single-device core."""
    refs, results = world
    ref, got = refs["sector"], _same_on_ranks(results, case)
    for a, b in zip(got["grad_hess"], ref["grad_hess"]):
        assert _err(a, b) < 1e-11
    st, rs = got["nr_step"], ref["nr_step"]
    assert abs(float(st[3]) - float(rs[3])) < 1e-11
    assert _err(st[0], rs[0]) < 1e-9
    assert _err(st[2], rs[2]) < 1e-9
    assert got["flat_program"] is False
    _pqc, oo = _port_oo(4, True, 2)
    theta = torch.tensor(ref["theta"])
    e, g, h = oo._grad_hess(theta)
    assert abs(float(got["grad_hess"][0]) - float(e)) < 1e-12
    assert _err(got["grad_hess"][1], g) < 1e-12
    assert _err(got["grad_hess"][2], h) < 1e-10
    port = oo._nr_iteration(theta, oo.oao_mo_coeff, *STEP)
    assert abs(float(st[3]) - float(port[3])) < 1e-10


def test_sharded_full_hessian(world):
    """The AD cross-check: jvp-of-grad rows of the rank's basis vectors,
    all-gathered, against JAX's full_hessian and the port's quadratic
    form."""
    refs, results = world
    got = _same_on_ranks(results, "full_hessian")["hess"]
    assert _err(got, refs["full_hessian"]) < 1e-9
    _pqc, oo = _port_oo(2, False)
    h = oo._grad_hess(torch.tensor(refs["core_2e2o"]["theta"]))[2]
    assert _err(got, h) < 1e-9


@pytest.mark.parametrize("part", ["state", "rdms", "int2e", "energy"])
def test_statevector_sharding(world, part):
    """sharded_state_fn (each rank its block, gathered here),
    sharded_rdms_fn (the sector's equal to the full space's;
    shard_gates=True refused),
    sharded_int2e_transform_fn at nao = 7 over 4 ranks and
    sharded_energy_fn against the JAX sharded functions on 4 devices and
    the port's single-device path."""
    refs, results = world
    ref = refs["statevector"]
    theta = torch.tensor(ref["theta"])
    pqc, oo = _port_oo(2, False)
    if part == "state":
        blocks = [r["statevector"]["state_block"] for r in results]
        got = np.concatenate(blocks)[:pqc.state_dim]
        assert _err(got, ref["state"]) < 1e-14
        np.testing.assert_array_equal(got, pqc.state(theta).numpy())
        return
    got = _same_on_ranks(results, "statevector", own=("state_block",))
    if part == "rdms":
        for a, b, c in zip(got["rdms"], ref["rdms"], pqc.get_rdms(theta)):
            assert _err(a, b) < 1e-13 and _err(a, c) < 1e-12
        for a, b in zip(got["rdms_sector"], ref["rdms_full_4e4o"]):
            assert _err(a, b) < 1e-12
        assert "shard_gates=False" in got["gates_refused"]
    elif part == "int2e":
        assert _err(got["int2e"], ref["int2e"]) < 1e-13
        single = transforms.int2e_transform(torch.tensor(ref["int2e_in"]),
                                            torch.tensor(ref["mo"]))
        assert _err(got["int2e"], single) < 1e-12
    else:
        assert abs(float(got["energy"]) - float(ref["energy"])) < 1e-11
        e = oo.energy_from_parameters(theta, torch.tensor(ref["kappa"]))
        assert abs(float(got["energy"]) - float(e)) < 1e-12


@pytest.mark.parametrize("part", ["energies", "gradients", "newton_steps",
                                  "device_loop"])
def test_geometry_batch_mesh(world, part):
    """GeometryBatch(mesh=) with 8 (2e,2o) geometries on the 4 dp ranks
    (2 each): against the JAX GeometryBatch and per-geometry steps, and
    the port's batch without a mesh."""
    refs, results = world
    ref = refs["batch"]
    got = _same_on_ranks(results, "batch", own=("lanes",))
    for r, res in enumerate(results):
        assert res["batch"]["lanes"] == (2 * r, 2 * r + 2)
    mols = [P.Moldata(P.get_formal_geo(a, p), "sto-3g") for a, p in GEOS]
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)
    batch = PP.GeometryBatch(mols, 2, 2, pqc)
    oaos = torch.stack([oo.oao_mo_coeff for oo in batch.oo_list])
    thetas, kappas = torch.tensor(ref["thetas"]), torch.tensor(ref["kappas"])
    if part == "energies":
        assert _err(got["energies"], ref["energies"]) < 1e-10
        assert _err(got["energies"],
                    batch.energies(thetas, kappas, oaos)) < 1e-12
    elif part == "gradients":
        for a, b, c in zip(got["gradients"], ref["gradients"],
                           batch.gradients(thetas, kappas, oaos)):
            assert _err(a, b) < 1e-9 and _err(a, c) < 1e-12
    elif part == "newton_steps":
        nth, _nka, noao, es, lows = got["newton_steps"]
        for i, rs in enumerate(ref["steps"]):
            assert abs(float(rs[3]) - float(es[i])) < 1e-12
            assert _err(rs[0], nth[i]) < 1e-9
            assert _err(rs[2], noao[i]) < 1e-9
            assert abs(float(rs[4]) - float(lows[i])) < 1e-9
        port = batch.newton_steps(pqc.init_zeros(), oaos)
        assert _err(es, port[3]) < 1e-12
    else:
        hist = got["device_loop"][0]
        port = batch.optimize_device_loop(pqc.init_zeros(), max_steps=6,
                                          conv_tol=0.0)[0]
        assert hist.shape == (6, len(GEOS))
        assert _err(hist, port) < 1e-11


def test_run_batched_mesh(world):
    """BerryPhaseLoop.run_batched(mesh=) splits the 4 tracked geometries
    over the dp ranks: the energies and lowest eigenvalues of the run
    without a mesh, 1e-10."""
    _refs, results = world
    got = _same_on_ranks(results, "run_batched")
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)
    geos = [P.get_formal_geo(a, p) for a, p in LOOP]
    loop = P.BerryPhaseLoop(geos, "sto-3g", 2, 2, pqc).run_batched(
        conv_tol=1e-10, track_steps=4)
    assert _err(got["energies"], loop.energy_l) < 1e-10
    assert _err(got["eigs"], loop.hess_eig_l) < 1e-10
