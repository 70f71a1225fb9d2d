"""The port's row-sharded string-grid engines on 4 gloo ranks against the
JAX package and the port's own single-device path, on the CPU.

One spawned world of 4 ranks (``parallel.distributed.run_ranks``) runs
every case of this module (tests/torch_parallel_workers.py); the JAX
references come from this process, the JAX package's sharded functions
on the conftest's virtual mesh of the same shape where its own test of
them is in the fast profile, single-device JAX where that test is marked
slow; the inputs (states, Hamiltonian coefficients) travel to the ranks
as numpy arrays.  Every rank must return the same whole results.

Bounds (tests/test_parallel.py's): ``row_sharded_sector_fns`` on the
(4e,4o), (4e,(3,1)) and (6e,6o) sectors: RDMs 1e-13, H psi 1e-12,
energy 1e-12, energy + gradient (E 1e-12, gradient 1e-10; the gradient
against jax.grad on the two (4e,4o) sectors, against the port's
single-device one everywhere), the state bit for bit; the same with ``_LOCAL_BLOCK_BYTES = 1024`` (one row per
sub-chunk) against the JAX engine on a 4-device mesh; the complex128
engine (float64 RDMs) and the real engine's TypeError;
``hosted_sharded_fns`` (row_chunk 2) against the JAX engine on a
4-device mesh to 1e-12, its memory table equal to the JAX one;
``row_sharded_gradient_optimization`` against single-device JAX and the
port to 1e-8 over 8 steps; ``grid2d_nr_fns`` on a 2 x 2 (tangent, row)
mesh at (4e,4o) and (4e,(3,1)): grad 1e-11, Hessian 1e-10, energy
1e-12, one NR step (E 1e-11, theta and OAO 1e-9), against single-device
JAX on (4e,4o) and the port's single-device core on both.  Against the port's
single-device path: RDMs, H psi and energies within 1e-12, Hessians
within 1e-10, an NR step's energy within 1e-10 Ha.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import auto_oo_tpu as J
from auto_oo_tpu.models import OO_pqc as JOO
from auto_oo_tpu.models import Parameterized_circuit as JPC
from auto_oo_tpu.ops import grid as JG
from auto_oo_tpu.ops import hamiltonian as JH
from auto_oo_tpu.parallel import grid_sharded as jgs
from auto_oo_tpu.parallel import make_mesh as jmake_mesh
from auto_oo_tpu.parallel.grid_hosted_sharded import hosted_sharded_fns
import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.ops import grid, grid_hosted, hamiltonian
from auto_oo_tpu_torch.parallel.distributed import run_ranks
from tests.torch_parallel_workers import run_cases
from tests.torch_jax_memos import (  # noqa: F401
    fresh_jax_memos, fresh_jax_memos_module)

RANKS = 4
SECTORS = {"4e4o": (4, 4), "4e31": (4, (3, 1)), "6e6o": (6, 6)}
STEP = (1e-4, 0.5, 1e-6, 1.1, 1e-6)
# the sectors whose energy gradient is also held to jax.grad here (the
# port's single-device gradient, held to JAX in test_torch_gradient.py,
# stands for it on (6e,6o))
JAX_GRADIENTS = ("4e4o", "4e31")


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


def _mol():
    return J.Moldata(J.get_formal_geo(140, 80), "sto-3g")


def _jax_sector(ncas, nelecas):
    pqc = JPC(ncas, nelecas, ansatz="np_fabric", n_layers=2, sector=True)
    return pqc, JOO(pqc, _mol(), ncas, nelecas, freeze_active=True)


def _coeffs(oo):
    c0, c1, c2 = oo.get_active_integrals(oo.mo_coeff)
    return float(c0), np.asarray(JH.c1_effective(c1, c2)), np.asarray(c2)


def _random_problem(ncas, nelecas, seed):
    gm = JG.build_grid_maps(ncas, nelecas)
    rng = np.random.RandomState(seed)
    psi = rng.randn(gm.dim)
    psi /= np.linalg.norm(psi)
    c1 = rng.randn(ncas, ncas)
    c1 = c1 + c1.T
    c2 = rng.randn(ncas, ncas, ncas, ncas)
    c2 = 0.5 * (c2 + c2.transpose(1, 0, 3, 2))
    return gm, psi, np.asarray(JH.c1_effective(jnp.asarray(c1),
                                               jnp.asarray(c2))), c2


@pytest.fixture(scope="module")
def world():
    """(inputs and JAX references per case, every rank's results).

    Every JAX circuit, maps object and engine built here stays in ``keep``
    until the fixture returns: the JAX package memoizes tables on the id
    of a maps' ``srcA`` (tests/torch_jax_memos.py), so a maps dropped here
    could hand its tables to the next one built."""
    jmesh = jmake_mesh(shape=(1, RANKS), names=("dp", "tp"),
                       devices=jax.devices()[:RANKS])
    refs, cases, keep = {}, [], []
    for key, (ncas, ne) in SECTORS.items():
        pqc, oo = _jax_sector(ncas, ne)
        keep.append((pqc, oo))
        theta = 0.07 * jnp.arange(pqc.theta_shape, dtype=jnp.float64)
        psi = pqc.state(theta)
        c0, c1e, c2 = _coeffs(oo)
        gm = pqc.sector_maps
        refs[key] = dict(
            rdms=pqc.get_rdms_from_state(psi),
            ham=JG.from_grid(JH.ham_apply(c1e, c2, JG.to_grid(psi, gm),
                                          ncas, False, gm), gm),
            energy=oo.energy_from_parameters(theta), state=psi)
        if key in JAX_GRADIENTS:
            refs[key]["grad"] = jax.grad(
                lambda th: oo.energy_from_parameters(th))(theta)
        inputs = dict(ncas=ncas, nelecas=ne, theta=np.asarray(theta),
                      psi=np.asarray(psi), c0=c0, c1eff=c1e, c2=c2)
        refs[key]["inputs"] = inputs
        cases.append((f"row_{key}", "row_engine", inputs))
    # the sub-chunked engine against the JAX engine on 4 devices
    inputs = dict(refs["4e4o"]["inputs"], block_bytes=1024)
    pqc, _oo = _jax_sector(4, 4)
    keep.append((pqc, _oo))
    saved = jgs._LOCAL_BLOCK_BYTES
    jgs._LOCAL_BLOCK_BYTES = 1024
    try:
        eng = jgs.row_sharded_sector_fns(pqc, jmesh, axis="tp")
        keep.append(eng)
        psi = jnp.asarray(inputs["psi"])
        refs["chunks"] = dict(rdms=eng["rdms"](psi), ham=eng["ham_apply"](
            inputs["c1eff"], inputs["c2"], psi))
    finally:
        jgs._LOCAL_BLOCK_BYTES = saved
    cases.append(("chunks", "row_engine", inputs))
    # the complex engine
    psi_r = np.asarray(refs["4e4o"]["state"])
    psi_c = psi_r + 0.1j * np.roll(psi_r, 1)
    psi_c /= np.linalg.norm(psi_c)
    pqc, _oo = _jax_sector(4, 4)
    keep.append((pqc, _oo))
    c0, c1e, c2 = (refs["4e4o"]["inputs"][k] for k in ("c0", "c1eff", "c2"))
    gm = pqc.sector_maps
    h_c = JG.from_grid(JH.ham_apply(c1e, c2, JG.to_grid(jnp.asarray(psi_c),
                                                       gm), 4, False, gm),
                       gm)
    refs["complex"] = dict(rdms=pqc.get_rdms_from_state(jnp.asarray(psi_c)),
                           ham=h_c, energy=c0 + float(jnp.real(
                               jnp.conj(psi_c) @ h_c)))
    cases.append(("complex", "row_engine_complex",
                  dict(psi=psi_c, c0=c0, c1eff=c1e, c2=c2)))
    # the hosted x row-sharded engine against the JAX engine on 4 devices
    jrow = Mesh(np.array(jax.devices()[:RANKS]), ("row",))
    for key, (ncas, ne) in SECTORS.items():
        gm, psi, c1e, c2 = _random_problem(ncas, ne, 3)
        fns = hosted_sharded_fns(gm, jrow, row_chunk=2)
        keep.append((gm, fns))
        refs[f"hosted_{key}"] = dict(
            rdms=fns["rdms"](jnp.asarray(psi)),
            ham=fns["ham_apply"](c1e, c2, jnp.asarray(psi)),
            budget8=fns["memory_budget"](8), row_chunk=fns["row_chunk"])
        inputs = dict(ncas=ncas, nelecas=ne, psi=psi, c1eff=c1e, c2=c2,
                      row_chunk=2)
        refs[f"hosted_{key}"]["inputs"] = inputs
        cases.append((f"hosted_{key}", "hosted", inputs))
    # first-order OO-VQE, single-device JAX
    pqc = JPC(4, 4, ansatz="np_fabric", n_layers=2, sector=True)
    keep.append(pqc)
    refs["gradient_opt"] = dict(energies=JOO(pqc, _mol(), 4, 4)
                                .gradient_optimization(
                                    pqc.init_zeros(), max_iterations=8,
                                    learning_rate=0.05, orbital_every=5,
                                    verbose=0)[0])
    cases.append(("gradient_opt", "gradient_opt",
                  dict(iterations=8, orbital_every=5)))
    # the 2-D engine, single-device JAX on the closed shell
    for key, ne in (("4e4o", 4), ("4e31", (3, 1))):
        pqc = JPC(4, ne, ansatz="np_fabric", n_layers=2, sector=True)
        keep.append(pqc)
        theta = 0.05 * jnp.arange(pqc.theta_shape, dtype=jnp.float64)
        refs[f"grid2d_{key}"] = dict(theta=np.asarray(theta))
        if key == "4e4o":
            oo = JOO(pqc, _mol(), 4, ne, freeze_active=True)
            keep.append(oo)
            refs[f"grid2d_{key}"].update(
                grad_hess=oo._grad_hess_jit(theta, oo.oao_mo_coeff),
                energy=oo.energy_from_parameters(theta),
                nr_step=oo._nr_iteration_jit(theta, oo.oao_mo_coeff,
                                             *STEP))
        cases.append((f"grid2d_{key}", "grid2d",
                       dict(nelecas=ne, theta=np.asarray(theta))))
    results = run_ranks(run_cases, RANKS, cases)
    return refs, results


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


def _port_single(ncas, nelecas):
    pqc = P.Parameterized_circuit(ncas, nelecas, ansatz="np_fabric",
                                  n_layers=2, sector=True)
    return pqc, P.OO_pqc(pqc, P.Moldata(P.get_formal_geo(140, 80), "sto-3g"),
                         ncas, nelecas, freeze_active=True)


@pytest.mark.parametrize("key", list(SECTORS))
def test_row_sharded_engine(world, key):
    """rdms, ham_apply, energy, energy_gradient and state of the
    row-sharded engine on 4 ranks: the JAX package's single-device values
    (its own test is slow) and the port's single-device path."""
    refs, results = world
    ref, got = refs[key], _same_on_ranks(results, f"row_{key}")
    ncas, ne = SECTORS[key]
    assert _err(got["rdms"][0], ref["rdms"][0]) < 1e-13
    assert _err(got["rdms"][1], ref["rdms"][1]) < 1e-13
    assert _err(got["ham"], ref["ham"]) < 1e-12
    assert abs(float(got["energy"]) - float(ref["energy"])) < 1e-12
    e0, grad = got["eg"]
    assert abs(float(e0) - float(ref["energy"])) < 1e-12
    if "grad" in ref:
        assert _err(grad, ref["grad"]) < 1e-10
    assert _err(got["state"], ref["state"]) < 1e-14
    assert _err(got["rdms_grid"][1], ref["rdms"][1]) < 1e-13
    # the port's single-device path
    pqc, oo = _port_single(ncas, ne)
    inp = ref["inputs"]
    theta = torch.tensor(inp["theta"])
    psi = torch.tensor(inp["psi"])
    g1, G2 = pqc.get_rdms_from_state(psi)
    assert _err(got["rdms"][0], g1) < 1e-12
    assert _err(got["rdms"][1], G2) < 1e-12
    gm = pqc.sector_maps
    c1e, c2 = torch.tensor(inp["c1eff"]), torch.tensor(inp["c2"])
    h = grid.from_grid(hamiltonian.ham_apply(c1e, c2, grid.to_grid(psi, gm),
                                             ncas, gm), gm)
    assert _err(got["ham"], h) < 1e-12
    e_port, g_port, _ = oo.energy_and_gradient(theta)
    assert abs(float(e0) - float(e_port)) < 1e-12
    assert _err(grad, g_port[:pqc.theta_shape]) < 1e-10
    np.testing.assert_array_equal(got["state"], pqc.state(theta).numpy())


def test_row_sharded_sub_chunks(world):
    """A 1024-byte block budget streams each rank's rows one by one: the
    JAX engine on a 4-device mesh with the same budget."""
    refs, results = world
    ref, got = refs["chunks"], _same_on_ranks(results, "chunks")
    assert _err(got["rdms"][0], ref["rdms"][0]) < 1e-13
    assert _err(got["rdms"][1], ref["rdms"][1]) < 1e-13
    assert _err(got["ham"], ref["ham"]) < 1e-12
    full = _same_on_ranks(results, "row_4e4o")
    assert _err(got["ham"], full["ham"]) < 1e-12


def test_row_sharded_complex(world):
    """The complex128 engine: float64 RDMs, H psi and energy of a complex
    state; the real engine refuses a complex state with TypeError."""
    refs, results = world
    ref, got = refs["complex"], _same_on_ranks(results, "complex")
    assert got["rdm_dtype"] == "torch.float64"
    assert _err(got["rdms"][0], ref["rdms"][0]) < 1e-13
    assert _err(got["rdms"][1], ref["rdms"][1]) < 1e-13
    assert _err(got["ham"], ref["ham"]) < 1e-12
    assert abs(float(np.real(got["energy"])) - ref["energy"]) < 1e-12
    assert "complex128" in got["refused"]


@pytest.mark.parametrize("key", list(SECTORS))
def test_hosted_sharded(world, key):
    """The hosted x row-sharded engine (row_chunk 2, several segments per
    rank) on each rank's rows of psi: its raw RDM grams and H psi (each
    rank's rows, all-gathered) against the JAX engine on a 4-device mesh
    and the port's single-device hosted passes, 1e-12; each rank returns
    its own rows of H psi; its memory table equal to the JAX one."""
    refs, results = world
    ref = refs[f"hosted_{key}"]
    got = _same_on_ranks(results, f"hosted_{key}", own=("ham_rows",))
    gm = grid.build_grid_maps(ref["inputs"]["ncas"], ref["inputs"]["nelecas"])
    per = -(-gm.Na // RANKS)
    h_pad = np.pad(np.asarray(got["ham"]).reshape(gm.Na, gm.Nb),
                   ((0, per * RANKS - gm.Na), (0, 0)))
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res[f"hosted_{key}"]["ham_rows"],
                                      h_pad[r * per:(r + 1) * per])
    assert _err(got["rdms"][0], ref["rdms"][0]) < 1e-12
    assert _err(got["rdms"][1], ref["rdms"][1]) < 1e-12
    assert _err(got["ham"], ref["ham"]) < 1e-12
    assert got["budget8"] == ref["budget8"]
    assert got["row_chunk"] == ref["row_chunk"]
    inp = ref["inputs"]
    psi = torch.tensor(inp["psi"])
    h = grid_hosted.ham_apply_hosted(torch.tensor(inp["c1eff"]),
                                     torch.tensor(inp["c2"]), psi, gm, 2)
    assert _err(got["ham"], h) < 1e-12
    g1, G2 = grid.assemble_rdms(torch.as_tensor(got["rdms"][0]),
                                torch.as_tensor(got["rdms"][1]),
                                inp["ncas"])
    g1r, G2r = grid_hosted.rdms_hosted(psi, gm, inp["ncas"], 2)
    assert _err(g1, g1r) < 1e-12 and _err(G2, G2r) < 1e-12


def test_row_sharded_gradient_optimization(world):
    """8 Adam steps with an orbital relaxation after step 5 on the mesh:
    every energy within 1e-8 of single-device JAX and of the port's
    single-device run."""
    refs, results = world
    got = _same_on_ranks(results, "gradient_opt")["energies"]
    ref = np.asarray(refs["gradient_opt"]["energies"])
    assert got.shape == ref.shape
    assert _err(got, ref) < 1e-8
    pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=2,
                                  sector=True)
    oo = P.OO_pqc(pqc, P.Moldata(P.get_formal_geo(140, 80), "sto-3g"), 4, 4)
    e_port, _ = oo.gradient_optimization(pqc.init_zeros(), max_iterations=8,
                                         learning_rate=0.05,
                                         orbital_every=5)
    assert _err(got, e_port) < 1e-8
    assert got[-1] < got[0]


@pytest.mark.parametrize("key", ["4e4o", "4e31"])
def test_grid2d(world, key):
    """The 2-D (tangent x row) engine on 2 x 2 ranks: grad+Hessian,
    energy and one host-driven NR step against single-device JAX and the
    port's single-device core."""
    refs, results = world
    ref, got = refs[f"grid2d_{key}"], _same_on_ranks(results,
                                                     f"grid2d_{key}")
    e_s, g_s, h_s = got["grad_hess"]
    st = got["nr_step"]
    if "grad_hess" in ref:
        e_r, g_r, h_r = ref["grad_hess"]
        assert abs(float(e_s) - float(e_r)) < 1e-11
        assert _err(g_s, g_r) < 1e-11
        assert _err(h_s, h_r) < 1e-10
        assert abs(float(got["energy"]) - float(ref["energy"])) < 1e-12
        rs = ref["nr_step"]
        assert abs(float(st[3]) - float(rs[3])) < 1e-11
        assert _err(st[0], rs[0]) < 1e-9
        assert _err(st[2], rs[2]) < 1e-9
    _pqc, oo = _port_single(4, SECTORS[key][1])
    theta = torch.tensor(ref["theta"])
    e_p, g_p, h_p = oo._grad_hess(theta)
    assert abs(float(e_s) - float(e_p)) < 1e-12
    assert _err(g_s, g_p) < 1e-12
    assert _err(h_s, h_p) < 1e-10
    assert abs(float(got["energy"])
               - float(oo.energy_from_parameters(theta))) < 1e-12
    port = oo._nr_iteration(theta, oo.oao_mo_coeff, *STEP)
    assert abs(float(st[3]) - float(port[3])) < 1e-10
    assert _err(st[0], port[0]) < 1e-9
    assert _err(st[2], port[2]) < 1e-9
