"""The port's Hamiltonian apply, RDMs and damped-Newton core against the
JAX package, on formaldimine sto-3g.

Pins (those of tests/test_grid.py and tests/test_oo_pqc.py): ham_apply and
RDMs to 1e-12; grad_hess e0/grad to 1e-11 and the Hessian to 1e-9 from a
random theta and a rotated OAO-MO matrix handed over by
utils.interop.from_jax; a 3-iteration NR trajectory to 1e-10; (2e,2o)
full_optimization equal to CASSCF to 1e-8.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.linalg import expm

import auto_oo_tpu as J
from auto_oo_tpu.models import OO_pqc as JOO
from auto_oo_tpu.models import Parameterized_circuit as JPC
from auto_oo_tpu.ops import grid as jgrid
from auto_oo_tpu.ops import hamiltonian as jham
from auto_oo_tpu.ops import rdms as jrdms
import auto_oo_tpu_torch as P
from auto_oo_tpu_torch.models import oo_pqc as poo
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.ops import grid, grid_hosted, hamiltonian, rdms
from auto_oo_tpu_torch.utils.interop import from_jax


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's default device is the card; these CPU tests ask for the
    CPU, and restore the default after the module."""
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


GEO = J.get_formal_geo(140, 80)

# (ncas, nelecas, circuit kwargs, basis/charge/spin of the molecule)
CASES = {
    "np_fabric_4e4o": (4, 4, dict(ansatz="np_fabric", n_layers=1), {}),
    "np_fabric_4e4o_631g": (4, 4, dict(ansatz="np_fabric", n_layers=1),
                            dict(basis="6-31g")),
    "np_fabric_3e4o_open": (4, (2, 1), dict(ansatz="np_fabric",
                                            n_layers=1),
                            dict(charge=1, spin=1)),
    "ucc_2e2o": (2, 2, dict(ansatz="ucc"), {}),
}


@pytest.fixture(scope="module")
def molecules():
    cache = {}

    def get(molkw):
        key = tuple(sorted(molkw.items()))
        if key not in cache:
            kw = dict(molkw)
            basis = kw.pop("basis", "sto-3g")
            cache[key] = (J.Moldata(GEO, basis, **kw),
                          P.Moldata(GEO, basis, **kw))
        return cache[key]
    return get


@pytest.fixture(scope="module")
def circuits():
    """One JAX circuit per case for the whole module: the JAX package
    caches its compiled Newton core on the circuit."""
    cache = {}

    def get(name):
        if name not in cache:
            ncas, ne, kw, _ = CASES[name]
            cache[name] = JPC(ncas, ne, sector=True, **kw)
        return cache[name]
    return get


def _pair(molecules, circuits, name, seed=0):
    """JAX and port OO_pqc on the same problem, both started from the
    same rotated OAO-MO matrix; returns (jo, po, theta)."""
    ncas, ne, kw, molkw = CASES[name]
    mj, mp = molecules(molkw)
    jo = JOO(circuits(name), mj, ncas, ne, freeze_active=True)
    rng = np.random.default_rng(seed)
    A = 0.05 * rng.standard_normal((jo.nao, jo.nao))
    oao = np.asarray(jo.oao_mo_coeff) @ expm(A - A.T)
    jo.oao_mo_coeff = jnp.asarray(oao)
    po = P.OO_pqc(P.Parameterized_circuit(ncas, ne, sector=True, **kw), mp,
                  ncas, ne, freeze_active=True, oao_mo_coeff=from_jax(oao))
    theta = 0.3 * rng.standard_normal(jo.pqc.theta_shape)
    return jo, po, theta


@pytest.mark.parametrize("ncas,nelecas", [(4, 4), (4, (2, 1))])
def test_ham_apply_and_rdms_match(ncas, nelecas):
    jm = jgrid.build_grid_maps(ncas, nelecas)
    pm = from_jax(jm)
    rng = np.random.default_rng(1)
    n2 = ncas * ncas
    c1 = rng.standard_normal((ncas, ncas))
    c1 = c1 + c1.T
    c2 = rng.standard_normal((ncas,) * 4)
    c2 = c2 + c2.transpose(1, 0, 3, 2)
    x = rng.standard_normal((3, jm.dim))
    c1e_j = jham.c1_effective(jnp.asarray(c1), jnp.asarray(c2))
    c1e_p = hamiltonian.c1_effective(torch.from_numpy(c1),
                                     torch.from_numpy(c2))
    np.testing.assert_allclose(c1e_p.numpy(), np.asarray(c1e_j), rtol=0,
                               atol=1e-13)
    ref = np.asarray(jham.ham_apply(c1e_j, jnp.asarray(c2), jnp.asarray(x),
                                    ncas, maps=jm))
    out = hamiltonian.ham_apply(c1e_p, torch.from_numpy(c2),
                                torch.from_numpy(x), ncas, pm)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)
    out1 = hamiltonian.ham_apply(c1e_p, torch.from_numpy(c2),
                                 torch.from_numpy(x[0]), ncas, pm)
    np.testing.assert_allclose(out1.numpy(), ref[0], rtol=0, atol=1e-12)
    assert n2 == pm.n2

    psi = x[0] / np.linalg.norm(x[0])                 # canonical order
    gj, Gj = jrdms.rdms_from_state(jnp.asarray(psi), ncas, maps=jm)
    gp, Gp = rdms.rdms_from_state(torch.from_numpy(psi), ncas, pm)
    np.testing.assert_allclose(gp.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(Gp.numpy(), np.asarray(Gj), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("name", sorted(CASES))
def test_grad_hess_matches(molecules, circuits, name):
    jo, po, theta = _pair(molecules, circuits, name)
    e_j, g_j, h_j = jo._grad_hess_jit(jnp.asarray(theta), jo.oao_mo_coeff)
    e_p, g_p, h_p = po._grad_hess(from_jax(theta))
    assert abs(float(e_p) - float(e_j)) < 1e-11
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_j), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(po.mo_coeff.numpy(), np.asarray(jo.mo_coeff),
                               rtol=0, atol=1e-13)
    # the reference-API blocks are views of the same grad_hess
    nt = po._nt
    for name, ref in (("circuit_gradient", g_p[:nt]),
                      ("orbital_gradient", g_p[nt:]),
                      ("full_gradient", g_p),
                      ("circuit_circuit_hessian", h_p[:nt, :nt]),
                      ("orbital_circuit_hessian", h_p[nt:, :nt]),
                      ("orbital_orbital_hessian", h_p[nt:, nt:]),
                      ("full_hessian", h_p)):
        np.testing.assert_array_equal(getattr(po, name)(theta).numpy(),
                                      ref.numpy(), err_msg=name)


def test_staged_regime_matches_jax_staged(molecules, circuits, monkeypatch):
    """With the port's staged threshold below D, (4e,4o) 6-31G takes the
    branch that (12e,12o) 6-31G takes: the JAX package's staged route, run
    by the port's eager grad_hess.  It must equal the JAX staged pipeline:
    e0 and grad to 1e-11, the Hessian to 1e-9."""
    monkeypatch.setattr(poo, "_STAGED_MIN_D", 2)
    jo, po, theta = _pair(molecules, circuits, "np_fabric_4e4o_631g",
                          seed=3)
    assert po._core["route"] == "staged"
    e_j, g_j, h_j = jo._core["grad_hess_staged"](
        jnp.asarray(theta), jo.oao_mo_coeff, *jo._mol_args)
    e_p, g_p, h_p = po._grad_hess(from_jax(theta))
    assert abs(float(e_p) - float(e_j)) < 1e-11
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_j), rtol=0,
                               atol=1e-9)


def test_streamed_regime_raises(molecules, monkeypatch):
    """Where one (n^2, D) f64 Phi does not fit its block, OO_pqc takes the
    streamed route (the JAX package's streamed rows); where one full-Phi
    pass reaches the JAX package's hosting threshold it takes the hosted
    route, whose (e0, grad, hess) equal the fused ones.  Below D = 2^19
    with Phi fitting, the route is the fused one."""
    _, mp = molecules({})
    pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                  sector=True)
    fused = P.OO_pqc(pqc, mp, 4, 4)
    assert fused._core["route"] == "fused"
    monkeypatch.setattr(grid, "_PAIR_CHUNK_BYTES", 8)
    oo = P.OO_pqc(pqc, mp, 4, 4)
    assert oo._core["route"] == "streamed"
    assert oo._core["plan"] == grid.stream_plan(pqc.sector_maps)
    monkeypatch.setattr(grid_hosted, "_HOSTED_MIN_BYTES", 1)
    oo = P.OO_pqc(pqc, mp, 4, 4)
    assert oo._core["route"] == "hosted"
    assert oo._core["plan"] == grid.stream_plan(pqc.sector_maps)
    theta = 0.3 * np.random.default_rng(8).standard_normal(pqc.theta_shape)
    (e_f, g_f, h_f), (e_h, g_h, h_h) = (o._grad_hess(theta)
                                        for o in (fused, oo))
    assert oo.n_kappa > 0 and abs(float(e_h) - float(e_f)) < 1e-11
    np.testing.assert_allclose(g_h.numpy(), g_f.numpy(), rtol=0, atol=1e-11)
    np.testing.assert_allclose(h_h.numpy(), h_f.numpy(), rtol=0, atol=1e-9)


def test_active_space_beyond_basis_raises(molecules):
    """(12e,12o) of formaldimine needs 2 core + 12 active orbitals, and
    STO-3G has 13: the JAX package accepts it (its active indices run past
    the basis and its gathers clamp them); the port refuses it."""
    mj, mp = molecules({})
    jo = J.OO_energy(mj, 12, 12, freeze_active=True)
    assert max(jo._act) == jo.nao == 13
    with pytest.raises(ValueError, match="exceed the 13 orbitals"):
        P.OO_energy(mp, 12, 12, freeze_active=True)
    assert P.OO_energy(mp, 10, 10, freeze_active=True)._act[-1] == 12


def test_energy_from_parameters_matches(molecules, circuits):
    jo, po, theta = _pair(molecules, circuits, "ucc_2e2o", seed=5)
    kappa = 0.02 * np.random.default_rng(6).standard_normal(jo.n_kappa)
    e_j = float(jo.energy_from_parameters(jnp.asarray(theta),
                                          jnp.asarray(kappa)))
    e_p = float(po.energy_from_parameters(theta, kappa))
    assert abs(e_p - e_j) < 1e-12
    # the energy at theta equals e0 of grad_hess (same quadratic form)
    assert abs(float(po.energy_from_parameters(theta))
               - float(po._grad_hess(theta)[0])) < 1e-12


def test_nr_trajectory_matches(molecules, circuits):
    """Three damped-Newton iterations from a random start: energies to
    1e-10, parameters and OAO-MO matrices to 1e-8."""
    jo, po, theta = _pair(molecules, circuits, "np_fabric_4e4o", seed=2)
    el_j, th_j, _, oao_j, eig_j = jo.full_optimization(
        jnp.asarray(theta), max_iterations=3)
    el_p, th_p, _, oao_p, eig_p = po.full_optimization(theta,
                                                       max_iterations=3)
    assert len(el_p) == len(el_j) == 3
    np.testing.assert_allclose(el_p, el_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(eig_p, eig_j, rtol=0, atol=1e-8)
    for a, b in zip(th_p, th_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-8)
    np.testing.assert_allclose(oao_p[-1].numpy(), np.asarray(oao_j[-1]),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(po.oao_mo_coeff.numpy(),
                               np.asarray(jo.oao_mo_coeff), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("shift", [0.0, 10.0])
def test_newton_step_matches(shift):
    """NewtonStep (augmented eigh solve, Armijo search over a list of
    parameter arrays) against the JAX package's, on a quartic objective:
    an indefinite Hessian (augmented) and a positive definite one."""
    rng = np.random.default_rng(4)
    c = np.abs(rng.standard_normal(3)) + 0.1
    x, y = rng.standard_normal(3), rng.standard_normal((2, 2))
    grad = np.concatenate([2 * c * x, (4 * y ** 3).ravel()])
    A = rng.standard_normal((7, 7))
    hess = A + A.T + shift * np.eye(7)

    def obj_j(u, v):
        return jnp.sum(jnp.asarray(c) * u ** 2) + jnp.sum(v ** 4)

    def obj_p(u, v):
        return torch.sum(torch.from_numpy(c) * u ** 2) + torch.sum(v ** 4)

    (xj, yj), low_j = J.NewtonStep().damped_newton_step(
        obj_j, [jnp.asarray(x), jnp.asarray(y)], jnp.asarray(grad),
        jnp.asarray(hess))
    (xp, yp), low_p = P.NewtonStep().damped_newton_step(
        obj_p, [torch.from_numpy(x), torch.from_numpy(y)],
        torch.from_numpy(grad), torch.from_numpy(hess))
    assert abs(low_p - low_j) < 1e-12
    assert (low_p < 0) == (shift == 0.0)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), rtol=0, atol=1e-12)


def test_full_optimization_2e2o_equals_casscf():
    mol = P.Moldata(GEO, "sto-3g")
    mol.run_casscf(2, 2)
    pqc = P.Parameterized_circuit(2, 2, ansatz="ucc", sector=True)
    oo = P.OO_pqc(pqc, mol, 2, 2)
    energy_l, theta_l, kappa_l, oao_l, eig_l = oo.full_optimization(
        pqc.init_zeros())
    assert abs(energy_l[-1] - mol.casscf.e_tot) < 1e-8
    assert abs(energy_l[-1] - (-92.74923230445957)) < 1e-8
    assert len(theta_l) == len(kappa_l) == len(oao_l) == len(eig_l)


def test_import_without_jax():
    """The port imports with jax blocked and loads nothing of the JAX
    package."""
    code = ("import sys; sys.modules['jax'] = None\n"
            "import auto_oo_tpu_torch as P\n"
            "from auto_oo_tpu_torch.ops import grid_kernels, linalg, rdms\n"
            "from auto_oo_tpu_torch.utils import (checkpoint, interop, "
            "observe)\n"
            "from auto_oo_tpu_torch.models import berry, noisy_oo_pqc\n"
            "from auto_oo_tpu_torch.simulator import custom, sector\n"
            "from auto_oo_tpu_torch.ops import spin_embed\n"
            "from auto_oo_tpu_torch.scripts import (demo_14e14o, "
            "lanczos_parking, tutorial_berry_phase)\n"
            "bad = [m for m, mod in sys.modules.items() if mod is not None "
            "and (m.split('.')[0] in ('jax', 'auto_oo_tpu'))]\n"
            "assert not bad, bad\n"
            "print(P.OO_pqc.__name__, P.BerryPhaseLoop.__name__, "
            "P.Noisy_OO_pqc.__name__)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "OO_pqc BerryPhaseLoop Noisy_OO_pqc"


def test_config_device_and_precision(monkeypatch):
    """The default device is the card; this module asked for the CPU
    (set_device), set_device names another, an explicit device= wins,
    and TF32 is off."""
    assert config.DEFAULT_DEVICE == torch.device("cuda")
    assert config.get_device() == torch.device("cpu")
    monkeypatch.setattr(config, "_DEVICE", config._DEVICE)
    config.set_device("meta")
    assert grid.build_grid_maps(2, 2).srcA.device.type == "meta"
    assert grid.build_grid_maps(2, 2, device="cpu").srcA.device.type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def test_default_device_is_the_card(monkeypatch):
    """With the default restored, get_device() is cuda, and a constructor
    given no device= puts its tensors on the card; on a host without one
    it raises where its first tensor is made, never returning CPU
    tensors."""
    monkeypatch.setattr(config, "_DEVICE", config.DEFAULT_DEVICE)
    assert config.get_device() == torch.device("cuda")
    if torch.cuda.is_available():
        pqc = P.Parameterized_circuit(2, 2, ansatz="ucc", sector=True)
        assert pqc.init_zeros().device.type == "cuda"
        assert grid.build_grid_maps(2, 2).srcA.device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|NVIDIA"):
        P.Parameterized_circuit(2, 2, ansatz="ucc", sector=True)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|NVIDIA"):
        grid.build_grid_maps(2, 2)


def test_unported_routes_raise(molecules, monkeypatch):
    _, mp = molecules({})
    pqc = P.Parameterized_circuit(2, 2, ansatz="ucc", sector=True)
    # "mixed" runs (tests/test_torch_mixed.py); other precisions, and a
    # hosted form off the hosted route, are refused
    with pytest.raises(ValueError, match="precision"):
        P.OO_pqc(pqc, mp, 2, 2, precision="f32")
    with pytest.raises(ValueError, match="hosted_form"):
        P.OO_pqc(pqc, mp, 2, 2, hosted_form="gram")
    with pytest.raises(ValueError, match="hosted_form"):
        P.OO_pqc(pqc, mp, 2, 2, hosted_form="chunked")
    oo = P.OO_pqc(pqc, mp, 2, 2)
    theta = pqc.init_zeros()
    # the device loop runs (tests/test_torch_device_loop.py), except at
    # the staged sizes, D >= 2^19, where it raises as the JAX package does
    monkeypatch.setattr(poo, "_STAGED_MIN_D", 1)
    with pytest.raises(ValueError, match="staged"):
        oo.full_optimization(theta, device_loop=True)
    monkeypatch.undo()
    # the gradient-only pipeline runs (held to the JAX package in
    # tests/test_torch_gradient.py)
    e, grad, (gamma, _) = oo.energy_and_gradient(theta)
    assert grad.shape == (pqc.theta_shape + oo.n_kappa,)
    assert abs(float(e) - float(oo.energy_from_parameters(theta))) < 1e-12
    # (on another object: both move its OAO coefficients, which the
    # checks below read)
    relaxed = P.OO_pqc(pqc, mp, 2, 2)
    assert len(relaxed.gradient_optimization(theta, max_iterations=2)[0]) \
        == 2
    assert len(relaxed.orbital_optimization(gamma, gamma.new_zeros(
        (2, 2, 2, 2)), max_iterations=1)) == 1
    # the streamed (Phi does not fit one block) branches run the
    # row-streamed functions and agree with the fused ones; so does the
    # hosted route
    psi = pqc._state_impl_grid(0.3 * torch.ones_like(theta))
    c1 = torch.tensor([[0.5, 0.1], [0.1, -0.2]], dtype=torch.float64)
    c2 = torch.arange(16, dtype=torch.float64).reshape(2, 2, 2, 2) / 16
    c2 = c2 + c2.permute(1, 0, 3, 2)
    fused = (rdms.rdms_from_state(psi, 2, pqc.sector_maps, grid_order=True),
             hamiltonian.ham_apply(c1, c2, psi, 2, pqc.sector_maps))
    monkeypatch.setattr(grid, "_PAIR_CHUNK_BYTES", 8)
    assert P.OO_pqc(pqc, mp, 2, 2)._core["route"] == "streamed"
    streamed = (rdms.rdms_from_state(psi, 2, pqc.sector_maps,
                                     grid_order=True),
                hamiltonian.ham_apply(c1, c2, psi, 2, pqc.sector_maps))
    for a, b in zip(fused[0] + fused[1:], streamed[0] + streamed[1:]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-13)
    monkeypatch.setattr(grid_hosted, "_HOSTED_MIN_BYTES", 1)
    hosted = P.OO_pqc(pqc, mp, 2, 2)
    assert hosted._core["route"] == "hosted"
    theta = 0.3 * torch.ones_like(theta)
    for a, b in zip(oo._grad_hess(theta), hosted._grad_hess(theta)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-11)
    assert abs(float(hosted.energy_from_parameters(theta))
               - float(oo.energy_from_parameters(theta))) < 1e-12
