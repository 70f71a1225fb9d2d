"""The port's gradient-only pipeline against the JAX package, on the CPU.

``OO_pqc.energy_and_gradient`` and ``gradient_optimization`` are the JAX
package's first-order OO-VQE (auto_oo_tpu/models/oo_pqc.py:945-988,
:1362-1444), and ``OO_energy.orbital_optimization`` its fixed-RDM orbital
loop (auto_oo_tpu/models/oo_energy.py:174-239).  Here at (2e,2o)-(4e,4o)
sizes, the same seeded inputs go through both packages:

* ``energy_and_gradient`` on the flat, fused, streamed (a small row
  chunk and pair block forced) and hosted (the hosting threshold forced
  to 1 byte in both packages) routes, the H4 chain (n_kappa = 0) and
  formaldimine (n_kappa > 0): f64 e0 to 1e-12, gradient and RDMs to
  1e-11 (tests/test_oo_pqc.py:183-187, tests/test_grid.py:606-612);
  mixed against the JAX package's mixed pipeline: e0 to 1e-5, gradient
  to 1e-4 (max|g| + 1), RDMs to 1e-5 and float64
  (tests/test_grid.py:686-690, tests/test_mixed_precision.py:105-111);
  no autograd tape is recorded;
* ``adam`` against ``optax.adam`` over 20 seeded steps, to 1 ulp;
* ``orbital_optimization``'s trajectory to 1e-10 Ha, the golden
  -92.66372193556138 to 5e-7, and the torch.func gradient and Hessian of
  ``energy_from_kappa`` against the analytic ones
  (tests/test_oo_energy.py:83-102);
* ``gradient_optimization`` trajectories, energies to 1e-10 Ha and theta
  to 1e-9, with orbital relaxations, a monitor, an ``eval_fn`` and an
  explicit optimizer;
* the (16e,16o) and (14e,14o) demos' gradient stages on the H4 chain
  with hosting forced, and the stages they still refuse.
"""

import functools

import numpy as np
import optax
import pytest
import torch
import jax.numpy as jnp

import auto_oo_tpu as J
from auto_oo_tpu.models import OO_energy as JOE
from auto_oo_tpu.models import OO_pqc as JOO
from auto_oo_tpu.models import Parameterized_circuit as JPC
import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.ops import grid, grid_hosted
from auto_oo_tpu_torch.scripts import demo_14e14o, demo_16e16o
from auto_oo_tpu_torch.utils import optim
from tests.torch_jax_memos import (  # noqa: F401
    fresh_jax_memos, fresh_jax_memos_module)

GEOS = {"h4_chain": "H 0 0 0; H 0 0 1.2; H 0 0 2.4; H 0 0 3.6",
        "formaldimine": J.get_formal_geo(140, 80)}
ROUTES = ("flat", "fused", "streamed", "hosted")
HOSTED_ENV = "AUTO_OO_TPU_HOSTED_MIN_BYTES"


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's default device is the card; these CPU tests ask for the
    CPU, and restore the default after the module."""
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


@functools.lru_cache(maxsize=None)
def _jax_mol(name):
    return J.Moldata(GEOS[name], "sto-3g")


@functools.lru_cache(maxsize=None)
def _port_mol(name):
    return P.Moldata(GEOS[name], "sto-3g")


def _theta(n):
    return 0.05 * np.arange(n) - 0.1


def _close(out, ref, atol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=0,
                               atol=atol)


@functools.lru_cache(maxsize=None)
def _jax_eg(name, sector, hosted, precision):
    """The JAX package's energy_and_gradient of (4e,4o) np_fabric L=1
    (freeze_active) at ``_theta``, as numpy (e, grad, gamma, Gamma); the
    hosted route forced through its byte threshold, read at call time."""
    import os
    jo = JOO(JPC(4, 4, ansatz="np_fabric", n_layers=1, sector=sector),
             _jax_mol(name), 4, 4, freeze_active=True, precision=precision)
    saved = os.environ.get(HOSTED_ENV)
    if hosted:
        os.environ[HOSTED_ENV] = "1"
    try:
        e, g, (g1, G2) = jo.energy_and_gradient(
            jnp.asarray(_theta(jo.pqc.theta_shape)))
    finally:
        if saved is None:
            os.environ.pop(HOSTED_ENV, None)
        else:
            os.environ[HOSTED_ENV] = saved
    return (float(e), np.asarray(g), np.asarray(g1), np.asarray(G2),
            jo.n_kappa)


def _port_oo(name, route, precision, monkeypatch):
    """The port's (4e,4o) np_fabric L=1 OO_pqc on ``route``."""
    kw = {}
    if route == "hosted":
        monkeypatch.setattr(grid_hosted, "_HOSTED_MIN_BYTES", 1)
        kw["stream_plan"] = grid.StreamPlan(3, 1, None)
    elif route == "streamed":
        kw["stream_plan"] = grid.StreamPlan(3, 5, None)
    pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                  sector=route != "flat")
    oo = P.OO_pqc(pqc, _port_mol(name), 4, 4, freeze_active=True,
                  precision=precision, **kw)
    assert oo._core["route"] == route
    return oo


def _no_tape():
    """Fails any autograd recording: a tape over the gate program would
    save tensors for backward."""
    def pack(t):
        raise AssertionError("autograd saved a tensor for backward")
    return torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t)


@pytest.mark.parametrize("precision", ["f64", "mixed"])
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", list(GEOS))
def test_energy_and_gradient_matches_jax(name, route, precision,
                                         monkeypatch):
    e_j, g_j, g1_j, G2_j, nk = _jax_eg(name, route != "flat",
                                       route == "hosted", precision)
    assert (nk > 0) == (name == "formaldimine")
    oo = _port_oo(name, route, precision, monkeypatch)
    with _no_tape():
        e, g, (g1, G2) = oo.energy_and_gradient(_theta(oo.pqc.theta_shape))
    assert g.shape == (oo.pqc.theta_shape + oo.n_kappa,)
    assert g1.dtype == G2.dtype == g.dtype == torch.float64
    if precision == "f64":
        assert abs(float(e) - e_j) < 1e-12
        _close(g, g_j, 1e-11)
        _close(g1, g1_j, 1e-11)
        _close(G2, G2_j, 1e-11)
    else:
        assert abs(float(e) - e_j) < 1e-5
        _close(g, g_j, 1e-4 * (np.abs(g_j).max() + 1))
        _close(g1, g1_j, 1e-5)
        _close(G2, G2_j, 1e-5)


def test_energy_and_gradient_agrees_with_grad_hess():
    """One route, both pipelines of the port: e0 and the gradient of
    energy_and_gradient equal grad_hess's (the same reverse sweep on the
    flat route), and its RDMs the circuit's."""
    pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1)
    oo = P.OO_pqc(pqc, _port_mol("formaldimine"), 4, 4, freeze_active=True)
    th = _theta(pqc.theta_shape)
    e, g, (g1, G2) = oo.energy_and_gradient(th)
    e_h, g_h, _ = oo._grad_hess(th)
    assert abs(float(e) - float(e_h)) < 1e-12
    _close(g, g_h, 1e-12)
    r1, r2 = pqc.get_rdms(th)
    _close(g1, r1, 1e-12)
    _close(G2, r2, 1e-12)


@pytest.mark.parametrize("kw", [
    dict(learning_rate=0.05),
    dict(learning_rate=0.07, b1=0.8, b2=0.99, eps=1e-6, eps_root=1e-12)])
def test_adam_matches_optax(kw):
    """20 seeded steps with gradients from 1e-10 to 1 (near eps, where
    the order of the roundings shows): theta and updates within 1 ulp of
    optax's, the count an int32."""
    rng = np.random.default_rng(7)
    th = rng.standard_normal(14)
    t_j, t_p = jnp.asarray(th), torch.from_numpy(th.copy())
    o_j, o_p = optax.adam(**kw), optim.adam(**kw)
    s_j, s_p = o_j.init(t_j), o_p.init(t_p)
    for _ in range(20):
        g = rng.standard_normal(14) * 10.0 ** rng.uniform(-10, 0, 14)
        u_j, s_j = o_j.update(jnp.asarray(g), s_j, t_j)
        u_p, s_p = o_p.update(torch.from_numpy(g), s_p, t_p)
        t_j = optax.apply_updates(t_j, u_j)
        t_p = optim.apply_updates(t_p, u_p)
        np.testing.assert_array_max_ulp(u_p.numpy(), np.asarray(u_j), 1)
        np.testing.assert_array_max_ulp(t_p.numpy(), np.asarray(t_j), 1)
    assert s_p.count.dtype == torch.int32 and int(s_p.count) == 20
    np.testing.assert_array_max_ulp(s_p.nu.numpy(), np.asarray(s_j[0].nu), 1)


@pytest.fixture(scope="module")
def orbital_pair():
    """(2e,2o) formaldimine OO_energy in both packages (freeze_active
    False) with closed-shell HF-like active RDMs
    (tests/test_oo_energy.py:70-76)."""
    one = np.array([[2.0, 0.0], [0.0, 0.0]])
    two = np.zeros((2, 2, 2, 2))
    two[0, 0, 0, 0] = 2.0
    return (lambda: JOE(_jax_mol("formaldimine"), 2, 2),
            lambda: P.OO_energy(_port_mol("formaldimine"), 2, 2),
            one, two)


def test_orbital_optimization_matches_jax(orbital_pair):
    """The trajectory to 1e-10 Ha of the JAX package's, the golden RHF
    minimum to 5e-7 (tests/test_oo_energy.py:96-102), and the warm start:
    the OAO coefficients are updated in place, as in JAX."""
    make_j, make_p, one, two = orbital_pair
    oj, op = make_j(), make_p()
    e_j = oj.orbital_optimization(jnp.asarray(one), jnp.asarray(two),
                                  conv_tol=1e-10, max_iterations=80)
    e_p = op.orbital_optimization(one, two, conv_tol=1e-10,
                                  max_iterations=80)
    assert len(e_p) == len(e_j)
    _close(e_p, e_j, 1e-10)
    assert abs(e_p[-1] - (-92.66372193556138)) < 5e-7
    # at the minimum the coefficients carry the last steps' roundoff
    # through the Hessian's soft directions (2.7e-9 here)
    _close(op.oao_mo_coeff, oj.oao_mo_coeff, 1e-7)
    # a second call starts where the first ended (one more short run)
    e2_j = oj.orbital_optimization(jnp.asarray(one), jnp.asarray(two),
                                   max_iterations=3)
    e2_p = op.orbital_optimization(one, two, max_iterations=3)
    _close(e2_p, e2_j, 1e-10)


def test_energy_from_kappa_torch_func_matches_analytic(orbital_pair):
    """torch.func.grad / hessian of energy_from_kappa against the
    analytic Fock gradient and Hessian (tests/test_oo_energy.py:83-93;
    the analytic blocks are held to the JAX package's through grad_hess
    in the other port tests), E(kappa) against the JAX package's and
    against the rotated MOs' energy, and the packing round trip."""
    make_j, make_p, one, two = orbital_pair
    oj, op = make_j(), make_p()
    one_p, two_p = torch.from_numpy(one), torch.from_numpy(two)
    k0 = torch.zeros(op.n_kappa, dtype=torch.float64)
    g_auto = torch.func.grad(op.energy_from_kappa)(k0, one_p, two_p)
    g_exact = op.kappa_matrix_to_vector(op.analytic_gradient(one_p, two_p))
    _close(g_auto, g_exact, 1e-9)
    h_auto = torch.func.hessian(op.energy_from_kappa)(k0, one_p, two_p)
    h_exact = op.full_hessian_to_matrix(op.analytic_hessian(one_p, two_p))
    _close(h_auto, h_exact, 1e-8)
    one_j, two_j = jnp.asarray(one), jnp.asarray(two)
    k = torch.zeros(op.n_kappa, dtype=torch.float64)
    k[0] = 0.05
    e1 = float(op.energy_from_kappa(k, one_p, two_p))
    e2 = float(op.energy_from_mo_coeff(
        op.get_transformed_mo(op.mo_coeff, k), one_p, two_p))
    assert abs(e1 - e2) < 1e-12
    assert abs(e1 - float(oj.energy_from_kappa(jnp.asarray(k.numpy()),
                                               one_j, two_j))) < 1e-11
    kmat = op.kappa_vector_to_matrix(k)
    _close(kmat, -kmat.T, 0)
    _close(op.kappa_matrix_to_vector(kmat), k, 0)
    # the dense Y of the Hessian (reference oo_energy.py:381-393) on
    # seeded tensors, against numpy
    rng = np.random.default_rng(3)
    g, G = rng.standard_normal((2, 5, 5, 5, 5))
    ref = (np.einsum("pmrn,qmns->pqrs", G, g)
           + np.einsum("pmnr,qmns->pqrs", G, g)
           + np.einsum("prmn,qsmn->pqrs", G, g))
    _close(op.y_matrix(torch.from_numpy(g), torch.from_numpy(G)), ref,
           1e-12)


class _Log:
    def __init__(self):
        self.rows = []

    def log(self, n, energy):
        self.rows.append((n, energy))


# (label, circuit kwargs, freeze_active, steps, lr, orbital_every, extra)
TRAJECTORIES = [
    ("2e2o_ucc", dict(ncas=2, kw=dict(ansatz="ucc")), False, 12, 0.1, 3,
     None),
    ("2e2o_ucc_optimizer", dict(ncas=2, kw=dict(ansatz="ucc")), False, 9,
     0.1, 4, "optimizer"),
    ("2e2o_sector_eval_fn", dict(ncas=2, kw=dict(ansatz="ucc",
                                                 sector=True)),
     False, 8, 0.1, 3, "eval_fn"),
]


@pytest.mark.parametrize("label,spec,frozen,steps,lr,every,extra",
                         TRAJECTORIES, ids=[t[0] for t in TRAJECTORIES])
def test_gradient_optimization_matches_jax(label, spec, frozen, steps, lr,
                                           every, extra):
    """Formaldimine (2e,2o) ucc from init_zeros with conv_tol=0, in the
    full space and on the sector grid: the energies to 1e-10 Ha and the
    final theta to 1e-9 of the JAX package's run, the OAO coefficients
    after the relaxations to 1e-9, and the monitor's rows; with an
    explicit optimizer (Adam at other constants in both packages) or an
    eval_fn whose RDM thunk is called on relaxation steps only.  (A
    circuit whose gradient at init_zeros has entries zero by symmetry,
    such as np_fabric here, is no trajectory test: Adam scales their
    roundoff to steps of the learning rate, in either package.)"""
    n = spec["ncas"]
    jo = JOO(JPC(n, n, **spec["kw"]), _jax_mol("formaldimine"), n, n,
             freeze_active=frozen)
    po = P.OO_pqc(P.Parameterized_circuit(n, n, **spec["kw"]),
                  _port_mol("formaldimine"), n, n, freeze_active=frozen)
    assert po.n_kappa > 0
    kw = dict(max_iterations=steps, learning_rate=lr, orbital_every=every,
              conv_tol=0)
    kw_j, kw_p = dict(kw), dict(kw)
    thunks = {"jax": 0, "port": 0}
    if extra == "optimizer":
        adam_kw = dict(b1=0.8, b2=0.99, eps=1e-7)
        kw_j["optimizer"] = optax.adam(0.07, **adam_kw)
        kw_p["optimizer"] = optim.adam(0.07, **adam_kw)
    elif extra == "eval_fn":
        def make(oo, key):
            def eval_fn(th):
                e, g, rdms = oo.energy_and_gradient(th)

                def thunk():
                    thunks[key] += 1
                    return rdms
                return e, g[:oo._nt], thunk
            return eval_fn
        kw_j["eval_fn"] = make(jo, "jax")
        kw_p["eval_fn"] = make(po, "port")
    log_j, log_p = _Log(), _Log()
    e_j, th_j = jo.gradient_optimization(jo.pqc.init_zeros(), monitor=log_j,
                                         **kw_j)
    e_p, th_p = po.gradient_optimization(po.pqc.init_zeros(), monitor=log_p,
                                         **kw_p)
    assert len(e_p) == len(e_j) == steps
    _close(e_p, e_j, 1e-10)
    _close(th_p, th_j, 1e-9)
    _close(po.oao_mo_coeff, jo.oao_mo_coeff, 1e-9)
    assert [r[0] for r in log_p.rows] == list(range(steps))
    _close([r[1] for r in log_p.rows], e_p, 0)
    if extra == "eval_fn":
        assert thunks["port"] == thunks["jax"] == steps // every
    assert e_p[-1] < e_p[0]


def test_gradient_optimization_default_stops_like_jax():
    """The stopping rule (two consecutive deltas below conv_tol, n > 2)
    at a conv_tol that stops the (2e,2o) run early in both packages, the
    default orbital settings (every 10 steps, 20 iterations)."""
    jo = JOO(JPC(2, 2, ansatz="ucc"), _jax_mol("formaldimine"), 2, 2)
    po = P.OO_pqc(P.Parameterized_circuit(2, 2, ansatz="ucc"),
                  _port_mol("formaldimine"), 2, 2)
    e_j, _ = jo.gradient_optimization(jo.pqc.init_zeros(),
                                      max_iterations=40, conv_tol=1e-4)
    e_p, _ = po.gradient_optimization(po.pqc.init_zeros(),
                                      max_iterations=40, conv_tol=1e-4)
    assert 3 < len(e_j) < 40
    assert len(e_p) == len(e_j)
    _close(e_p, e_j, 1e-10)


def test_full_circuit_hessian_to_matrix():
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=2)
    oo = P.OO_pqc(pqc, _port_mol("formaldimine"), 2, 2)
    h = oo.circuit_circuit_hessian(0.1 * np.arange(pqc.theta_shape))
    nt = pqc.theta_shape
    out = oo.full_circuit_hessian_to_matrix(h.reshape(-1))
    assert out.shape == (nt, nt)
    _close(out, h, 0)


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_demo_gradient_stages_on_hosted_route(precision, monkeypatch,
                                              capsys):
    """The (16e,16o) demo's grad / gradmixed and adam / adammixed stages
    on the H4 chain (4e,4o) with hosting forced: the hosted route, the
    stage's energy equal to E(theta) in f64, and descending Adam steps
    (mixed: E(0) equal to RHF to 1e-4)."""
    monkeypatch.setattr(grid_hosted, "_HOSTED_MIN_BYTES", 1)
    pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                  sector=True)
    mol = _port_mol("h4_chain")
    mol.run_rhf()
    theta = 0.02 * torch.arange(pqc.theta_shape, dtype=torch.float64)
    oo, e, grad = demo_16e16o.grad_stage(pqc, mol, 4, 4, theta, precision,
                                         check_energy=precision == "f64")
    assert oo._core["route"] == "hosted"
    assert oo._core["precision"] == precision
    assert grad.shape == (pqc.theta_shape,)
    oo, es = demo_16e16o.adam_stage(pqc, mol, 4, 4, precision, 3)
    assert oo._core["route"] == "hosted"
    assert len(es) == 3 and es[-1] < es[0]
    out = capsys.readouterr().out
    assert "3 Adam steps" in out and "|grad|" in out


def test_demo_14e14o_refuses_s2_only():
    """The (14e,14o) demo runs the JAX demo's s2 stage: every stage,
    s2 among them and in its default list, is accepted (without a card
    the demo then returns 2), and an unknown stage is a ValueError before
    any card is looked for."""
    assert "s2" in demo_14e14o._STAGES
    with pytest.raises(ValueError, match="unknown stage"):
        demo_14e14o.main(["1", "nope"])
    if not torch.cuda.is_available():
        assert demo_14e14o.main(["1", "state,s2"]) == 2
        assert demo_14e14o.main(["1", "state,rdms,s2,energy,grad,adam"]) \
            == 2