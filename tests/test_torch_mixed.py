"""The port's precision="mixed" against the JAX package, on the CPU.

``OO_pqc(..., precision="mixed")`` runs the Hessian blocks in float32 and
keeps the energy, the gradient, psi's RDMs and the Fock packs in float64
(auto_oo_tpu/models/oo_pqc.py:62-140).  Here at (4e,4o)-class sizes, the
same seeded theta goes through the JAX package's mixed core and the
port's, with the contract of tests/test_mixed_precision.py:48-66:

* flat (sector=False) and fused (sector=True) routes: e0 and gradient
  within 1e-12 of the JAX package's mixed values and of the port's f64
  ones (both stay f64), the Hessian within 1e-5 relative (Frobenius) of
  both, and not equal to the f64 one (the f32 blocks ran);
* staged equals fused (one eager body in the port);
* streamed (a small row chunk and pair block forced) against the port's
  f64 and mixed fused values;
* the hosted per-tangent form against the JAX package's
  (AUTO_OO_TPU_HOSTED_PER_TANGENT=1), with one Newton update under the
  hosted-mixed Armijo slack.  There the passes over Phi run on the f32
  state in both packages, so e0 and the gradient carry f32 error: they
  are held to each other at 1e-6 (e0) and 1e-5 relative (gradient; f32
  eps 6e-8 over sums of ~10^3 terms), and each to the f64 values with
  the JAX package's own bounds (tests/test_grid.py:772-777);
* every gate sweep returns float32 from float32 theta and states (the
  flat program and the grid program, its rank-1 sign factors too);
* float32 matmuls stay at "highest" precision (no TF32) after a mixed
  ``OO_pqc`` is built and run.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import auto_oo_tpu as J
from auto_oo_tpu.models import OO_pqc as JOO
from auto_oo_tpu.models import Parameterized_circuit as JPC
import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.models import oo_pqc as poo
from auto_oo_tpu_torch.ops import grid, grid_hosted
from auto_oo_tpu_torch.simulator import grid_program

GEO = J.get_formal_geo(140, 80)
H4 = "H 0 0 0; H 0 0 1.2; H 0 0 2.4; H 0 0 3.6"
STEP = (1e-4, 0.5, 1e-6, 1.1, 1e-6)


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's default device is the card; these CPU tests ask for the
    CPU, and restore the default after the module."""
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


@pytest.fixture(scope="module")
def mols():
    cache = {}

    def get(geo):
        if geo not in cache:
            cache[geo] = (J.Moldata(geo, "sto-3g"), P.Moldata(geo, "sto-3g"))
        return cache[geo]
    return get


def _theta(n):
    return (0.05 * np.arange(n)
            + 0.02 * np.random.default_rng(3).standard_normal(n))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _port(mol, sector, precision, **kw):
    pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                  sector=sector)
    return P.OO_pqc(pqc, mol, 4, 4, freeze_active=True,
                    precision=precision, **kw)


def _held_f32(e, g, h, e_ref, g_ref, h_ref):
    """The mixed contract: e0 and gradient f64 (1e-12), the Hessian f32
    accurate (1e-5 relative) and f64 for the solve."""
    assert abs(float(e) - float(e_ref)) < 1e-12
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=0,
                               atol=1e-12)
    assert np.asarray(h).dtype == np.float64
    assert _rel(h, h_ref) < 1e-5


@pytest.mark.parametrize("sector", [False, True], ids=["flat", "fused"])
def test_mixed_grad_hess_matches_jax(sector, mols):
    jmol, pmol = mols(GEO)
    jpqc = JPC(4, 4, ansatz="np_fabric", n_layers=1, sector=sector)
    jo = JOO(jpqc, jmol, 4, 4, freeze_active=True, precision="mixed")
    theta = _theta(jpqc.theta_shape)
    e_j, g_j, h_j = jo._grad_hess_jit(jnp.asarray(theta), jo.oao_mo_coeff)

    po = _port(pmol, sector, "mixed")
    po64 = _port(pmol, sector, "f64")
    assert po._core["route"] == ("fused" if sector else "flat")
    assert po.n_kappa > 0
    th = torch.from_numpy(theta)
    e_p, g_p, h_p = po._grad_hess(th)
    e_64, g_64, h_64 = po64._grad_hess(th)
    _held_f32(e_p, g_p, h_p, e_j, g_j, h_j)
    _held_f32(e_p, g_p, h_p, e_64, g_64, h_64)
    assert float((h_p - h_64).abs().max()) > 0.0   # the f32 blocks ran


def test_mixed_staged_equals_fused(mols, monkeypatch):
    """The port runs the JAX package's fused and staged regimes with one
    eager body, so staged mixed equals fused mixed (the JAX package holds
    its two to f32 resolution, tests/test_mixed_precision.py:70-88)."""
    _, pmol = mols(GEO)
    po = _port(pmol, True, "mixed")
    th = torch.from_numpy(_theta(po.pqc.theta_shape))
    fused = po._grad_hess(th)
    monkeypatch.setattr(poo, "_STAGED_MIN_D", 1)
    po = _port(pmol, True, "mixed")
    assert po._core["route"] == "staged"
    for a, b in zip(po._grad_hess(th), fused):
        assert torch.equal(a, b)


def test_mixed_streamed_matches_f64(mols):
    """The streamed route (row chunk 3, pair block 5: ragged pieces) in
    mixed precision: the H J rows and transition-RDM rows on f32 states,
    psi's H-apply and RDMs f64.  Against the port's f64 fused values (held
    to the JAX package in tests/test_torch_oo_pqc.py) and its mixed fused
    ones."""
    _, pmol = mols(GEO)
    po = _port(pmol, True, "mixed",
               stream_plan=grid.StreamPlan(3, 5, None))
    assert po._core["route"] == "streamed"
    assert po._core["plan_lp"] == po._core["plan"]
    th = torch.from_numpy(_theta(po.pqc.theta_shape))
    e_p, g_p, h_p = po._grad_hess(th)
    _held_f32(e_p, g_p, h_p, *_port(pmol, True, "f64")._grad_hess(th))
    _held_f32(e_p, g_p, h_p, *_port(pmol, True, "mixed")._grad_hess(th))


def _held_hosted(e, g, h, e_64, g_64, h_64):
    """The JAX package's bounds of its hosted mixed route against f64
    (tests/test_grid.py:772-777): e0 and gradient come from f32 passes."""
    gs = float(np.abs(np.asarray(g_64)).max()) + 1.0
    hs = float(np.abs(np.asarray(h_64)).max()) + 1.0
    assert abs(float(e) - float(e_64)) < 1e-5
    assert float(np.abs(np.asarray(g) - np.asarray(g_64)).max()) < 1e-4 * gs
    assert float(np.abs(np.asarray(h) - np.asarray(h_64)).max()) < 5e-4 * hs


def _hosted_port(pmol, precision, form, geo):
    pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                  sector=True)
    po = P.OO_pqc(pqc, pmol, 4, 4, freeze_active=True, precision=precision,
                  hosted_form=form, stream_plan=grid.StreamPlan(3, 1, None))
    assert po._core["route"] == "hosted"
    assert po._core["hosted_form"] == form
    assert (po.n_kappa > 0) == (geo == GEO)
    return po


def test_mixed_hosted_per_tangent_matches_jax(mols, monkeypatch):
    """Forced hosting, the per-tangent form in both packages, mixed, on
    the H4 chain (n_kappa = 0, the (16e,16o) shape): the (H psi, RDMs)
    pass, the pair sweeps and the H J_i passes on f32 states, grad_c by
    the f64 adjoint sweep with the f32 H psi; then one Newton update
    (line-search energies from the f32 RDM pass, the 2e-6-relative
    slack)."""
    jmol, pmol = mols(H4)
    jo = JOO(JPC(4, 4, ansatz="np_fabric", n_layers=1, sector=True), jmol,
             4, 4, freeze_active=True, precision="mixed")
    theta = 0.05 * np.arange(jo.pqc.theta_shape)
    args = (jnp.asarray(theta), jo.oao_mo_coeff) + jo._mol_args
    monkeypatch.setenv("AUTO_OO_TPU_HOSTED_MIN_BYTES", "1")
    monkeypatch.setenv("AUTO_OO_TPU_HOSTED_PER_TANGENT", "1")
    e_j, g_j, h_j = jo._core["grad_hess_staged"](*args)
    up_j = jo._core["newton_update_staged"](*args, e_j, g_j, h_j, *STEP)

    monkeypatch.setattr(grid_hosted, "_HOSTED_MIN_BYTES", 1)
    po = _hosted_port(pmol, "mixed", "per_tangent", H4)
    th = torch.from_numpy(theta)
    e_p, g_p, h_p = po._grad_hess(th)
    # the f64 values: the port's fused route (held to the JAX package to
    # 1e-11 / 1e-9 in tests/test_torch_oo_pqc.py)
    f64 = P.OO_pqc(po.pqc, pmol, 4, 4, freeze_active=True)._grad_hess(th)
    _held_hosted(e_p, g_p, h_p, *f64)
    _held_hosted(e_j, g_j, h_j, *f64)
    assert abs(float(e_p) - float(e_j)) < 1e-6
    assert _rel(g_p, g_j) < 1e-5
    assert _rel(h_p, h_j) < 1e-5
    up_p = po._core["newton_update"](th, po.oao_mo_coeff, *po._mol_args,
                                     e_p, g_p, h_p, *STEP)
    np.testing.assert_allclose(up_p[0].numpy(), np.asarray(up_j[0]),
                               rtol=0, atol=1e-5)
    assert abs(float(up_p[3]) - float(up_j[3])) < 1e-6


def test_mixed_hosted_transition_rdms(mols, monkeypatch):
    """Formaldimine (n_kappa > 0): the per-tangent form's f32 passes that
    build both Phi chunks (H J_i with the transition RDMs), against the
    port's f64 fused values with the JAX package's bounds, and against
    the Gram form in mixed precision (held to the JAX package in
    tests/test_torch_gram.py) at f32 resolution."""
    _, pmol = mols(GEO)
    monkeypatch.setattr(grid_hosted, "_HOSTED_MIN_BYTES", 1)
    po = _hosted_port(pmol, "mixed", "per_tangent", GEO)
    th = torch.from_numpy(0.05 * np.arange(po.pqc.theta_shape))
    e_p, g_p, h_p = po._grad_hess(th)
    _held_hosted(e_p, g_p, h_p, *P.OO_pqc(po.pqc, pmol, 4, 4,
                                          freeze_active=True)._grad_hess(th))
    e_g, g_g, h_g = _hosted_port(pmol, "mixed", "gram", GEO)._grad_hess(th)
    assert abs(float(e_p) - float(e_g)) < 1e-6
    assert _rel(g_p, g_g) < 1e-5
    assert _rel(h_p, h_g) < 1e-5


def _f32_sweeps(prog, nt_full, params_idx, seed=0):
    """Every sweep of a program on f32 theta and states, against the same
    sweep in f64."""
    rng = np.random.default_rng(seed)
    th = torch.from_numpy(0.3 * rng.standard_normal(nt_full))
    v = torch.from_numpy(rng.standard_normal(nt_full))
    a = torch.from_numpy(rng.standard_normal(prog.dim))
    b = torch.from_numpy(rng.standard_normal(prog.dim))
    out = {}
    for dt in (torch.float64, torch.float32):
        t, vv, aa, bb = (x.to(dt) for x in (th, v, a, b))
        psi = prog.apply(t)
        psi_j, J = prog.apply_with_jacobian(t, params_idx)
        out[dt] = dict(
            initial=prog.initial_state(dt), apply=psi, psi_j=psi_j, J=J,
            hess=prog.hessian_dot(t, aa, psi_j, J, params_idx),
            pair=prog.apply_pair(t, vv)[1],
            row=prog.pair_row(t, vv, aa, bb))
    for name, x in out[torch.float32].items():
        assert x.dtype == torch.float32, name
        ref = out[torch.float64][name]
        scale = float(ref.abs().max()) + 1.0
        assert float((x.double() - ref).abs().max()) < 1e-5 * scale, name


@pytest.mark.parametrize("sector", [False, True], ids=["flat", "grid"])
def test_f32_sweeps_return_f32(sector, monkeypatch):
    """The flat GateProgram and the GridGateProgram (every sign matrix as
    its rank-1 factors too) keep f32 theta and states in f32 through every
    sweep: no f64 table or constant upcasts them."""
    for dense_max in ((grid_program._DENSE_SIGNS_MAX, 0) if sector
                      else (None,)):
        if dense_max is not None:
            monkeypatch.setattr(grid_program, "_DENSE_SIGNS_MAX", dense_max)
        pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=2,
                                      sector=sector)
        prog = pqc._sweep
        if dense_max == 0:
            assert all(isinstance(s, tuple) for s in prog._signs(
                torch.float32))
        _f32_sweeps(prog, prog.n_params, pqc._tangent_params)


def test_matmul_precision_stays_highest(mols):
    """A mixed OO_pqc turns on no reduced-precision float32 matmul: the
    JAX package measured one-pass low-precision f32 dots derailing the
    Newton trajectory by 8e-2 Ha (auto_oo_tpu/models/oo_pqc.py:132-138)."""
    _, pmol = mols(GEO)
    po = _port(pmol, True, "mixed")
    po._grad_hess(torch.from_numpy(_theta(po.pqc.theta_shape)))
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
