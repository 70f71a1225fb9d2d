"""The hosted route's Gram form against the JAX package, on the CPU.

Where the (n_theta + 1, D) stack of psi and its tangent columns fits the
JAX package's 11e9-byte budget, its hosted second order takes the Gram
route (``grad_hess_hosted_gram`` on ``cross_hosted``,
auto_oo_tpu/models/oo_pqc.py:704-793, ops/grid_hosted.py:460-582); so
does the port's.  Here at (4e,4o)-class sizes, the same seeded inputs go
through both packages:

* ``cross_hosted``'s three accumulators with row chunk 3 (ragged
  chunks): f64 states to 1e-12, f32 states to 1e-5 relative (f32 grams,
  f64 sums); without the tangent grams only cross0[0] is summed;
* the forced hosted ``grad_hess`` on the Gram form against the JAX
  package's default hosted route (no AUTO_OO_TPU_HOSTED_PER_TANGENT), the
  H4 chain (n_kappa = 0) and formaldimine (n_kappa > 0): in f64 e0 and
  gradient to 1e-11 and the Hessian to 1e-9, plus one damped-Newton
  update (theta 1e-9, energy 1e-11); in mixed precision, where e0 and the
  gradient come from the f32 sweep in both packages, e0 to 1e-6, gradient
  and Hessian to 1e-5 relative, each also within the JAX package's bounds
  of its hosted mixed route against f64 (tests/test_grid.py:772-777);
* the Gram form equals the per-tangent form inside the port;
* the rule: the port takes the Gram form exactly where the JAX package
  does (its budget, and at (16e,16o) f64 per-tangent, mixed Gram).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import auto_oo_tpu as J
from auto_oo_tpu.models import OO_pqc as JOO
from auto_oo_tpu.models import Parameterized_circuit as JPC
from auto_oo_tpu.ops import grid as jgrid
from auto_oo_tpu.ops import grid_hosted as jgh
import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.ops import grid, grid_hosted
from auto_oo_tpu_torch.utils.interop import from_jax
from tests.torch_jax_memos import (  # noqa: F401
    fresh_jax_memos, fresh_jax_memos_module)

GEO = J.get_formal_geo(140, 80)
H4 = "H 0 0 0; H 0 0 1.2; H 0 0 2.4; H 0 0 3.6"
STEP = (1e-4, 0.5, 1e-6, 1.1, 1e-6)
SECTORS = [(4, 4), (4, (3, 1)), (5, (3, 2))]


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


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("ncas,nelecas", SECTORS)
def test_cross_hosted_matches_jax(ncas, nelecas, dtype):
    jm = jgrid.build_grid_maps(ncas, nelecas)
    pm = from_jax(jm)
    rng = np.random.default_rng(ncas)
    B = 4
    states = rng.standard_normal((B, jm.dim))
    c2 = rng.standard_normal((ncas,) * 4)
    c2 = (c2 + c2.transpose(1, 0, 3, 2) + c2.transpose(2, 3, 0, 1)) / 3
    jdt, pdt = ((jnp.float64, torch.float64) if dtype == "f64"
                else (jnp.float32, torch.float32))
    ref = jgh.cross_hosted([jnp.asarray(s, jdt) for s in states],
                           jnp.asarray(c2), jm, ncas, row_chunk=3,
                           seg_chunks=2)
    S = torch.from_numpy(states).to(pdt)
    out = grid_hosted.cross_hosted(S, torch.from_numpy(c2), pm, ncas, 3)
    for a, b in zip(out, ref):
        assert a.dtype == torch.float64
        if dtype == "f64":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-12)
        else:
            assert _rel(a.numpy(), b) < 1e-5
    # the (B, Na, Nb) stack and, without the tangent grams, cross0[0] only
    part = grid_hosted.cross_hosted(S.reshape(B, pm.Na, pm.Nb),
                                    torch.from_numpy(c2), pm, ncas, 3,
                                    tangent_grams=False)
    for a, b in zip(part[:2], out[:2]):
        assert torch.equal(a, b)
    assert torch.equal(part[2][0], out[2][0])
    assert not part[2][1:].any()


def _jax_hosted(jmol, precision, monkeypatch, per_tangent=False):
    """The JAX package's hosted (e0, grad, hess) and one Newton update at
    theta = 0.05 * arange, forced hosting, its default form unless
    ``per_tangent``."""
    jo = JOO(JPC(4, 4, ansatz="np_fabric", n_layers=1, sector=True), jmol,
             4, 4, freeze_active=True, precision=precision)
    theta = 0.05 * np.arange(jo.pqc.theta_shape)
    args = (jnp.asarray(theta), jo.oao_mo_coeff) + jo._mol_args
    monkeypatch.setenv("AUTO_OO_TPU_HOSTED_MIN_BYTES", "1")
    if per_tangent:
        monkeypatch.setenv("AUTO_OO_TPU_HOSTED_PER_TANGENT", "1")
    out = jo._core["grad_hess_staged"](*args)
    up = jo._core["newton_update_staged"](*args, *out, *STEP)
    return theta, out, up


def _port_hosted(pmol, precision, form=None):
    pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                  sector=True)
    return P.OO_pqc(pqc, pmol, 4, 4, freeze_active=True, precision=precision,
                    hosted_form=form, stream_plan=grid.StreamPlan(3, 1, None))


@pytest.mark.parametrize("precision", ["f64", "mixed"])
@pytest.mark.parametrize("geo", [H4, GEO], ids=["h4_chain", "formaldimine"])
def test_gram_grad_hess_matches_jax_default(geo, precision, mols,
                                            monkeypatch):
    jmol, pmol = mols(geo)
    theta, (e_j, g_j, h_j), up_j = _jax_hosted(jmol, precision, monkeypatch)

    monkeypatch.setattr(grid_hosted, "_HOSTED_MIN_BYTES", 1)
    po = _port_hosted(pmol, precision)
    assert po._core["route"] == "hosted"
    assert po._core["hosted_form"] == "gram"
    assert (po.n_kappa > 0) == (geo == GEO)
    th = torch.from_numpy(theta)
    e_p, g_p, h_p = po._grad_hess(th)
    up_p = po._core["newton_update"](th, po.oao_mo_coeff, *po._mol_args,
                                     e_p, g_p, h_p, *STEP)
    if precision == "f64":
        assert abs(float(e_p) - float(e_j)) < 1e-11
        np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=0,
                                   atol=1e-11)
        np.testing.assert_allclose(h_p.numpy(), np.asarray(h_j), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(up_p[0].numpy(), np.asarray(up_j[0]),
                                   rtol=0, atol=1e-9)
        assert abs(float(up_p[3]) - float(up_j[3])) < 1e-11
        return
    e_64, g_64, h_64 = P.OO_pqc(po.pqc, pmol, 4, 4,
                                freeze_active=True)._grad_hess(th)
    gs = float(g_64.abs().max()) + 1.0
    hs = float(h_64.abs().max()) + 1.0
    for e, g, h in ((e_p, g_p, h_p), (e_j, g_j, h_j)):
        g, h = np.asarray(g), np.asarray(h)
        assert abs(float(e) - float(e_64)) < 1e-5
        assert float(np.abs(g - g_64.numpy()).max()) < 1e-4 * gs
        assert float(np.abs(h - h_64.numpy()).max()) < 5e-4 * hs
    assert abs(float(e_p) - float(e_j)) < 1e-6
    assert _rel(g_p, g_j) < 1e-5
    assert _rel(h_p, h_j) < 1e-5
    np.testing.assert_allclose(up_p[0].numpy(), np.asarray(up_j[0]),
                               rtol=0, atol=1e-5)
    assert abs(float(up_p[3]) - float(up_j[3])) < 1e-6


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_gram_equals_per_tangent(precision, mols, monkeypatch):
    """Inside the port, formaldimine (n_kappa > 0): the two hosted forms
    give the same (e0, grad, hess), to rounding in f64 and to f32
    resolution in mixed precision."""
    _, pmol = mols(GEO)
    monkeypatch.setattr(grid_hosted, "_HOSTED_MIN_BYTES", 1)
    th = None
    out = {}
    for form in ("gram", "per_tangent"):
        po = _port_hosted(pmol, precision, form)
        assert po._core["hosted_form"] == form
        if th is None:
            th = 0.05 * torch.arange(po.pqc.theta_shape,
                                     dtype=torch.float64)
        out[form] = po._grad_hess(th)
    (e_g, g_g, h_g), (e_t, g_t, h_t) = out["gram"], out["per_tangent"]
    if precision == "f64":
        assert abs(float(e_g - e_t)) < 1e-11
        assert float((g_g - g_t).abs().max()) < 1e-11
        assert float((h_g - h_t).abs().max()) < 1e-9
    else:
        assert abs(float(e_g - e_t)) < 1e-6
        assert _rel(g_g, g_t) < 1e-5
        assert _rel(h_g, h_t) < 1e-5


class _Took(Exception):
    pass


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_route_rule_matches_jax(precision, mols, monkeypatch):
    """The port's rule is the JAX package's: the Gram form where (n_theta
    + 1) D itemsize is at most the budget.  At (16e,16o) (n_theta 14,
    D = 165,636,900) f64 goes per-tangent and mixed takes the Gram form;
    at (4e,4o) with the budget set at the stack's bytes and one byte
    below, both packages take the same form (the JAX one seen by which
    hosted pass it starts)."""
    itemsize = 4 if precision == "mixed" else 8
    assert grid_hosted._HOSTED_STACK_MAX_BYTES == 11e9
    assert grid_hosted.gram_fits(14, 165_636_900, itemsize) == (
        precision == "mixed")
    jmol, pmol = mols(H4)
    jo = JOO(JPC(4, 4, ansatz="np_fabric", n_layers=1, sector=True), jmol,
             4, 4, freeze_active=True, precision=precision)
    args = (jnp.zeros(jo.pqc.theta_shape), jo.oao_mo_coeff) + jo._mol_args
    stack = (jo.pqc.theta_shape + 1) * jo.pqc.state_dim * itemsize

    def took(name):
        def spy(*a, **k):
            raise _Took(name)
        return spy

    monkeypatch.setenv("AUTO_OO_TPU_HOSTED_MIN_BYTES", "1")
    monkeypatch.setattr(jgh, "cross_hosted", took("gram"))
    monkeypatch.setattr(jgh, "ham_and_rdms_hosted", took("per_tangent"))
    monkeypatch.setattr(grid_hosted, "_HOSTED_MIN_BYTES", 1)
    for budget in (stack, stack - 1):
        monkeypatch.setenv("AUTO_OO_TPU_HOSTED_STACK_MAX_BYTES", str(budget))
        with pytest.raises(_Took) as jax_form:
            jo._core["grad_hess_staged"](*args)
        monkeypatch.setattr(grid_hosted, "_HOSTED_STACK_MAX_BYTES", budget)
        po = _port_hosted(pmol, precision)
        assert po._core["hosted_form"] == jax_form.value.args[0]
        assert po._core["hosted_form"] == (
            "gram" if budget == stack else "per_tangent")
