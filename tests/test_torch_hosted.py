"""The port's hosted route against the JAX package, on the CPU.

Where one full-Phi pass reaches the JAX package's hosting threshold
((16e,16o) on), the port's ``OO_pqc`` takes the hosted route: the
scatter-form grid passes of ops/grid_hosted.py and the per-tangent
Hessian of models/oo_pqc.py, whose rows come from the pair sweeps of
simulator/grid_program.py.  Here at (4e,4o)-class sizes, the same seeded
inputs go through the JAX package's functions and the port's:

* ``inverse_alpha_maps``: exactly equal;
* ``rdms_hosted``, ``ham_apply_hosted`` (grid and canonical order),
  ``ham_and_rdms_hosted`` and ``ham_and_trdms_hosted`` with row chunk 3
  (ragged remainders) to 1e-13, the pins of tests/test_grid.py;
* the alpha scatter's plain version against the JAX package's
  ``.at[].add`` chunk step, and against the gather form the card's kernel
  computes, to 1e-13;
* ``apply_pair`` / ``pair_row`` against ``_pair_state_impl_grid`` and
  ``jax.grad`` over it: 1e-13 forward, 1e-11 reverse;
* ``OO_pqc`` with the hosting threshold forced to 1 byte and the
  per-tangent form against the JAX package's forced hosted per-tangent
  ``grad_hess_staged``: e0 and gradient to 1e-11, the Hessian to 1e-9,
  and one damped-Newton update (theta to 1e-9, energy to 1e-11) (the Gram
  form: tests/test_torch_gram.py);
* the (16e,16o) demo's stages: the refused one (s2) names its ROADMAP
  item, and its nrmixed stage takes the Gram form at a small
  forced-hosted size.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import auto_oo_tpu as J
from auto_oo_tpu.models import OO_pqc as JOO
from auto_oo_tpu.models import Parameterized_circuit as JPC
from auto_oo_tpu.ops import grid as jgrid
from auto_oo_tpu.ops import grid_hosted as jgh
import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.ops import fermion, grid, grid_hosted
from auto_oo_tpu_torch.ops import grid_kernels as gk
from auto_oo_tpu_torch.scripts import demo_16e16o
from auto_oo_tpu_torch.utils.interop import from_jax

SECTORS = [(4, 4), (4, (3, 1)), (5, (3, 2))]
STEP = (1e-4, 0.5, 1e-6, 1.1, 1e-6)


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's default device is the card; these CPU tests ask for the
    CPU, and restore the default after the module."""
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


def _maps(ncas, nelecas):
    jm = jgrid.build_grid_maps(ncas, nelecas)
    return jm, from_jax(jm)


def _inputs(ncas, D, seed):
    """A normalized state, a tangent, and random symmetric (c1eff, c2) as
    numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(D)
    x /= np.linalg.norm(x)
    t = rng.standard_normal(D)
    c1 = rng.standard_normal((ncas, ncas))
    c2 = rng.standard_normal((ncas,) * 4)
    c2 = (c2 + c2.transpose(1, 0, 3, 2) + c2.transpose(2, 3, 0, 1)) / 3
    return x, t, (c1 + c1.T) / 2, c2


def _close(out, ref, atol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("ncas,nelecas", SECTORS)
def test_inverse_alpha_maps_exact(ncas, nelecas):
    jm, pm = _maps(ncas, nelecas)
    jdst, jdsg = jgrid.inverse_alpha_maps(jm)
    dst, dsg = grid.inverse_alpha_maps(pm)
    assert dst.dtype == np.asarray(jdst).dtype
    assert dsg.dtype == np.asarray(jdsg).dtype
    np.testing.assert_array_equal(dst, np.asarray(jdst))
    np.testing.assert_array_equal(dsg, np.asarray(jdsg))
    # cached on the maps
    assert grid.inverse_alpha_maps(pm)[0] is dst


@pytest.mark.parametrize("ncas,nelecas", SECTORS)
def test_hosted_drivers_match_jax(ncas, nelecas):
    """The four hosted passes against the JAX package's functions of the
    same names, row chunk 3 (ragged remainders), to 1e-13."""
    jm, pm = _maps(ncas, nelecas)
    x, t, c1, c2 = _inputs(ncas, jm.dim, 1)
    jx, jt, jc1, jc2 = (jnp.asarray(a) for a in (x, t, c1, c2))
    px, pt, pc1, pc2 = (torch.from_numpy(a) for a in (x, t, c1, c2))
    kw = dict(row_chunk=3, seg_chunks=2)

    g_j, G_j = jgh.rdms_hosted(jx, jm, ncas, **kw)
    g_p, G_p = grid_hosted.rdms_hosted(px, pm, ncas, row_chunk=3)
    _close(g_p, g_j, 1e-13)
    _close(G_p, G_j, 1e-13)

    h_j = jgh.ham_apply_hosted(jc1, jc2, jx, jm, **kw)
    _close(grid_hosted.ham_apply_hosted(pc1, pc2, px, pm, 3), h_j, 1e-13)
    # canonical order in and out
    h_c = grid_hosted.ham_apply_hosted(pc1, pc2, grid.from_grid(px, pm), pm,
                                       3, grid_order=False)
    _close(h_c, jgrid.from_grid(h_j, jm), 1e-13)

    out = grid_hosted.ham_and_rdms_hosted(pc1, pc2, px, pm, ncas, 3)
    for a, b in zip(out, jgh.ham_and_rdms_hosted(jc1, jc2, jx, jm, ncas,
                                                 **kw)):
        _close(a, b, 1e-13)
    out = grid_hosted.ham_and_trdms_hosted(pc1, pc2, px, pt, pm, ncas, 3)
    for a, b in zip(out, jgh.ham_and_trdms_hosted(jc1, jc2, jx, jt, jm,
                                                  ncas, **kw)):
        _close(a, b, 1e-13)


@pytest.mark.parametrize("r0,r1", [(0, 3), (2, 7), (7, 10)])
def test_scatter_plain_matches_jax_chunk_step(r0, r1):
    """The alpha half of one hosted chunk: the port's plain scatter (and
    the wrapper on CPU tensors) against the JAX package's
    acc.at[dst].add(Y * dsg * tB), and against the gather form that the
    card's kernel computes, on a batch of two."""
    jm, pm = _maps(5, (3, 2))
    R = r1 - r0
    rng = np.random.default_rng(r0)
    Y = rng.standard_normal((2, jm.n2, R, jm.Nb))
    acc = rng.standard_normal((2, jm.Na, jm.Nb))
    dst, dsg = (np.asarray(a) for a in jgrid.inverse_alpha_maps(jm))
    tB = np.asarray(jm.tB, dtype=np.float64)
    contrib = (jnp.asarray(Y) * dsg[:, r0:r1, None].astype(np.float64)
               * tB[:, None, :])
    ref = jnp.stack([jnp.asarray(acc[b]).at[dst[:, r0:r1]].add(contrib[b])
                     for b in range(2)])
    like = torch.zeros((), dtype=torch.float64)
    srcA, sgnA, tB_p = pm.tables(like)[:3]
    idst, idsg = grid_hosted._inverse_tables(pm, like)
    for fn in (gk.scatter_rows_plain, gk.scatter_rows):
        out = torch.from_numpy(acc.copy())
        res = fn(out, torch.from_numpy(Y), srcA, sgnA, tB_p, idst, idsg, r0)
        assert res is out
        _close(out, ref, 1e-13)
    # the gather form: output row i reads its pairs' source rows inside
    # the window
    gather = acc.copy()
    src, sgn = np.asarray(jm.srcA), np.asarray(jm.sgnA, dtype=np.float64)
    for k in range(jm.n2):
        for i in range(jm.Na):
            if sgn[k, i] != 0 and r0 <= src[k, i] < r1:
                gather[:, i] += Y[:, k, src[k, i] - r0] * sgn[k, i] * tB[k]
    _close(out, gather, 1e-13)


@pytest.mark.parametrize("ncas,nelecas,kw", [
    (4, 4, dict(ansatz="np_fabric", n_layers=1)),
    (3, (2, 1), dict(ansatz="ucc", add_singles=True))])
def test_pair_sweeps_match_jax(ncas, nelecas, kw):
    """apply_pair against _pair_state_impl_grid (1e-13) and pair_row
    against jax.grad of <psi, a> + <J v, b> over it (1e-11), with and
    without the forward pair given."""
    jp = JPC(ncas, nelecas, sector=True, **kw)
    pp = P.Parameterized_circuit(ncas, nelecas, sector=True, **kw)
    rng = np.random.default_rng(0)
    th = 0.3 * rng.standard_normal(jp.theta_shape)
    v = rng.standard_normal(jp.theta_shape)
    a = rng.standard_normal(jp.grid_program.dim)
    b = rng.standard_normal(jp.grid_program.dim)
    psi_j, dl_j = jp._pair_state_impl_grid(jnp.asarray(th), jnp.asarray(v))
    th_p, v_p = torch.from_numpy(th), torch.from_numpy(v)
    psi_p, dl_p = pp._pair_state_grid(th_p, v_p)
    _close(psi_p, psi_j, 1e-13)
    _close(dl_p, dl_j, 1e-13)

    def g(t):
        ps, d = jp._pair_state_impl_grid(t, jnp.asarray(v))
        return ps @ jnp.asarray(a) + d @ jnp.asarray(b)

    ref = jax.grad(g)(jnp.asarray(th))
    a_p, b_p = torch.from_numpy(a), torch.from_numpy(b)
    _close(pp._pair_row_grid(th_p, v_p, a_p, b_p), ref, 1e-11)
    _close(pp._pair_row_grid(th_p, v_p, a_p, b_p, psi_p, dl_p), ref, 1e-11)
    # one tangent direction (the hosted Hessian row's seed)
    e = torch.zeros_like(th_p)
    e[1] = 1.0
    _, dl_e = jp._pair_state_impl_grid(jnp.asarray(th), jnp.asarray(e))
    _close(pp._pair_state_grid(th_p, e)[1], dl_e, 1e-13)


@pytest.mark.parametrize("name", ["h4_chain", "formaldimine"])
def test_forced_hosted_grad_hess_matches_jax(name, monkeypatch):
    """(4e,4o) np_fabric L=1 with the hosting threshold forced to 1 byte in
    both packages: the port's hosted grad_hess (row chunk 3, ragged
    chunks; the H4 chain full-valence with n_kappa = 0, formaldimine with
    n_kappa > 0) against the JAX package's per-tangent hosted
    grad_hess_staged, and one damped-Newton update from them."""
    geo = ("H 0 0 0; H 0 0 1.2; H 0 0 2.4; H 0 0 3.6" if name == "h4_chain"
           else J.get_formal_geo(140, 80))
    jo = JOO(JPC(4, 4, ansatz="np_fabric", n_layers=1, sector=True),
             J.Moldata(geo, "sto-3g"), 4, 4, freeze_active=True)
    theta = 0.05 * np.arange(jo.pqc.theta_shape)
    args = (jnp.asarray(theta), jo.oao_mo_coeff) + jo._mol_args
    monkeypatch.setenv("AUTO_OO_TPU_HOSTED_MIN_BYTES", "1")
    monkeypatch.setenv("AUTO_OO_TPU_HOSTED_PER_TANGENT", "1")
    e_j, g_j, h_j = jo._core["grad_hess_staged"](*args)
    up_j = jo._core["newton_update_staged"](*args, e_j, g_j, h_j, *STEP)

    monkeypatch.setattr(grid_hosted, "_HOSTED_MIN_BYTES", 1)
    pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                  sector=True)
    po = P.OO_pqc(pqc, P.Moldata(geo, "sto-3g"), 4, 4, freeze_active=True,
                  stream_plan=grid.StreamPlan(3, 1, None),
                  hosted_form="per_tangent")
    assert po._core["route"] == "hosted"
    assert po._core["hosted_form"] == "per_tangent"
    assert (po.n_kappa > 0) == (name == "formaldimine")
    th = torch.from_numpy(theta)
    e_p, g_p, h_p = po._grad_hess(th)
    assert abs(float(e_p) - float(e_j)) < 1e-11
    _close(g_p, g_j, 1e-11)
    _close(h_p, h_j, 1e-9)
    up_p = po._core["newton_update"](th, po.oao_mo_coeff, *po._mol_args,
                                     e_p, g_p, h_p, *STEP)
    _close(up_p[0], up_j[0], 1e-9)
    assert abs(float(up_p[3]) - float(up_j[3])) < 1e-11


def test_demo_refuses_unported_stages():
    """The (16e,16o) demo refuses only stages it does not know, before it
    looks for a card: every stage of the JAX demo is accepted, s2 (S^2 on
    the grid) among them (without a card the demo then returns 2), and an
    unknown stage is a ValueError."""
    with pytest.raises(ValueError, match="unknown stage"):
        demo_16e16o.main(["1", "nope"])
    with pytest.raises(ValueError, match="unknown stage"):
        demo_16e16o.main(["1", "state,s2,nope"])
    if not torch.cuda.is_available():
        assert demo_16e16o.main(["1", "state,s2"]) == 2
        assert demo_16e16o.main([]) == 2
        assert demo_16e16o.main(
            ["1", "state,rdms,s2,energy,grad,gradmixed,adam,adammixed,nr,"
                  "nrmixed"]) == 2


def test_demo_nrmixed_reaches_gram(monkeypatch, capsys):
    """The demo's nrmixed stage on the H4 chain (4e,4o) with hosting
    forced: a mixed OO_pqc on the hosted route's Gram form (the JAX
    package's form for the (16e,16o) mixed iteration), one descending
    iteration."""
    monkeypatch.setattr(grid_hosted, "_HOSTED_MIN_BYTES", 1)
    pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                  sector=True)
    mol = P.Moldata("H 0 0 0; H 0 0 1.2; H 0 0 2.4; H 0 0 3.6", "sto-3g")
    theta = 0.02 * torch.arange(pqc.theta_shape, dtype=torch.float64)
    oo, es = demo_16e16o.nr_stage(pqc, mol, 4, 4, theta, "mixed",
                                  iterations=2)
    assert oo._core["route"] == "hosted"
    assert oo._core["hosted_form"] == "gram"
    assert oo._core["precision"] == "mixed"
    assert len(es) == 2
    assert "hosted form gram" in capsys.readouterr().out


def test_sector_basis_is_built_on_first_use():
    """The circuit keeps no D-sized host table unless it is asked for one
    (the (16e,16o) demo's guard)."""
    pqc = P.Parameterized_circuit(3, (2, 1), ansatz="ucc", sector=True)
    assert pqc._sector_basis is None
    np.testing.assert_array_equal(pqc.sector_basis,
                                  fermion.sector_basis(3, (2, 1)))
    assert pqc.sector_basis is pqc._sector_basis
