"""The port's row-streamed route against the JAX package, on the CPU.

Where one (n^2, D) f64 Phi exceeds its 1 GB block ((14e,14o) on), the
port streams Phi over grid A-rows (ops/grid.py: phi_rows, ham_apply_rows,
rdms_rows, transition_rdms_rows; the pair-streamed ham_apply_chunked and
rdms_chunked beside them).  Here at (4e,4o)-class sizes, the same seeded
inputs go through the JAX package's functions and the port's:

* phi_rows to 1e-13 against _phi_rows_xla and rows of phi_all;
* ham_apply_rows (row chunks 1, 3, Na; pair blocks None, 1, 5) and
  ham_apply_chunked to 1e-12 against ham_apply;
* rdms_rows, rdms_chunked and transition_rdms_rows to 1e-13 against the
  dense Phi-gram formulas;
* the VJPs of phi_all / epq_sum on pair-sliced maps and of phi_rows to
  1e-13 against jax.vjp of the XLA grid ops;
* the public ham_apply / rdms_from_state dispatch with the byte budgets
  patched (tests/test_grid.py's test of the JAX dispatch);
* OO_pqc on the streamed route at (4e,4o) 6-31G (n_kappa > 0) against the
  JAX package's grad_hess_staged: e0 and gradient to 1e-11, the Hessian
  to 1e-9; and 2 NR iterations against its full_optimization to 1e-10.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.linalg import expm

import auto_oo_tpu as J
from auto_oo_tpu.models import OO_pqc as JOO
from auto_oo_tpu.models import Parameterized_circuit as JPC
from auto_oo_tpu.ops import grid as jgrid
from auto_oo_tpu.ops import hamiltonian as jham
from auto_oo_tpu.ops import rdms as jrdms
import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.ops import grid, grid_hosted, hamiltonian, rdms
from auto_oo_tpu_torch.utils.interop import from_jax
from tests.torch_jax_memos import (  # noqa: F401
    fresh_jax_memos, fresh_jax_memos_module)


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's default device is the card; these CPU tests ask for the
    CPU, and restore the default after the module."""
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


def _maps(ncas=4, nelecas=4):
    jm = jgrid.build_grid_maps(ncas, nelecas)
    return jm, from_jax(jm)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _coeffs(ncas, seed):
    """Random symmetric (c1eff, c2) as numpy arrays."""
    rng = np.random.default_rng(seed)
    c1 = rng.standard_normal((ncas, ncas))
    c2 = rng.standard_normal((ncas,) * 4)
    c2 = c2 + c2.transpose(1, 0, 3, 2)
    c1eff = np.array(jham.c1_effective(jnp.asarray(c1 + c1.T),
                                         jnp.asarray(c2)))
    return c1eff, c2


@pytest.mark.parametrize("rows", [(0, 6), (0, 1), (2, 5), (5, 6)])
@pytest.mark.parametrize("ncas,nelecas", [(4, 4), (4, (2, 1))])
def test_phi_rows_matches_xla(ncas, nelecas, rows):
    jm, pm = _maps(ncas, nelecas)
    r0, r1 = min(rows[0], jm.Na - 1), min(rows[1], jm.Na)
    x = _rand((2, jm.dim), 1)
    ref = np.asarray(jgrid._phi_rows_xla(jnp.asarray(x), jm, r0, r1))
    out = grid.phi_rows(torch.from_numpy(x), pm, r0, r1)
    assert out.shape == ref.shape == (2, jm.n2, r1 - r0, jm.Nb)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-13)
    full = np.asarray(jgrid.phi_all(jnp.asarray(x), jm)).reshape(
        2, jm.n2, jm.Na, jm.Nb)[:, :, r0:r1]
    np.testing.assert_allclose(out.numpy(), full, rtol=0, atol=1e-13)


@pytest.mark.parametrize("pair_block", [None, 1, 5])
@pytest.mark.parametrize("row_chunk", [1, 3, 6])
def test_ham_apply_rows_matches_jax(row_chunk, pair_block):
    jm, pm = _maps()
    c1eff, c2 = _coeffs(4, 2)
    x = _rand((3, jm.dim), 3)
    ref = np.asarray(jham.ham_apply(jnp.asarray(c1eff), jnp.asarray(c2),
                                    jnp.asarray(x), 4, maps=jm))
    out = grid.ham_apply_rows(torch.from_numpy(c1eff).reshape(16),
                              torch.from_numpy(c2).reshape(16, 16),
                              torch.from_numpy(x), pm, row_chunk, pair_block)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)
    if (row_chunk, pair_block) != (3, 5):
        return
    # the JAX package's own row-streamed H-apply, same sizes (one case:
    # each shape compiles a scan)
    jout = jgrid.ham_apply_rows(jnp.asarray(c1eff).reshape(16),
                                jnp.asarray(c2).reshape(16, 16),
                                jnp.asarray(x), jm, row_chunk, pair_block)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_ham_apply_chunked_matches_jax(chunk):
    jm, pm = _maps(4, (2, 1))
    c1eff, c2 = _coeffs(4, 4)
    x = _rand((2, jm.dim), 5)
    ref = np.asarray(jham.ham_apply(jnp.asarray(c1eff), jnp.asarray(c2),
                                    jnp.asarray(x), 4, maps=jm))
    out = grid.ham_apply_chunked(torch.from_numpy(c1eff).reshape(16),
                                 torch.from_numpy(c2).reshape(16, 16),
                                 torch.from_numpy(x), pm, chunk)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)


def _dense_rdms(jm, psi):
    """The JAX package's dense Phi-gram RDMs of a grid-ordered state."""
    g, G = jrdms.rdms_from_state(jnp.asarray(psi), 4, maps=jm,
                                 grid_order=True)
    return np.asarray(g), np.asarray(G)


@pytest.mark.parametrize("row_chunk", [1, 3, 6])
def test_rdms_rows_matches_dense(row_chunk):
    jm, pm = _maps()
    psi = _rand(jm.dim, 6)
    psi /= np.linalg.norm(psi)
    g_ref, G_ref = _dense_rdms(jm, psi)
    g, G = grid.rdms_rows(torch.from_numpy(psi), pm, 4, row_chunk)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=0, atol=1e-13)
    np.testing.assert_allclose(G.numpy(), G_ref, rtol=0, atol=1e-13)


@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_rdms_chunked_matches_dense(chunk):
    jm, pm = _maps()
    psi = _rand(jm.dim, 7)
    psi /= np.linalg.norm(psi)
    g_ref, G_ref = _dense_rdms(jm, psi)
    g, G = grid.rdms_chunked(torch.from_numpy(psi), pm, 4, chunk)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=0, atol=1e-13)
    np.testing.assert_allclose(G.numpy(), G_ref, rtol=0, atol=1e-13)


@pytest.mark.parametrize("row_chunk", [1, 4, 6])
def test_transition_rdms_rows_matches_dense(row_chunk):
    """dgamma = (E tpsi).psi + (E psi).tpsi and dcorr = Phi_t Phi^T +
    Phi Phi_t^T from the JAX package's dense Phi, and its own streamed
    rows."""
    jm, pm = _maps()
    psi, tpsi = _rand(jm.dim, 8), _rand(jm.dim, 9)
    phi = np.asarray(jgrid._phi_all_xla(jnp.asarray(psi), jm))
    phit = np.asarray(jgrid._phi_all_xla(jnp.asarray(tpsi), jm))
    dg_ref = phit @ psi + phi @ tpsi
    dc_ref = phit @ phi.T + phi @ phit.T
    dg, dc = grid.transition_rdms_rows(torch.from_numpy(psi),
                                       torch.from_numpy(tpsi), pm, 4,
                                       row_chunk)
    np.testing.assert_allclose(dg.numpy(), dg_ref, rtol=0, atol=1e-13)
    np.testing.assert_allclose(dc.numpy(), dc_ref, rtol=0, atol=1e-13)
    jdg, jdc = jgrid.transition_rdms_rows(jnp.asarray(psi),
                                          jnp.asarray(tpsi), jm, 4,
                                          row_chunk)
    np.testing.assert_allclose(dg.numpy(), np.asarray(jdg), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(dc.numpy(), np.asarray(jdc), rtol=0,
                               atol=1e-13)


def _vjp(fn, base, ct):
    return np.asarray(jax.vjp(fn, jnp.asarray(base))[1](jnp.asarray(ct))[0])


@pytest.mark.parametrize("lo,hi", [(0, 9), (2, 7), (8, 9)])
def test_pair_sliced_vjps_match_jax(lo, hi):
    """phi_all / epq_sum on pair-sliced maps, and phi_rows, backward
    through the transposed maps (E_pq^T = E_qp) against jax.vjp of the
    XLA grid ops on pair_slice maps; batched cotangents."""
    jm, pm = _maps(3, 2)
    sl_j, sl_p = jgrid.pair_slice(jm, lo, hi), grid.pair_slice(pm, lo, hi)
    nk = hi - lo
    x, ct = _rand((2, jm.dim), 10), _rand((2, nk, jm.dim), 11)
    ref = _vjp(lambda v: jgrid._phi_all_xla(v, sl_j), x, ct)
    xt = torch.from_numpy(x).requires_grad_(True)
    (grid.phi_all(xt, sl_p) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), ref, rtol=0, atol=1e-13)

    Y, g = _rand((2, nk, jm.dim), 12), _rand((2, jm.dim), 13)
    ref = _vjp(lambda v: jgrid._epq_sum_xla(v, sl_j), Y, g)
    Yt = torch.from_numpy(Y).requires_grad_(True)
    (grid.epq_sum(Yt, sl_p) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(Yt.grad.numpy(), ref, rtol=0, atol=1e-13)

    r0, r1 = 1, 3
    ct = _rand((2, jm.n2, r1 - r0, jm.Nb), 14)
    ref = _vjp(lambda v: jgrid._phi_rows_xla(v, jm, r0, r1), x, ct)
    xt = torch.from_numpy(x).requires_grad_(True)
    (grid.phi_rows(xt, pm, r0, r1) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), ref, rtol=0, atol=1e-13)


def test_transposed_maps_are_the_adjoint():
    """The transposed maps of a slice hold E_qp for each pair pq of it:
    <E_pq x, y> = <x, E_qp y>, and transposing twice gives the slice's
    own tables back."""
    jm, pm = _maps(4, (2, 1))
    sl = grid.pair_slice(pm, 3, 11)
    tr = sl.transposed()
    x = torch.from_numpy(_rand(jm.dim, 15))
    y = torch.from_numpy(_rand(jm.dim, 16))
    lhs = grid.phi_all(x, sl) @ y
    rhs = grid.phi_all(y, tr) @ x
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=0, atol=1e-13)
    back = tr.transposed()
    for name in ("srcA", "srcB", "sgnA", "sgnB", "tA", "tB"):
        assert torch.equal(getattr(back, name), getattr(sl, name)), name
    assert sl.transposed() is tr


def test_stream_plan_on_the_cpu(monkeypatch):
    """On the CPU the plan takes the JAX package's budgets and cuts Na
    and n2 into equal pieces."""
    _, pm = _maps()
    plan = grid.stream_plan(pm)
    assert plan == (pm.Na, pm.n2, None)
    # a Phi row is n2 * Nb * 8 = 768 bytes, a Y pair D * 8 = 288 bytes
    monkeypatch.setattr(grid, "_PAIR_CHUNK_BYTES", 4 * 768)
    monkeypatch.setattr(grid, "_Y_BUDGET_BYTES", 5 * 7 * 288)
    assert grid.stream_plan(pm)[:2] == (3, 6)
    assert grid.stream_plan(pm, B=2)[:2] == (2, 3)


def test_auto_dispatch_streamed_paths(monkeypatch):
    """Tiny byte budgets take the PUBLIC ham_apply / rdms_from_state
    through the row-streamed functions (one Y block, then blocks of one
    pair) with unchanged results, as tests/test_grid.py pins for the JAX
    package."""
    jm, pm = _maps()
    c1eff, c2 = _coeffs(4, 17)
    x = _rand(jm.dim, 18)
    psi = x / np.linalg.norm(x)
    full = np.asarray(jham.ham_apply(jnp.asarray(c1eff), jnp.asarray(c2),
                                     jnp.asarray(x), 4, maps=jm))
    g_full, G_full = _dense_rdms(jm, psi)
    called = []
    rows_fn = grid.ham_apply_rows
    monkeypatch.setattr(hamiltonian, "ham_apply_rows",
                        lambda *a: called.append(a[4:]) or rows_fn(*a))
    monkeypatch.setattr(grid, "_PAIR_CHUNK_BYTES", 4096)
    for ybudget, blocks in ((1 << 40, 16), (0, 1)):
        monkeypatch.setattr(grid, "_Y_BUDGET_BYTES", ybudget)
        got = hamiltonian.ham_apply(torch.from_numpy(c1eff),
                                    torch.from_numpy(c2),
                                    torch.from_numpy(x), 4, pm)
        np.testing.assert_allclose(got.numpy(), full, rtol=0, atol=1e-12)
        assert called[-1] == (3, blocks)
    g_s, G_s = rdms.rdms_from_state(torch.from_numpy(psi), 4, pm,
                                    grid_order=True)
    np.testing.assert_allclose(g_s.numpy(), g_full, rtol=0, atol=1e-13)
    np.testing.assert_allclose(G_s.numpy(), G_full, rtol=0, atol=1e-13)
    # a plan given by the caller is taken as it is
    got = hamiltonian.ham_apply(torch.from_numpy(c1eff), torch.from_numpy(c2),
                                torch.from_numpy(x), 4, pm,
                                plan=grid.StreamPlan(2, 7, None))
    np.testing.assert_allclose(got.numpy(), full, rtol=0, atol=1e-12)
    assert called[-1] == (2, 7)


GEO = J.get_formal_geo(140, 80)


@pytest.fixture(scope="module")
def problem_631g():
    """(4e,4o) 6-31G np_fabric L=1: the JAX OO_pqc, the port's molecule
    and circuit kwargs, from a rotated OAO-MO matrix."""
    mj = J.Moldata(GEO, "6-31g")
    mp = P.Moldata(GEO, "6-31g")
    jo = JOO(JPC(4, 4, ansatz="np_fabric", n_layers=1, sector=True), mj, 4,
             4, freeze_active=True)
    rng = np.random.default_rng(3)
    A = 0.05 * rng.standard_normal((jo.nao, jo.nao))
    oao = np.asarray(jo.oao_mo_coeff) @ expm(A - A.T)
    jo.oao_mo_coeff = jnp.asarray(oao)
    theta = 0.3 * rng.standard_normal(jo.pqc.theta_shape)
    return jo, mp, oao, theta


def _port(mp, oao, **kw):
    pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                  sector=True)
    return P.OO_pqc(pqc, mp, 4, 4, freeze_active=True,
                    oao_mo_coeff=from_jax(oao), **kw)


@pytest.mark.parametrize("plan", [(1, 5), (4, 16), None])
def test_streamed_grad_hess_matches_jax_staged(problem_631g, monkeypatch,
                                               plan):
    """OO_pqc on the streamed route (a small plan forced, or the route
    rule with the 1 GB block patched down) against the JAX package's
    staged grad_hess: e0 and grad to 1e-11, the Hessian to 1e-9."""
    jo, mp, oao, theta = problem_631g
    if plan is None:
        monkeypatch.setattr(grid, "_PAIR_CHUNK_BYTES", 8)
        po = _port(mp, oao)
        assert po._core["plan"] == grid.stream_plan(po.pqc.sector_maps)
    else:
        po = _port(mp, oao, stream_plan=grid.StreamPlan(*plan, None))
    assert po._core["route"] == "streamed" and po.n_kappa > 0
    e_j, g_j, h_j = jo._core["grad_hess_staged"](
        jnp.asarray(theta), jo.oao_mo_coeff, *jo._mol_args)
    e_p, g_p, h_p = po._grad_hess(from_jax(theta))
    assert abs(float(e_p) - float(e_j)) < 1e-11
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_j), rtol=0,
                               atol=1e-9)
    # the line-search energy streams its RDMs too
    assert abs(float(po.energy_from_parameters(theta)) - float(e_j)) < 1e-11


def test_streamed_trajectory_matches_jax(problem_631g):
    """Two damped-Newton iterations on the streamed route against the JAX
    package's: energies to 1e-10."""
    jo, mp, oao, theta = problem_631g
    po = _port(mp, oao, stream_plan=grid.StreamPlan(2, 3, None))
    el_p, *_ = po.full_optimization(theta, max_iterations=2)
    jo.oao_mo_coeff = jnp.asarray(oao)
    el_j, *_ = jo.full_optimization(jnp.asarray(theta), max_iterations=2)
    jo.oao_mo_coeff = jnp.asarray(oao)
    assert len(el_p) == len(el_j) == 2
    np.testing.assert_allclose(el_p, el_j, rtol=0, atol=1e-10)


def test_hosted_regime_still_raises(monkeypatch):
    """Where one full-Phi pass reaches the JAX package's hosting threshold
    the route is the hosted one, with a plan given or not (a given plan
    sets its row chunk), and its (e0, grad, hess) equal the fused ones."""
    mp = P.Moldata(GEO, "sto-3g")
    pqc = P.Parameterized_circuit(2, 2, ansatz="ucc", sector=True)
    theta = torch.tensor([0.3], dtype=torch.float64)
    fused = P.OO_pqc(pqc, mp, 2, 2)._grad_hess(theta)
    # (2e,2o): one full-Phi pass is n2 * D * 8 = 4 * 4 * 8 bytes
    monkeypatch.setattr(grid_hosted, "_HOSTED_MIN_BYTES", 4 * 4 * 8)
    for kw, rows in (({}, 2), ({"stream_plan": grid.StreamPlan(1, 1, None)},
                               1)):
        oo = P.OO_pqc(pqc, mp, 2, 2, **kw)
        assert oo._core["route"] == "hosted"
        assert oo._core["plan"].row_chunk == rows
        for a, b in zip(fused, oo._grad_hess(theta)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                       atol=1e-11)
