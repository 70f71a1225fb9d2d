"""Callable (real or complex) ansatze in the port against the JAX package.

Mirrors tests/test_custom_complex.py.  The same callables are built in
both packages: a real one that wraps the (4e,4o) kupccd gate program's
``apply``, and the JAX test's complex (2e,2o) ansatz (the UCCD rotation
times an occupation-dependent phase).  The port's circuit takes its J,
circuit-Hessian term, J v and VJP rows from ``torch.func`` over the
callable (simulator/custom.py), which pins that the port's own
``GateProgram.apply`` runs under ``jacfwd`` and ``jvp``.  Held to the JAX
package from seeded numpy inputs: ``grad_hess`` at two points each (e0
and gradient 1e-11, Hessian 1e-9), ``energy_and_gradient`` and three
``gradient_optimization`` steps with an orbital relaxation (1e-10), the
orbital optimization at a complex state's RDMs (1e-10), three NR
iterations (1e-10), ``precision="mixed"`` (e0 and gradient 1e-11, the
Hessian 1e-5 relative, with ``gram_last``'s complex64 pieces summed in
complex128); the port's complex (2e,2o) ``full_optimization``
reaches CASSCF within 1e-7, the JAX test's bound (the JAX side of that
run is marked slow in its own suite and not run here).  The constructor
refuses what the JAX package refuses, with its ValueErrors.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.linalg import expm

import auto_oo_tpu as J
from auto_oo_tpu.models import OO_pqc as JOO
from auto_oo_tpu.models import Parameterized_circuit as JPC
import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
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
E_CASSCF_2E2O = -92.74923230445957


def _occupation_of_mode0(ncas):
    nm = 2 * ncas
    idx = np.arange(1 << nm)
    return ((idx >> (nm - 1)) & 1).astype(np.float64)


def _callables(kind):
    """(ncas, nelecas, JAX callable, port callable, n_params)."""
    if kind == "complex_2e2o":
        jprog = JPC(2, 2, ansatz="ucc").program
        pprog = P.Parameterized_circuit(2, 2, ansatz="ucc").program
        nvec = _occupation_of_mode0(2)
        jn, pn = jnp.asarray(nvec), torch.as_tensor(nvec)

        def jfn(theta):
            psi = jprog.apply(theta[:1])
            return psi.astype(jnp.complex128) * jnp.exp(1j * theta[1] * jn)

        def pfn(theta):
            psi = pprog.apply(theta[:1])
            return psi.to(torch.complex128) * torch.exp(1j * theta[1] * pn)
        return 2, 2, jfn, pfn, 2
    jprog = JPC(4, 4, ansatz="kupccd", k=1).program
    pprog = P.Parameterized_circuit(4, 4, ansatz="kupccd", k=1).program
    return 4, 4, jprog.apply, pprog.apply, jprog.n_params


@pytest.fixture(scope="module")
def problems():
    cache = {}

    def get(kind):
        if kind not in cache:
            ncas, ne, jfn, pfn, n = _callables(kind)
            jpc = JPC(ncas, ne, ansatz=jfn, theta_shape=n)
            ppc = P.Parameterized_circuit(ncas, ne, ansatz=pfn,
                                          theta_shape=n)
            cache[kind] = (ncas, ne, jpc, ppc, J.Moldata(GEO, "sto-3g"),
                           P.Moldata(GEO, "sto-3g"))
        return cache[kind]
    return get


def _oo_pair(problems, kind, seed, freeze_active=True):
    """JAX and port OO_pqc on the callable circuit from one rotated
    OAO-MO matrix; returns (jo, po)."""
    ncas, ne, jpc, ppc, mj, mp = problems(kind)
    jo = JOO(jpc, mj, ncas, ne, freeze_active=freeze_active)
    rng = np.random.default_rng(seed)
    M = 0.05 * rng.standard_normal((jo.nao, jo.nao))
    oao = np.asarray(jo.oao_mo_coeff) @ expm(M - M.T)
    jo.oao_mo_coeff = jnp.asarray(oao)
    po = P.OO_pqc(ppc, mp, ncas, ne, freeze_active=freeze_active,
                  oao_mo_coeff=from_jax(oao))
    return jo, po


KINDS = ["real_4e4o", "complex_2e2o"]


@pytest.mark.parametrize("kind", KINDS)
def test_callable_state_and_rdms(problems, kind):
    """The callable's state keeps its dtype; its restricted and
    spin-resolved RDMs equal the JAX package's to 1e-13."""
    ncas, ne, jpc, ppc, _, _ = problems(kind)
    theta = 0.3 * np.random.default_rng(1).standard_normal(
        ppc.theta_shape)
    psi = ppc.state(theta)
    assert psi.dtype == (torch.complex128 if kind.startswith("complex")
                         else torch.float64)
    np.testing.assert_allclose(psi.numpy(),
                               np.asarray(jpc.state(jnp.asarray(theta))),
                               rtol=0, atol=1e-13)
    for restricted in (True, False):
        gj, Gj = jpc.get_rdms(jnp.asarray(theta), restricted=restricted)
        gp, Gp = ppc.get_rdms(theta, restricted=restricted)
        assert gp.dtype == Gp.dtype == torch.float64
        np.testing.assert_allclose(gp.numpy(), np.asarray(gj), rtol=0,
                                   atol=1e-13)
        np.testing.assert_allclose(Gp.numpy(), np.asarray(Gj), rtol=0,
                                   atol=1e-13)
    assert ppc.draw_circuit(theta) == "<custom state function>"


@pytest.mark.parametrize("kind,seed", [(k, s) for k in KINDS
                                       for s in (0, 1)])
def test_callable_grad_hess_matches_jax(problems, kind, seed):
    """grad_hess of the callable circuit at a seeded theta and a rotated
    OAO matrix: e0 and the gradient within 1e-11, the Hessian within
    1e-9 of the JAX core's jacfwd route."""
    jo, po = _oo_pair(problems, kind, seed)
    assert po._core["route"] == "flat"
    theta = 0.4 * np.random.default_rng(10 + seed).standard_normal(
        po._nt)
    e_j, g_j, h_j = jo._grad_hess_jit(jnp.asarray(theta), jo.oao_mo_coeff)
    e_p, g_p, h_p = po._grad_hess(theta)
    assert abs(float(e_p) - float(e_j)) < 1e-11
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_j), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("kind", KINDS)
def test_callable_mixed_precision_matches_jax(problems, kind):
    """precision="mixed" with a callable: the Hessian blocks on the
    callable at f32 theta, complex128 states lowered to complex64 as the
    JAX package's _lowp does; e0 and the gradient (f64) within 1e-11 of
    the JAX mixed core, the Hessian within 1e-5 relative (Frobenius) of
    it and of the port's f64 Hessian."""
    ncas, ne, jpc, ppc, mj, mp = problems(kind)
    jo = JOO(jpc, mj, ncas, ne, freeze_active=True, precision="mixed")
    po = P.OO_pqc(ppc, mp, ncas, ne, freeze_active=True, precision="mixed")
    po64 = P.OO_pqc(ppc, mp, ncas, ne, freeze_active=True)
    theta = 0.3 * np.random.default_rng(0).standard_normal(po._nt)
    e_j, g_j, h_j = jo._grad_hess_jit(jnp.asarray(theta), jo.oao_mo_coeff)
    e_p, g_p, h_p = po._grad_hess(theta)
    h_64 = po64._grad_hess(theta)[2]
    assert abs(float(e_p) - float(e_j)) < 1e-11
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=0,
                               atol=1e-11)
    for ref in (np.asarray(h_j), h_64.numpy()):
        assert (np.linalg.norm(h_p.numpy() - ref)
                / np.linalg.norm(ref)) < 1e-5


def test_gram_last_complex_pieces():
    """gram_last on complex64 operands sums its pieces in complex128:
    within 1e-6 relative of the complex128 product (one matmul)."""
    from auto_oo_tpu_torch.ops.linalg import gram_last

    rng = np.random.default_rng(1)
    A = torch.as_tensor(rng.standard_normal((5, 9000))
                        + 1j * rng.standard_normal((5, 9000)))
    B = torch.as_tensor(rng.standard_normal((4, 9000))
                        + 1j * rng.standard_normal((4, 9000)))
    ref = gram_last(A.conj(), B)
    torch.testing.assert_close(ref, A.conj() @ B.T, rtol=0, atol=1e-12)
    low = gram_last(A.conj().to(torch.complex64), B.to(torch.complex64))
    assert low.dtype == torch.complex128
    assert float((low - ref).abs().max() / ref.abs().max()) < 1e-6
    vec = gram_last(A.to(torch.complex64), B[0].conj().to(torch.complex64))
    assert vec.shape == (5,) and vec.dtype == torch.complex128


@pytest.mark.parametrize("kind", KINDS)
def test_callable_sweeps_agree(problems, kind):
    """The callable sweeps' pair forms against their batched forms: J v
    equals J @ v, and the pair row with a = 0 equals the Hessian term of
    <b, psi> times v plus nothing, with b = 0 the adjoint gradient."""
    _, _, _, ppc, _, _ = problems(kind)
    rng = np.random.default_rng(5)
    n = ppc.theta_shape
    theta = torch.as_tensor(0.3 * rng.standard_normal(n))
    v = torch.as_tensor(rng.standard_normal(n))
    psi, Jm = ppc._state_and_jacobian_grid(theta)
    w = torch.as_tensor(rng.standard_normal(psi.shape[0])).to(psi.dtype)
    psi2, Jv = ppc._pair_state_grid(theta, v)
    torch.testing.assert_close(psi2, psi, rtol=0, atol=1e-14)
    torch.testing.assert_close(Jv, v.to(Jm.dtype) @ Jm, rtol=0, atol=1e-13)
    H = ppc._state_hessian_dot_grid(theta, w, psi, Jm)
    row = ppc._pair_row_grid(theta, v, torch.zeros_like(w), w)
    torch.testing.assert_close(row, H @ v, rtol=0, atol=1e-12)
    grad = ppc._pair_row_grid(theta, torch.zeros_like(v), w,
                              torch.zeros_like(w))
    torch.testing.assert_close(grad, (Jm.conj() @ w).real, rtol=0,
                               atol=1e-13)


@pytest.mark.parametrize("kind", KINDS)
def test_callable_gradient_pipeline_matches_jax(problems, kind):
    """energy_and_gradient at a seeded theta, then three Adam steps with
    an orbital relaxation after the second: every value within 1e-10 of
    the JAX package's."""
    jo, po = _oo_pair(problems, kind, 2)
    theta = 0.2 * np.random.default_rng(3).standard_normal(po._nt)
    e_j, g_j, (g1_j, G2_j) = jo.energy_and_gradient(jnp.asarray(theta))
    e_p, g_p, (g1_p, G2_p) = po.energy_and_gradient(theta)
    assert abs(float(e_p) - float(e_j)) < 1e-10
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(G2_p.numpy(), np.asarray(G2_j), rtol=0,
                               atol=1e-10)
    kw = dict(max_iterations=3, learning_rate=0.05, orbital_every=2,
              conv_tol=0, orbital_kwargs=dict(max_iterations=3))
    el_j, th_j = jo.gradient_optimization(jnp.asarray(theta), **kw)
    el_p, th_p = po.gradient_optimization(theta, **kw)
    np.testing.assert_allclose(el_p, el_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(th_p.numpy(), np.asarray(th_j), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(po.oao_mo_coeff.numpy(),
                               np.asarray(jo.oao_mo_coeff), rtol=0,
                               atol=1e-10)


def test_complex_rdms_orbital_optimization_matches_jax(problems):
    """The orbital loop at the RDMs of a complex state (real float64 by
    construction) follows the JAX package's to 1e-10."""
    jo, po = _oo_pair(problems, "complex_2e2o", 4)
    theta = np.array([0.3, 0.7])
    g1, G2 = jo.pqc.get_rdms(jnp.asarray(theta))
    el_j = jo.orbital_optimization(g1, G2, max_iterations=4)
    el_p = po.orbital_optimization(*po.pqc.get_rdms(theta),
                                   max_iterations=4)
    np.testing.assert_allclose(el_p, el_j, rtol=0, atol=1e-10)


@pytest.mark.parametrize("kind", KINDS)
def test_callable_nr_trajectory_matches_jax(problems, kind):
    """Three damped-Newton iterations from a seeded theta: energies
    within 1e-10 of the JAX package's and the lowest Hessian eigenvalues
    within 1e-8."""
    jo, po = _oo_pair(problems, kind, 6)
    theta = 0.1 * np.random.default_rng(7).standard_normal(po._nt)
    el_j, _, _, _, eig_j = jo.full_optimization(jnp.asarray(theta),
                                                max_iterations=3)
    el_p, _, _, _, eig_p = po.full_optimization(theta, max_iterations=3)
    np.testing.assert_allclose(el_p, el_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(eig_p, eig_j, rtol=0, atol=1e-8)


def test_complex_custom_ansatz_reaches_casscf(problems):
    """The complex (2e,2o) ansatz optimized end to end by the port
    reaches the CASSCF energy within 1e-7 (tests/test_custom_complex.py's
    bound), and its gradient and circuit Hessian at a complex point equal
    autograd through the energy to 1e-9."""
    ncas, ne, _, ppc, _, mp = problems("complex_2e2o")
    oo = P.OO_pqc(ppc, mp, ncas, ne)
    energy_l, *_ = oo.full_optimization(ppc.init_zeros(), conv_tol=1e-12)
    assert abs(energy_l[-1] - E_CASSCF_2E2O) < 1e-7
    oo2 = P.OO_pqc(ppc, mp, ncas, ne)
    theta = torch.tensor([0.2, 0.4], dtype=torch.float64)

    def e_fn(th):
        return oo2.energy_from_parameters(th)
    g_ad = torch.func.grad(e_fn)(theta)
    h_ad = torch.func.hessian(e_fn)(theta)
    torch.testing.assert_close(oo2.circuit_gradient(theta), g_ad, rtol=0,
                               atol=1e-9)
    torch.testing.assert_close(oo2.circuit_circuit_hessian(theta), h_ad,
                               rtol=0, atol=1e-9)


def test_callable_constructor_refusals_match_jax():
    """A callable needs theta_shape (or a .theta_shape attribute) and the
    full space: the same ValueErrors as the JAX package; the attribute
    form works."""
    for pkg in (JPC, P.Parameterized_circuit):
        with pytest.raises(ValueError, match="theta_shape"):
            pkg(2, 2, ansatz=lambda th: th)
        with pytest.raises(ValueError, match="compiled GateProgram"):
            pkg(2, 2, ansatz=lambda th: th, theta_shape=1, sector=True)
        with pytest.raises(ValueError, match="unknown ansatz"):
            pkg(2, 2, ansatz="nope")

    def fn(th):
        return torch.zeros(16, dtype=torch.float64).index_fill(
            0, torch.tensor([3]), 1.0) * torch.cos(th[0])
    fn.theta_shape = (1,)
    pqc = P.Parameterized_circuit(2, 2, ansatz=fn)
    assert pqc.theta_shape == 1 and pqc.program is None
    assert float(pqc.state([0.0])[3]) == 1.0
