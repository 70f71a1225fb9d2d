"""The port's geometry batch (``parallel.GeometryBatch``, the dp axis) and
``BerryPhaseLoop.run_batched`` against the JAX package, on the CPU.

Pins (tests/test_parallel.py's and tests/test_berry.py's, at least as
tight): on three formaldimine geometries, (2e,2o) in the full space and
a (4e,4o) sector np_fabric (the grid kernels' plain versions, each
launch carrying the geometry axis in its batch), batched energies equal
the JAX GeometryBatch's and the port's sequential energies to 1e-10, and
batched gradients the JAX batch's and the port's sequential gradients to
1e-9; one batched Newton step equals the JAX package's per-geometry
``_nr_iteration_jit`` (energy 1e-12; theta, OAO and lowest eigenvalue
1e-9) and the port's sequential ``_nr_iteration`` (1e-12; eigenvalue
1e-9); ``optimize`` reaches each geometry's CASSCF within 1e-8;
``optimize_device_loop`` equals ``optimize`` over 8 steps and stops
early on its own test; a 5-point loop's ``run_batched`` equals the JAX
one to 1e-10.  The refusals: a ``mesh`` that is not a DeviceMesh
(TypeError; a real mesh runs in tests/test_torch_parallel.py), the
streamed and hosted routes (ValueError).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import auto_oo_tpu as J
from auto_oo_tpu.models import Parameterized_circuit as JPC
from auto_oo_tpu.models.berry import BerryPhaseLoop as JLoop
from auto_oo_tpu.parallel import GeometryBatch as JBatch
import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.ops import fock, grid, grid_hosted, kappa, transforms
from auto_oo_tpu_torch.parallel import GeometryBatch

STEP = (1e-4, 0.5, 1e-6, 1.1, 1e-6)
GEOS = [J.get_formal_geo(a, p) for a, p in [(140, 80), (135, 85),
                                            (130, 90)]]
CASES = {"full_2e2o": (2, dict(ansatz="np_fabric", n_layers=1)),
         "sector_4e4o": (4, dict(ansatz="np_fabric", n_layers=1,
                                 sector=True))}


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's default device is the card; these CPU tests ask for the
    CPU, and restore the default after the module."""
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


@pytest.fixture(scope="module")
def batches():
    """Per case: (JAX batch, port batch, JAX circuit, port circuit)."""
    cache = {}

    def get(case):
        if case not in cache:
            ncas, kw = CASES[case]
            jpqc = JPC(ncas, ncas, **kw)
            ppqc = P.Parameterized_circuit(ncas, ncas, **kw)
            cache[case] = (
                JBatch([J.Moldata(g, "sto-3g") for g in GEOS], ncas, ncas,
                       jpqc),
                GeometryBatch([P.Moldata(g, "sto-3g") for g in GEOS], ncas,
                              ncas, ppqc), jpqc, ppqc)
        return cache[case]
    return get


@pytest.fixture(scope="module")
def pair():
    """The JAX test's two geometries, (2e,2o) full space: (batch,
    circuit)."""
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)
    return GeometryBatch([P.Moldata(g, "sto-3g") for g in GEOS[:2]], 2, 2,
                         pqc), pqc


def _oaos(batch):
    return np.stack([np.asarray(oo.oao_mo_coeff) for oo in batch.oo_list])


@pytest.mark.parametrize("case", list(CASES))
def test_energies_and_gradients(case, batches):
    jb, pb, _, ppqc = batches(case)
    rng = np.random.default_rng(3)
    th = 0.1 * rng.standard_normal((len(GEOS), ppqc.theta_shape))
    ka = 0.01 * rng.standard_normal((len(GEOS), pb.oo0.n_kappa))
    oaos = _oaos(jb)
    assert np.array_equal(oaos, _oaos(pb))
    e = pb.energies(th, ka, oaos)
    assert e.shape == (len(GEOS),)
    ej = np.asarray(jb.energies(jnp.asarray(th), jnp.asarray(ka),
                                jnp.asarray(oaos)))
    np.testing.assert_allclose(e.numpy(), ej, rtol=0, atol=1e-10)
    for i, oo in enumerate(pb.oo_list):
        assert abs(float(e[i]) - float(oo.energy_from_parameters(
            th[i], ka[i]))) < 1e-10
    g_th, g_ka = pb.gradients(th, ka, oaos)
    jg_th, jg_ka = jb.gradients(jnp.asarray(th), jnp.asarray(ka),
                                jnp.asarray(oaos))
    np.testing.assert_allclose(g_th.numpy(), np.asarray(jg_th), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(g_ka.numpy(), np.asarray(jg_ka), rtol=0,
                               atol=1e-9)
    # at kappa = 0 the port's sequential full gradient (grad_hess)
    g0_th, g0_ka = pb.gradients(th, np.zeros_like(ka), oaos)
    for i, oo in enumerate(pb.oo_list):
        full = oo.full_gradient(th[i])
        np.testing.assert_allclose(
            torch.cat([g0_th[i], g0_ka[i]]).numpy(), full.numpy(), rtol=0,
            atol=1e-9)


@pytest.mark.parametrize("case", list(CASES))
def test_newton_steps_match_jax_and_sequential(case, batches, monkeypatch):
    """One batched step equals the JAX package's per-geometry step and
    the port's sequential one; on the sector every gather_two_spin of the
    batched grad_hess carries more than one geometry in its batch."""
    jb, pb, jpqc, ppqc = batches(case)
    batch_dims = []
    plain = grid.gather_two_spin

    def spy(x, *args, **kw):
        batch_dims.append(tuple(x.shape[:-2]))
        return plain(x, *args, **kw)

    monkeypatch.setattr(grid, "gather_two_spin", spy)
    theta0 = ppqc.init_zeros()
    nth, nka, noao, es, lows = pb.newton_steps(theta0, _oaos(pb))
    B = len(GEOS)
    assert nth.shape == (B, ppqc.theta_shape) and es.shape == (B,)
    assert nka.shape == (B, pb.oo0.n_kappa) and lows.shape == (B,)
    if ppqc.sector:
        # H psi of every geometry in one launch, then the lanes' tangent
        # rows, psi's Phi with the transition RDMs, the trial energies
        assert batch_dims[0] == (B,)
        assert all(d and d[0] >= B for d in batch_dims)
    monkeypatch.setattr(grid, "gather_two_spin", plain)
    for i, (joo, poo) in enumerate(zip(jb.oo_list, pb.oo_list)):
        ref = joo._nr_iteration_jit(jpqc.init_zeros(), joo.oao_mo_coeff,
                                    *STEP)
        assert abs(float(ref[3]) - float(es[i])) < 1e-12
        for a, b in ((ref[0], nth[i]), (ref[1], nka[i]), (ref[2], noao[i])):
            assert np.max(np.abs(np.asarray(a) - b.numpy())) < 1e-9
        assert abs(float(ref[4]) - float(lows[i])) < 1e-9
        seq = poo._nr_iteration(theta0, poo.oao_mo_coeff, *STEP)
        assert abs(float(seq[3]) - float(es[i])) < 1e-12
        for a, b in ((seq[0], nth[i]), (seq[1], nka[i]), (seq[2], noao[i])):
            assert float((a - b).abs().max()) < 1e-12
        assert abs(float(seq[4]) - float(lows[i])) < 1e-9


def test_optimize_converges_to_casscf(pair):
    """The batched driver converges every geometry to its own CASSCF
    minimum (tests/test_parallel.py:101-113)."""
    pb, ppqc = pair
    hist, thetas, oaos, lows = pb.optimize(ppqc.init_zeros(), n_steps=10)
    assert len(hist) == 10 and thetas.shape[0] == 2
    for i, g in enumerate(GEOS[:2]):
        mol = P.Moldata(g, "sto-3g")
        mol.run_casscf(2, 2)
        assert abs(float(hist[-1][i]) - mol.casscf.e_tot) < 1e-8


def test_optimize_device_loop_matches_optimize(pair):
    """optimize_device_loop (no host read in a step) equals the per-step
    driver over 8 forced steps, and with conv_tol=1e-10 stops on its own
    all-geometry test before 20 steps (tests/test_parallel.py:115-142)."""
    pb, ppqc = pair
    hist_h, th_h, oao_h, low_h = pb.optimize(ppqc.init_zeros(), n_steps=8)
    hist_d, th_d, oao_d, low_d = pb.optimize_device_loop(
        ppqc.init_zeros(), max_steps=8, conv_tol=0.0)
    assert hist_d.shape == (8, 2)
    np.testing.assert_allclose(hist_d.numpy(),
                               torch.stack(hist_h).numpy(), rtol=0,
                               atol=1e-11)
    for a, b in ((th_d, th_h), (oao_d, oao_h), (low_d, low_h)):
        assert float((a - b).abs().max()) < 1e-9
    hist_c, *_ = pb.optimize_device_loop(ppqc.init_zeros(), max_steps=40,
                                         conv_tol=1e-10)
    assert 3 <= hist_c.shape[0] < 20
    last = hist_c[-1] - hist_c[-2]
    assert float(last.abs().max()) < 1e-10


def _loop_geos(n_points):
    ts = np.linspace(0, 1, n_points)
    return [J.get_formal_geo(130 + 10 * np.cos(2 * np.pi * t + np.pi / 20),
                             89.9 + 10 * np.sin(2 * np.pi * t + np.pi / 20))
            for t in ts]


def test_run_batched_matches_jax():
    """A 5-point (2e,2o) loop, track_steps=4, run_batched in both
    packages: energies and lowest Hessian eigenvalues to 1e-10, the
    overlaps and the Berry phase to 1e-8."""
    geos = _loop_geos(5)
    kw = dict(ansatz="np_fabric", n_layers=1)
    jl = JLoop(geos, "sto-3g", 2, 2, JPC(2, 2, **kw),
               freeze_active=True).run_batched(track_steps=4)
    pl = P.BerryPhaseLoop(geos, "sto-3g", 2, 2,
                          P.Parameterized_circuit(2, 2, **kw),
                          run_casscf=True).run_batched(track_steps=4)
    np.testing.assert_allclose(pl.energy_l, jl.energy_l, rtol=0, atol=1e-10)
    np.testing.assert_allclose(pl.hess_eig_l, jl.hess_eig_l, rtol=0,
                               atol=1e-10)
    assert len(pl.casscf_energy_l) == len(geos)
    np.testing.assert_allclose(pl.overlaps(), jl.overlaps(), rtol=0,
                               atol=1e-8)
    assert abs(pl.berry_phase() - jl.berry_phase()) < 1e-8


def test_orbital_algebra_batched_equals_per_lane():
    """The leading geometry axis of the orbital algebra: the integral
    transforms, the active-space coefficients, the energy from RDMs, the
    Fock gradient and Hessian and kappa's packing, each on a stack of 3
    equal to the per-matrix calls to 1e-12 (random symmetric integrals,
    nao = 7, occ = (0, 1), act = (2, 3, 4))."""
    rng = np.random.default_rng(21)
    occ, act, nao, B = (0, 1), (2, 3, 4), 7, 3

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape))

    h = t(B, nao, nao)
    h = h + h.mT
    g = t(B, nao, nao, nao, nao)
    for perm in ((0, 1, 3, 2, 4), (0, 2, 1, 3, 4), (0, 3, 4, 1, 2)):
        g = g + g.permute(perm)
    mo, nuc = t(B, nao, nao), t(B)
    g1, G2 = t(B, 3, 3), t(B, 3, 3, 3, 3)
    g1 = g1 + g1.mT
    vec = t(B, nao * (nao - 1) // 2)
    h1 = transforms.int1e_transform(h, mo)
    g2 = transforms.int2e_transform(g, mo)
    c = transforms.molecular_hamiltonian_coefficients(nuc, h1, g2, occ, act)
    e = transforms.energy_from_rdms(*c, g1, G2)
    grad = fock.analytic_gradient_from_integrals(h1, g2, g1, G2, occ, act)
    hess = fock.analytic_hessian_from_integrals(h1, g2, g1, G2, occ, act)
    hmat = fock.full_hessian_to_matrix(hess, np.arange(0, 21, 2), nao)
    K = kappa.vector_to_skew_symmetric(vec)
    for b in range(B):
        h1b = transforms.int1e_transform(h[b], mo[b])
        g2b = transforms.int2e_transform(g[b], mo[b])
        cb = transforms.molecular_hamiltonian_coefficients(nuc[b], h1b, g2b,
                                                           occ, act)
        hb = fock.analytic_hessian_from_integrals(h1b, g2b, g1[b], G2[b],
                                                  occ, act)
        pairs = [(h1[b], h1b), (g2[b], g2b), (e[b], transforms.
                  energy_from_rdms(*cb, g1[b], G2[b])),
                 (grad[b], fock.analytic_gradient_from_integrals(
                     h1b, g2b, g1[b], G2[b], occ, act)), (hess[b], hb),
                 (hmat[b], fock.full_hessian_to_matrix(
                     hb, np.arange(0, 21, 2), nao)),
                 (K[b], kappa.vector_to_skew_symmetric(vec[b])),
                 (kappa.skew_symmetric_to_vector(K)[b], vec[b])]
        pairs += list(zip((x[b] for x in c), cb))
        for got, ref in pairs:
            scale = max(1.0, float(ref.abs().max()))
            assert float((got - ref).abs().max()) <= 1e-12 * scale


def test_refusals(monkeypatch):
    """A ``mesh`` must be a torch.distributed DeviceMesh (the dp ranks of
    tests/test_torch_parallel.py); the streamed and the hosted route have
    no geometry batch."""
    mols = [P.Moldata(g, "sto-3g") for g in GEOS[:2]]
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)
    with pytest.raises(TypeError, match="DeviceMesh"):
        GeometryBatch(mols, 2, 2, pqc, mesh=object())
    sector = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1,
                                     sector=True)
    monkeypatch.setattr(grid_hosted, "_HOSTED_MIN_BYTES", 1)
    with pytest.raises(ValueError, match="hosted route"):
        GeometryBatch(mols, 2, 2, sector)
    monkeypatch.undo()
    monkeypatch.setattr(grid, "_PAIR_CHUNK_BYTES", 1)
    with pytest.raises(ValueError, match="streamed route"):
        GeometryBatch(mols, 2, 2, sector)
