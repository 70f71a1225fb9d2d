"""The port's iterative Newton solver, Monitor and checkpoints against the
JAX package, on the CPU.

Pins: newton_dir_iterative's lowest eigenvalue within 1e-9 and its
direction within 1e-7 |dp| of the JAX package's on seeded Hessians at
n = 8, 64 and 130 (indefinite, positive definite, and a nearly singular
one whose Newton-Schulz solve the guard rejects, falling back to eigh:
tests/test_linalg_robust.py:43-83); the Lanczos, Newton-Schulz and power
pieces against the JAX package's; OO_pqc(newton_method="iterative")
against eigh and the JAX package's iterative run; Monitor records equal
the JAX package's for the same run; a checkpoint written by either
package resumes in the other with equal energies to 1e-12.
"""

import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from auto_oo_tpu import Moldata as JMoldata, get_formal_geo
from auto_oo_tpu.models import OO_pqc as JOO
from auto_oo_tpu.models import Parameterized_circuit as JPC
from auto_oo_tpu.ops import linalg as jlinalg
from auto_oo_tpu.utils import checkpoint as jcheckpoint
from auto_oo_tpu.utils import newton_raphson as jnr
from auto_oo_tpu.utils.observe import Monitor as JMonitor
import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.ops import linalg
from auto_oo_tpu_torch.utils import checkpoint, newton_raphson as nr
from auto_oo_tpu_torch.utils.observe import Monitor

GEO = get_formal_geo(140, 80)


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's default device is the card; these CPU tests ask for the
    CPU, and restore the default after the module."""
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


def _hessian(n, kind, seed):
    """Seeded symmetric H = Q diag(w) Q^T: "indefinite" (one negative
    eigenvalue below a separated spectrum), "definite", or "singular"
    (spectrum 1e-4 .. 1, whose 20-step Newton-Schulz inverse does not
    converge)."""
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.randn(n, n))
    if kind == "indefinite":
        w = np.concatenate([[-0.5], np.linspace(0.1, 2.0, n - 1)])
    elif kind == "definite":
        w = np.linspace(0.05, 3.0, n)
    else:
        w = np.logspace(-4, 0, n)
    return Q @ np.diag(w) @ Q.T, rng.randn(n), w


CASES = [(8, "indefinite", None), (8, "definite", None),
         (64, "indefinite", None), (64, "singular", 20),
         (130, "indefinite", None), (130, "definite", None)]


@pytest.mark.parametrize("n,kind,ns_iters", CASES)
def test_newton_dir_iterative_equals_jax(n, kind, ns_iters):
    """(dp, lowest) of the port equal the JAX package's: lowest within
    1e-9, dp within 1e-7 |dp|; the nearly singular case falls back to
    eigh in both (the port counts it) and equals the exact solve."""
    H, g, w = _hessian(n, kind, seed=n + len(kind))
    kw = {} if ns_iters is None else dict(ns_iters=ns_iters, aug=False)
    before = linalg.ITERATIVE_FALLBACKS
    dp, low = linalg.newton_dir_iterative(torch.as_tensor(g),
                                          torch.as_tensor(H), **kw)
    fell_back = linalg.ITERATIVE_FALLBACKS - before
    jdp, jlow = jlinalg.newton_dir_iterative(jnp.asarray(g), jnp.asarray(H),
                                             **kw)
    jdp = np.asarray(jdp)
    assert abs(float(low) - float(jlow)) < 1e-9
    assert abs(float(low) - w[0]) < 1e-9
    assert np.linalg.norm(dp.numpy() - jdp) <= 1e-7 * np.linalg.norm(jdp)
    assert fell_back == (1 if kind == "singular" else 0)
    if kind == "singular":
        exact = -np.linalg.solve(H, g)
        assert np.linalg.norm(dp.numpy() - exact) <= 1e-8 * np.linalg.norm(
            exact)


def test_solver_pieces_equal_jax():
    """lanczos_lowest (n <= k: the whole Krylov space), the Newton-Schulz
    inverse and its residual, and _power_max equal the JAX package's."""
    H, _, w = _hessian(40, "indefinite", seed=1)
    assert abs(float(linalg.lanczos_lowest(torch.as_tensor(H)))
               - float(jlinalg.lanczos_lowest(jnp.asarray(H)))) < 1e-12
    assert abs(float(linalg.lanczos_lowest(torch.as_tensor(H))) - w[0]) \
        < 1e-12
    S, _, _ = _hessian(30, "definite", seed=2)
    X, r = linalg.symmetric_inverse_ns(torch.as_tensor(S), iters=40,
                                       with_residual=True)
    jX, jr = jlinalg.symmetric_inverse_ns(jnp.asarray(S), iters=40,
                                          with_residual=True)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0,
                               atol=1e-12)
    assert float(r) < 1e-12 and abs(float(r) - float(jr)) < 1e-13
    bad, _, _ = _hessian(64, "singular", seed=3)
    assert float(linalg.symmetric_inverse_ns(torch.as_tensor(bad), iters=20,
                                             with_residual=True)[1]) > 1e-2
    assert abs(float(linalg._power_max(torch.as_tensor(S), iters=200))
               - float(jlinalg._power_max(jnp.asarray(S), iters=200))) \
        < 1e-10


def test_expm_small_skew_equals_scipy():
    """``linalg.expm`` of a skew matrix of 1-norm 0.034 (the size of a
    first-iteration (10e,10o) orbital rotation, nao = 13) is within 1e-15
    of scipy's expm; ``torch.linalg.matrix_exp`` of the single matrix
    misses that by two orders and more, which is why ``expm`` sends one
    matrix through it as a stack."""
    import scipy.linalg

    rng = np.random.default_rng(5)
    A = rng.standard_normal((13, 13))
    A = A - A.T
    A *= 0.034 / np.abs(A).sum(axis=0).max()
    ref = scipy.linalg.expm(A)
    assert np.abs(linalg.expm(torch.as_tensor(A)).numpy() - ref).max() \
        < 1e-15
    assert np.abs(torch.linalg.matrix_exp(torch.as_tensor(A)).numpy()
                  - ref).max() > 1e-13


def test_lanczos_breakdown_drops_dead_steps():
    """A Hessian with a null space (nine zero eigenvalues, as the frozen
    (2e,2o) Hessian at init_zeros has): the Krylov space is invariant
    after 43 steps and Lanczos breaks down; the port parks the steps
    after the breakdown above the live block's spectrum (its Gershgorin
    bound) and finds the lowest eigenvalue at every scale
    and under rounding-level perturbations (the JAX package's +1e30
    parking misses it in 67 of 200 such trials on its own Hessian:
    scripts/lanczos_breakdown.py)."""
    rng = np.random.default_rng(12)
    Q, _ = np.linalg.qr(rng.standard_normal((52, 52)))
    w = np.concatenate([[-4e-3], np.zeros(9), np.linspace(0.01, 50.0, 42)])
    H = Q @ np.diag(w) @ Q.T
    for trial in range(12):
        s = 10 ** rng.uniform(0, 2)
        E = rng.standard_normal(H.shape) * 1e-15 * np.abs(H).max()
        Hp = (H + 0.5 * (E + E.T)) * s
        low = float(linalg.lanczos_lowest(torch.as_tensor(Hp))) / s
        assert abs(low - np.linalg.eigvalsh(Hp)[0] / s) < 1e-10, trial


@pytest.mark.parametrize("method", [None, "eigh", "iterative"])
def test_newton_step_methods_equal_jax(method):
    """newton_step_pure and damped_newton_step_pure take method=; each
    method equals the JAX package's (None is eigh on the CPU in both);
    an unknown method is refused."""
    H, g, _ = _hessian(12, "indefinite", seed=4)
    dp, low = nr.newton_step_pure(torch.as_tensor(g), torch.as_tensor(H),
                                  method=method)
    jdp, jlow = jnr.newton_step_pure(jnp.asarray(g), jnp.asarray(H),
                                     method=method)
    np.testing.assert_allclose(dp.numpy(), np.asarray(jdp), rtol=0,
                               atol=1e-10)
    assert abs(float(low) - float(jlow)) < 1e-10

    def f(x):
        return 0.5 * x @ (torch.as_tensor(H) @ x) + torch.as_tensor(g) @ x

    x0 = torch.zeros(12, dtype=torch.float64)
    newp, _, t, e = nr.damped_newton_step_pure(
        f, x0, torch.as_tensor(g), torch.as_tensor(H), method=method)
    assert t == 1.0 and e < 0.0
    with pytest.raises(ValueError, match="method"):
        nr.newton_step_pure(torch.as_tensor(g), torch.as_tensor(H),
                            method="lu")


def test_oo_pqc_iterative_equals_eigh_and_jax():
    """OO_pqc(newton_method="iterative") on (2e,2o) np_fabric L=1 in the
    full space: the trajectory equals eigh's and the JAX package's
    iterative one to 1e-10, hess_eig to 1e-9; an unknown method is a
    ValueError."""
    mol = P.Moldata(GEO, "sto-3g")
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)
    runs = {}
    for method in ("eigh", "iterative"):
        oo = P.OO_pqc(pqc, mol, 2, 2, freeze_active=True,
                      newton_method=method)
        el, *_, eig = oo.full_optimization(pqc.init_zeros(),
                                           max_iterations=10)
        runs[method] = (np.array(el), np.array(eig))
    jpqc = JPC(2, 2, ansatz="np_fabric", n_layers=1)
    jel, *_, jeig = JOO(jpqc, JMoldata(GEO, "sto-3g"), 2, 2,
                        freeze_active=True,
                        newton_method="iterative").full_optimization(
        jpqc.init_zeros(), max_iterations=10)
    el, eig = runs["iterative"]
    assert len(el) == len(runs["eigh"][0]) == len(jel)
    np.testing.assert_allclose(el, runs["eigh"][0], rtol=0, atol=1e-10)
    np.testing.assert_allclose(el, jel, rtol=0, atol=1e-10)
    np.testing.assert_allclose(eig, jeig, rtol=0, atol=1e-9)
    np.testing.assert_allclose(eig, runs["eigh"][1], rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match="newton_method"):
        P.OO_pqc(pqc, mol, 2, 2, newton_method="lu")


def test_monitor_records_equal_jax(tmp_path):
    """full_optimization(monitor=) records equal the JAX package's for
    the same run (every key but the wall time, energies to 1e-10; the
    port's records add the timestamps ``t_ns`` and ``step_s``); the
    JSONL sink holds the same records."""
    path = tmp_path / "run.jsonl"
    mon = Monitor(jsonl_path=str(path), label="port")
    mol = P.Moldata(GEO, "sto-3g")
    pqc = P.Parameterized_circuit(2, 2, ansatz="ucc")
    P.OO_pqc(pqc, mol, 2, 2).full_optimization(pqc.init_zeros(),
                                              monitor=mon)
    mon.close()
    jmon = JMonitor(label="port")
    jpqc = JPC(2, 2, ansatz="ucc")
    JOO(jpqc, JMoldata(GEO, "sto-3g"), 2, 2).full_optimization(
        jpqc.init_zeros(), monitor=jmon)
    assert len(mon.records) == len(jmon.records) > 2
    for rec, jrec in zip(mon.records, jmon.records):
        assert set(rec) - {"t_ns", "step_s"} == set(jrec)
        assert rec["t_ns"] > 0 and rec["step_s"] > 0.0
        assert rec["iter"] == jrec["iter"] and rec["label"] == jrec["label"]
        for k in ("energy", "lowest_hess_eig"):
            assert abs(rec[k] - jrec[k]) < 1e-10
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert lines == mon.records
    np.testing.assert_allclose(mon.energies(), jmon.energies(), rtol=0,
                               atol=1e-10)


def test_monitor_stdout_and_metrics(capsys):
    mon = Monitor(stdout=True)
    rec = mon.log(3, torch.tensor(-1.5, dtype=torch.float64),
                  t=torch.tensor(0.5), note="x")
    assert rec["iter"] == 3 and rec["energy"] == -1.5 and rec["t"] == 0.5
    assert rec["note"] == "x"
    assert "iter=3 energy=-1.5" in capsys.readouterr().out


@pytest.fixture(scope="module")
def spin_problem():
    """(2e,2o) ucc at a rotated OAO-MO matrix in both packages."""
    jmol = JMoldata(GEO, "sto-3g")
    mol = P.Moldata(GEO, "sto-3g")
    jpqc, pqc = JPC(2, 2, ansatz="ucc"), P.Parameterized_circuit(
        2, 2, ansatz="ucc")
    joo, oo = JOO(jpqc, jmol, 2, 2), P.OO_pqc(pqc, mol, 2, 2)
    jel, jthl, _, jol, _ = joo.full_optimization(jpqc.init_zeros(),
                                                 max_iterations=2)
    return joo, oo, np.array(jthl[-1]), np.array(jol[-1])


def test_checkpoint_jax_to_port(spin_problem, tmp_path):
    """A checkpoint saved by the JAX package (version 2, with its spec
    header) resumes in the port: theta and oao_mo_coeff land on the
    OO_pqc's device, and the port's energy there equals the JAX
    package's to 1e-12."""
    joo, oo, theta, oao = spin_problem
    path = tmp_path / "jax.npz"
    jcheckpoint.save_state(path, theta, oao, energy=-1.0, oo_pqc=joo,
                           extra={"trace": np.arange(3.0)})
    th = checkpoint.resume(oo, path)
    assert th.device == oo.device and oo.oao_mo_coeff.device == oo.device
    assert abs(float(oo.energy_from_parameters(th))
               - float(joo.energy_from_parameters(jnp.asarray(theta)))) \
        < 1e-12
    state = checkpoint.load_state(path)
    assert state["spec"]["ncas"] == "2" and state["spec"]["ansatz"] == "ucc"
    np.testing.assert_array_equal(state["extra"]["trace"], np.arange(3.0))
    assert float(state["energy"]) == -1.0


def test_checkpoint_port_to_jax(spin_problem, tmp_path):
    """A checkpoint saved by the port (tensors, spec from the OO_pqc)
    resumes in the JAX package with equal energies to 1e-12."""
    joo, oo, theta, oao = spin_problem
    path = tmp_path / "port.npz"
    checkpoint.save_state(path, torch.as_tensor(theta),
                          torch.as_tensor(oao), oo_pqc=oo)
    jth = jcheckpoint.resume(joo, path)
    oo.oao_mo_coeff = torch.as_tensor(oao)
    assert abs(float(joo.energy_from_parameters(jth))
               - float(oo.energy_from_parameters(torch.as_tensor(theta)))) \
        < 1e-12
    assert jcheckpoint.load_state(path)["spec"] == \
        checkpoint.load_state(path)["spec"]


def test_checkpoint_spec_checks(spin_problem, tmp_path):
    """A mismatched spec header raises (or warns with strict=False); a
    newer version is refused."""
    _, oo, theta, oao = spin_problem
    path = tmp_path / "other.npz"
    checkpoint.save_state(path, theta, oao, spec=dict(
        ncas=3, nelecas=2, basis="sto-3g", ansatz="ucc", nao=oo.nao))
    with pytest.raises(ValueError, match="ncas"):
        checkpoint.resume(oo, path)
    with pytest.warns(UserWarning, match="ncas"):
        checkpoint.resume(oo, path, strict=False)
    newer = tmp_path / "newer.npz"
    np.savez(newer, version=np.asarray(3), theta=theta, oao_mo_coeff=oao)
    with pytest.raises(ValueError, match="newer"):
        checkpoint.load_state(newer)
