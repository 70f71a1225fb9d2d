"""``OO_pqc.full_optimization(device_loop=True)`` and the device-decided
line search against the port's host loop and the JAX package, on the
CPU.

Pins (tests/test_oo_pqc.py:206-251's, at least as tight): the (2e,2o)
np_fabric run, freeze_active, in the full space and on the sector grid,
with the eigh and the iterative Newton solve: the same iteration count
as the host loop, energies within 1e-11, theta, kappa, the OAO matrices
and the lowest eigenvalues within 1e-9, the same monitor records, the
final OAO matrix left in ``oao_mo_coeff``, CASSCF within 1e-8, and the
JAX package's device loop within 1e-10 (energies) and 1e-9; a (4e,4o)
sector run of 4 iterations at conv_tol=0 against the host loop; the
staged refusal (ValueError at D >= 2^19, ``_STAGED_MIN_D`` lowered as
the JAX test lowers its threshold) and the forced streamed route's.
In ``precision="mixed"`` (ROADMAP queue 1 item 11), 6 iterations at
conv_tol=0 at (2e,2o) in the full space and on the sector and on the
(4e,4o) sector: the port's device loop against the JAX package's mixed
device loop, 1e-6 Ha at iteration 1 and 1e-5 Ha after (the f32 noise of
a mixed trajectory), and against the port's mixed host loop, 1e-11 Ha.
The pieces: ``backtracking_batched`` equals ``backtracking_pure`` lane
by lane, exhausted searches included, in one round and in rounds;
batched ``eigh_direction`` equals the per-lane solves to 1e-12;
``newton_dir_iterative(sync_free=True)`` equals the host form on a
separated spectrum and across a Lanczos breakdown.
"""

import numpy as np
import pytest
import torch

import auto_oo_tpu as J
from auto_oo_tpu.models import OO_pqc as JOO
from auto_oo_tpu.models import Parameterized_circuit as JPC
import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.models import oo_pqc as poo
from auto_oo_tpu_torch.ops import grid, linalg
from auto_oo_tpu_torch.utils import newton_raphson as nr
from auto_oo_tpu_torch.utils.observe import Monitor

GEO = J.get_formal_geo(140, 80)
E_CASSCF = -92.74923230445957


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's default device is the card; these CPU tests ask for the
    CPU, and restore the default after the module."""
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


@pytest.fixture(scope="module")
def mol():
    return P.Moldata(GEO, "sto-3g")


@pytest.fixture(scope="module")
def jax_device_run():
    """The JAX package's device loop at (2e,2o), f64, eigh."""
    pqc = JPC(2, 2, ansatz="np_fabric", n_layers=1)
    oo = JOO(pqc, J.Moldata(GEO, "sto-3g"), 2, 2, freeze_active=True,
             newton_method="eigh")
    return oo.full_optimization(pqc.init_zeros(), device_loop=True)


def _runs(mol, ncas, kw, method, pqc=None, **opt):
    pqc = pqc or P.Parameterized_circuit(ncas, ncas, **kw)
    out = []
    for device_loop in (False, True):
        oo = P.OO_pqc(pqc, mol, ncas, ncas, freeze_active=True,
                      newton_method=method)
        mon = Monitor()
        res = oo.full_optimization(pqc.init_zeros(), monitor=mon,
                                   device_loop=device_loop, **opt)
        out.append((oo, res, mon))
    return out


def _held(host, dev, e_tol=1e-11):
    (e_h, th_h, k_h, oao_h, eig_h), (e_d, th_d, k_d, oao_d, eig_d) = host, dev
    assert len(e_d) == len(e_h)
    np.testing.assert_allclose(e_d, e_h, rtol=0, atol=e_tol)
    np.testing.assert_allclose(eig_d, eig_h, rtol=0, atol=1e-9)
    for seq_d, seq_h in ((th_d, th_h), (k_d, k_h), (oao_d, oao_h)):
        for a, b in zip(seq_d, seq_h):
            assert float((torch.as_tensor(np.asarray(a)) - b).abs().max()) \
                < 1e-9


@pytest.mark.parametrize("method", ["eigh", "iterative"])
@pytest.mark.parametrize("sector", [False, True])
def test_device_loop_matches_host_loop(mol, method, sector,
                                       jax_device_run):
    (oo_h, host, mon_h), (oo_d, dev, mon_d) = _runs(
        mol, 2, dict(ansatz="np_fabric", n_layers=1, sector=sector), method)
    _held(host, dev)
    assert [r["iter"] for r in mon_d.records] == \
        [r["iter"] for r in mon_h.records]
    for a, b in zip(mon_d.records, mon_h.records):
        assert abs(a["energy"] - b["energy"]) < 1e-11
        assert abs(a["lowest_hess_eig"] - b["lowest_hess_eig"]) < 1e-9
    assert torch.equal(oo_d.oao_mo_coeff, dev[3][-1])
    assert abs(dev[0][-1] - E_CASSCF) < 1e-8
    # the JAX package's device loop (its solve is eigh here)
    e_j, th_j, k_j, oao_j, eig_j = jax_device_run
    assert len(dev[0]) == len(e_j)
    np.testing.assert_allclose(dev[0], e_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(dev[4], eig_j, rtol=0, atol=1e-9)
    for seq_d, seq_j in ((dev[1], th_j), (dev[2], k_j), (dev[3], oao_j)):
        for a, b in zip(seq_d, seq_j):
            assert np.max(np.abs(a.numpy() - np.asarray(b))) < 1e-9


def test_device_loop_sector_4e4o_fixed_iterations(mol, capsys):
    """conv_tol=0 runs all max_iterations; the verbose lines come after
    the run."""
    pqc_kw = dict(ansatz="np_fabric", n_layers=1, sector=True)
    (_, host, _), (_, dev, _) = _runs(mol, 4, pqc_kw, None,
                                      max_iterations=4, conv_tol=0.0)
    _held(host, dev)
    assert len(dev[0]) == 4
    pqc = P.Parameterized_circuit(4, 4, **pqc_kw)
    P.OO_pqc(pqc, mol, 4, 4, freeze_active=True).full_optimization(
        pqc.init_zeros(), max_iterations=2, device_loop=True, verbose=1)
    out = capsys.readouterr().out
    assert "iter = 001" in out and "iter = 002" in out


def test_callable_ansatz_device_loop_and_batch(mol):
    """A callable ansatz (a real one wrapping the (2e,2o) np_fabric
    program) takes the lane axis through its per-lane torch.func sweeps:
    the device loop equals the host loop, and a GeometryBatch step the
    sequential one (1e-12)."""
    from auto_oo_tpu_torch.parallel import GeometryBatch

    base = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)
    program = base.program

    def ansatz(theta):
        return program.apply(base._expand_theta(theta))

    pqc = P.Parameterized_circuit(2, 2, ansatz=ansatz,
                                  theta_shape=base.theta_shape)
    (_, host, _), (_, dev, _) = _runs(mol, 2, None, None, pqc=pqc)
    _held(host, dev)
    assert abs(dev[0][-1] - E_CASSCF) < 1e-8
    batch = GeometryBatch([mol, P.Moldata(J.get_formal_geo(135, 85),
                                          "sto-3g")], 2, 2, pqc)
    th0 = pqc.init_zeros() + 0.05
    oaos = torch.stack([oo.oao_mo_coeff for oo in batch.oo_list])
    nth, _, noao, es, _ = batch.newton_steps(th0, oaos)
    for i, oo in enumerate(batch.oo_list):
        ref = oo._nr_iteration(th0, oo.oao_mo_coeff, 1e-4, 0.5, 1e-6, 1.1,
                               1e-6)
        assert abs(float(ref[3] - es[i])) < 1e-12
        assert float((ref[0] - nth[i]).abs().max()) < 1e-12
        assert float((ref[2] - noao[i]).abs().max()) < 1e-12


@pytest.mark.parametrize("ncas,sector", [(2, False), (2, True),
                                         (4, True)])
def test_device_loop_mixed_precision(mol, ncas, sector):
    """full_optimization(device_loop=True, precision="mixed"): 6
    iterations against the JAX package's mixed device loop (iteration 1
    1e-6 Ha, then 1e-5 Ha) and against the port's mixed host loop."""
    kw = dict(ansatz="np_fabric", n_layers=1, sector=sector)
    jpqc = JPC(ncas, ncas, **kw)
    joo = JOO(jpqc, J.Moldata(GEO, "sto-3g"), ncas, ncas,
              freeze_active=True, precision="mixed")
    e_jax = joo.full_optimization(jpqc.init_zeros(), max_iterations=6,
                                  conv_tol=0.0, device_loop=True)[0]
    pqc = P.Parameterized_circuit(ncas, ncas, **kw)
    runs = []
    for device_loop in (False, True):
        oo = P.OO_pqc(pqc, mol, ncas, ncas, freeze_active=True,
                      precision="mixed")
        runs.append(oo.full_optimization(pqc.init_zeros(), max_iterations=6,
                                         conv_tol=0.0,
                                         device_loop=device_loop)[0])
    host, dev = runs
    assert len(dev) == len(e_jax) == 6
    assert abs(dev[0] - float(e_jax[0])) < 1e-6
    np.testing.assert_allclose(dev[1:], np.asarray(e_jax[1:], dtype=float),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(dev, host, rtol=0, atol=1e-11)


def test_device_loop_refusals(mol, monkeypatch):
    """D >= 2^19 raises the staged ValueError (the threshold lowered, as
    tests/test_oo_pqc.py:243-251 does); a forced streamed route raises
    too.  Neither falls back to the host loop."""
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1,
                                  sector=True)
    oo = P.OO_pqc(pqc, mol, 2, 2, freeze_active=True)
    monkeypatch.setattr(poo, "_STAGED_MIN_D", 1)
    with pytest.raises(ValueError, match="staged"):
        oo.full_optimization(pqc.init_zeros(), device_loop=True)
    monkeypatch.undo()
    streamed = P.OO_pqc(pqc, mol, 2, 2, freeze_active=True,
                        stream_plan=grid.StreamPlan(1, 1, None))
    assert streamed._core["route"] == "streamed"
    with pytest.raises(ValueError, match="streamed"):
        streamed.full_optimization(pqc.init_zeros(), device_loop=True)


@pytest.mark.parametrize("rounds", [None, (1, 19), (3, 5, 12)])
def test_backtracking_batched_equals_host_search(rounds):
    """Each lane of the device-decided search takes backtracking_pure's
    step and energy: quadratics along dp whose first accepted trial is
    t = 1, a halving, or none (an ascent direction: t = 0, e0)."""
    rng = np.random.default_rng(5)
    n, B = 4, 5
    A = torch.tensor(rng.standard_normal((B, n, n)))
    A = A @ A.mT + n * torch.eye(n, dtype=torch.float64)
    x0 = torch.tensor(rng.standard_normal((B, n)))

    def f(lane, x):
        return 0.5 * x @ A[lane] @ x + 3.0

    grad = (A @ x0[..., None])[..., 0]
    dp = -torch.linalg.solve(A, grad[..., None])[..., 0]
    dp[1] *= 7.0      # overshoots: accepted after halvings
    dp[2] *= -1.0     # ascent: exhausted
    dp[3] *= 2.3
    e0 = torch.stack([f(b, x0[b]) for b in range(B)])

    def energies(lanes, trials):
        return torch.stack([f(int(b), x) for b, x in zip(lanes, trials)]), \
            trials.sum(-1, keepdim=True)

    new, t, e, ok, aux = nr.backtracking_batched(energies, x0, dp, grad, e0,
                                                 rounds=rounds)
    for b in range(B):
        ref_x, ref_t, ref_e = nr.backtracking_pure(
            lambda x, b=b: f(b, x), x0[b], dp[b], grad[b], e0=e0[b])
        assert float(t[b]) == ref_t and float(e[b]) == ref_e
        assert torch.equal(new[b], ref_x)
        assert bool(ok[b]) == (ref_t != 0.0)
        assert float(aux[b, 0]) == (float(ref_x.sum()) if ref_t else 0.0)
    assert float(t[2]) == 0.0 and 0.0 < float(t[1]) < 1.0
    assert float(t[0]) == 1.0


def test_eigh_direction_batched_equals_per_lane():
    rng = np.random.default_rng(8)
    H = torch.tensor(rng.standard_normal((6, 9, 9)))
    H = H + H.mT
    g = torch.tensor(rng.standard_normal((6, 9)))
    dp, low = linalg.eigh_direction(g, H)
    for b in range(6):
        dp1, low1 = linalg.eigh_direction(g[b], H[b])
        assert float((dp[b] - dp1).abs().max()) < 1e-12
        assert abs(float(low[b] - low1)) < 1e-12


@pytest.mark.parametrize("case", ["separated", "breakdown"])
def test_iterative_sync_free_equals_host_form(case):
    """The sync-free iterative solve equals the host form: on a separated
    spectrum to rounding, and where the Lanczos start lies in a small
    invariant subspace (a breakdown after two steps), whose parked T
    still gives the lowest eigenvalue."""
    rng = np.random.default_rng(11)
    n = 12
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    w = (np.linspace(-0.7, 3.0, n) if case == "separated"
         else np.repeat([-0.4, 1.5, 2.5], 4))
    H = torch.tensor(Q @ np.diag(w) @ Q.T)
    assert abs(float(linalg.lanczos_lowest(H)) - w.min()) < 1e-10
    g = torch.tensor(rng.standard_normal(n))
    dp_h, l_h = linalg.newton_dir_iterative(g, H)
    dp_f, l_f = linalg.newton_dir_iterative(g, H, sync_free=True)
    assert float((dp_h - dp_f).abs().max()) < 1e-10
    assert abs(float(l_h - l_f)) < 1e-12
