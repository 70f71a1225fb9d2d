"""The port's FLOP count (auto_oo_tpu_torch/utils/flops.py) against the
JAX package's, and against the matmul FLOPs the port runs, on the CPU.

Pins:
* ``update_flops(newton_method="iterative")`` equals the JAX function to
  1e-12 relative on the same shapes, and ``grad_hess_flops`` differs
  from it by the one transition gram per tangent the port does not run
  (2 nt n2^2 D) alone;
* ``nr_iteration_flops`` equals the JAX package's, less that gram, on a
  sector (grid) problem with ``newton_method="iterative"``; on a flat
  problem the
  port's pair count is the JAX program's ``n_real_pairs.sum()`` (the JAX
  count takes its padded tables);
* the eigh term and the None default differ from the JAX count by the
  documented convention alone: 9 n^3 in place of 30 Jacobi sweeps (120
  n^3), and None counted as eigh where the JAX package counts it as the
  iterative solve;
* one count for the fused, staged, streamed and hosted (per-tangent and
  Gram) routes, f64 and mixed, and a GeometryBatch lane of one problem;
* the count of one f64 NR iteration within a factor 2 of the matmul
  FLOPs ``torch.utils.flop_counter.FlopCounterMode`` sees the port run
  (its update's Armijo trials counted as the energies it asks for),
  at formaldimine (8e,8o) sector np_fabric L=1 sto-3g (D = 4,900, where
  the D terms are ~100x the orbital ones; ~5 s on the CPU);
* ``armijo_trials`` against the host search's steps;
* ``mfu`` against the H100's datasheet peaks.
"""

import inspect

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from auto_oo_tpu import Moldata as JMoldata
from auto_oo_tpu.models import OO_pqc as JOO_pqc
from auto_oo_tpu.models import Parameterized_circuit as JPC
from auto_oo_tpu.utils import flops as jflops
import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.models import oo_pqc as poo
from auto_oo_tpu_torch.ops import grid, grid_hosted
from auto_oo_tpu_torch.parallel import GeometryBatch
from auto_oo_tpu_torch.utils import flops
from auto_oo_tpu_torch.utils.newton_raphson import armijo_steps

GEO = P.get_formal_geo(140, 80)
# (ncas, D, nt, nk, nao, ns, pairs): (10e,10o), (12e,12o), (16e,16o)-like
SHAPES = [(10, 63504, 28, 30, 13, 14, 123456),
          (12, 853776, 10, 164, 26, 14, 987654),
          (16, 165636900, 14, 0, 16, 16, 10 ** 9), (2, 4, 2, 20, 13, 8, 6)]


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's default device is the card; these CPU tests ask for the
    CPU, and restore the default after the module."""
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


def gram(ncas, D, nt):
    """The transition gram per tangent the JAX count takes twice and the
    port's once: 2 nt n2^2 D."""
    return 2.0 * nt * ncas ** 4 * D


@pytest.fixture(scope="module")
def mol():
    return P.Moldata(GEO, "sto-3g")


@pytest.mark.parametrize("shape", SHAPES)
def test_terms_equal_jax(shape):
    """The terms where the algorithms are the same equal the JAX count;
    grad_hess counts one transition gram per tangent, 2 nt n2^2 D, where
    the JAX count takes two."""
    ncas, D, nt = shape[:3]
    ref = jflops.grad_hess_flops(*shape)
    assert ref - flops.grad_hess_flops(*shape) == pytest.approx(
        gram(ncas, D, nt), rel=1e-12)
    for trials in (1, 3):
        ref = jflops.update_flops(*shape, newton_method="iterative",
                                  n_trials=trials)
        got = flops.update_flops(*shape, newton_method="iterative",
                                 n_trials=trials)
        assert got == pytest.approx(ref, rel=1e-12)


@pytest.mark.parametrize("shape", SHAPES)
def test_eigh_and_none_by_the_convention(shape):
    """eigh: 9 n^3 where the JAX package counts 30 Jacobi sweeps (120
    n^3); None is eigh in the port and the iterative solve in the JAX
    count."""
    n = shape[2] + shape[3]
    eigh = flops.update_flops(*shape, newton_method="eigh")
    assert eigh == flops.update_flops(*shape)
    assert eigh - jflops.update_flops(*shape, newton_method="eigh") == (
        pytest.approx((9.0 - 120.0) * n ** 3, rel=1e-12, abs=1e-3))
    assert eigh - jflops.update_flops(*shape, newton_method="iterative") == (
        pytest.approx((9.0 - 600.0) * n ** 3, rel=1e-12, abs=1e-3))
    with pytest.raises(ValueError):
        flops.update_flops(*shape, newton_method="jacobi")


def test_sector_count_equals_jax(mol):
    """A sector problem: the same grid pair count and, with
    newton_method="iterative", the same total as the JAX package (whose
    default counts the iterative solve); the default counts eigh."""
    jmol = JMoldata(GEO, "sto-3g")
    jpqc = JPC(4, 4, ansatz="np_fabric", n_layers=2, sector=True)
    joo = JOO_pqc(jpqc, jmol, 4, 4, freeze_active=True)
    ref = jflops.nr_iteration_flops(jpqc, joo, n_trials=2)
    pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=2,
                                  sector=True)
    oo = P.OO_pqc(pqc, mol, 4, 4, freeze_active=True,
                  newton_method="iterative")
    got = flops.nr_iteration_flops(pqc, oo, n_trials=2)
    assert flops._pairs_of(pqc) == jflops._pairs_per_apply_grid(
        jpqc.grid_program) > 0
    assert pqc._program is None, "the count built the flat program"
    less = gram(4, pqc.state_dim, pqc.theta_shape)
    assert got["update"] == pytest.approx(ref["update"], rel=1e-12)
    for key in ("grad_hess", "total"):
        assert ref[key] - got[key] == pytest.approx(less, rel=1e-12)
    n = pqc.theta_shape + oo.n_kappa
    eigh = flops.nr_iteration_flops(pqc, P.OO_pqc(pqc, mol, 4, 4,
                                                  freeze_active=True), 2)
    assert eigh["total"] - ref["total"] == pytest.approx(
        (9.0 - 600.0) * n ** 3 - less, rel=1e-12)


@pytest.mark.parametrize("ncas,nelecas,kw", [
    (3, 4, {"ansatz": "np_fabric", "n_layers": 2}),
    (4, 4, {"ansatz": "ucc", "add_singles": True}),
])
def test_flat_pairs_are_the_real_pairs(mol, ncas, nelecas, kw):
    """The flat program's count is the JAX program's real pair count
    (its tables are padded), and the rest of the count the JAX
    formula's, less the one transition gram."""
    jpqc = JPC(ncas, nelecas, **kw)
    pqc = P.Parameterized_circuit(ncas, nelecas, **kw)
    real = int(jpqc.program.n_real_pairs.sum())
    assert flops._pairs_of(pqc) == real
    assert real <= jflops._pairs_per_apply(jpqc.program)
    oo = P.OO_pqc(pqc, mol, ncas, nelecas, newton_method="iterative")
    shapes = (ncas, 4 ** ncas, pqc.theta_shape, oo.n_kappa, oo.nao,
              len(oo._occ) + len(oo._act), real)
    got = flops.nr_iteration_flops(pqc, oo)
    assert jflops.grad_hess_flops(*shapes) - got["grad_hess"] == (
        pytest.approx(gram(ncas, 4 ** ncas, pqc.theta_shape), rel=1e-12))
    assert got["update"] == pytest.approx(jflops.update_flops(*shapes),
                                          rel=1e-12)


def test_one_count_on_every_route(mol, monkeypatch):
    """The count reads the problem's shapes only: fused, staged,
    streamed, hosted per-tangent and Gram, f64 and mixed, and a lane of
    a GeometryBatch give one number."""
    pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=2,
                                  sector=True)

    def oo(**kw):
        return P.OO_pqc(pqc, mol, 4, 4, freeze_active=True, **kw)

    counts = {}
    for precision in ("f64", "mixed"):
        made = oo(precision=precision)
        assert made._core["route"] == "fused"
        counts[("fused", precision)] = flops.nr_iteration_flops(pqc, made)
        made = oo(precision=precision, stream_plan=grid.StreamPlan(2, 3,
                                                                  None))
        assert made._core["route"] == "streamed"
        counts[("streamed", precision)] = flops.nr_iteration_flops(pqc,
                                                                   made)
    batch = GeometryBatch([mol, P.Moldata(P.get_formal_geo(135, 85),
                                          "sto-3g")], 4, 4, pqc,
                          freeze_active=True)
    counts["batch lane"] = flops.nr_iteration_flops(pqc, batch.oo_list[1])
    monkeypatch.setattr(poo, "_STAGED_MIN_D", 1)
    made = oo()
    assert made._core["route"] == "staged"
    counts["staged"] = flops.nr_iteration_flops(pqc, made)
    monkeypatch.setattr(grid_hosted, "_HOSTED_MIN_BYTES", 1)
    for form in ("per_tangent", "gram"):
        for precision in ("f64", "mixed"):
            made = oo(hosted_form=form, precision=precision)
            assert made._core["route"] == "hosted"
            counts[(form, precision)] = flops.nr_iteration_flops(pqc, made)
    ref = counts.pop(("fused", "f64"))
    assert ref["total"] > 0
    for key, got in counts.items():
        assert got == ref, key


def test_count_within_a_factor_two_of_the_counter(mol):
    """One f64 NR iteration from theta = 0 at (8e,8o) sector: the count
    and the matmul FLOPs FlopCounterMode sees (mm, bmm, addmm, baddbmm)
    agree within a factor 2 either way, for grad_hess, for the update
    (its Armijo trials are the energies the core's update asks for) and
    in total.  The band catches a units error (a lost factor 2, a missed
    n_theta) and is never widened."""
    pqc = P.Parameterized_circuit(8, 8, ansatz="np_fabric", n_layers=1,
                                  sector=True)
    oo = P.OO_pqc(pqc, mol, 8, 8, freeze_active=True)
    assert (pqc.state_dim, oo._core["route"]) == (4900, "fused")
    energy, trials = oo._core["energy"], []

    def counted_energy(*args):
        trials.append(1)
        return energy(*args)

    update = oo._core["newton_update_on"](counted_energy)
    theta, args = pqc.init_zeros(), (oo.oao_mo_coeff, *oo._mol_args)
    with FlopCounterMode(display=False) as counter:
        e0, grad, hess = oo._core["grad_hess"](theta, *args)
    seen_gh = counter.get_total_flops()
    with FlopCounterMode(display=False) as counter:
        update(theta, *args, e0, grad, hess, 1e-4, 0.5, 1e-6, 1.1, 1e-6)
    seen_up = counter.get_total_flops()
    assert 1 <= len(trials) <= 20
    count = flops.nr_iteration_flops(pqc, oo, n_trials=len(trials))
    D, n2 = pqc.state_dim, 64
    orbital = 8.0 * oo.nao ** 5 + 2.0 * 12 ** 4 * oo.nao ** 2
    assert 2.0 * n2 * n2 * D * (1 + pqc.theta_shape) > 10 * orbital
    for got, seen in ((count["grad_hess"], seen_gh),
                      (count["update"], seen_up),
                      (count["total"], seen_gh + seen_up)):
        assert 0.5 <= got / seen <= 2.0, (got, seen, len(trials))


@pytest.mark.parametrize("beta", [0.5, 0.3])
def test_armijo_trials_of_a_step(beta):
    """The k-th trial step of the host search (armijo_steps) maps back to
    k trials, t = 0 to all lmax, and a step the search never tries is
    refused; its default lmax is the Newton core's."""
    for lmax in (1, 20):
        for k, t in enumerate(armijo_steps(beta, lmax), 1):
            assert flops.armijo_trials(t, beta, lmax) == k
        assert flops.armijo_trials(0.0, beta, lmax) == lmax
    assert flops.armijo_trials(0.0, beta) == 20
    lmax = (inspect.signature(fn).parameters["lmax"].default
            for fn in (flops.armijo_trials, poo.damped_newton_step_pure))
    assert len(set(lmax)) == 1, "armijo_trials' lmax is not the core's"
    with pytest.raises(ValueError):
        flops.armijo_trials(0.7, beta)


def test_mfu_against_the_h100_peaks():
    """The datasheet peaks of one H100 SXM5 at 700 W; mfu divides by the
    peak of the precision it is given (f64 by default)."""
    assert flops.FP64_PEAK == flops.FP32_PEAK == 67e12
    assert flops.HBM_BYTES_PER_S == 3.35e12
    assert flops.mfu(6.7e12, 0.5) == (pytest.approx(1.34e13),
                                      pytest.approx(0.2))
    achieved, share = flops.mfu(6.7e12, 0.5, "mixed")
    assert share == pytest.approx(achieved / flops.FP32_PEAK)
    with pytest.raises(KeyError):
        flops.mfu(1.0, 1.0, "bf16")
    assert not any(name.startswith("TPU") for name in vars(flops))
