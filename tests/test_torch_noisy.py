"""The port's Noisy_OO_pqc against the JAX package, on the CPU.

Pins (tests/test_noisy_oo_pqc.py's): at variance 0 the noisy blocks equal
the exact ones (1e-14 gradient, 1e-12 Hessian) and the noisy run equals
the JAX package's noisy run and the port's full_optimization; the same
generator seed gives the same result, another seed another; the noise
has the asked variance; variance 1e-10 still reaches CASSCF to 1e-4.
The eigh solve of a non-symmetric Hessian (the cc-block noise is not
symmetric) takes its symmetric part, as the JAX package's CPU eigh does.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from auto_oo_tpu import Moldata as JMoldata, get_formal_geo
from auto_oo_tpu.models import Noisy_OO_pqc as JNoisy
from auto_oo_tpu.models import Parameterized_circuit as JPC
from auto_oo_tpu.utils import newton_raphson as jnr
import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.utils import newton_raphson as nr

GEO = get_formal_geo(140, 80)
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


def _noisy(mol, seed=7):
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)
    return P.Noisy_OO_pqc(pqc, mol, 2, 2, freeze_active=True, seed=seed)


def test_zero_variance_equals_exact(mol):
    noisy = _noisy(mol)
    theta = torch.tensor([0.3, -0.1], dtype=torch.float64)
    g0 = noisy.full_noisy_gradient(theta, 0.0)
    np.testing.assert_allclose(g0.numpy(), noisy.full_gradient(theta).numpy(),
                               rtol=0, atol=1e-14)
    h0 = noisy.full_noisy_hessian(theta, 0.0)
    np.testing.assert_allclose(h0.numpy(), noisy.full_hessian(theta).numpy(),
                               rtol=0, atol=1e-12)
    for name in ("circuit_gradient", "orbital_gradient",
                 "circuit_circuit_hessian", "orbital_circuit_hessian",
                 "orbital_orbital_hessian"):
        exact = getattr(noisy, name)(theta)
        np.testing.assert_array_equal(
            getattr(noisy, "noisy_" + name)(theta, 0.0).numpy(),
            exact.numpy())


def test_zero_variance_run_equals_jax_and_exact(mol):
    """At variance 0 the noisy optimization is the exact damped Newton:
    its energies equal the JAX package's noisy run and the port's
    full_optimization to 1e-10, and it ends at CASSCF."""
    noisy = _noisy(mol)
    el, thl, kl, ol, eig = noisy.full_noisy_optimization(
        noisy.pqc.init_zeros(), variance=0.0, max_iterations=12)
    jpqc = JPC(2, 2, ansatz="np_fabric", n_layers=1)
    jel, *_ = JNoisy(jpqc, JMoldata(GEO, "sto-3g"), 2, 2,
                     freeze_active=True, seed=7).full_noisy_optimization(
        jpqc.init_zeros(), variance=0.0, max_iterations=12)
    exact = P.OO_pqc(noisy.pqc, mol, 2, 2, freeze_active=True)
    xel, *_ = exact.full_optimization(noisy.pqc.init_zeros(),
                                      max_iterations=12)
    assert len(el) == len(jel) == len(xel)
    np.testing.assert_allclose(el, jel, rtol=0, atol=1e-10)
    np.testing.assert_allclose(el, xel, rtol=0, atol=1e-12)
    assert abs(el[-1] - E_CASSCF) < 1e-8
    assert len(thl) == len(kl) == len(ol) == len(eig) == len(el)
    assert torch.equal(noisy.oao_mo_coeff, ol[-1])


def test_seed_reproducibility_and_scale(mol):
    """The same seed gives the same noisy gradient and the same noisy
    trajectory; another seed another; a given generator replaces the
    object's; the noise has the asked standard deviation."""
    theta = torch.tensor([0.3, -0.1], dtype=torch.float64)
    g1 = _noisy(mol, 3).full_noisy_gradient(theta, 1e-2)
    g2 = _noisy(mol, 3).full_noisy_gradient(theta, 1e-2)
    g3 = _noisy(mol, 4).full_noisy_gradient(theta, 1e-2)
    assert torch.equal(g1, g2) and not torch.equal(g1, g3)
    gen = torch.Generator().manual_seed(42)
    a = _noisy(mol, 3).full_noisy_gradient(theta, 1e-2, generator=gen)
    gen = torch.Generator().manual_seed(42)
    b = _noisy(mol, 9).full_noisy_gradient(theta, 1e-2, generator=gen)
    assert torch.equal(a, b)
    exact = _noisy(mol).full_gradient(theta)
    assert 0.0 < float((g1 - exact).abs().max()) < 1.0
    draws = _noisy(mol, 5)._noisify(torch.zeros(200_000,
                                                dtype=torch.float64), 4.0)
    assert abs(float(draws.std()) - 2.0) < 0.02
    assert abs(float(draws.mean())) < 0.02
    runs = []
    for _ in range(2):
        noisy = _noisy(mol, 11)
        runs.append(noisy.full_noisy_optimization(
            noisy.pqc.init_zeros(), variance=1e-6, max_iterations=5,
            conv_tol=0.0)[0])
    assert runs[0] == runs[1]
    noisy = _noisy(mol, 12)
    other = noisy.full_noisy_optimization(
        noisy.pqc.init_zeros(), variance=1e-6, max_iterations=5,
        conv_tol=0.0, generator=torch.Generator().manual_seed(13))[0]
    assert other != runs[0]


def test_small_variance_reaches_casscf(mol, capsys):
    """Variance 1e-10 still reaches the CASSCF basin (the JAX test's
    bound, 1e-4 Ha)."""
    noisy = _noisy(mol)
    energy_l, theta_l, kappa_l, oao_l, eig_l = noisy.full_noisy_optimization(
        noisy.pqc.init_zeros(), variance=1e-10, max_iterations=25,
        conv_tol=1e-9, verbose=1)
    assert abs(energy_l[-1] - E_CASSCF) < 1e-4
    assert len(kappa_l) == len(energy_l)
    assert "iter = 001" in capsys.readouterr().out


def test_asymmetric_hessian_eigh_equals_jax():
    """newton_step_pure(method="eigh") on a non-symmetric H (an exact
    symmetric Hessian plus a non-symmetric cc-block noise, as the noisy
    step builds) equals the JAX package's to 1e-12: both solve
    (H + H^T) / 2; a symmetric H is solved unchanged to the bit."""
    rng = np.random.RandomState(3)
    n = 9
    A = rng.randn(n, n)
    H = A + A.T
    H[:4, :4] += 0.1 * rng.randn(4, 4)
    g = rng.randn(n)
    dp, low = nr.newton_step_pure(torch.as_tensor(g), torch.as_tensor(H),
                                  method="eigh")
    jdp, jlow = jnr.newton_step_pure(jnp.asarray(g), jnp.asarray(H),
                                     method="eigh")
    np.testing.assert_allclose(dp.numpy(), np.asarray(jdp), rtol=0,
                               atol=1e-12)
    assert abs(float(low) - float(jlow)) < 1e-12
    S = 0.5 * (H + H.T)
    sym = nr.newton_step_pure(torch.as_tensor(g), torch.as_tensor(S))
    assert torch.equal(sym[0], dp) and torch.equal(sym[1], low)
    w, V = P.ops.linalg.eigh(torch.as_tensor(S))
    w2, V2 = torch.linalg.eigh(torch.as_tensor(S))
    assert torch.equal(w, w2) and torch.equal(V, V2)
