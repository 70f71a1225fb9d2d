"""The port's spin diagnostics against the JAX package, on the CPU.

Pins (tests/test_grid.py:403-436, tests/test_sector.py:71-121,
tests/test_open_shell.py:95-111): the string-factorized grid S^- tables
and the flat cross-sector S^- tables equal the JAX package's exactly
(None where S^- is the zero map); <S^2> equals the JAX package's to
1e-12 on the grid, flat-sector and full-space forms, on random
spin-contaminated (real and complex) states from (3e,3o) to (5e,5o) and
on circuit states; the dense S^2 and S_z equal the JAX package's; the
(3e,3o) doublet's converged <S^2> is 3/4 to 1e-9.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from auto_oo_tpu import Moldata as JMoldata, get_formal_geo
from auto_oo_tpu.models import Parameterized_circuit as JPC
from auto_oo_tpu.models import fermionic_cas_hamiltonian as jcas_ham
from auto_oo_tpu.ops import fermion as jfermion
from auto_oo_tpu.ops import grid as jgrid
from auto_oo_tpu.ops import rdms as jrdms
from auto_oo_tpu.simulator import sector as jsector
import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.ops import grid, rdms
from auto_oo_tpu_torch.scripts import demo_16e16o
from auto_oo_tpu_torch.simulator import sector

SECTORS = [(3, 3), (3, (2, 1)), (4, 4), (4, (3, 1)), (3, (2, 2)),
           (4, (1, 3)), (5, 5), (5, (3, 2)), (4, (0, 2)), (3, (3, 3))]


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's default device is the card; these CPU tests ask for the
    CPU, and restore the default after the module."""
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


def _random_state(D, seed, complex_=False):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(D)
    if complex_:
        v = v + 1j * rng.standard_normal(D)
    return v / np.linalg.norm(v)


@pytest.mark.parametrize("ncas,nelec", SECTORS)
def test_sminus_tables_equal_jax(ncas, nelec):
    """Both S^- table families equal the JAX package's exactly, and both
    are None on the same sectors."""
    sm, jsm = grid.sminus_grid_maps(ncas, nelec), jgrid.sminus_grid_maps(
        ncas, nelec)
    flat, jflat = (sector.sector_sminus_maps(ncas, nelec),
                   jsector.sector_sminus_maps(ncas, nelec))
    assert (sm is None) == (jsm is None) == (flat is None) == (jflat is None)
    if sm is None:
        return
    for name in ("srcAm", "fA", "srcBp", "fB"):
        np.testing.assert_array_equal(getattr(sm, name).numpy(),
                                      np.asarray(getattr(jsm, name)))
    assert sm.srcAm.dtype == torch.int64 and sm.fA.dtype == torch.int8
    for mine, ref in zip(flat, jflat):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("ncas,nelec", SECTORS)
def test_s2_expectation_forms_equal_jax(ncas, nelec, complex_):
    """<S^2> of a random (spin-contaminated) sector state: the grid form
    from canonical order and from the 2-D grid state, and the flat
    sector form, each within 1e-12 of the JAX package's grid value and of
    the dense S^2 quadratic form on the embedded full-space vector."""
    basis = jfermion.sector_basis(ncas, nelec)
    v = _random_state(len(basis), 11, complex_)
    gm = grid.build_grid_maps(ncas, nelec)
    sm = grid.sminus_grid_maps(ncas, nelec)
    psi = torch.as_tensor(v)
    s2_grid = float(grid.s2_expectation_grid(psi, gm, sm, nelec))
    s2_grid2d = float(grid.s2_expectation_grid(
        grid.to_grid(psi, gm).reshape(gm.Na, gm.Nb), gm, sm, nelec))
    s2_flat = float(sector.s2_expectation_sector(
        psi, sector.sector_sminus_maps(ncas, nelec), nelec))
    ref = float(jgrid.s2_expectation_grid(
        jnp.asarray(v), jgrid.build_grid_maps(ncas, nelec),
        jgrid.sminus_grid_maps(ncas, nelec), nelec))
    full = np.zeros(4 ** ncas, dtype=v.dtype)
    full[basis] = v
    S2 = rdms.s2_matrix(ncas).numpy()
    dense = float(np.real(np.conj(full) @ (S2 @ full)))
    for val in (s2_grid, s2_grid2d, s2_flat):
        assert abs(val - ref) < 1e-12
        assert abs(val - dense) < 1e-12


def test_none_sector_values():
    """Where S^- is the zero map, <S^2> is Sz^2 - Sz exactly."""
    gm = grid.build_grid_maps(3, (0, 2))
    psi = torch.zeros(gm.dim, dtype=torch.float64)
    psi[0] = 1.0
    assert float(grid.s2_expectation_grid(psi, gm, None, (0, 2))) == 2.0
    assert float(sector.s2_expectation_sector(psi, None, (0, 2))) == 2.0
    # two aligned up spins: S = 1, S^2 = 2 (the target (1,1) exists)
    maps = sector.sector_sminus_maps(2, (2, 0))
    psi = torch.zeros(len(jfermion.sector_basis(2, (2, 0))),
                      dtype=torch.float64)
    psi[0] = 1.0
    assert abs(float(sector.s2_expectation_sector(psi, maps, (2, 0)))
               - 2.0) < 1e-12


@pytest.mark.parametrize("ncas,nelec,sector_", [
    (3, 3, True), (4, 4, True), (5, 5, True), (4, (2, 1), True),
    (3, 3, False), (4, 4, False)])
def test_circuit_s2_equals_jax(ncas, nelec, sector_):
    """Parameterized_circuit.s2_expectation at a random theta (np_fabric
    L=2, whose pair gates mix spin on open-shell sectors) and
    s2_expectation_of_state on a random state equal the JAX package's to
    1e-12; sz_value is (n_a - n_b) / 2."""
    kw = dict(ansatz="np_fabric", n_layers=2, sector=sector_)
    pqc, jpqc = P.Parameterized_circuit(ncas, nelec, **kw), JPC(ncas, nelec,
                                                                 **kw)
    theta = 0.3 * np.random.RandomState(7).randn(pqc.theta_shape)
    s2 = float(pqc.s2_expectation(torch.as_tensor(theta)))
    assert abs(s2 - float(jpqc.s2_expectation(jnp.asarray(theta)))) < 1e-12
    v = _random_state(pqc.state_dim, 5)
    s2v = float(pqc.s2_expectation_of_state(v))
    assert abs(s2v - float(jpqc.s2_expectation_of_state(jnp.asarray(v)))) \
        < 1e-12
    assert pqc.sz_value() == jpqc.sz_value()
    assert abs(float(pqc.s2_expectation(pqc.init_zeros()))
               - float(jpqc.s2_expectation(jpqc.init_zeros()))) < 1e-12


def test_dense_spin_operators_equal_jax():
    """models.s2 / sz (the dense operators of the full space) and
    fermionic_cas_hamiltonian equal the JAX package's."""
    for n in (1, 2, 3):
        np.testing.assert_array_equal(P.s2(n).numpy(),
                                      np.asarray(jrdms.s2_matrix(n)))
        np.testing.assert_array_equal(P.sz(n).numpy(),
                                      np.asarray(jrdms.sz_matrix(n)))
    rng = np.random.RandomState(2)
    c1 = rng.randn(2, 2)
    c1 = c1 + c1.T
    c2 = rng.randn(2, 2, 2, 2)
    c2 = c2 + c2.transpose(1, 0, 3, 2)
    H = P.fermionic_cas_hamiltonian(
        torch.tensor(0.4, dtype=torch.float64), torch.as_tensor(c1),
        torch.as_tensor(c2))
    np.testing.assert_allclose(H.toarray(), jcas_ham(0.4, c1, c2).toarray(),
                               rtol=0, atol=1e-14)
    with pytest.raises(NotImplementedError):
        P.fermionic_cas_hamiltonian(0.0, c1, c2, restricted=False)


def test_doublet_converged_s2():
    """The (3e,3o) doublet of the formaldimine cation (ucc with singles,
    sector, freeze_active) optimized to convergence is spin-pure:
    <S^2> = 3/4 to 1e-9, and its energy is the JAX package's CASSCF."""
    mol = P.Moldata(get_formal_geo(140, 80), "sto-3g", charge=1, spin=1)
    pqc = P.Parameterized_circuit(3, (2, 1), ansatz="ucc", add_singles=True,
                                  sector=True)
    oo = P.OO_pqc(pqc, mol, 3, (2, 1), freeze_active=True)
    el, thl, *_ = oo.full_optimization(pqc.init_zeros())
    assert abs(float(pqc.s2_expectation(thl[-1])) - 0.75) < 1e-9
    assert pqc.sz_value() == 0.5
    jmol = JMoldata(get_formal_geo(140, 80), "sto-3g", charge=1, spin=1)
    jmol.run_casscf(3, (2, 1))
    assert abs(el[-1] - jmol.casscf.e_tot) < 1e-8


def test_demo_s2_stage(capsys):
    """The demos' s2 stage on the H4 chain (4e,4o) sector at theta0 =
    0.02 * arange(n_theta): |<S^2>| < 1e-8, its seconds printed."""
    pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                  sector=True)
    theta = 0.02 * torch.arange(pqc.theta_shape, dtype=torch.float64)
    s2, sec, peak = demo_16e16o.s2_stage(pqc, theta)
    assert abs(s2) < 1e-8 and sec >= 0 and peak is None
    assert "<S^2> =" in capsys.readouterr().out
