"""The port's host layer (auto_oo_tpu_torch.moldata, numpy) against the
JAX package's: same molecule, same integrals, same reference solvers."""

import numpy as np
import pytest

import auto_oo_tpu as J
import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config


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
    geo = J.get_formal_geo(140, 80)
    return J.Moldata(geo, "sto-3g"), P.Moldata(geo, "sto-3g")


@pytest.mark.parametrize("name", ["int1e_ao", "int2e_ao", "oao_coeff",
                                  "overlap"])
def test_integrals_match(mols, name):
    mj, mp = mols
    a, b = np.asarray(getattr(mj, name)), np.asarray(getattr(mp, name))
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-13)


def test_nuclear_repulsion_and_partition(mols):
    mj, mp = mols
    assert abs(mp.nuc - mj.nuc) < 1e-13
    assert mp.nao == mj.nao == 13
    for a, b in zip(mj.get_active_space_idx(10, 10),
                    mp.get_active_space_idx(10, 10)):
        np.testing.assert_array_equal(a, b)


def test_rhf_matches(mols):
    mj, mp = mols
    mj.run_rhf()
    mp.run_rhf()
    assert abs(mp.hf.e_tot - mj.hf.e_tot) < 1e-10
    np.testing.assert_allclose(np.abs(mp.hf.mo_coeff),
                               np.abs(mj.hf.mo_coeff), rtol=0, atol=1e-8)


def test_open_shell_cation_builds():
    geo = J.get_formal_geo(140, 80)
    mj = J.Moldata(geo, "sto-3g", charge=1, spin=1)
    mp = P.Moldata(geo, "sto-3g", charge=1, spin=1)
    mj.run_rhf()
    mp.run_rhf()
    assert abs(mp.hf.e_tot - mj.hf.e_tot) < 1e-10
    for a, b in zip(mj.get_active_space_idx(4, (2, 1)),
                    mp.get_active_space_idx(4, (2, 1))):
        np.testing.assert_array_equal(a, b)


def test_631g_formaldimine_matches():
    """6-31G, the basis of the (12e,12o) configuration (24 orbitals: 2 core
    + 12 active + 10 virtual): integrals, RHF and the partition."""
    geo = J.get_formal_geo(140, 80)
    mj, mp = J.Moldata(geo, "6-31g"), P.Moldata(geo, "6-31g")
    assert mp.nao == mj.nao == 24
    for name in ("int1e_ao", "int2e_ao", "oao_coeff", "overlap"):
        np.testing.assert_allclose(np.asarray(getattr(mp, name)),
                                   np.asarray(getattr(mj, name)), rtol=0,
                                   atol=1e-13, err_msg=name)
    mj.run_rhf()
    mp.run_rhf()
    assert abs(mp.hf.e_tot - mj.hf.e_tot) < 1e-10
    for a, b in zip(mj.get_active_space_idx(12, 12),
                    mp.get_active_space_idx(12, 12)):
        np.testing.assert_array_equal(a, b)
