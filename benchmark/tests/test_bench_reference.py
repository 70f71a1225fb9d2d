"""The plain reference against the port on small hydrogen chains (CPU).

These tests import the port; the reference itself imports nothing of it
(``test_reference_imports_nothing_of_the_program``)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.models.oo_energy import mo_ao_to_mo_oao

from benchmark.reference import chem, fci
from benchmark.reference.fabric import Fabric
from benchmark.reference.problem import Reference

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STEP = dict(alpha=1e-4, beta=0.5, mu=1e-6, rho=1.1, lambda_min=1e-6)


@pytest.fixture(scope="module", autouse=True)
def on_cpu():
    previous = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(previous)


def port_problem(atoms, spacing):
    """The port's Moldata, circuit and OO_pqc of the chain, in the
    reference's sign-fixed RHF orbitals."""
    geo = chem.chain_geometry(atoms, spacing)
    S, hcore, eri, _ = chem.integrals(geo)
    C = chem.fix_signs(chem.rhf(S, hcore, eri, atoms)[1])
    mol = P.Moldata(geo, "sto-3g")
    pqc = P.Parameterized_circuit(atoms, atoms, ansatz="np_fabric",
                                  n_layers=1, sector=True)
    oo = P.OO_pqc(pqc, mol, atoms, atoms, freeze_active=True,
                  oao_mo_coeff=mo_ao_to_mo_oao(C, mol.overlap))
    return geo, mol, pqc, oo


@pytest.mark.parametrize("atoms,spacing", [(4, 0.8), (6, 0.93), (8, 1.0)])
def test_integrals_and_rhf_match_moldata(atoms, spacing):
    geo = chem.chain_geometry(atoms, spacing)
    mol = P.Moldata(geo, "sto-3g")
    mol.run_rhf()
    S, hcore, eri, e_nuc = chem.integrals(geo)
    np.testing.assert_allclose(S, mol.overlap, atol=1e-13)
    np.testing.assert_allclose(hcore, mol.int1e_ao, atol=1e-12)
    np.testing.assert_allclose(eri, mol.int2e_ao, atol=1e-12)
    assert abs(e_nuc - mol.nuc) < 1e-12
    e_elec, C, _ = chem.rhf(S, hcore, eri, atoms)
    assert abs(e_elec + e_nuc - mol.hf.e_tot) < 1e-10
    # the same orbitals up to sign, and one sign after fix_signs (the
    # port's SCF stops on a 1e-11 energy change, its orbitals ~1e-6 off)
    np.testing.assert_allclose(chem.fix_signs(C),
                               chem.fix_signs(mol.hf.mo_coeff), atol=2e-5)


def test_fix_signs_is_a_convention():
    C = np.array([[0.5, -0.2], [0.5, 0.7]])
    fixed = chem.fix_signs(-C)
    np.testing.assert_array_equal(fixed, chem.fix_signs(C))
    assert (fixed[0] > 0).all()


def test_excitation_tables_against_bits():
    strs, tgt, sgn = fci.excitation_tables(5, 2)
    index = {int(s): i for i, s in enumerate(strs)}
    for p in range(5):
        for q in range(5):
            k = p * 5 + q
            for i, s in enumerate(strs):
                s = int(s)
                if not s >> q & 1 or (p != q and s >> p & 1):
                    assert sgn[k, i] == 0
                    continue
                new = (s & ~(1 << q)) | (1 << p)
                between = sum(s >> m & 1 for m in range(min(p, q) + 1,
                                                        max(p, q)))
                assert tgt[k, i] == index[new]
                assert sgn[k, i] == (-1) ** between


@pytest.mark.parametrize("atoms", [4, 6, 8])
def test_energy_gradient_hessian_match_the_port(atoms):
    geo, mol, pqc, oo = port_problem(atoms, 0.9)
    ref = Reference(geo, atoms, 1, "cpu")
    assert ref.fabric.n_theta == pqc.theta_shape
    theta = np.random.default_rng(atoms).uniform(-0.3, 0.3, pqc.theta_shape)
    e_port, g_port, h_port = (t.numpy() for t in oo._grad_hess(theta))
    e, g, h = ref.hessian(torch.tensor(theta))
    assert abs(e - float(e_port)) < 1e-11
    np.testing.assert_allclose(g.numpy(), g_port, atol=1e-11)
    np.testing.assert_allclose(h.numpy(), h_port, atol=1e-10)
    e2, g2 = ref.energy_gradient(torch.tensor(theta))
    assert e2 == e
    np.testing.assert_allclose(g2.numpy(), g.numpy(), atol=1e-14)


def test_hartree_fock_state_gives_the_rhf_energy():
    geo = chem.chain_geometry(6, 0.85)
    ref = Reference(geo, 6, 1, "cpu")
    e = ref.energy(np.zeros(ref.fabric.n_theta))[0]
    assert abs(e - ref.e_rhf) < 1e-10


def test_newton_trajectory_matches_the_port():
    geo, mol, pqc, oo = port_problem(6, 0.91)
    theta0 = np.zeros(pqc.theta_shape)
    energies, thetas, _, _, lows = oo.full_optimization(
        torch.tensor(theta0), max_iterations=3, conv_tol=-1.0, **STEP)
    out = Reference(geo, 6, 1, "cpu").newton(theta0, 3, **STEP)
    for k in range(3):
        assert abs(out[k][1] - energies[k]) < 1e-11
        assert abs(out[k][2] - lows[k]) < 1e-10
        np.testing.assert_allclose(out[k][0].numpy(), thetas[k].numpy(),
                                   atol=1e-10)


def test_adam_trajectory_matches_the_port():
    geo, mol, pqc, oo = port_problem(6, 0.87)
    theta0 = np.random.default_rng(5).uniform(-0.1, 0.1, pqc.theta_shape)
    energies, theta = oo.gradient_optimization(
        torch.tensor(theta0), max_iterations=3, learning_rate=0.05,
        conv_tol=-1.0, orbital_every=0)
    e_ref, g_ref, theta_ref = Reference(geo, 6, 1, "cpu").adam(theta0, 3,
                                                               0.05)
    np.testing.assert_allclose(e_ref, energies, atol=1e-11)
    np.testing.assert_allclose(theta_ref, theta.numpy(), atol=1e-11)
    g_port = oo.energy_and_gradient(torch.tensor(theta0))[1].numpy()
    np.testing.assert_allclose(g_ref, g_port, atol=1e-11)


def test_generator_is_the_derivative_of_the_gate():
    space = fci.Space(6, 3, "cpu")
    fab = Fabric(space, 1)
    rng = np.random.default_rng(0)
    C = torch.tensor(rng.standard_normal((space.N, space.N)))
    for i in range(fab.n_theta):
        h = 1e-6
        up = fab.rotate(C.clone(), i, 0.3 + h)
        dn = fab.rotate(C.clone(), i, 0.3 - h)
        mid = fab.rotate(C.clone(), i, 0.3)
        np.testing.assert_allclose(((up - dn) / (2 * h)).numpy(),
                                   fab.generator(mid, i).numpy(), atol=1e-8)


def test_reference_imports_nothing_of_the_program():
    """Every module under ``benchmark/reference/`` and every problem module
    under ``benchmark/problems/``, found by glob, with the harness, the
    counts and the control: loading them loads no module of JAX, of the
    JAX package or of the port."""
    code = """if True:
        import glob, importlib, os, sys
        import benchmark.counts, benchmark.control
        from benchmark import harness
        def stems(kind):
            return sorted(os.path.basename(p)[:-3] for p in glob.glob(
                os.path.join(harness.HERE, kind, "*.py")))
        refs, probs = stems("reference"), stems("problems")
        assert refs and probs
        for name in refs:
            importlib.import_module("benchmark.reference." + name)
        for name in probs:
            harness.load(harness.HERE, "problems", name)
        bad = sorted({m.split(".")[0] for m in sys.modules} & {
            "jax", "jaxlib", "flax", "auto_oo_tpu", "auto_oo_tpu_torch"})
        print(refs, probs, bad)
        sys.exit(1 if bad else 0)
    """
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
def test_reference_on_the_card_equals_the_cpu(card):
    geo = chem.chain_geometry(8, 0.9)
    theta = np.random.default_rng(1).uniform(-0.2, 0.2, 6)
    e_cpu, g_cpu = Reference(geo, 8, 1, "cpu").energy_gradient(theta)
    e_gpu, g_gpu = Reference(geo, 8, 1, card).energy_gradient(theta)
    assert abs(e_cpu - e_gpu) < 1e-12
    np.testing.assert_allclose(g_cpu.numpy(), g_gpu.numpy(), atol=1e-12)
