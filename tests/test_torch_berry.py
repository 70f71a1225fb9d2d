"""The port's Berry-phase workflow against the JAX package, on the CPU.

Pins (tests/test_berry.py's, at least as tight): the Givens split and
the polar factorization equal the JAX package's to 1e-14; the device
Thouless transfer equals the JAX package's and the scipy host oracle to
1e-12 for orthogonal, reflecting, non-orthogonal and diag(-1, -1, 1) M
and in a sector basis; a 5-point (2e,2o) loop around the formaldimine
conical intersection (track_steps=4) gives the JAX loop's energies,
lowest Hessian eigenvalues and overlaps to 1e-8 and its Berry phase to
1e-8; the loop's states handed across (utils.interop) give the same
overlaps in either package to 1e-12; the (6e,6o) sector arc keeps the
JAX test's physics contract (overlaps real, above 0.97).
"""

import numpy as np
import pytest
import torch

from auto_oo_tpu import Moldata as JMoldata, get_formal_geo
from auto_oo_tpu.models import Parameterized_circuit as JPC
from auto_oo_tpu.models import berry as jberry
from auto_oo_tpu.ops import fermion as jfermion
import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.models import berry
from auto_oo_tpu_torch.utils import interop

ACT = np.arange(3)


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's default device is the card; these CPU tests ask for the
    CPU, and restore the default after the module."""
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


def _m_cases():
    """The four M of tests/test_berry.py:60-70: orthogonal, reflecting
    (det < 0), non-orthogonal, and diag(-1, -1, 1)."""
    rng = np.random.RandomState(0)
    q = np.linalg.qr(rng.randn(3, 3))[0]
    return {"orthogonal": q,
            "reflecting": np.linalg.qr(rng.randn(3, 3))[0]
            * np.array([1, 1, -1]),
            "non_orthogonal": (np.linalg.qr(rng.randn(3, 3))[0]
                               + 0.05 * rng.randn(3, 3)),
            "diag_flip": np.diag([-1.0, -1.0, 1.0])}


@pytest.mark.parametrize("case", list(_m_cases()))
def test_factors_equal_jax(case):
    """givens_angles and transfer_factors are host numpy in both
    packages: the same rotations, flip and singular values to 1e-14."""
    M = _m_cases()[case]
    rw, fw, rv, sigma = berry.transfer_factors(M)
    jrw, jfw, jrv, jsigma = jberry.transfer_factors(M)
    assert fw == jfw
    for mine, ref in ((rw, jrw), (rv, jrv)):
        assert [r[:2] for r in mine] == [r[:2] for r in ref]
        np.testing.assert_allclose([r[2] for r in mine],
                                   [r[2] for r in ref], rtol=0, atol=1e-14)
    np.testing.assert_allclose(sigma, jsigma, rtol=0, atol=1e-14)
    R = np.linalg.qr(np.random.RandomState(9).randn(4, 4))[0]
    R[:, -1] *= np.sign(np.linalg.det(R))
    for (i, j, t), (ji, jj, jt) in zip(berry.givens_angles(R),
                                       jberry.givens_angles(R)):
        assert (i, j) == (ji, jj) and abs(t - jt) < 1e-14


@pytest.mark.parametrize("case", list(_m_cases()))
def test_transfer_equals_jax_and_host_oracle(case):
    """The port's device transfer (Givens gate programs + occupation
    weights) equals the JAX package's transfer_state and both host
    oracles (the port's and the JAX package's expm_multiply) to 1e-12."""
    M = _m_cases()[case]
    rng = np.random.RandomState(1)
    psi = rng.randn(1 << 6)
    psi /= np.linalg.norm(psi)
    mine = berry.transfer_state(torch.as_tensor(psi), M.T, ACT, 3)
    assert isinstance(mine, torch.Tensor) and mine.device.type == "cpu"
    mine = mine.numpy()
    ref = np.asarray(jberry.transfer_state(psi, M.T, ACT, 3))
    host = berry.transfer_state_host(psi, M.T, ACT, 3)
    jhost = jberry.transfer_state_host(psi, M.T, ACT, 3)
    assert np.max(np.abs(mine - ref)) < 1e-12
    assert np.max(np.abs(mine - host)) < 1e-12
    assert np.max(np.abs(host - jhost)) < 1e-12


def test_transfer_sector_basis():
    """A sector-basis transfer (dets = the (3e,3o)-with-4-electrons
    basis) equals the full-space oracle projected and the JAX package's
    sector transfer, to 1e-12 (tests/test_berry.py:87-104)."""
    rng = np.random.RandomState(3)
    basis = jfermion.sector_basis(3, 4)
    assert np.array_equal(basis, P.Parameterized_circuit(
        3, 4, ansatz="ucc", sector=True).sector_basis)
    psi = np.zeros(1 << 6)
    psi[basis] = rng.randn(len(basis))
    psi /= np.linalg.norm(psi)
    M = (np.linalg.qr(rng.randn(3, 3))[0] + 0.03 * rng.randn(3, 3))
    ref = berry.transfer_state_host(psi, M.T, ACT, 3)
    mine = berry.transfer_state(psi[basis], M.T, ACT, 3, dets=basis)
    jmine = np.asarray(jberry.transfer_state(psi[basis], M.T, ACT, 3,
                                             dets=basis))
    assert np.max(np.abs(mine.numpy() - ref[basis])) < 1e-12
    assert np.max(np.abs(mine.numpy() - jmine)) < 1e-12


def test_transfer_fci_self_consistency():
    """Transferring the CAS ground state of MO basis A into basis B gives
    the ground state computed in B, up to sign (tests/test_berry.py:21-
    53), on the port's own FCI oracle."""
    from scipy.linalg import expm as sexpm

    from auto_oo_tpu_torch.moldata import fci

    mol = P.Moldata(get_formal_geo(140, 80), "sto-3g")
    mol.run_rhf()
    occ, act, _ = mol.get_active_space_idx(2, 2)

    def cas_ground(C):
        h1, g2 = mol._mo_ints(C)
        core, h_eff, g_act = fci.active_space_integrals_np(h1, g2, occ, act)
        res = fci.solve_cas(core + mol.nuc, h_eff, 0.5 * g_act, 2, 2,
                            n_roots=1)
        return res.e_tot[0], res.vecs_full[0]

    C_a = np.asarray(mol.hf.mo_coeff)
    k = np.zeros((mol.nao, mol.nao))
    k[act[0], act[1]], k[act[1], act[0]] = 0.3, -0.3
    C_b = C_a @ sexpm(-k)
    e_a, v_a = cas_ground(C_a)
    e_b, v_b = cas_ground(C_b)
    assert abs(e_a - e_b) < 1e-10
    ovlp = np.asarray(mol.overlap)
    oao_a = P.models.mo_ao_to_mo_oao(C_a, ovlp)
    oao_b = P.models.mo_ao_to_mo_oao(C_b, ovlp)
    moved = berry.transfer_state(np.asarray(v_a),
                                 np.asarray(oao_a).T @ np.asarray(oao_b),
                                 act, 2)
    assert abs(abs(float(np.asarray(v_b) @ moved.numpy())) - 1.0) < 1e-8


def _loop_geos(n_points):
    ts = np.linspace(0, 1, n_points)
    return [get_formal_geo(130 + 10 * np.cos(2 * np.pi * t + np.pi / 20),
                           89.9 + 10 * np.sin(2 * np.pi * t + np.pi / 20))
            for t in ts]


@pytest.fixture(scope="module")
def loops():
    """The 5-point (2e,2o) np_fabric L=1 loop, track_steps=4, in both
    packages (CPU JAX ~13 s)."""
    geos = _loop_geos(5)
    kw = dict(conv_tol=1e-10, track_steps=4, track_tol=1e-10)
    jpqc = JPC(2, 2, ansatz="np_fabric", n_layers=1)
    jloop = jberry.BerryPhaseLoop(geos, "sto-3g", 2, 2, jpqc,
                                  freeze_active=True).run(**kw)
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)
    loop = P.BerryPhaseLoop(geos, "sto-3g", 2, 2, pqc,
                            freeze_active=True).run(**kw)
    return jloop, loop


def test_loop_equals_jax(loops):
    """Per-point energies, lowest Hessian eigenvalues and overlaps within
    1e-8 of the JAX loop, the Berry phase within 1e-8 of JAX's and +-pi
    (the loop encircles the conical intersection)."""
    jloop, loop = loops
    assert len(loop.energy_l) == len(jloop.energy_l) == 5
    np.testing.assert_allclose(loop.energy_l, jloop.energy_l, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(loop.hess_eig_l, jloop.hess_eig_l, rtol=0,
                               atol=1e-8)
    ov, jov = loop.overlaps(), jloop.overlaps()
    assert ov.dtype == np.complex128
    assert np.max(np.abs(ov - jov)) < 1e-8
    phase = loop.berry_phase()
    assert abs(phase - jloop.berry_phase()) < 1e-8
    assert abs(abs(phase) - np.pi) < 1e-6
    assert np.array_equal(loop.act_idx, jloop.act_idx)


def test_loop_state_handed_across(loops):
    """The JAX loop's (theta, oao) at every point, handed to the port
    (interop.berry_loop_from_jax), give the JAX loop's states and
    overlaps to 1e-12: the transfer alone, free of trajectory rounding;
    and the port's states handed back give the port's overlaps in the
    JAX package."""
    jloop, loop = loops
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)
    moved = interop.berry_loop_from_jax(jloop, pqc)
    assert isinstance(moved, berry.BerryPhaseLoop)
    assert moved.energy_l == jloop.energy_l
    for s, js in zip(moved.states(), jloop.states()):
        assert np.max(np.abs(s.numpy() - np.asarray(js))) < 1e-12
    assert np.max(np.abs(moved.overlaps() - jloop.overlaps())) < 1e-12
    jloop.theta_l = [th.numpy() for th in loop.theta_l]
    jloop.oao_mo_coeff_l = [c.numpy() for c in loop.oao_mo_coeff_l]
    assert np.max(np.abs(jloop.overlaps() - loop.overlaps())) < 1e-12


def test_loop_checkpoint_warm_start(loops, tmp_path):
    """The loop's warm start crosses a checkpoint file: point 2 of the
    port loop saved, resumed by an OO_pqc at point 3's geometry, and one
    tracking iteration from there equals the loop's first tracking
    iteration at point 3."""
    from auto_oo_tpu_torch.utils import checkpoint

    _, loop = loops
    pqc = loop.pqc
    path = tmp_path / "point2.npz"
    checkpoint.save_state(path, loop.theta_l[2], loop.oao_mo_coeff_l[2],
                          energy=loop.energy_l[2])
    oo = P.OO_pqc(pqc, P.Moldata(loop.geometries[3], "sto-3g"), 2, 2,
                  freeze_active=True)
    theta = checkpoint.resume(oo, path)
    e_direct = P.OO_pqc(pqc, P.Moldata(loop.geometries[3], "sto-3g"), 2, 2,
                        oao_mo_coeff=loop.oao_mo_coeff_l[2],
                        freeze_active=True)._nr_iteration(
        loop.theta_l[2], loop.oao_mo_coeff_l[2], *berry._TRACK_STEP)[3]
    e_resumed = oo._nr_iteration(theta, oo.oao_mo_coeff,
                                 *berry._TRACK_STEP)[3]
    assert e_resumed == e_direct


def test_sector_loop_equals_full_space(loops):
    """The same 5-point loop in sector mode (the fused route: states,
    tracking and the transfer on sector vectors) gives the full-space
    loop's energies and Berry phase."""
    _, loop = loops
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1,
                                  sector=True)
    sloop = P.BerryPhaseLoop(loop.geometries, "sto-3g", 2, 2, pqc).run(
        conv_tol=1e-10, track_steps=4, track_tol=1e-10)
    np.testing.assert_allclose(sloop.energy_l, loop.energy_l, rtol=0,
                               atol=1e-8)
    assert abs(sloop.berry_phase() - loop.berry_phase()) < 1e-8


def test_6e6o_sector_arc_contract():
    """The (6e,6o) sector arc (tests/test_berry.py:157-195): three
    geometries, the circuit on D = 400; the JAX package's own run from
    theta = 1e-13 leaves its unperturbed one by 1.4e-4 Ha at point 0
    (scripts/full_space_anchors.py berry_6e6o_sector --perturb 1e-13), so
    the port is held to the JAX test's contract: finite energies, and
    overlaps real, above 0.97."""
    geos = [get_formal_geo(140 + 0.25 * k, 80 + 0.25 * k) for k in range(3)]
    pqc = P.Parameterized_circuit(6, 6, ansatz="np_fabric", n_layers=2,
                                  sector=True)
    assert pqc.state_dim == 400
    loop = P.BerryPhaseLoop(geos, "sto-3g", 6, 6, pqc).run(
        conv_tol=1e-9, max_iterations=30, track_steps=6, track_tol=1e-9)
    assert len(loop.energy_l) == 3 and np.all(np.isfinite(loop.energy_l))
    ov = loop.overlaps()
    assert np.all(ov.real > 0.97)
    assert np.all(np.abs(ov.imag) < 1e-10)


def test_run_batched_names_its_item():
    """run_batched runs (tests/test_torch_batch.py), and on a DeviceMesh
    of dp ranks (tests/test_torch_parallel.py); a ``mesh`` that is not a
    DeviceMesh raises a TypeError that names what it must be."""
    loop = P.BerryPhaseLoop(_loop_geos(3), "sto-3g", 2, 2,
                            P.Parameterized_circuit(2, 2))
    with pytest.raises(TypeError, match="DeviceMesh"):
        loop.run_batched(mesh=object(), track_steps=1)


def test_run_casscf_and_verbose(capsys):
    """run_casscf records the host CASSCF energy of every point; the
    tracked energies lie above it (the L=1 fabric is exact at (2e,2o),
    so within 1e-6 Ha once tracked)."""
    geos = _loop_geos(3)
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)
    loop = P.BerryPhaseLoop(geos, "sto-3g", 2, 2, pqc,
                            run_casscf=True).run(track_steps=6,
                                                 track_tol=1e-10,
                                                 verbose=1)
    assert len(loop.casscf_energy_l) == 3
    assert np.max(np.abs(np.array(loop.energy_l)
                         - loop.casscf_energy_l)) < 1e-6
    assert "Energy at step 2" in capsys.readouterr().out
    jmol = JMoldata(geos[0], "sto-3g")
    jmol.run_casscf(2, 2)
    assert abs(loop.casscf_energy_l[0] - jmol.casscf.e_tot) < 1e-8
