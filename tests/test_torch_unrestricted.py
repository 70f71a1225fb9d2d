"""Spin-resolved RDMs and the up-then-down ordering in the port against
the JAX package.

Mirrors tests/test_unrestricted.py and
tests/utils/test_misc.py::test_restricted_to_unrestricted_shapes.  Same
seeded numpy states into both packages, elementwise at 1e-13: the
spin-resolved RDMs in the full space, over the flat sector maps and on
the string grid (real and complex states), the cross-sector pair maps
entry by entry, one spin component of Phi (``phi_all(spin=...)``, the
gather_rows_scaled kernel's plain version here), up-then-down RDMs and
``ham_apply`` with the up-then-down maps, three NR iterations of an
up-then-down circuit (1e-10), ``reorder_unrestricted_rdms`` (an exact
round trip) and ``restricted_to_unrestricted``; the sparse oracles and
the spectrum invariance of the ordering as in the JAX test.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import auto_oo_tpu as J
from auto_oo_tpu.models import OO_pqc as JOO
from auto_oo_tpu.models import Parameterized_circuit as JPC
from auto_oo_tpu.ops import fermion as jfermion
from auto_oo_tpu.ops import grid as jgrid
from auto_oo_tpu.ops import hamiltonian as jham
from auto_oo_tpu.ops import rdms as jrdms
from auto_oo_tpu.ops.spin_embed import restricted_to_unrestricted as jr2u
from auto_oo_tpu.simulator import sector as jsector
import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.ops import fermion, grid, hamiltonian, rdms
from auto_oo_tpu_torch.ops.spin_embed import restricted_to_unrestricted
from auto_oo_tpu_torch.simulator import sector
from auto_oo_tpu_torch.utils.interop import from_jax


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's default device is the card; these CPU tests ask for the
    CPU, and restore the default after the module."""
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


TOL = 1e-13


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(torch.as_tensor(port).numpy(),
                               np.asarray(ref), rtol=0, atol=tol)


def _random_state(D, seed, complex_=False):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(D)
    if complex_:
        psi = psi + 1j * rng.standard_normal(D)
    return psi / np.linalg.norm(psi)


def _phased(psi, seed):
    """psi times a seeded per-determinant phase."""
    phase = np.random.default_rng(seed).uniform(0, 2 * np.pi, psi.size)
    return psi * np.exp(1j * phase)


@pytest.mark.parametrize("ncas,complex_", [(2, False), (2, True),
                                           (3, False), (3, True)])
def test_full_space_unrestricted_rdms(ncas, complex_):
    """rdms_from_state_unrestricted of a random full-space state equals
    the JAX package's elementwise; the tables equal its tables."""
    psi = _random_state(1 << (2 * ncas), ncas, complex_)
    gj, Gj = jrdms.rdms_from_state_unrestricted(jnp.asarray(psi), ncas)
    gp, Gp = rdms.rdms_from_state_unrestricted(torch.as_tensor(psi), ncas)
    assert gp.dtype == Gp.dtype == torch.float64
    _close(gp, gj)
    _close(Gp, Gj)
    src_j, sign_j = jfermion.pair_annihilation_gather(ncas)
    src_p, sign_p = fermion.pair_annihilation_gather(ncas)
    np.testing.assert_array_equal(src_p, src_j)
    np.testing.assert_array_equal(sign_p, sign_j)


def test_unrestricted_rdms_match_sparse_oracles():
    """Port RDMs of a complex (2e,2o) state against the port's sparse
    operators, and those against the JAX package's (the JAX test's
    oracle)."""
    ncas, nm = 2, 4
    psi = _random_state(16, 3, True)
    pqc = P.Parameterized_circuit(ncas, 2, ansatz="ucc")
    g, G = pqc.get_rdms_from_state(psi, restricted=False)
    for p in range(nm):
        for q in range(nm):
            op = fermion.apq_sparse(p, q, ncas)
            assert (op != jfermion.apq_sparse(p, q, ncas)).nnz == 0
            assert abs(float(g[p, q]) - np.real(np.vdot(psi, op @ psi))) \
                < 1e-12
    rng = np.random.RandomState(0)
    quads = {tuple(rng.randint(0, nm, size=4)) for _ in range(40)}
    quads |= {(0, 1, 2, 3), (0, 2, 1, 3), (1, 3, 3, 1), (2, 0, 0, 2)}
    for p, q, r, s in quads:
        op = fermion.apqrs_sparse(p, q, r, s, ncas)
        assert abs(op - jfermion.apqrs_sparse(p, q, r, s, ncas)).max() == 0
        assert abs(float(G[p, q, r, s])
                   - np.real(np.vdot(psi, op @ psi))) < 1e-12
    for p, q, r, s in [(0, 1, 1, 0), (1, 0, 0, 1), (0, 0, 1, 1)]:
        a = fermion.epqrs_sparse(p, q, r, s, ncas, True)
        b = jfermion.epqrs_sparse(p, q, r, s, ncas, True)
        assert abs(a - b).max() == 0


def test_restricted_from_unrestricted_sum_rule():
    """gamma^R = the spin sum of gamma^U; Gamma^R_pqrs = sum_{sigma tau}
    Gamma^U_(p sigma)(r tau)(s tau)(q sigma) (chemist order)."""
    pqc = P.Parameterized_circuit(2, 2, ansatz="ucc")
    theta = [0.4217]
    g_r, G_r = pqc.get_rdms(theta)
    g_u, G_u = pqc.get_rdms(theta, restricted=False)
    n = 2
    gs = g_u.reshape(n, 2, n, 2).diagonal(dim1=1, dim2=3).sum(-1)
    torch.testing.assert_close(g_r, gs, rtol=0, atol=1e-12)
    acc = torch.zeros_like(G_r)
    for sg in range(2):
        for tu in range(2):
            # Gamma^U[(p,sg), (r,tu), (s,tu), (q,sg)] as [p, r, s, q]
            acc += G_u[sg::2, tu::2, tu::2, sg::2].permute(0, 3, 1, 2)
    torch.testing.assert_close(G_r, acc, rtol=0, atol=1e-12)


@pytest.mark.parametrize("ncas,nelecas", [(4, 3), (4, 4), (3, (2, 1))])
def test_sector_pair_maps_equal_jax(ncas, nelecas):
    """The cross-sector pair-annihilation maps, built on the device with
    searchsorted, equal the JAX package's host tables entry by entry."""
    mj = jsector.sector_pair_annihilation_maps(ncas, nelecas)
    mp = sector.sector_pair_annihilation_maps(ncas, nelecas)
    assert sorted(mj) == sorted(mp)
    for name in mj:
        for a, b in zip(mp[name], mj[name]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("ncas,nelecas,complex_", [
    (4, 3, False), (4, 4, True), (3, (2, 1), True)])
def test_sector_unrestricted_rdms_flat_and_grid(ncas, nelecas, complex_):
    """Spin-resolved RDMs of a sector state over the flat sector maps and
    over the grid maps equal the JAX package's flat route elementwise;
    the flat sector maps equal its tables."""
    basis = fermion.sector_basis(ncas, nelecas)
    psi = _random_state(basis.size, 11, complex_)
    jmaps = jsector.sector_epq_maps(ncas, nelecas)
    fmaps = sector.sector_epq_maps(ncas, nelecas)
    np.testing.assert_array_equal(fmaps.src.numpy(), np.asarray(jmaps[0]))
    np.testing.assert_array_equal(fmaps.sign.numpy(), np.asarray(jmaps[1]))
    gj, Gj = jsector.rdms_from_sector_state_unrestricted(
        jnp.asarray(psi), jmaps,
        jsector.sector_pair_annihilation_maps(ncas, nelecas), ncas)
    umaps = sector.sector_pair_annihilation_maps(ncas, nelecas)
    gm = grid.build_grid_maps(ncas, nelecas)
    for maps in (fmaps, gm):
        gp, Gp = sector.rdms_from_sector_state_unrestricted(
            torch.as_tensor(psi), maps, umaps, ncas)
        _close(gp, gj)
        _close(Gp, Gj)


@pytest.mark.parametrize("ncas,nelecas", [(4, 3), (4, 4), (3, 2)])
def test_circuit_sector_unrestricted_matches_jax_and_full_space(ncas,
                                                                nelecas):
    """get_rdms(restricted=False) of a sector circuit equals the JAX
    package's and the full-space circuit's; get_rdms_from_state of the
    phased (complex) sector state equals the JAX package's, restricted and
    spin-resolved, and the phase-free part of each RDM is unchanged by a
    global phase (tests/test_custom_complex.py)."""
    kw = dict(ansatz="np_fabric", n_layers=1)
    jp = JPC(ncas, nelecas, sector=True, **kw)
    pp = P.Parameterized_circuit(ncas, nelecas, sector=True, **kw)
    pf = P.Parameterized_circuit(ncas, nelecas, **kw)
    theta = 0.07 * np.arange(pp.theta_shape) + 0.1
    gj, Gj = jp.get_rdms(jnp.asarray(theta), restricted=False)
    gp, Gp = pp.get_rdms(theta, restricted=False)
    gf, Gf = pf.get_rdms(theta, restricted=False)
    for a in (gp, gf):
        _close(a, gj)
    for a in (Gp, Gf):
        _close(a, Gj)
    psi = pp.state(theta).numpy()
    psi_c = _phased(psi, ncas)
    for restricted in (True, False):
        gj, Gj = jp.get_rdms_from_state(jnp.asarray(psi_c),
                                        restricted=restricted)
        gp, Gp = pp.get_rdms_from_state(psi_c, restricted=restricted)
        _close(gp, gj)
        _close(Gp, Gj)
        g0, G0 = pp.get_rdms_from_state(psi, restricted=restricted)
        g1, G1 = pp.get_rdms_from_state(psi * np.exp(0.7j),
                                        restricted=restricted)
        torch.testing.assert_close(g1, g0, rtol=0, atol=1e-13)
        torch.testing.assert_close(G1, G0, rtol=0, atol=1e-13)


@pytest.mark.parametrize("spin", [0, 1])
@pytest.mark.parametrize("complex_", [False, True])
def test_phi_one_spin_matches_jax(spin, complex_):
    """phi_all(x, gm, spin) equals the JAX package's one-spin Phi: spin 0
    in grid order, spin 1 in the transposed grid order of
    ``transpose_grid``; a batch of states too."""
    ncas, nelecas = 4, (2, 1)
    jm = jgrid.build_grid_maps(ncas, nelecas)
    gm = grid.build_grid_maps(ncas, nelecas)
    x = np.stack([_random_state(gm.dim, s, complex_) for s in (1, 2)])
    ref = np.asarray(jgrid.phi_all(jnp.asarray(x), jm, spin=spin))
    out = grid.phi_all(torch.as_tensor(x), gm, spin=spin)
    if spin == 1:
        ref = ref.reshape(2, gm.n2, gm.Na, gm.Nb).swapaxes(-1, -2).reshape(
            2, gm.n2, gm.dim)
        np.testing.assert_array_equal(
            grid.transpose_grid(torch.as_tensor(x), gm).numpy(),
            x.reshape(2, gm.Na, gm.Nb).swapaxes(-1, -2).reshape(2, -1))
    _close(out, ref, 1e-15)
    both = grid.phi_all(torch.as_tensor(x), gm)
    _close(both, np.asarray(jgrid.phi_all(jnp.asarray(x), jm)), 1e-14)


def _utd_program():
    """A (4e,4o) kupccd gate program carried across from the JAX
    package, to be read in the up-then-down ordering."""
    jprog = JPC(4, 4, ansatz="kupccd", k=1).program
    return jprog, from_jax(jprog)


def test_up_then_down_rdms_and_ham_apply():
    """With up_then_down the flat maps, the RDMs of a random state and
    H|chi> equal the JAX package's up-then-down kernels and its sparse
    up-then-down operators; a GateProgram circuit read up-then-down gives
    the JAX package's restricted and spin-resolved RDMs."""
    ncas = 2
    psi = _random_state(16, 7)
    maps = rdms.build_flat_maps(ncas, up_then_down=True)
    src, sign = fermion.epq_gather(ncas, True)
    np.testing.assert_array_equal(src, jfermion.epq_gather(ncas, True)[0])
    gamma, Gamma = rdms.rdms_from_state(torch.as_tensor(psi), ncas, maps)
    gj, Gj = jrdms.rdms_from_state(jnp.asarray(psi), ncas, up_then_down=True)
    _close(gamma, gj)
    _close(Gamma, Gj)
    for p in range(ncas):
        for q in range(ncas):
            ref = psi @ (fermion.epq_sparse(p, q, ncas, True) @ psi)
            assert abs(float(gamma[p, q]) - ref) < 1e-12
    rng = np.random.default_rng(4)
    c1 = rng.standard_normal((ncas, ncas))
    c2 = rng.standard_normal((ncas,) * 4)
    chi = np.stack([_random_state(16, 8, True), _random_state(16, 9, True)])
    c1eff = jham.c1_effective(jnp.asarray(c1), jnp.asarray(c2))
    ref = jham.ham_apply(c1eff, jnp.asarray(c2), jnp.asarray(chi), ncas,
                         up_then_down=True)
    out = hamiltonian.ham_apply(torch.as_tensor(np.array(c1eff)),
                                torch.as_tensor(c2), torch.as_tensor(chi),
                                ncas, maps)
    _close(out, ref, 1e-12)
    e = hamiltonian.energy_quadratic(0.5, torch.as_tensor(c1),
                                     torch.as_tensor(c2),
                                     torch.as_tensor(chi[0]), ncas, maps)
    e_j = jham.energy_quadratic(0.5, jnp.asarray(c1), jnp.asarray(c2),
                                jnp.asarray(chi[0]), ncas, True)
    assert abs(float(e) - float(e_j)) < 1e-12
    jprog, prog = _utd_program()
    jpc = JPC(4, 4, ansatz=jprog, up_then_down=True)
    ppc = P.Parameterized_circuit(4, 4, ansatz=prog, up_then_down=True)
    assert ppc.up_then_down
    theta = 0.3 * np.random.default_rng(2).standard_normal(prog.n_params)
    for restricted in (True, False):
        gj, Gj = jpc.get_rdms(jnp.asarray(theta), restricted=restricted)
        gp, Gp = ppc.get_rdms(theta, restricted=restricted)
        _close(gp, gj)
        _close(Gp, Gj)


def test_up_then_down_nr_trajectory_matches_jax():
    """Three damped-Newton iterations of the up-then-down (4e,4o)
    program circuit: energies within 1e-10 of the JAX package's."""
    jprog, prog = _utd_program()
    mj = J.Moldata(J.get_formal_geo(140, 80), "sto-3g")
    mp = P.Moldata(J.get_formal_geo(140, 80), "sto-3g")
    jo = JOO(JPC(4, 4, ansatz=jprog, up_then_down=True), mj, 4, 4,
             freeze_active=True)
    po = P.OO_pqc(P.Parameterized_circuit(4, 4, ansatz=prog,
                                          up_then_down=True), mp, 4, 4,
                  freeze_active=True)
    theta = 0.05 * np.random.default_rng(3).standard_normal(prog.n_params)
    el_j, *_ = jo.full_optimization(jnp.asarray(theta), max_iterations=3)
    el_p, *_ = po.full_optimization(theta, max_iterations=3)
    np.testing.assert_allclose(el_p, el_j, rtol=0, atol=1e-10)


def test_up_then_down_hamiltonian_spectrum_invariance():
    """A CAS Hamiltonian built from the port's up-then-down operators has
    the spectrum of the interleaved one (mode relabeling is a signed
    unitary; the JAX test's check)."""
    ncas = 2
    rng = np.random.RandomState(5)
    c1 = rng.randn(ncas, ncas)
    c1 = c1 + c1.T
    c2 = rng.randn(ncas, ncas, ncas, ncas)
    c2 = c2 + c2.transpose(1, 0, 3, 2)

    def ham(utd):
        D = 1 << (2 * ncas)
        H = np.zeros((D, D))
        for p in range(ncas):
            for q in range(ncas):
                H += c1[p, q] * fermion.epq_sparse(p, q, ncas, utd).toarray()
                for r in range(ncas):
                    for s in range(ncas):
                        H += c2[p, q, r, s] * fermion.epqrs_sparse(
                            p, q, r, s, ncas, utd).toarray()
        return H

    np.testing.assert_allclose(np.linalg.eigvalsh(ham(True)),
                               np.linalg.eigvalsh(ham(False)), rtol=0,
                               atol=1e-10)


def test_reorder_unrestricted_rdms_roundtrip_and_jax():
    """The mode permutation equals the JAX package's and its round trip
    is exact."""
    ncas = 2
    psi = torch.as_tensor(_random_state(16, 5))
    g_i, G_i = rdms.rdms_from_state_unrestricted(psi, ncas)
    g_p, G_p = fermion.reorder_unrestricted_rdms(g_i, G_i, ncas)
    gj, Gj = jfermion.reorder_unrestricted_rdms(g_i.numpy(), G_i.numpy(),
                                                ncas)
    np.testing.assert_array_equal(g_p.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(G_p.numpy(), np.asarray(Gj))
    g_b, G_b = fermion.reorder_unrestricted_rdms(g_p, G_p, ncas,
                                                 to_up_then_down=False)
    assert torch.equal(g_b, g_i) and torch.equal(G_b, G_i)
    # the permuted RDMs are those of the state read in the up-then-down
    # labels: the JAX package's own up-then-down kernel on the same state
    # gives the permuted spin-summed gamma
    n = ncas
    gr = torch.stack([g_p[s * n:(s + 1) * n, s * n:(s + 1) * n]
                      for s in range(2)]).sum(0)
    g_ref, _ = rdms.rdms_from_state(psi, ncas, rdms.build_flat_maps(ncas))
    torch.testing.assert_close(gr, g_ref, rtol=0, atol=1e-13)


@pytest.mark.parametrize("shape,atb", [((2, 2), False), ((2, 2), True),
                                       ((2, 2, 2, 2), False),
                                       ((3, 3), True)])
def test_restricted_to_unrestricted(shape, atb):
    """The spin embedding equals the JAX package's; the interleaved 1e
    embedding puts h on the same-spin blocks and zero across."""
    t = np.random.RandomState(0).randn(*shape)
    out = restricted_to_unrestricted(torch.as_tensor(t), atb)
    assert out.shape == tuple(2 * n for n in shape)
    _close(out, jr2u(jnp.asarray(t), atb), 0.0)
    if len(shape) == 2 and not atb:
        h = torch.as_tensor(t)
        torch.testing.assert_close(out[::2, ::2], h)
        torch.testing.assert_close(out[1::2, 1::2], h)
        assert float(out[::2, 1::2].abs().max()) == 0.0
    with pytest.raises(ValueError):
        restricted_to_unrestricted(torch.zeros(2, 2, 2))
