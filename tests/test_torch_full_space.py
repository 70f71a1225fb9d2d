"""The port's full-space route (``sector=False``) against the JAX package.

Same seeded numpy inputs into both packages, at the JAX package's own
tolerances: states against the reference goldens (tests/goldens.py) and
against the JAX states; the flat sweeps' J against jax.jacfwd and their
Hessian term against jax.jacfwd(jax.grad) to 1e-12; the flat E_pq maps
equal to the JAX package's tables and to its bit-arithmetic form;
``apply_epq_all``, RDMs and ``ham_apply`` to 1e-12; ``grad_hess`` e0 and
grad to 1e-11 and the Hessian to 1e-9 from a random theta and a rotated
OAO matrix carried across by ``from_jax``; 3-iteration NR trajectories to
1e-10; (2e,2o) ``full_optimization`` equal to CASSCF to 1e-8; a prebuilt
GateProgram projected onto its sector and factorized onto the grid equal
to the built-in grid program; a JAX GateProgram carried across by
``from_jax``; and ``draw_circuit`` / ``dirac_notation`` text.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.linalg import expm

import auto_oo_tpu as J
from auto_oo_tpu.models import OO_pqc as JOO
from auto_oo_tpu.models import Parameterized_circuit as JPC
from auto_oo_tpu.ops import fermion as jfermion
from auto_oo_tpu.ops import hamiltonian as jham
from auto_oo_tpu.ops import rdms as jrdms
from auto_oo_tpu.simulator import ansatze as JA
from auto_oo_tpu.simulator import gates as JG
from auto_oo_tpu.simulator import grid_program as jgp
from auto_oo_tpu.simulator import sector as jsector
from auto_oo_tpu.simulator.circuit import dirac_notation as jdirac
from auto_oo_tpu.simulator.program import GateProgram as JGateProgram
import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.ops import hamiltonian, rdms
from auto_oo_tpu_torch.simulator import ansatze as A
from auto_oo_tpu_torch.simulator import grid_program, sector
from auto_oo_tpu_torch.simulator.gates import PairGate
from auto_oo_tpu_torch.simulator.program import GateProgram
from auto_oo_tpu_torch.utils.interop import from_jax
from .goldens import STATE_GOLDENS


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's default device is the card; these CPU tests ask for the
    CPU, and restore the default after the module."""
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


GEO = J.get_formal_geo(140, 80)
E_CASSCF_2E2O = -92.74923230445957

# (ncas, nelecas, circuit kwargs, charge/spin of the molecule)
CASES = {
    "ucc_2e2o": (2, 2, dict(ansatz="ucc"), {}),
    "uccsd_3e3o_doublet": (3, (2, 1), dict(ansatz="ucc", add_singles=True),
                           dict(charge=1, spin=1)),
    "np_fabric_4e4o": (4, 4, dict(ansatz="np_fabric", n_layers=1), {}),
    "kupccd_4e4o": (4, 4, dict(ansatz="kupccd", k=1), {}),
}


@pytest.fixture(scope="module")
def molecules():
    cache = {}

    def get(molkw):
        key = tuple(sorted(molkw.items()))
        if key not in cache:
            cache[key] = (J.Moldata(GEO, "sto-3g", **molkw),
                          P.Moldata(GEO, "sto-3g", **molkw))
        return cache[key]
    return get


@pytest.fixture(scope="module")
def circuits():
    """(JAX, port) full-space circuits per case, one pair for the module:
    the JAX package caches its compiled programs on the circuit."""
    cache = {}

    def get(name):
        if name not in cache:
            ncas, ne, kw, _ = CASES[name]
            cache[name] = (JPC(ncas, ne, **kw),
                           P.Parameterized_circuit(ncas, ne, **kw))
        return cache[name]
    return get


def _theta(n, seed, scale=0.4):
    return scale * np.random.default_rng(seed).standard_normal(n)


@pytest.mark.parametrize(
    "ncas,ne,add_s,ansatz,L,theta,ref_map", STATE_GOLDENS,
    ids=[f"{g[3]}-{g[0]}-{g[1]}-{g[2]}-{g[4]}" for g in STATE_GOLDENS])
def test_state_goldens(ncas, ne, add_s, ansatz, L, theta, ref_map):
    """The reference's golden statevectors (tests/test_pqc.py), with the
    JAX package's tolerance; and the JAX state to 1e-13."""
    kw = dict(ansatz=ansatz, n_layers=L or 3, add_singles=bool(add_s))
    psi = P.Parameterized_circuit(ncas, ne, **kw).state(theta).numpy()
    ref = np.zeros(psi.shape)
    for k, v in ref_map.items():
        ref[k] = v
    assert np.allclose(psi, ref, atol=2e-5)
    assert abs(np.linalg.norm(psi) - 1.0) < 1e-12
    jpsi = np.asarray(JPC(ncas, ne, **kw).state(jnp.asarray(theta)))
    np.testing.assert_allclose(psi, jpsi, rtol=0, atol=1e-13)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flat_sweeps_match_jax(circuits, name):
    """The flat program's state, its tangent-batched J against
    jax.jacfwd, and the reverse sweep's d2<w, psi>/dtheta2 against
    jax.jacfwd(jax.grad), on the same theta and w."""
    jp, pp = circuits(name)
    assert pp.state_dim == jp.state_dim == 4 ** jp.ncas
    assert pp.theta_shape == jp.theta_shape
    theta = _theta(jp.theta_shape, 3)
    w = np.random.default_rng(4).standard_normal(jp.state_dim)
    tables = jp._tables()

    def f(th):
        return jp._state_impl(th, tables)

    def refs(th):
        return (f(th), jax.jacfwd(f)(th).T,
                jax.jacfwd(jax.grad(lambda t: f(t) @ jnp.asarray(w)))(th))

    psi_j, J_j, H_j = (np.asarray(a) for a in
                       jax.jit(refs)(jnp.asarray(theta)))
    th = torch.from_numpy(theta)
    psi, Jp = pp._state_and_jacobian_grid(th)
    np.testing.assert_allclose(psi.numpy(), psi_j, rtol=0, atol=1e-13)
    np.testing.assert_allclose(pp.state(theta).numpy(), psi_j, rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(Jp.numpy(), J_j, rtol=0, atol=1e-12)
    H = pp._state_hessian_dot_grid(th, torch.from_numpy(w), psi, Jp)
    np.testing.assert_allclose(H.numpy(), H_j, rtol=0, atol=1e-12)
    # the gate step is out of place: torch.func agrees with the sweep
    Jf = torch.func.jacfwd(pp._state_impl_grid)(th)
    np.testing.assert_allclose(Jf.T.numpy(), Jp.numpy(), rtol=0,
                               atol=1e-13)


@pytest.mark.parametrize("ncas", [2, 3, 4])
def test_flat_maps_equal_jax_tables_and_bit_arithmetic(ncas, monkeypatch):
    """The port's (src, sign) tables equal the JAX package's tables, and
    its bit-arithmetic form (used above D = 2^16) on every entry the sign
    keeps (that form leaves an annihilated entry's src unmasked)."""
    maps = rdms.build_flat_maps(ncas)
    D = 4 ** ncas
    assert maps.src.dtype == torch.int32 and maps.sign.dtype == torch.int8
    assert tuple(maps.src.shape) == (2, ncas * ncas, D) == tuple(
        maps.sign.shape)
    for s in range(2):
        src_t, sign_t = (np.asarray(a) for a in jrdms._epq_tables_spin(
            ncas, False, s, "float64"))
        np.testing.assert_array_equal(maps.src[s].numpy(), src_t)
        np.testing.assert_array_equal(maps.sign[s].numpy(), sign_t)
    monkeypatch.setattr(jrdms, "_ONTHEFLY_MIN_DIM", 0)
    for s in range(2):
        src_b, sign_b = (np.asarray(a) for a in jrdms._epq_maps_spin(
            ncas, False, s, D, jnp.float64))
        sign = maps.sign[s].numpy()
        np.testing.assert_array_equal(sign, sign_b)
        np.testing.assert_array_equal(maps.src[s].numpy()[sign != 0],
                                      src_b[sign != 0])


@pytest.mark.parametrize("ncas", [2, 3, 4])
def test_epq_rdms_and_ham_apply_match(ncas):
    """apply_epq_all, the RDMs, ham_apply (batched and single) and the
    quadratic energy over the full space, to 1e-12."""
    maps = rdms.build_flat_maps(ncas)
    rng = np.random.default_rng(ncas)
    D = 4 ** ncas
    c1 = rng.standard_normal((ncas, ncas))
    c1 = c1 + c1.T
    c2 = rng.standard_normal((ncas,) * 4)
    c2 = c2 + c2.transpose(1, 0, 3, 2)
    x = rng.standard_normal((3, D))
    psi = x[0] / np.linalg.norm(x[0])

    phi_j = np.asarray(jrdms.apply_epq_all(jnp.asarray(psi), ncas))
    phi_p = rdms.apply_epq_all(torch.from_numpy(psi), ncas, maps)
    np.testing.assert_allclose(phi_p.numpy(), phi_j, rtol=0, atol=1e-12)
    phiB = rdms.apply_epq_all(torch.from_numpy(x), ncas, maps)
    assert tuple(phiB.shape) == (3, ncas * ncas, D)
    np.testing.assert_allclose(phiB[0].numpy() / np.linalg.norm(x[0]),
                               phi_j, rtol=0, atol=1e-12)

    gj, Gj = jrdms.rdms_from_state(jnp.asarray(psi), ncas)
    gp, Gp = rdms.rdms_from_state(torch.from_numpy(psi), ncas, maps)
    np.testing.assert_allclose(gp.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(Gp.numpy(), np.asarray(Gj), rtol=0,
                               atol=1e-12)

    c1e_j = jham.c1_effective(jnp.asarray(c1), jnp.asarray(c2))
    c1e_p = hamiltonian.c1_effective(torch.from_numpy(c1),
                                     torch.from_numpy(c2))
    ref = np.asarray(jham.ham_apply(c1e_j, jnp.asarray(c2), jnp.asarray(x),
                                    ncas))
    out = hamiltonian.ham_apply(c1e_p, torch.from_numpy(c2),
                                torch.from_numpy(x), ncas, maps)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)
    out1 = hamiltonian.ham_apply(c1e_p, torch.from_numpy(c2),
                                 torch.from_numpy(x[1]), ncas, maps)
    np.testing.assert_allclose(out1.numpy(), ref[1], rtol=0, atol=1e-12)

    e_j = float(jham.energy_quadratic(0.7, jnp.asarray(c1), jnp.asarray(c2),
                                      jnp.asarray(psi), ncas))
    e_p = float(hamiltonian.energy_quadratic(
        0.7, torch.from_numpy(c1), torch.from_numpy(c2),
        torch.from_numpy(psi), ncas, maps))
    assert abs(e_p - e_j) < 1e-12


def _oo_pair(molecules, circuits, name, seed=0):
    """JAX and port OO_pqc on the same full-space problem, both from the
    same rotated OAO-MO matrix; returns (jo, po, theta)."""
    ncas, ne, _, molkw = CASES[name]
    mj, mp = molecules(molkw)
    jp, pp = circuits(name)
    jo = JOO(jp, mj, ncas, ne, freeze_active=True)
    rng = np.random.default_rng(seed)
    M = 0.05 * rng.standard_normal((jo.nao, jo.nao))
    oao = np.asarray(jo.oao_mo_coeff) @ expm(M - M.T)
    jo.oao_mo_coeff = jnp.asarray(oao)
    po = P.OO_pqc(pp, mp, ncas, ne, freeze_active=True,
                  oao_mo_coeff=from_jax(oao))
    return jo, po, 0.3 * rng.standard_normal(jp.theta_shape)


@pytest.mark.parametrize("name", sorted(CASES))
def test_grad_hess_matches(molecules, circuits, name):
    jo, po, theta = _oo_pair(molecules, circuits, name)
    assert po._core["route"] == "flat" and po.n_kappa > 0
    e_j, g_j, h_j = jo._grad_hess_jit(jnp.asarray(theta), jo.oao_mo_coeff)
    e_p, g_p, h_p = po._grad_hess(from_jax(theta))
    assert abs(float(e_p) - float(e_j)) < 1e-11
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_j), rtol=0,
                               atol=1e-9)
    e_jt = float(jo.energy_from_parameters(jnp.asarray(theta)))
    assert abs(float(po.energy_from_parameters(theta)) - e_jt) < 1e-12


@pytest.mark.parametrize("name", sorted(CASES))
def test_nr_trajectory_matches(molecules, circuits, name):
    """Three damped-Newton iterations from init_zeros (the JAX package's
    OAO-MO matrix): energies to 1e-10, the lowest Hessian eigenvalues
    and the final OAO-MO matrix to 1e-8."""
    ncas, ne, _, molkw = CASES[name]
    mj, mp = molecules(molkw)
    jp, pp = circuits(name)
    jo = JOO(jp, mj, ncas, ne, freeze_active=True)
    po = P.OO_pqc(pp, mp, ncas, ne, freeze_active=True)
    el_j, _, _, _, eig_j = jo.full_optimization(jp.init_zeros(),
                                                max_iterations=3)
    el_p, _, _, _, eig_p = po.full_optimization(pp.init_zeros(),
                                                max_iterations=3)
    assert len(el_p) == len(el_j) == 3
    np.testing.assert_allclose(el_p, el_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(eig_p, eig_j, rtol=0, atol=1e-8)
    np.testing.assert_allclose(po.oao_mo_coeff.numpy(),
                               np.asarray(jo.oao_mo_coeff), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("kw,freeze_active", [
    (dict(ansatz="np_fabric", n_layers=1), True),     # the quick start
    (dict(ansatz="ucc"), False)])
def test_full_optimization_reaches_casscf(molecules, kw, freeze_active):
    """(2e,2o) in the full space converges to the CASSCF energy."""
    mj, mp = molecules({})
    pqc = P.Parameterized_circuit(2, 2, **kw)
    oo = P.OO_pqc(pqc, mp, 2, 2, freeze_active=freeze_active)
    energies, *_ = oo.full_optimization(pqc.init_zeros())
    assert abs(energies[-1] - E_CASSCF_2E2O) < 1e-8


def _flat_program(ncas, ne, kw):
    """The port's full-space GateProgram of a built-in ansatz."""
    if kw["ansatz"] == "ucc":
        return A.uccd_program(ncas, ne, kw.get("add_singles", False))
    if kw["ansatz"] == "np_fabric":
        return A.gatefabric_program(ncas, ne, kw["n_layers"])
    return A.kupccd_program(ncas, ne, k=kw["k"])


@pytest.mark.parametrize("name", ["uccsd_3e3o_doublet", "np_fabric_4e4o",
                                  "kupccd_4e4o"])
def test_projected_program_equals_builtin_grid(molecules, name):
    """A prebuilt full-space GateProgram with sector=True: its projection
    and factorization equal the JAX package's, and the circuit gives the
    built-in grid circuit's state and J, and its OO_pqc the built-in
    one's (e0, grad, hess) to 1e-12, 1e-11 and 1e-9 (np_fabric's prebuilt
    program also carries the parameters that the built-in one drops)."""
    ncas, ne, kw, molkw = CASES[name]
    jpc = JPC(ncas, ne, **kw)
    sp, basis = sector.project_program(from_jax(jpc.program), ncas, ne)
    jsp, jbasis = jsector.project_program(jpc.program, ncas, ne)
    np.testing.assert_array_equal(basis, jbasis)
    assert sp.init_idx == jsp.init_idx and len(sp.half) == len(jsp.half)
    for g in range(len(sp.half)):
        k = int(jsp.n_real_pairs[g])
        for port_tab, jax_tab in ((sp.ia, jsp.ia), (sp.ib, jsp.ib),
                                  (sp.sign, jsp.sign)):
            np.testing.assert_array_equal(port_tab[g], jax_tab[g, :k])
    gp = grid_program.factorize_program(sp, basis, ncas)
    jg = jgp.factorize_program(jsp, jbasis, ncas)
    assert len(gp.gates) == len(jg.gates) and gp.init_idx == jg.init_idx
    for a, b in zip(gp.gates, jg.gates):
        for f in ("Ai_src", "Ai_dst", "Bj_src", "Bj_dst", "sA", "sB",
                  "half", "param", "alpha_identity", "beta_identity"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))

    built = P.Parameterized_circuit(ncas, ne, sector=True, **kw)
    prebuilt = P.Parameterized_circuit(ncas, ne, sector=True,
                                       ansatz=_flat_program(ncas, ne, kw))
    assert prebuilt.theta_shape == prebuilt.program.n_params
    np.testing.assert_array_equal(prebuilt.sector_basis, built.sector_basis)
    theta = torch.from_numpy(_theta(built.theta_shape, 5))
    full = built._expand_theta(theta)
    tang = torch.as_tensor(built._tangent_params)
    psi_b, J_b = built._state_and_jacobian_grid(theta)
    psi_p, J_p = prebuilt._state_and_jacobian_grid(full)
    np.testing.assert_allclose(psi_p.numpy(), psi_b.numpy(), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(J_p[tang].numpy(), J_b.numpy(), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(prebuilt.state(full).numpy(),
                               built.state(theta).numpy(), rtol=0,
                               atol=1e-13)

    mp = molecules(molkw)[1]
    oo_b = P.OO_pqc(built, mp, ncas, ne, freeze_active=True)
    oo_p = P.OO_pqc(prebuilt, mp, ncas, ne, freeze_active=True)
    assert oo_p._core["route"] == oo_b._core["route"] == "fused"
    (e_b, g_b, h_b), (e_p, g_p, h_p) = (oo_b._grad_hess(theta),
                                        oo_p._grad_hess(full))
    rows = torch.cat([tang, prebuilt.theta_shape
                      + torch.arange(oo_p.n_kappa)])
    assert abs(float(e_p) - float(e_b)) < 1e-12
    np.testing.assert_allclose(g_p[rows].numpy(), g_b.numpy(), rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(h_p[rows][:, rows].numpy(), h_b.numpy(),
                               rtol=0, atol=1e-9)


def _custom_program():
    """The JAX package's custom-program test circuit: one fermionic
    double on (2e,2o) (tests/test_pqc.py)."""
    init_idx, _ = jfermion.hf_bitstring(2, 2)
    return JGateProgram(
        [JG.fermionic_double_pairs(3, 2, 1, 0, 4, param=0, half=0.5)],
        n_params=1, init_idx=init_idx, dim=16)


@pytest.mark.parametrize("which", ["custom", "fabric_3e4o_L2"])
def test_from_jax_gate_program_state(which):
    """A JAX GateProgram carried across by from_jax gives the JAX state,
    as a program and as a circuit's ansatz, in the full space and with
    sector=True; its RDMs trace to the electron count."""
    if which == "custom":
        jprog, ncas, ne = _custom_program(), 2, 2
    else:
        jprog, ncas, ne = JA.gatefabric_program(4, (2, 1), 2), 4, (2, 1)
    prog = from_jax(jprog)
    assert prog.n_params == jprog.n_params and prog.dim == jprog.dim
    theta = _theta(jprog.n_params, 7, scale=1.0)
    ref = np.asarray(jprog.apply(jnp.asarray(theta)))
    np.testing.assert_allclose(prog.apply(torch.from_numpy(theta)).numpy(),
                               ref, rtol=0, atol=1e-13)
    for sec in (False, True):
        jpc = JPC(ncas, ne, ansatz=jprog, sector=sec)
        pqc = P.Parameterized_circuit(ncas, ne, ansatz=prog, sector=sec)
        np.testing.assert_allclose(pqc.state(theta).numpy(),
                                   np.asarray(jpc.state(jnp.asarray(theta))),
                                   rtol=0, atol=1e-13)
        g1, _ = pqc.get_rdms(theta)
        assert abs(float(torch.trace(g1)) - np.sum(ne)) < 1e-10
    if which == "custom":
        psi = P.Parameterized_circuit(2, 2, ansatz=prog).state(
            [1.3661890029907227])
        assert abs(float(psi[12]) - 0.77562) < 1e-4


@pytest.mark.parametrize("name", sorted(CASES))
def test_draw_circuit_and_dirac_notation_match(circuits, name):
    """The same text from both packages: the wire diagram of a built-in
    circuit, the gate table of a projected program (no display
    metadata), and the Dirac-notation sum of the state."""
    jp, pp = circuits(name)
    theta = _theta(jp.theta_shape, 9)
    assert pp.draw_circuit(theta) == jp.draw_circuit(jnp.asarray(theta))
    psi = pp.state(theta)
    for kw in ({}, dict(decimals=4, atol=1e-3)):
        assert P.dirac_notation(psi, **kw) == jdirac(
            np.asarray(jp.state(jnp.asarray(theta))), **kw)
    ncas, ne = CASES[name][:2]
    jsec = JPC(ncas, ne, ansatz=jp.program, sector=True)
    psec = P.Parameterized_circuit(ncas, ne, ansatz=from_jax(jp.program),
                                   sector=True)
    full = np.array(jp._expand_theta(jnp.asarray(theta)))
    assert psec.draw_circuit(full) == jsec.draw_circuit(jnp.asarray(full))


def test_flat_api_and_refusals(circuits):
    """uccd_circuit / gatefabric_circuit equal the JAX flat API; the
    full-space OO_pqc takes the flat route; the constructor's rules and
    the spin-resolved RDMs are the JAX package's."""
    theta = [0.4217]
    np.testing.assert_allclose(
        P.uccd_circuit(theta, 2, 2).numpy(),
        np.asarray(J.uccd_circuit(jnp.asarray(theta), 2, 2)), rtol=0,
        atol=1e-14)
    full = 0.1 * np.arange(int(np.prod(A.gatefabric_full_shape(2, 6))))
    np.testing.assert_allclose(
        P.gatefabric_circuit(full, 3, 2, n_layers=2).numpy(),
        np.asarray(J.gatefabric_circuit(jnp.asarray(full), 3, 2,
                                        n_layers=2)), rtol=0, atol=1e-14)
    pqc = circuits("ucc_2e2o")[1]
    assert pqc.state_complex(theta).dtype == torch.complex128
    np.testing.assert_array_equal(pqc.qnode(theta).numpy(),
                                  pqc.state(theta).numpy())
    assert pqc.grid_program is None and pqc.sector_maps is None
    # what the port once refused, as the JAX package does it: a callable
    # constructs, up_then_down with a built-in ansatz raises its
    # ValueError, and the spin-resolved RDMs equal its values
    for pkg in (JPC, P.Parameterized_circuit):
        assert pkg(2, 2, ansatz=lambda th: th, theta_shape=1).theta_shape \
            == 1
        with pytest.raises(ValueError, match="interleaved ordering"):
            pkg(2, 2, up_then_down=True)
    gj, Gj = circuits("ucc_2e2o")[0].get_rdms(jnp.asarray(theta),
                                              restricted=False)
    gp, Gp = pqc.get_rdms(theta, restricted=False)
    np.testing.assert_allclose(gp.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(Gp.numpy(), np.asarray(Gj), rtol=0,
                               atol=1e-13)
    with pytest.raises(ValueError, match="full 4\\^2 space"):
        pqc.get_rdms_from_state(torch.zeros(6, dtype=torch.float64))
    with pytest.raises(ValueError, match="4\\^3"):
        P.Parameterized_circuit(3, 2, ansatz=A.uccd_program(2, 2))
    with pytest.raises(ValueError, match="crosses the particle sector"):
        bad = PairGate([3], [1], [1.0], 0.5, 0)
        sector.project_program(GateProgram([bad], 1, 3, 16), 2, 2)
