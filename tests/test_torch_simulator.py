"""The port's grid gate program and circuit against the JAX package.

Same theta (numpy, seeded) into both packages: grid-ordered and
canonical states to 1e-13, the Jacobian of the tangent-batched sweep
against jax.jacfwd to 1e-12, and the reverse Hessian sweep
d2<w, psi>/dtheta2 against jax.jacfwd(jax.grad) to 1e-12.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from auto_oo_tpu.models import Parameterized_circuit as JPC
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


CASES = {
    "np_fabric_4e4o_L2": (4, 4, dict(ansatz="np_fabric", n_layers=2)),
    "ucc_3e4o_open": (4, (2, 1), dict(ansatz="ucc")),
    "kupccd_2e2o": (2, 2, dict(ansatz="kupccd", k=2)),
    "ucc_2e2o": (2, 2, dict(ansatz="ucc")),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    """(JAX circuit, port circuit, theta, w, JAX references): the grid
    state, J = jax.jacfwd of it and jax.jacfwd(jax.grad(<psi, w>)), from
    one compiled program per case."""
    ncas, ne, kw = CASES[request.param]
    jp = JPC(ncas, ne, sector=True, **kw)
    pp = P.Parameterized_circuit(ncas, ne, sector=True, **kw)
    rng = np.random.default_rng(3)
    theta = 0.4 * rng.standard_normal(jp.theta_shape)
    w = rng.standard_normal(jp.state_dim)
    tables = jp._tables()

    def f(th):
        return jp._state_impl_grid(th, tables)

    def refs(th):
        return (f(th), jax.jacfwd(f)(th).T,
                jax.jacfwd(jax.grad(lambda t: f(t) @ jnp.asarray(w)))(th))

    ref = [np.asarray(a) for a in jax.jit(refs)(jnp.asarray(theta))]
    return jp, pp, theta, w, ref


def test_shapes_match(pair):
    jp, pp = pair[:2]
    assert pp.theta_shape == jp.theta_shape
    assert pp.state_dim == jp.state_dim
    np.testing.assert_array_equal(pp.sector_basis, jp.sector_basis)
    z = pp.init_zeros()
    assert z.dtype == torch.float64 and z.shape == (jp.theta_shape,)


def test_states_match(pair):
    jp, pp, theta, _, (ref_g, _, _) = pair
    th = torch.from_numpy(theta)
    np.testing.assert_allclose(pp._state_impl_grid(th).numpy(), ref_g,
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(pp.state(theta).numpy(),
                               np.asarray(jp.state(jnp.asarray(theta))),
                               rtol=0, atol=1e-13)


def test_jacobian_matches_jacfwd(pair):
    jp, pp, theta, _, (ref_g, Jj, _) = pair
    psi, J = pp._state_and_jacobian_grid(torch.from_numpy(theta))
    assert J.shape == (jp.theta_shape, jp.state_dim)
    np.testing.assert_allclose(J.numpy(), Jj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(psi.numpy(), ref_g, rtol=0, atol=1e-13)


def test_hessian_dot_matches_jacfwd_grad(pair):
    _, pp, theta, w, (_, _, Hj) = pair
    th = torch.from_numpy(theta)
    psi, J = pp._state_and_jacobian_grid(th)
    H = pp._state_hessian_dot_grid(th, torch.from_numpy(w), psi, J)
    np.testing.assert_allclose(H.numpy(), Hj, rtol=0, atol=1e-12)


def test_rdms_match(pair):
    """Restricted RDMs from theta, and from a canonical-order state."""
    jp, pp, theta = pair[:3]
    gj, Gj = (np.asarray(a) for a in jp.get_rdms(jnp.asarray(theta)))
    for gp, Gp in (pp.get_rdms(theta),
                   pp.get_rdms_from_state(pp.state(theta))):
        np.testing.assert_allclose(gp.numpy(), gj, rtol=0, atol=1e-12)
        np.testing.assert_allclose(Gp.numpy(), Gj, rtol=0, atol=1e-12)


def test_functional_gate_program_under_torch_func(pair):
    """The gate step is out of place, so torch.func forward-mode AD runs
    through it and agrees with the explicit tangent sweep."""
    pp, theta = pair[1], pair[2]
    th = torch.from_numpy(theta)
    Jf = torch.func.jacfwd(pp._state_impl_grid)(th)
    _, J = pp._state_and_jacobian_grid(th)
    np.testing.assert_allclose(Jf.T.numpy(), J.numpy(), rtol=0, atol=1e-13)


@pytest.mark.parametrize("builder,kw", [
    ("fermionic_double_pairs", dict(p=5, q=4, r=1, s=0, param=0)),
    ("fermionic_single_pairs", dict(p=4, r=0, param=1)),
    ("double_excitation_pairs", dict(wires=(0, 1, 2, 3), param=2)),
    ("single_excitation_pairs", dict(wires=(1, 5), param=3,
                                     string_mask=0b000110)),
    ("orbital_rotation_pairs", dict(wires=(0, 1, 4, 5), param=4)),
])
@pytest.mark.parametrize("sector", [False, True])
def test_pair_gates_match(builder, kw, sector):
    """The host-side gate compilers (the semantics the grid gate builders
    mirror) against the JAX package's, over the full space and over a
    sector's determinants."""
    from auto_oo_tpu.simulator import gates as jgates
    from auto_oo_tpu_torch.ops import fermion
    from auto_oo_tpu_torch.simulator import gates as pgates
    dets = fermion.sector_basis(3, (2, 1)) if sector else None
    out = [getattr(mod, builder)(nm=6, dets=dets, **kw)
           for mod in (jgates, pgates)]
    jg, pg = ([g] if not isinstance(g, list) else g for g in out)
    assert len(jg) == len(pg)
    for a, b in zip(jg, pg):
        for f in ("ia", "ib", "sign"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
        assert (b.half, b.param, b.name, b.wires) == \
            (a.half, a.param, a.name, a.wires)
    assert any(g.ia.size for g in pg)


def test_unported_routes_raise():
    """The routes the port once refused now do what the JAX package
    does: the spin-resolved RDMs equal its values (full space and
    sector), and up_then_down with sector=True or a callable with
    sector=True raise its ValueErrors; the two refusals that are the JAX
    package's own (the grid gates' up_then_down and the unrestricted CAS
    Hamiltonian) stay NotImplementedError in both packages."""
    from auto_oo_tpu.models import fermionic_cas_hamiltonian as jcas
    from auto_oo_tpu.simulator import grid_gates as jgg
    from auto_oo_tpu_torch.simulator import grid_gates as pgg
    for sector in (False, True):
        theta = np.array([0.37])
        jp = JPC(2, 2, ansatz="ucc", sector=sector)
        pp = P.Parameterized_circuit(2, 2, ansatz="ucc", sector=sector)
        gj, Gj = jp.get_rdms(jnp.asarray(theta), restricted=False)
        gp, Gp = pp.get_rdms(theta, restricted=False)
        np.testing.assert_allclose(gp.numpy(), np.asarray(gj), rtol=0,
                                   atol=1e-13)
        np.testing.assert_allclose(Gp.numpy(), np.asarray(Gj), rtol=0,
                                   atol=1e-13)
    for pkg in (JPC, P.Parameterized_circuit):
        with pytest.raises(ValueError, match="interleaved"):
            pkg(2, 2, ansatz="ucc", sector=True, up_then_down=True)
        with pytest.raises(ValueError, match="compiled GateProgram"):
            pkg(2, 2, ansatz=lambda th: th, sector=True, theta_shape=1)
    for gg in (jgg, pgg):
        with pytest.raises(NotImplementedError, match="interleaved"):
            gg.build_direct(2, 2, "ucc", up_then_down=True)
    c1, c2 = np.eye(2), np.zeros((2, 2, 2, 2))
    for cas in (jcas, P.fermionic_cas_hamiltonian):
        with pytest.raises(NotImplementedError, match="restricted"):
            cas(0.0, c1, c2, restricted=False)
        with pytest.raises(NotImplementedError, match="restricted"):
            cas(0.0, c1, c2, up_then_down=True)
