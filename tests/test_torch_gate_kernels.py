"""The string-grid sweeps' in-place gate steps on the CPU.

simulator/grid_program.py steps the gates in place (ops/gate_kernels.py:
the plain versions here, the CUDA kernels on the card, which
tests/test_torch_cuda.py holds to these plain versions) wherever nothing
records through the operands, and keeps the functional step of
simulator/program.py under autograd, forward-mode duals and torch.func.
Here every in-place sweep is held to the functional sweep (1e-14 relative
in f64, 1e-6 in f32: the plain versions run the functional step's
operations, so they agree to the last bit in practice) on the (4e,4o)
and (6e,6o) np_fabric sectors (every gate shape: beta-identity,
alpha-identity, subgrid), leaves its inputs unchanged and counts no
functional step; the recorded paths still give the functional path's
derivatives; and construction checks that each gate's pairs are
disjoint, which the kernels' one-thread-a-pair update needs.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwad

import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.ops import grid_kernels as gk
from auto_oo_tpu_torch.simulator import grid_gates, grid_program
from auto_oo_tpu_torch.simulator.program import _SweepProgram as Sweep
from auto_oo_tpu_torch.utils import observe

# sector (ncas, nelecas) -> np_fabric layers
SECTORS = {"4e4o": (4, 4, 2), "6e6o": (6, 6, 1)}
TOL = {torch.float64: 1e-14, torch.float32: 1e-6}
SWEEPS = ("apply", "apply_lanes", "apply_with_jacobian",
          "apply_with_jacobian_lanes", "hessian_dot", "hessian_dot_lanes",
          "apply_pair", "pair_row_v0", "pair_row_live")


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's default device is the card; these CPU tests ask for the
    CPU, and restore the default after the module."""
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


@pytest.fixture(scope="module", params=sorted(SECTORS))
def prog(request):
    ncas, ne, layers = SECTORS[request.param]
    return grid_gates.build_direct(ncas, ne, "np_fabric", n_layers=layers)


def _inputs(prog, dtype):
    rng = np.random.default_rng(prog.dim)
    n, dim = prog.n_params, prog.dim

    def t(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape)).to(dtype)

    return SimpleNamespace(
        theta=t(n, scale=0.4), thetas=t(3, n, scale=0.4), v=t(n), a=t(dim),
        b=t(dim), ws=t(3, dim), tangents=list(range(0, n, 2)))


def _args(name, call, x):
    """(method, args) of sweep ``name``, its state inputs made through
    ``call(method, *args)``."""
    z = x.a.new_zeros(()).expand(x.a.shape)
    lanes = name.endswith("_lanes")
    th = x.thetas if lanes else x.theta
    base = name[:-len("_lanes")] if lanes else name
    if base == "apply":
        return base, (th,)
    if base == "apply_with_jacobian":
        return base, (th, x.tangents)
    if base == "hessian_dot":
        psi, J = call("apply_with_jacobian", th, x.tangents)
        return base, (th, x.ws if lanes else x.a, psi, J, x.tangents)
    if base == "apply_pair":
        return base, (th, x.v)
    if base == "pair_row_v0":
        psi = call("apply", th)
        return "pair_row", (th, torch.zeros_like(th), x.a, z, psi, z)
    return "pair_row", (th, x.v, x.a, x.b)


def _run(call, method, args):
    out = call(method, *args)
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", SWEEPS)
def test_in_place_sweep_matches_functional(prog, name, dtype):
    """Each sweep in place against the functional sweep: the same values,
    no input changed, no functional gate step counted, no kernel launch
    counted (the CPU runs the plain versions)."""
    x = _inputs(prog, dtype)

    def functional(m, *a):
        return getattr(Sweep, m)(prog, *a)

    def in_place(m, *a):
        return getattr(prog, m)(*a)

    want = _run(functional, *_args(name, functional, x))
    method, args = _args(name, in_place, x)
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    kept = [a.clone() for a in tensors]
    launches = dict(gk.LAUNCHES)
    observe.clear()
    was = observe.tracing(True)
    try:
        got = _run(in_place, method, args)
        counts = observe.counters()
    finally:
        observe.tracing(was)
        observe.clear()
    for g, w in zip(got, want, strict=True):
        assert g.dtype == dtype and g.shape == w.shape
        err = float((g - w).abs().max()) / float(w.abs().max())
        assert err <= TOL[dtype], (name, err)
    for a, k in zip(tensors, kept):
        assert torch.equal(a, k), f"{name} changed an input"
    assert counts.get("functional_gate_steps", 0) == 0
    assert gk.LAUNCHES == launches


@pytest.mark.parametrize("mode", ["autograd", "forward_ad", "torch.func"])
def test_recorded_apply_takes_functional_path(prog, mode):
    """Under autograd, a forward-mode dual and torch.func the state sweep
    runs the functional step (every gate counted) and its derivative equals
    the in-place sweeps' own: the adjoint gradient of <psi, a> (pair_row
    with v = 0) and the tangent J v (apply_pair)."""
    x = _inputs(prog, torch.float64)
    zero = x.a.new_zeros(()).expand(x.a.shape)
    observe.clear()
    was = observe.tracing(True)
    try:
        if mode == "autograd":
            th = x.theta.clone().requires_grad_(True)
            (prog.apply(th) @ x.a).backward()
            got = th.grad
            want = prog.pair_row(x.theta, torch.zeros_like(x.theta), x.a,
                                 zero, prog.apply(x.theta), zero)
        elif mode == "forward_ad":
            with fwad.dual_level():
                got = fwad.unpack_dual(prog.apply(fwad.make_dual(
                    x.theta, x.v))).tangent
            want = prog.apply_pair(x.theta, x.v)[1]
        else:
            got = torch.func.jvp(prog.apply, (x.theta,), (x.v,))[1]
            want = prog.apply_pair(x.theta, x.v)[1]
        counts = observe.counters()
    finally:
        observe.tracing(was)
        observe.clear()
    assert counts["functional_gate_steps"] == len(prog.gates)
    assert float((got - want).abs().max()) < 1e-13 * float(
        want.abs().max())


@pytest.mark.parametrize("ncas,nelecas,kw", [
    (2, 2, dict(ansatz="np_fabric", n_layers=2)),
    (4, 4, dict(ansatz="np_fabric", n_layers=2)),
    (6, 6, dict(ansatz="np_fabric", n_layers=2)),
    (8, 8, dict(ansatz="np_fabric", n_layers=1)),
    (10, 10, dict(ansatz="np_fabric", n_layers=1)),
    (4, 4, dict(ansatz="ucc")),
    (6, 6, dict(ansatz="ucc", add_singles=True)),
    (4, (2, 1), dict(ansatz="ucc")),
    (3, (2, 1), dict(ansatz="ucc", add_singles=True)),
    (4, 4, dict(ansatz="kupccd", k=2)),
], ids=lambda v: str(v).replace(" ", ""))
def test_gate_pairs_disjoint_on_the_sectors(ncas, nelecas, kw):
    """Every gate of the H-chain and formaldimine sector circuits up to
    (10e,10o) (np_fabric, ucc with and without singles, open-shell ucc,
    kupccd) has disjoint pairs: construction passes and the check holds
    gate by gate."""
    pqc = P.Parameterized_circuit(ncas, nelecas, sector=True, **kw)
    gates = pqc.grid_program.gates
    assert gates and all(grid_program._pairs_disjoint(g) for g in gates)


def _gate(Ai_src, Ai_dst, Bj_src, Bj_dst):
    g = grid_program._GridGate()
    g.Ai_src, g.Ai_dst = np.asarray(Ai_src), np.asarray(Ai_dst)
    g.Bj_src, g.Bj_dst = np.asarray(Bj_src), np.asarray(Bj_dst)
    g.sA = np.ones(len(Ai_src), dtype=np.int8)
    g.sB = np.ones(len(Bj_src), dtype=np.int8)
    g.alpha_identity = g.beta_identity = False
    g.half, g.param, g.empty = 0.5, 0, False
    return g


@pytest.mark.parametrize("tables", [
    ([0, 1], [1, 2], [0, 1], [1, 0]),   # rows and columns both shared
    ([0, 0], [1, 2], [0], [1]),         # a row pair repeats a source row
], ids=["shared-rows-and-columns", "repeated-row"])
def test_overlapping_gate_raises(tables):
    """A hand-made gate whose pairs overlap is refused at construction
    (an in-place step of it would race on the card); the same tables with
    disjoint columns are accepted."""
    with pytest.raises(ValueError, match="overlap"):
        grid_program.GridGateProgram([_gate(*tables)], 1, 0, 3, 3)
    grid_program.GridGateProgram([_gate([0, 1], [1, 2], [0], [1])], 1, 0, 3,
                                 3)
