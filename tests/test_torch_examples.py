"""The port's tutorial and noise-study entry points and its last public
functions against the JAX package, on the CPU.

* ``scripts/tutorial_oo_vqe`` (examples/tutorial_oo_vqe.py): the
  damped-Newton trajectory of formaldimine (4e,3o) np_fabric L=2 equals
  the JAX ``OO_pqc`` run on the same inputs to 1e-8 Ha per iteration and
  reaches CASSCF to 1e-8; the circuit-only Adam run (``utils.optim.adam``
  and ``torch.autograd``) equals ``optax.adam`` on ``jax.value_and_grad``
  of the same loss for 50 steps to 1e-8 Ha;
* ``scripts/noise_study`` (examples/noise_study.py): at variance 0 its
  row equals the JAX example's (run through its own ``main``); a row at
  variance > 0 has the JAX keys and a basin fraction that is a share of
  the seeds;
* ``simulator.sector.rdms_from_sector_state`` over the flat (src, sign)
  tables, FlatMaps and GridMaps, real and complex states;
  ``ops.transforms.general_4index_transform``;
  ``utils.newton_raphson.wolfe``;
* name by name, every public name of the JAX package has its counterpart
  in the port's module of the same name, but the reasoned exclusions of
  ROADMAP queue 1 (NOT_PORTED).
"""

import contextlib
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from auto_oo_tpu import Moldata as JMoldata
from auto_oo_tpu.models import OO_pqc as JOO_pqc
from auto_oo_tpu.models import Parameterized_circuit as JPC
from auto_oo_tpu.models import fermionic_cas_hamiltonian as jcas_h
from auto_oo_tpu.ops import grid as jgrid
from auto_oo_tpu.ops import transforms as jtr
from auto_oo_tpu.simulator import sector as jsector
from auto_oo_tpu.utils import newton_raphson as jnr
import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.ops import grid, transforms
from auto_oo_tpu_torch.scripts import noise_study, tutorial_oo_vqe
from auto_oo_tpu_torch.simulator import sector
from auto_oo_tpu_torch.utils import newton_raphson as nr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOISE_KEYS = {"variance", "basin_tol_ha", "fraction_in_basin",
              "median_best_error_ha", "worst_best_error_ha",
              "median_iters_to_basin"}


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's default device is the card; these CPU tests ask for the
    CPU, and restore the default after the module."""
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


@pytest.fixture(scope="module")
def tutorial():
    """The port's tutorial objects and the JAX example's, built alike."""
    mol, pqc, oo = tutorial_oo_vqe.build()
    jmol = JMoldata(P.get_formal_geo(140, 80), "sto-3g")
    jpqc = JPC(3, 4, ansatz="np_fabric", n_layers=2)
    joo = JOO_pqc(jpqc, jmol, 3, 4, freeze_active=True)
    return mol, pqc, oo, jmol, jpqc, joo


def test_tutorial_newton_equals_jax_and_casscf(tutorial):
    mol, pqc, oo, _, jpqc, joo = tutorial
    energies = tutorial_oo_vqe.newton_run(oo, pqc)[0]
    ref = joo.full_optimization(jpqc.init_zeros(), conv_tol=1e-10)[0]
    assert len(energies) == len(ref)
    np.testing.assert_allclose(energies, ref, rtol=0, atol=1e-8)
    mol.run_casscf(3, 4)
    assert abs(energies[-1] - mol.casscf.e_tot) < 1e-8


def test_tutorial_adam_equals_optax(tutorial):
    """50 circuit-only Adam steps at the RHF orbitals, energy by energy,
    against the JAX example's optax loop on the same Hamiltonian."""
    mol, pqc, oo, jmol, jpqc, joo = tutorial
    H = tutorial_oo_vqe.cas_hamiltonian(mol, oo)
    energies, _ = tutorial_oo_vqe.adam_run(pqc, H, steps=50)

    jmol.run_rhf()
    c0, c1, c2 = (np.asarray(x) for x in joo.get_active_integrals(
        jnp.asarray(jmol.hf.mo_coeff)))
    jH = jnp.asarray(jcas_h(c0, c1, c2).toarray())
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=0,
                               atol=1e-12)

    def casci_energy(th):
        psi = jpqc._state_impl(th)
        return psi @ (jH @ psi)

    opt = optax.adam(5e-2)
    th = jpqc.init_zeros()
    state = opt.init(th)
    val_grad = jax.jit(jax.value_and_grad(casci_energy))
    ref = []
    for _ in range(50):
        e, g = val_grad(th)
        ref.append(float(e))
        updates, state = opt.update(g, state)
        th = optax.apply_updates(th, updates)
    np.testing.assert_allclose(energies, ref, rtol=0, atol=1e-8)
    assert energies[-1] < energies[0]


def _jax_noise_rows(variances, seeds):
    """The JAX example's JSON lines, from its own main()."""
    spec = importlib.util.spec_from_file_location(
        "jax_noise_study", os.path.join(ROOT, "examples", "noise_study.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.VARIANCES, module.SEEDS = variances, seeds
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        module.main()
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_noise_study_rows_equal_jax():
    """Variance 0 (where every seed runs the exact trajectory, so one
    seed stands for all): the port's row equals the JAX example's (the
    errors to 1e-10 Ha, the rest exactly); variance 1e-4, 2 seeds of 10
    iterations: the JAX keys and a basin fraction in {0, 1/2, 1}."""
    (ref,) = _jax_noise_rows([0.0], range(1))
    mol = P.Moldata(P.get_formal_geo(140, 80), "sto-3g")
    e_ref = noise_study.casscf_energy(mol)
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)
    row = noise_study.study_row(pqc, mol, e_ref, 0.0, range(1))
    assert set(row) == set(ref) == NOISE_KEYS
    for key in ("variance", "basin_tol_ha", "fraction_in_basin",
                "median_iters_to_basin"):
        assert row[key] == ref[key], key
    for key in ("median_best_error_ha", "worst_best_error_ha"):
        assert abs(row[key] - ref[key]) < 1e-10, key
    noisy = noise_study.study_row(pqc, mol, e_ref, 1e-4, range(2),
                                  max_iter=10)
    assert set(noisy) == NOISE_KEYS
    assert noisy["fraction_in_basin"] in (0.0, 0.5, 1.0)
    assert noisy["basin_tol_ha"] == pytest.approx(50 * 1e-2)


@pytest.mark.parametrize("ncas,nelecas,dtype", [
    (3, 4, np.float64), (4, 4, np.float64), (4, 4, np.complex128),
    (4, (3, 2), np.complex128),
])
def test_rdms_from_sector_state_equals_jax(ncas, nelecas, dtype):
    """Flat (src, sign) tables, FlatMaps and GridMaps, against the JAX
    function on the same tables, 1e-13."""
    D = len(jsector.sector_basis_and_rank(ncas, nelecas)[0])
    rng = np.random.default_rng(ncas + D)
    v = rng.standard_normal(D)
    if dtype == np.complex128:
        v = v + 1j * rng.standard_normal(D)
    v /= np.linalg.norm(v)
    src, sign = (np.array(t) for t in jsector.sector_epq_maps(
        ncas, nelecas))
    ref = jsector.rdms_from_sector_state(jnp.asarray(v), (src, sign))
    ref_grid = jsector.rdms_from_sector_state(
        jnp.asarray(v), jgrid.build_grid_maps(ncas, nelecas))
    psi = torch.as_tensor(v)
    for maps in ((src, sign), (torch.as_tensor(src), torch.as_tensor(sign)),
                 sector.sector_epq_maps(ncas, nelecas),
                 grid.build_grid_maps(ncas, nelecas)):
        got = sector.rdms_from_sector_state(psi, maps)
        for g, r, rg in zip(got, ref, ref_grid):
            assert g.dtype == torch.float64
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                       atol=1e-13)
            np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=0,
                                       atol=1e-13)


def test_general_4index_transform_equals_jax():
    rng = np.random.default_rng(21)
    M = rng.standard_normal((5, 6, 4, 3))
    Cs = [rng.standard_normal((n, k)) for n, k in
          ((5, 3), (6, 2), (4, 4), (3, 5))]
    ref = jtr.general_4index_transform(jnp.asarray(M),
                                       *map(jnp.asarray, Cs))
    got = transforms.general_4index_transform(torch.as_tensor(M),
                                              *map(torch.as_tensor, Cs))
    assert got.shape == (3, 2, 4, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13,
                               atol=1e-13)
    C = rng.standard_normal((5, 5))
    M = rng.standard_normal((5,) * 4)
    np.testing.assert_allclose(
        transforms.general_4index_transform(
            *map(torch.as_tensor, (M, C, C, C, C))).numpy(),
        transforms.int2e_transform(torch.as_tensor(M),
                                   torch.as_tensor(C)).numpy(),
        rtol=0, atol=1e-12)


@pytest.mark.parametrize("t,alpha", [(1.0, 1e-4), (0.125, 1e-4),
                                     (0.5, 0.3)])
def test_wolfe_equals_jax(t, alpha):
    rng = np.random.default_rng(5)
    grad, dp = rng.standard_normal(24), rng.standard_normal(24)
    ref = float(jnr.wolfe(t, jnp.asarray(grad), jnp.asarray(dp), alpha))
    got = nr.wolfe(t, torch.as_tensor(grad), torch.as_tensor(dp), alpha)
    assert float(got) == pytest.approx(ref, rel=1e-15, abs=1e-300)


# public names of the JAX package the port leaves out on purpose (ROADMAP
# queue 1, "What is deliberately not ported"): TPU or JAX machinery
NOT_PORTED = {
    "config": {"DEFAULT_DTYPE", "grid_mm_mode", "pallas_enabled",
               "set_grid_mm", "set_pallas"},
    "ops.grid_hosted": {"cross_stack_spec", "hosted_min_bytes",
                        "seg_chunks_default", "warm_tables_for"},
    "ops.linalg": {"atan2_f64", "jacobi_eigh", "trig_f64"},
    "ops.pallas_grid": {"epq_sum_pallas", "phi_all_pallas",
                        "phi_rows_pallas"},
    "ops.rdms": {"small_matmul_free_last", "vdot_big", "warm_tables"},
    "simulator.grid_program": {"GridGateProgram.apply_adjoint",
                               "GridGateProgram.apply_pair_adjoint"},
    "simulator.program": {"GateProgram.device_arrays", "deferred_device"},
    "utils.flops": {"TPU_V5E_BF16_PEAK"},
}
# JAX modules whose names live in another port module
PORT_MODULE = {"ops.pallas_grid": "ops.grid_kernels"}


def _jax_public_names():
    """{module: public names} of the JAX package, read from its source:
    module-level defs, classes and their methods, constants, and the
    names each package __init__ exports."""
    import ast

    root = os.path.join(ROOT, "auto_oo_tpu")
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            mod = os.path.relpath(path, root)[:-3].replace(os.sep, ".")
            mod = mod[:-len(".__init__")] if mod.endswith(".__init__") else (
                "" if mod == "__init__" else mod)
            names = set()
            for node in ast.parse(open(path).read()).body:
                if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                    names.add(node.name)
                    if isinstance(node, ast.ClassDef):
                        names.update(f"{node.name}.{m.name}"
                                     for m in node.body
                                     if isinstance(m, ast.FunctionDef))
                elif isinstance(node, ast.ImportFrom) and f == "__init__.py":
                    names.update(a.asname or a.name for a in node.names)
                elif isinstance(node, ast.Assign):
                    names.update(t.id for t in node.targets
                                 if isinstance(t, ast.Name))
            out[mod] = {n for n in names if not any(
                part.startswith("_") for part in n.split("."))}
    return out


def test_every_public_name_is_ported():
    """Name by name: every public def, class, method and constant of each
    JAX module, and each package __init__'s names, has its counterpart in
    the same port module, but the reasoned exclusions (NOT_PORTED)."""
    import importlib

    missing = {}
    for mod, names in _jax_public_names().items():
        target = "auto_oo_tpu_torch" + (
            "." + PORT_MODULE.get(mod, mod) if mod else "")
        port = importlib.import_module(target)
        for name in sorted(names - NOT_PORTED.get(mod, set())):
            obj = port
            for part in name.split("."):
                obj = getattr(obj, part, None)
            if obj is None:
                missing.setdefault(mod, []).append(name)
    assert not missing, missing
