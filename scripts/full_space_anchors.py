"""CPU JAX trajectories of the full-space (sector=False) cells and of the
mixed-precision sector cells, the anchors the PyTorch port is held to on
the card (chip_smoke.py).

    JAX_PLATFORMS=cpu python scripts/full_space_anchors.py [cell ...]
        [--perturb EPS]

Cells (formaldimine sto-3g, f64, damped Newton from init_zeros with the
default step parameters alpha=1e-4, beta=0.5, mu=1e-6, rho=1.1,
lambda_min=1e-6; freeze_active=True unless noted):

  2e2o_fabric  np_fabric L=1 to convergence (the README quick start)
  2e2o_ucc     ucc to convergence, freeze_active=False
  3e3o         the cation (charge 1, spin 1), nelecas=(2, 1), ucc with
               singles, 3 iterations (bench.py's 3e3o_doublet tier)
  6e6o         np_fabric L=2 to convergence (bench.py's headline tier)
  8e8o         np_fabric L=2, 3 iterations (bench.py's 8e8o tier)
  10e10o_mixed sector=True, np_fabric L=2, precision="mixed", 4
               iterations (bench.py's 10e10o_sector tier in mixed mode)

and the gradient-only pipeline's cells (``OO_pqc.gradient_optimization``
from init_zeros with conv_tol=0, Adam steps with a damped-Newton orbital
relaxation every ``orbital_every`` steps):

  10e10o_adam        the 10e10o_mixed cell's circuit in f64, 10 steps,
                     learning_rate=0.05, orbital_every=5
  10e10o_adam_mixed  the same in precision="mixed"
  2e2o_adam          ucc in the full space (sector=False), freeze_active
                     False, 60 steps, learning_rate=0.1, orbital_every=5
                     (tests/test_oo_pqc.py:189-203), with the CASSCF energy

and the Berry-phase cells (``BerryPhaseLoop`` around the formaldimine
conical intersection, loop origin (130, 89.9) and radius 10 deg,
tests/test_berry.py:87-222; ``--perturb`` offsets theta_init):

  berry_2e2o            np_fabric L=1 in the full space, 21 points,
                        run(conv_tol=1e-10, track_steps=12,
                        track_tol=1e-10) (the tutorial's loop)
  berry_2e2o_sector     the same in sector mode, 11 points
  berry_6e6o_sector     np_fabric L=2, sector=True, the 3-point arc
                        get_formal_geo(140 + 0.25 k, 80 + 0.25 k),
                        run(conv_tol=1e-9, max_iterations=30,
                        track_steps=6, track_tol=1e-9)
  berry_2e2o_iterative  the full-space loop at 6 points, track_steps=8,
                        on newton_method="eigh" and "iterative"
  berry_2e2o_5          the full-space loop at 5 points, track_steps=4
                        (the CPU parity test's loop)

and the cells of the user-defined states (circuits built from a fixed
theta or a seeded start; every RDM cell prints the scalar functionals
||gamma||_F, ||Gamma||_F and sum(M * Gamma) of each RDM pair, M a
standard normal array from numpy's default_rng(14) of Gamma's shape):

  10e10o_unrestricted  sector=True, np_fabric L=2, theta = 0.07 * arange
                       + 0.1: the spin-resolved RDMs of the state, and
                       the restricted and spin-resolved RDMs of the state
                       times a per-determinant phase exp(i phi), phi from
                       default_rng(10).uniform(0, 2 pi) in canonical order
  8e8o_unrestricted    the full space, np_fabric L=2, the same theta: the
                       spin-resolved RDMs
  6e6o_utd             the prebuilt (6e,6o) np_fabric L=2 GateProgram read
                       up_then_down=True, 3 iterations from init_zeros
  6e6o_complex         the JAX test's complex construction
                       (tests/test_custom_complex.py:94-117) on the (6e,6o)
                       np_fabric L=2 program: psi(theta[:n]) *
                       exp(i theta[n] n_0), n_0 the occupation of mode 0,
                       3 iterations from theta0 = 0.1 * default_rng(6)
                       standard normal
  6e6o_callable        a real callable wrapping the built-in (6e,6o)
                       np_fabric L=2 program, 3 iterations from init_zeros
                       (the 6e6o cell's first iterations)

and the cells of the geometry batches (``GeometryBatch``, the dp axis, and
``BerryPhaseLoop.run_batched``), on the tutorial's loop:

  batch_10e10o          sector=True, np_fabric L=2 (the 10e10o_mixed
                        cell's circuit in f64), the first 8 of 9 loop
                        points: one damped-Newton iteration from
                        init_zeros at points 0 and 4, each its own
                        ``OO_pqc._nr_iteration_jit`` (the batched step's
                        lanes 0 and 4): energy, lowest Hessian eigenvalue
                        and |theta|
  batched_2e2o          np_fabric L=1 in the full space, 21 points,
                        run_batched(track_steps=12)
  batched_2e2o_sector   the same in sector mode, 11 points

Each cell prints one JSON line: the energy after every iteration (for
the Adam cells, the energy at every step before its update), the lowest
Hessian eigenvalues (Newton cells), n_theta, n_kappa, D and, for the
cells run to convergence, the CASSCF energy of the active space; a
Berry cell prints per method its energies, lowest Hessian eigenvalues,
overlaps (real and imaginary parts) and Berry phase.
``--perturb EPS`` starts from theta = EPS instead of 0 (for every
entry), which shows how far a trajectory amplifies a difference in its
last bits.
"""

import json
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import auto_oo_tpu as aoo  # noqa: E402
import numpy as np  # noqa: E402

from auto_oo_tpu.models import OO_pqc, Parameterized_circuit  # noqa: E402
from auto_oo_tpu.models.berry import BerryPhaseLoop  # noqa: E402

CELLS = {
    "2e2o_fabric": dict(ncas=2, ne=2, kw=dict(ansatz="np_fabric",
                                              n_layers=1), iters=50),
    "2e2o_ucc": dict(ncas=2, ne=2, kw=dict(ansatz="ucc"), iters=50,
                     freeze_active=False),
    "3e3o": dict(ncas=3, ne=(2, 1), kw=dict(ansatz="ucc", add_singles=True),
                 mol=dict(charge=1, spin=1), iters=3),
    "6e6o": dict(ncas=6, ne=6, kw=dict(ansatz="np_fabric", n_layers=2),
                 iters=50),
    "8e8o": dict(ncas=8, ne=8, kw=dict(ansatz="np_fabric", n_layers=2),
                 iters=3),
    "10e10o_mixed": dict(ncas=10, ne=10, kw=dict(ansatz="np_fabric",
                                                 n_layers=2, sector=True),
                         iters=4, precision="mixed"),
    "10e10o_adam": dict(ncas=10, ne=10, kw=dict(ansatz="np_fabric",
                                                n_layers=2, sector=True),
                        adam=dict(steps=10, lr=0.05, every=5)),
    "10e10o_adam_mixed": dict(ncas=10, ne=10,
                              kw=dict(ansatz="np_fabric", n_layers=2,
                                      sector=True),
                              adam=dict(steps=10, lr=0.05, every=5),
                              precision="mixed"),
    "2e2o_adam": dict(ncas=2, ne=2, kw=dict(ansatz="ucc"),
                      freeze_active=False,
                      adam=dict(steps=60, lr=0.1, every=5), casscf=True),
}

_BERRY_RUN = dict(conv_tol=1e-10, track_steps=12, track_tol=1e-10)
BERRY_CELLS = {
    "berry_2e2o": dict(ncas=2, points=21, kw=dict(ansatz="np_fabric",
                                                  n_layers=1),
                       run=_BERRY_RUN),
    "berry_2e2o_sector": dict(ncas=2, points=11,
                              kw=dict(ansatz="np_fabric", n_layers=1,
                                      sector=True), run=_BERRY_RUN),
    "berry_6e6o_sector": dict(ncas=6, arc=3, kw=dict(ansatz="np_fabric",
                                                     n_layers=2,
                                                     sector=True),
                              run=dict(conv_tol=1e-9, max_iterations=30,
                                       track_steps=6, track_tol=1e-9)),
    "berry_2e2o_iterative": dict(ncas=2, points=6,
                                 kw=dict(ansatz="np_fabric", n_layers=1),
                                 run=dict(conv_tol=1e-10, track_steps=8,
                                          track_tol=1e-10),
                                 methods=("eigh", "iterative")),
    "berry_2e2o_5": dict(ncas=2, points=5, kw=dict(ansatz="np_fabric",
                                                   n_layers=1),
                         run=dict(conv_tol=1e-10, track_steps=4,
                                  track_tol=1e-10)),
}


def rdm_functionals(gamma, Gamma, seed=14):
    """(||gamma||_F, ||Gamma||_F, sum(M * Gamma)) with M standard normal
    from default_rng(seed) in Gamma's shape."""
    gamma, Gamma = np.asarray(gamma), np.asarray(Gamma)
    M = np.random.default_rng(seed).standard_normal(Gamma.shape)
    return [float(np.linalg.norm(gamma)), float(np.linalg.norm(Gamma)),
            float(np.sum(M * Gamma))]


def fixed_theta(n):
    """The fixed circuit parameters of the RDM cells."""
    return 0.07 * np.arange(n) + 0.1


def determinant_phase(D, seed=10):
    """exp(i phi) per determinant, phi from default_rng(seed)."""
    return np.exp(1j * np.random.default_rng(seed).uniform(0, 2 * np.pi, D))


def callable_6e6o(kind):
    """(callable, theta_shape) of the 6e6o callable cells: the built-in
    (6e,6o) np_fabric L=2 program applied to its expanded parameters,
    real ("real") or times exp(i theta[n] n_0) ("complex")."""
    import jax.numpy as jnp

    base = Parameterized_circuit(6, 6, ansatz="np_fabric", n_layers=2)
    prog, nt = base.program, int(base.theta_shape)
    if kind == "real":
        return (lambda th: prog.apply(base._expand_theta(th))), nt
    nm = 12
    idx = np.arange(1 << nm)
    nvec = jnp.asarray(((idx >> (nm - 1)) & 1).astype(np.float64))

    def fn(th):
        psi = prog.apply(base._expand_theta(th[:nt]))
        return psi.astype(jnp.complex128) * jnp.exp(1j * th[nt] * nvec)
    return fn, nt + 1


def run_user_states(name):
    import jax.numpy as jnp

    if name in ("10e10o_unrestricted", "8e8o_unrestricted"):
        ncas = 10 if name.startswith("10e") else 8
        pqc = Parameterized_circuit(ncas, ncas, ansatz="np_fabric",
                                    n_layers=2, sector=ncas == 10)
        theta = jnp.asarray(fixed_theta(int(pqc.theta_shape)))
        psi = np.asarray(pqc.state(theta))
        out = dict(cell=name, D=int(psi.size), n_theta=int(pqc.theta_shape),
                   unrestricted=rdm_functionals(
                       *pqc.get_rdms_from_state(jnp.asarray(psi),
                                                restricted=False)))
        if ncas == 10:
            psi_c = jnp.asarray(psi * determinant_phase(psi.size))
            out["phased_restricted"] = rdm_functionals(
                *pqc.get_rdms_from_state(psi_c))
            out["phased_unrestricted"] = rdm_functionals(
                *pqc.get_rdms_from_state(psi_c, restricted=False))
        return out
    mol = aoo.Moldata(aoo.get_formal_geo(140, 80), "sto-3g")
    if name == "6e6o_utd":
        prog = Parameterized_circuit(6, 6, ansatz="np_fabric",
                                     n_layers=2).program
        pqc = Parameterized_circuit(6, 6, ansatz=prog, up_then_down=True)
        theta0 = pqc.init_zeros()
    else:
        fn, n = callable_6e6o("complex" if name == "6e6o_complex"
                              else "real")
        pqc = Parameterized_circuit(6, 6, ansatz=fn, theta_shape=n)
        theta0 = (jnp.asarray(0.1 * np.random.default_rng(6)
                              .standard_normal(n))
                  if name == "6e6o_complex" else pqc.init_zeros())
    oo = OO_pqc(pqc, mol, 6, 6, freeze_active=True)
    energies, _, _, _, eigs = oo.full_optimization(theta0, max_iterations=3)
    return dict(cell=name, energies=energies, lowest_hess_eig=eigs,
                n_theta=int(pqc.theta_shape), n_kappa=int(oo.n_kappa))


USER_STATE_CELLS = ("10e10o_unrestricted", "8e8o_unrestricted",
                    "6e6o_utd", "6e6o_complex", "6e6o_callable")


def loop_geometries(points):
    """The loop of origin (130, 89.9) deg and radius 10 deg around the
    formaldimine conical intersection, ``points`` geometries with the
    first and last equal (tests/test_berry.py:107-111)."""
    ts = np.linspace(0, 1, points)
    return [aoo.get_formal_geo(
        130 + 10 * np.cos(2 * np.pi * t + np.pi / 20),
        89.9 + 10 * np.sin(2 * np.pi * t + np.pi / 20)) for t in ts]


def run_berry(name, perturb=0.0):
    c = BERRY_CELLS[name]
    ncas = c["ncas"]
    geos = (loop_geometries(c["points"]) if "points" in c else
            [aoo.get_formal_geo(140 + 0.25 * k, 80 + 0.25 * k)
             for k in range(c["arc"])])
    pqc = Parameterized_circuit(ncas, ncas, **c["kw"])
    out = dict(cell=name, perturb=perturb, n_theta=int(pqc.theta_shape),
               D=int(pqc.state_dim))
    for method in c.get("methods", (None,)):
        loop = BerryPhaseLoop(geos, "sto-3g", ncas, ncas, pqc,
                              freeze_active=True, newton_method=method)
        loop.run(theta_init=pqc.init_zeros() + perturb, **c["run"])
        ov = loop.overlaps()
        out[method or "default"] = dict(
            energies=[float(e) for e in loop.energy_l],
            lowest_hess_eig=[float(e) for e in loop.hess_eig_l],
            overlaps_real=[float(o) for o in ov.real],
            overlaps_imag=[float(o) for o in ov.imag],
            berry_phase=loop.berry_phase())
    return out


BATCH_CELLS = {
    "batch_10e10o": dict(ncas=10, points=9, lanes=(0, 4),
                         kw=dict(ansatz="np_fabric", n_layers=2,
                                 sector=True)),
    "batched_2e2o": dict(ncas=2, points=21,
                         kw=dict(ansatz="np_fabric", n_layers=1)),
    "batched_2e2o_sector": dict(ncas=2, points=11,
                                kw=dict(ansatz="np_fabric", n_layers=1,
                                        sector=True)),
}


def run_batch(name, perturb=0.0):
    c = BATCH_CELLS[name]
    ncas = c["ncas"]
    geos = loop_geometries(c["points"])
    pqc = Parameterized_circuit(ncas, ncas, **c["kw"])
    out = dict(cell=name, perturb=perturb, n_theta=int(pqc.theta_shape),
               D=int(pqc.state_dim))
    if "lanes" in c:
        for lane in c["lanes"]:
            mol = aoo.Moldata(geos[lane], "sto-3g")
            oo = OO_pqc(pqc, mol, ncas, ncas, freeze_active=True)
            theta, _, _, energy, lowest = oo._nr_iteration_jit(
                pqc.init_zeros() + perturb, oo.oao_mo_coeff, 1e-4, 0.5,
                1e-6, 1.1, 1e-6)
            out[f"lane{lane}"] = dict(
                energy=float(energy), lowest_hess_eig=float(lowest),
                theta_norm=float(np.linalg.norm(np.asarray(theta))))
        return out
    loop = BerryPhaseLoop(geos, "sto-3g", ncas, ncas, pqc,
                          freeze_active=True)
    loop.run_batched(theta_init=pqc.init_zeros() + perturb, track_steps=12)
    out.update(energies=[float(e) for e in loop.energy_l],
               lowest_hess_eig=[float(e) for e in loop.hess_eig_l],
               berry_phase=loop.berry_phase())
    return out


def run(name, perturb=0.0):
    if name in BATCH_CELLS:
        return run_batch(name, perturb)
    if name in BERRY_CELLS:
        return run_berry(name, perturb)
    if name in USER_STATE_CELLS:
        return run_user_states(name)
    c = CELLS[name]
    mol = aoo.Moldata(aoo.get_formal_geo(140, 80), "sto-3g",
                      **c.get("mol", {}))
    pqc = Parameterized_circuit(c["ncas"], c["ne"], **c["kw"])
    oo = OO_pqc(pqc, mol, c["ncas"], c["ne"],
                freeze_active=c.get("freeze_active", True),
                precision=c.get("precision", "f64"))
    if "adam" in c:
        a = c["adam"]
        energies, _ = oo.gradient_optimization(
            pqc.init_zeros() + perturb, max_iterations=a["steps"],
            learning_rate=a["lr"], orbital_every=a["every"], conv_tol=0)
        eigs = None
    else:
        energies, _, _, _, eigs = oo.full_optimization(
            pqc.init_zeros() + perturb, max_iterations=c["iters"])
    out = dict(cell=name, perturb=perturb, energies=energies,
               lowest_hess_eig=eigs, n_theta=int(pqc.theta_shape),
               n_kappa=int(oo.n_kappa), D=int(pqc.state_dim))
    if c.get("iters") == 50 or c.get("casscf"):
        mol.run_casscf(c["ncas"], c["ne"])
        out["casscf"] = float(mol.casscf.e_tot)
    return out


def main(argv):
    perturb = 0.0
    if "--perturb" in argv:
        i = argv.index("--perturb")
        perturb = float(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    for name in argv or (list(CELLS) + list(BERRY_CELLS)
                         + list(USER_STATE_CELLS) + list(BATCH_CELLS)):
        print(json.dumps(run(name, perturb)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
