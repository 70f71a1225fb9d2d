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

Each cell prints one JSON line: the energy after every iteration (for
the Adam cells, the energy at every step before its update), the lowest
Hessian eigenvalues (Newton cells), n_theta, n_kappa, D and, for the
cells run to convergence, the CASSCF energy of the active space.
``--perturb EPS`` starts from theta = EPS instead of 0 (for every
entry), which shows how far a trajectory amplifies a difference in its
last bits.
"""

import json
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import auto_oo_tpu as aoo  # noqa: E402
from auto_oo_tpu.models import OO_pqc, Parameterized_circuit  # noqa: E402

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


def run(name, perturb=0.0):
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
    for name in argv or list(CELLS):
        print(json.dumps(run(name, perturb)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
