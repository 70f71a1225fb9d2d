"""Shot-noise robustness study of the damped-Newton OO-VQE optimizer.

    python -m auto_oo_tpu_torch.scripts.noise_study [--device cpu]
        [--variances V [V ...]] [--seeds N]

Port of examples/noise_study.py.  For each noise variance (finite
measurement shots: var ~ 1/N_shots), ``Noisy_OO_pqc.
full_noisy_optimization`` runs from theta = 0 for each seed, 30
iterations with no early stop, on formaldimine (140, 80) sto-3g (2e,2o)
np_fabric L=1 with the active-active rotations frozen; the noise is
drawn from a ``torch.Generator`` on the OO_pqc's device, seeded by the
seed.  One JSON line per variance gives the robustness curve: the basin
tolerance max(50 sqrt(var), 1e-6) Ha, the fraction of seeds whose
trajectory comes within it of CASSCF, the median and worst best error
and the median iterations to enter the basin.  The defaults are the
JAX example's: variances 1e-8, 1e-6, 1e-5, 1e-4, 1e-3 and seeds 0-4.
Runs on the card unless ``--device cpu`` is given.
"""

import argparse
import json
import sys

import numpy as np

import auto_oo_tpu_torch as P

VARIANCES = [1e-8, 1e-6, 1e-5, 1e-4, 1e-3]
SEEDS = range(5)
MAX_ITER = 30


def casscf_energy(mol):
    """The (2e,2o) CASSCF energy, the study's reference."""
    mol.run_casscf(2, 2)
    return mol.casscf.e_tot


def study_row(pqc, mol, e_ref, variance, seeds=SEEDS, max_iter=MAX_ITER):
    """The robustness row of one variance over ``seeds``."""
    basin_tol = max(50 * np.sqrt(variance), 1e-6)
    errs, iters_to_basin = [], []
    for seed in seeds:
        noisy = P.Noisy_OO_pqc(pqc, mol, 2, 2, freeze_active=True,
                               seed=seed)
        energy_l, *_ = noisy.full_noisy_optimization(
            pqc.init_zeros(), variance=variance, max_iterations=max_iter,
            conv_tol=0.0)
        err = np.abs(np.array(energy_l) - e_ref)
        errs.append(err.min())
        inside = np.nonzero(err < basin_tol)[0]
        iters_to_basin.append(int(inside[0]) + 1 if inside.size else None)
    reached = [i for i in iters_to_basin if i is not None]
    return {
        "variance": variance,
        "basin_tol_ha": basin_tol,
        "fraction_in_basin": len(reached) / len(errs),
        "median_best_error_ha": float(np.median(errs)),
        "worst_best_error_ha": float(np.max(errs)),
        "median_iters_to_basin": (float(np.median(reached))
                                  if reached else None),
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--variances", type=float, nargs="+",
                        default=VARIANCES)
    parser.add_argument("--seeds", type=int, default=len(SEEDS),
                        help="seeds 0..N-1")
    args = parser.parse_args(argv)
    mol = P.Moldata(P.get_formal_geo(140, 80), "sto-3g")
    e_ref = casscf_energy(mol)
    print(f"CASSCF reference energy: {e_ref:.10f}", file=sys.stderr)
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1,
                                  device=args.device)
    for var in args.variances:
        print(json.dumps(study_row(pqc, mol, e_ref, var,
                                   range(args.seeds))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
