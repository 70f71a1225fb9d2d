"""Seconds per damped-Newton iteration in f64 and in mixed precision.

    python -m auto_oo_tpu_torch.scripts.time_precision [cell ...]

Cells (formaldimine, sector np_fabric, freeze_active, from init_zeros):
``10e`` (10e,10o) sto-3g L=2, 4 iterations (the fused route); ``12e``
(12e,12o) 6-31G L=1, 3 iterations (the JAX package's staged regime).
For each cell and precision, in the order f64, mixed, mixed, f64 (two
runs of each, so that a drift of the card shows), it prints each
iteration's wall time on the host clock (ending in a synchronize), the
median of iterations 2 on, the peak device memory and the energies, then
the mixed energies' differences from the f64 ones.  Needs a card; prints
the card's name and power limit first.
"""

import statistics
import subprocess
import sys
import time

import torch

import auto_oo_tpu_torch as P
from auto_oo_tpu_torch.utils.misc import get_formal_geo

CELLS = {"10e": (10, "sto-3g", 2, 4), "12e": (12, "6-31g", 1, 3)}
STEP = dict(alpha=1e-4, beta=0.5, mu=1e-6, rho=1.1, lambda_min=1e-6)


def run(mol, pqc, n, precision, iterations):
    """One trajectory; returns (energies, iteration seconds, peak bytes)."""
    oo = P.OO_pqc(pqc, mol, n, n, freeze_active=True, precision=precision)
    stamps = []

    class Stamp:
        def log(self, it, energy, **kw):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    energies, *_ = oo.full_optimization(pqc.init_zeros(),
                                        max_iterations=iterations,
                                        monitor=Stamp(), **STEP)
    secs = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    return energies, secs, torch.cuda.max_memory_allocated()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("time_precision: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for cell in argv or list(CELLS):
        n, basis, layers, iterations = CELLS[cell]
        mol = P.Moldata(get_formal_geo(140, 80), basis)
        pqc = P.Parameterized_circuit(n, n, ansatz="np_fabric",
                                      n_layers=layers, sector=True)
        out = {}
        for precision in ("f64", "mixed", "mixed", "f64"):
            energies, secs, peak = run(mol, pqc, n, precision, iterations)
            out[precision] = energies
            print(f"({n}e,{n}o) {basis} {precision:5s}: s/NR-iter "
                  f"{statistics.median(secs[1:]):.4f} (iterations "
                  + ", ".join(f"{x:.4f}" for x in secs)
                  + f"), peak {peak / 1e9:.3f} GB, energies "
                  + ", ".join(f"{e:.12f}" for e in energies), flush=True)
        print(f"({n}e,{n}o) mixed - f64 by iteration: " + ", ".join(
            f"{a - b:+.3e}" for a, b in zip(out["mixed"], out["f64"])))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
