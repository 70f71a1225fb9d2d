"""The control of a cell's check: the plain reference in float32, put in the
program's place, compared with the reference in float64 by the cell's
numbers.  It has to come out as not correct.  Beside it, the fault "an
energy altered where it is produced": the float64 reference in the
program's place with every energy ``ALTERED`` Ha off.

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...]
        [--device cuda|cpu]

Prints, per seed, each number beside the cell's limit, and last a JSON
line with the readings.  The benchmark's own runs do not run it.
"""

import argparse
import json
import sys

import numpy as np
import torch

from benchmark import harness


ALTERED = 1e-7


def readings(cell, seed, device, fault=False):
    """The control's numbers at one seed, through the cell's problem
    module; with ``fault``, also those of the altered-energy fault."""
    problem = cell.problem
    inputs = problem.inputs(cell, seed)
    theta0 = np.asarray(inputs.theta0, dtype=np.float64)
    ref = problem.reference_trajectory(cell, inputs, device, torch.float64)
    low = problem.reference_trajectory(cell, inputs, device, torch.float32)
    values = harness.compare(theta0, low, ref)
    if not fault:
        return values
    altered = harness.Trajectory([(i, e + ALTERED) for i, e in ref.energies],
                                 ref.theta, ref.lowest, ref.grad)
    return values, harness.compare(theta0, altered, ref)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("benchmark.control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload)
    out = {}
    for seed in args.seeds:
        values, altered = readings(cell, seed, args.device, fault=True)
        for label, nums in (("control", values), ("altered", altered)):
            correct, lines = harness.verdict(nums, cell.limits)
            for line in lines:
                print(f"seed {seed} {label} {line}", flush=True)
            print(f"seed {seed}: {label} correct = {correct}", flush=True)
        out[str(seed)] = {"control": values, "altered": altered}
    print(json.dumps({"workload": args.workload, "seeds": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
