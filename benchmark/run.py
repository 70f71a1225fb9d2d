"""Run one cell of the benchmark on the card and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout.  Exits 2, printing no result, without a
CUDA card or with fewer cards than the cell asks for; exits 3 if a JAX
module or the JAX package was loaded.  The last line of standard output
is the result's JSON object; the numbers compared with the reference,
each beside its limit, end standard error and the result (``checks``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of compiled code inside the checkout, at fixed paths, so
    # that only a cell's first run there compiles (the port's own nvcc
    # libraries go to its build/; these serve Triton and cpp_extension)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, os.path.join(ROOT, "build", sub))
    import torch
    from benchmark import harness
    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
