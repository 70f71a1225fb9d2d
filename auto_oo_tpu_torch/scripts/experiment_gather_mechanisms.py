"""Which dynamic row-gather mechanism does Hopper favour, and how fast?

Port of scripts/experiment_gather_mechanisms.py, which decided how the
TPU's production row gather (ops/pallas_grid.py ``gather_rows_scaled``)
was built.  On an H100 it times the same gather,
out[k, i, :] = x[src[k, i], :] * s[k, i], through five mechanisms:

  plain: PyTorch indexing (the script's "xla take"): L2-cached loads;
  A: 1-D bulk row copies (TMA, no tensor map), double-buffered;
  B: a column slab of x split across a thread-block cluster's shared
     memory, read remotely (distributed shared memory);
  C: 8-row aligned 2-D TMA boxes, selecting one row (8x read traffic);
  L: the production kernel's mechanism, one warp per row with L2-cached
     loads (ops/grid_kernels.gather_rows_scaled with t = 1, which is
     exact: (x * s) * 1 = x * s).

Shapes and inputs are the script's: ncas orbitals give na_str =
C(ncas, ncas // 2) strings, ns padded to 8, nb to 128, na to 8, n2 =
ncas^2, inputs from np.random.default_rng(0).  Each variant runs the
script's K-step harness, y_{k+1} = y_k + gather(x + c_k), as a Python
loop timed with CUDA events, divided by K, and the gather alone (CUDA
events over K launches).  A variant that raises prints FAILED and its
reason.

    python -m auto_oo_tpu_torch.scripts.experiment_gather_mechanisms \\
        [ncas] [K] [--dtype f32|f64]

Needs a CUDA device; without one it exits non-zero.
"""

import argparse
import statistics
import subprocess
import sys
from math import comb

import numpy as np
import torch

from ..config import get_device
from ..ops import gather_mechanisms as gm
from ..ops import grid_kernels as gk

R = 8      # rows per program step of the TPU kernels (na is padded to it)
L = 128    # lane width (nb is padded to it)
#: published HBM bandwidth of one H100 SXM at its 700 W limit, GB/s
PEAK_GBS = 3350.0

_DTYPES = {"f32": torch.float32, "f64": torch.float64}


def gather_rows_l2(x, src, s):
    """The same gather through the production row kernel (one warp per
    output row, L2-cached loads), with a column scale of ones."""
    t = torch.ones((src.shape[0], x.shape[1]), dtype=x.dtype,
                   device=x.device)
    return gk.gather_rows_scaled(x, src, s, t)


VARIANTS = (("plain", "xla take / torch indexing", gm.gather_rows_plain),
            ("A", "A: 1-D bulk row copies (db)", gm.gather_a),
            ("B", "B: x slab across a cluster", gm.gather_b),
            ("C", "C: 8-row 2-D TMA boxes", gm.gather_c),
            ("L", "L: warp-per-row L2 loads", gather_rows_l2))


def shapes(ncas):
    """(ns, nb, n2, na) of the script's main for ncas orbitals."""
    na_str = comb(ncas, ncas // 2)
    ns = ((na_str + 7) // 8) * 8
    nb = ((na_str + L - 1) // L) * L
    na = ((na_str + R - 1) // R) * R
    return ns, nb, ncas * ncas, na


def make_inputs(ncas, K, dtype=torch.float32, device=None):
    """(x, src, s, cs) drawn as the script draws them, on ``device``
    (default: config's device)."""
    device = get_device(device)
    ns, nb, n2, na = shapes(ncas)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((ns, nb))
    src = rng.integers(0, ns, (n2, na)).astype(np.int32)
    s = rng.standard_normal((n2, na))
    cs = rng.standard_normal(K)

    def put(a, dt):
        return torch.from_numpy(a).to(device=device, dtype=dt)

    return put(x, dtype), put(src, torch.int32), put(s, dtype), put(cs, dtype)


def repeat_scan(gather_fn, K):
    """K repetitions, y_{k+1} = y_k + gather(x + c_k): the fresh constant
    keeps every gather a gather of new data and the carry add makes each
    (n2, na, nb) output materialize, as the script's scan does."""

    def run(x, src, s, cs):
        n2, na = src.shape
        y = torch.zeros((n2, na, x.shape[1]), dtype=x.dtype,
                        device=x.device)
        for k in range(K):
            y = y + gather_fn(x + cs[k], src, s)
        return y

    return run


def _event_ms(fn, n):
    """Median of n CUDA-event times of fn(), in ms."""
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def timed(label, gather_fn, x, src, s, cs, ref, K, bytes_out, n=6):
    """Time one variant and print its line; returns a dict of its
    numbers, or None if it raised."""
    scan = repeat_scan(gather_fn, K)
    try:
        out = scan(x, src, s, cs)
        torch.cuda.synchronize()
    except Exception as exc:  # a failed variant is a printed finding
        msg = str(exc).split("\n")[0][:160]
        print(f"{label:30s} FAILED: {msg}")
        return None
    err = float((out - ref).abs().max() / ref.abs().max())
    scan_ms = _event_ms(lambda: scan(x, src, s, cs), n) / K
    xs = x + cs[0]

    def gathers():
        for _ in range(K):
            gather_fn(xs, src, s)

    gathers()
    kern_ms = _event_ms(gathers, n) / K
    gb = bytes_out / 1e9
    gbs = gb / (kern_ms * 1e-3)
    print(f"{label:30s} {scan_ms:8.4f} ms/op (K-step)  gather "
          f"{kern_ms:8.4f} ms  {gb:.3f} GB out -> {gbs:7.1f} GB/s "
          f"({100 * gbs / PEAK_GBS:5.1f}% of 3.35 TB/s)  relerr {err:.1e}")
    return {"scan_ms": scan_ms, "ms": kern_ms, "gbs": gbs, "relerr": err}


def main(argv=None):
    """Run the experiment; returns {variant: numbers or None}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ncas", nargs="?", type=int, default=10)
    ap.add_argument("K", nargs="?", type=int, default=8)
    ap.add_argument("--dtype", choices=sorted(_DTYPES), default="f32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("experiment_gather_mechanisms: needs a CUDA device "
                         "(torch.cuda.is_available() is False)")
    dtype = _DTYPES[args.dtype]
    dev = torch.device("cuda")
    x, src, s, cs = make_inputs(args.ncas, args.K, dtype, dev)
    ns, nb, n2, na = shapes(args.ncas)
    bytes_out = n2 * na * nb * x.element_size()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()
    print(f"device={torch.cuda.get_device_name(0)} "
          f"({card[0] if card else 'nvidia-smi: no answer'}) "
          f"ncas={args.ncas} K={args.K} x=({ns},{nb}) out=({n2},{na},{nb}) "
          f"{args.dtype} ({bytes_out / 1e9:.3f} GB/op)")
    ref = repeat_scan(gm.gather_rows_plain, args.K)(x, src, s, cs)
    return {key: timed(label, fn, x, src, s, cs, ref, args.K, bytes_out)
            for key, label, fn in VARIANTS}


if __name__ == "__main__":
    res = main()
    sys.exit(0 if all(v is not None for v in res.values()) else 1)
