"""gather_rows_scaled timed at the shapes of its callers on the card.

    python -m auto_oo_tpu_torch.scripts.sweep_rows_scaled [--dtype f64|f32]
        [--baseline SRC] [--no-plans] [shape ...]

A shape is ``ncas:half[:rows[@r0]]`` or ``pNCAS``.  ``ncas:half`` is one spin
half (``alpha`` or ``beta``) of the one-spin Phi of the (ncas e, ncas o)
grid, as ``grid.phi_all(x, gm, spin=0 | 1)`` builds it: x (Na, Nb) with
the alpha maps, or its transposed copy with the beta maps.  With
``:rows`` it is that half of a window of ``rows`` grid rows from the
middle of the grid, as the hosted route's Phi chunk (``16:alpha:495``)
and the hosted x row-sharded engine's segment (``16:alpha:14``, its
default row chunk at one rank) take it: the alpha half on the whole x
with the window's columns of the alpha maps, the beta half on the
window's transposed rows; ``@r0`` starts the window at grid row r0
(``14:alpha:1716@0``, the streamed route's first chunk).  ``pNCAS`` is
the row-gather probes' shape (``scripts/experiment_gather_mechanisms.py``:
random src and s, t = 1).  The defaults are the shapes of the kernel's
row in PERF.md: 10 and 12 (alpha, beta), 14 (alpha, beta), 16 (alpha,
beta) at 14 and at 495 rows, p10 and p12.

For each shape it builds the maps on the card and a seeded x in the
dtype, prints the bound and, where x does not fit half the L2, the
re-read floor (``grid_kernels.rows_scaled_bytes``, at 3.35 TB/s), checks
the kernel with the wrapper's plan against the plain version (a slab of
28 pairs at a time), equal as values, and times it beside ``zero_`` of a
tensor of out's bytes (a store-only floor); then:

- ``--baseline SRC``: an earlier grid_gather.cu whose gather_rows_scaled
  took no plan (entry point ``grid_gather_rows_scaled_f64/_f32(x, src,
  s, t, out, B, n2, Ns, Na, Nb, stream)``, e.g. the file of commit
  5dc38cf unpacked with ``git archive`` into ``build/``), equal to the
  new kernel as values and timed against it in turns (baseline, new,
  new, baseline);
- unless ``--no-plans``: the plans around the wrapper's (``plans``:
  slot width, threads, unroll, block order), each equal to the
  wrapper's as values, the ten fastest printed (5 calls a round, 3
  rounds) with the wrapper's rank.

A time is the device time of one call: 10 calls back to back behind a
spin kernel, median of 5 rounds.  Needs a card; prints the card's name
and power limit first.
"""

import argparse
import statistics
import subprocess
import sys

import torch

from ..ops import grid, grid_kernels as gk
from ..ops.cuda_build import I32, I64, PTR, CudaLibrary
from ..utils.flops import HBM_BYTES_PER_S
from . import experiment_gather_mechanisms as exp

STEP = 28
DTYPES = {"f64": torch.float64, "f32": torch.float32}
DEFAULT_SHAPES = ["10:alpha", "10:beta", "12:alpha", "12:beta", "14:alpha",
                  "14:beta", "16:alpha:14", "16:beta:14", "16:alpha:495",
                  "16:beta:495", "p10", "p12"]
# the earlier entry point: x, src, s, t, out; B; n2, Ns, Na, Nb; the stream
_OLD_ARGS = [PTR] * 5 + [I64] + [I32] * 4 + [PTR]


def time_ms(fn, reps=10, rounds=5):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


_MAPS = {}


def operands(spec, dtype):
    """(x, src, s, t, label) of a shape, on the card."""
    if spec.startswith("p"):
        ncas = int(spec[1:])
        x, src, s, _ = exp.make_inputs(ncas, 1, dtype, "cuda")
        t = torch.ones((src.shape[0], x.shape[1]), dtype=dtype,
                       device="cuda")
        return x, src, s, t, f"probes ncas={ncas} (t = 1)"
    ncas, half, rows = (spec.split(":") + [""])[:3]
    rows, _, at = rows.partition("@")
    ncas = int(ncas)
    if ncas not in _MAPS:
        _MAPS.clear()
        _MAPS[ncas] = grid.build_grid_maps(ncas, ncas, device="cuda")
    gm = _MAPS[ncas]
    rows = int(rows) if rows else gm.Na
    r0 = int(at) if at else (gm.Na - rows) // 2
    r1 = r0 + rows
    like = torch.zeros((), dtype=dtype, device="cuda")
    srcA, sgnA, tB, srcB, sgnB, tA = gm.tables(like)
    gen = torch.Generator(device="cuda").manual_seed(ncas)
    x = torch.randn((gm.Na, gm.Nb), generator=gen, dtype=dtype,
                    device="cuda")
    where = (f"one-spin Phi" if rows == gm.Na
             else f"rows [{r0}, {r1}) of {gm.Na}")
    if half == "alpha":
        return (x, srcA[:, r0:r1].contiguous(), sgnA[:, r0:r1].contiguous(),
                tB, f"({ncas}e,{ncas}o) alpha, {where}")
    if half == "beta":
        return (x[r0:r1].T.contiguous(), srcB, sgnB,
                tA[:, r0:r1].contiguous(), f"({ncas}e,{ncas}o) beta, {where}")
    raise SystemExit(f"sweep_rows_scaled: unknown half {half!r} in {spec}")


def check_plain(out, x, src, s, t, what):
    for k0 in range(0, src.shape[0], STEP):
        ref = gk.gather_rows_scaled_plain(x, src[k0:k0 + STEP].long(),
                                          s[k0:k0 + STEP], t[k0:k0 + STEP])
        if not torch.equal(out[..., k0:k0 + STEP, :, :], ref):
            raise SystemExit(f"{what}: not equal to the plain version")
        del ref


def plans(base, itemsize):
    """The wrapper's plan and the plans around it: slots of 16, 8 or 4
    bytes (one element), 128, 256 or 512 threads, unroll 1, 2, 4 or 8,
    both block orders."""
    out = [base]
    for vec in (v for v in (1, 2, 4) if v * itemsize <= 16):
        for threads in (128, 256, 512):
            for unroll in gk.ROWS_UNROLLS:
                for order in (0, 1):
                    p = gk.RowsPlan(vec, threads, unroll, order)
                    if p not in out:
                        out.append(p)
    return out


def old_kernel(lib, symbol):
    def run(x, src, s, t):
        n2, Na = src.shape
        Ns, Nb = x.shape[-2:]
        out = torch.empty(x.shape[:-2] + (n2, Na, Nb), dtype=x.dtype,
                          device=x.device)
        lib.launch(symbol, *[v.data_ptr() for v in (x, src, s, t, out)],
                   x.numel() // (Ns * Nb), n2, Ns, Na, Nb,
                   torch.cuda.current_stream().cuda_stream)
        return out
    return run


def sweep(spec, dtype, baseline, with_plans):
    x, src, s, t, label = operands(spec, dtype)
    Ns, Nb = x.shape[-2:]
    n2, Na = src.shape
    nbytes = gk.rows_scaled_bytes(x, src, s, t)
    bound = nbytes.bound / HBM_BYTES_PER_S * 1e3
    floor = (None if nbytes.reread is None
             else nbytes.reread / HBM_BYTES_PER_S * 1e3)

    def shares(ms):
        return (f"bound {100 * bound / ms:.1f}%" + ("" if floor is None else
                f", floor {100 * floor / ms:.1f}%"))
    base = gk.plan_rows_scaled(1, Ns, Na, Nb, n2, x.element_size())

    def new(plan=None):
        return gk.gather_rows_scaled(x, src, s, t, plan=plan)

    ref = new()
    torch.cuda.synchronize()
    check_plain(ref, x, src, s, t, label)
    ms = time_ms(new)
    tag = str(dtype)[6:]
    valid = int((s != 0).sum())
    reread = ("no re-read floor (x fits half the L2)" if floor is None else
              f"re-read floor {floor:.4f} ms ({nbytes.reread / 1e9:.3f} GB)")
    x_mb = x.numel() * x.element_size() / 1e6
    distinct = int(torch.unique(src[s != 0]).numel())
    out_gb = ref.numel() * ref.element_size() / 1e9
    print(f"{label} {tag}: x {tuple(x.shape)} ({x_mb:.1f} MB), src "
          f"{tuple(src.shape)}, {valid} valid entries, {distinct} distinct "
          f"source rows; out {out_gb:.4f} GB; bound "
          f"{bound:.4f} ms ({nbytes.bound / 1e9:.4f} GB), {reread}; kernel "
          f"{ms:.4f} ms ({shares(ms)}), plan {tuple(base)}; equal to plain")
    store = torch.empty_like(ref)
    zms = time_ms(store.zero_)
    del store
    print(f"  zero_ of a tensor of out's bytes (a store-only floor): "
          f"{zms:.4f} ms ({out_gb / zms:.3f} TB/s); the kernel at "
          f"{100 * zms / ms:.1f}% of it")
    if baseline is not None:
        old = baseline(x, src, s, t)
        torch.cuda.synchronize()
        if not torch.equal(old, ref):
            raise SystemExit(f"{label}: baseline != new kernel")
        del old
        turns = [time_ms(lambda: baseline(x, src, s, t)), time_ms(new),
                 time_ms(new), time_ms(lambda: baseline(x, src, s, t))]
        ratio = (turns[0] + turns[3]) / (turns[1] + turns[2])
        print(f"  in turns: baseline {turns[0]:.4f}, new {turns[1]:.4f}, "
              f"new {turns[2]:.4f}, baseline {turns[3]:.4f} ms; "
              f"baseline/new {ratio:.3f}; new {shares(min(turns[1:3]))}; "
              f"baseline "
              f"{shares(min(turns[0], turns[3]))}")
    if with_plans:
        results = []
        for p in plans(base, x.element_size()):
            out = new(p)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise SystemExit(f"plan {tuple(p)}: not equal")
            del out
            results.append((time_ms(lambda: new(p), reps=5, rounds=3), p))
        results.sort(key=lambda r: r[0])
        for pms, p in results[:10]:
            mark = " (the wrapper's)" if p == base else ""
            loads = (" (element loads)" if gk.rows_elem(
                Nb, p.vec, x.element_size()) else "")
            print(f"  plan vec={p.vec}{loads} threads={p.threads} unroll="
                  f"{p.unroll} order={p.order}: {pms:.4f} ms, "
                  f"{shares(pms)}{mark}")
        rank = [p for _, p in results].index(base) + 1
        print(f"  the wrapper's plan ranks {rank} of {len(results)}")
    del ref, x
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="*")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f64")
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--no-plans", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_rows_scaled: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    baseline = None
    if args.baseline:
        sym = f"grid_gather_rows_scaled_{args.dtype}"
        baseline = old_kernel(CudaLibrary(args.baseline, {sym: _OLD_ARGS}),
                              sym)
    for spec in args.shapes or DEFAULT_SHAPES:
        sweep(spec, DTYPES[args.dtype], baseline, not args.no_plans)
    return 0


if __name__ == "__main__":
    sys.exit(main())
