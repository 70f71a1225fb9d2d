"""gather_two_spin timed at the routes' Phi shapes on the card.

    python -m auto_oo_tpu_torch.scripts.sweep_two_spin [--dtype f64|f32]
        [--baseline SRC] [--no-plans] [ncas:rows[:B] ...]

For each shape (ncas electrons in ncas orbitals, a window of that many
grid rows from the middle of the grid, B states gathered at once; a shape
given without rows takes the whole grid) it builds the grid maps on the
card and a seeded x (B, Na, Nb) in the dtype, and prints the bound and
the re-read floor where x does not fit half the L2
(``grid_kernels.two_spin_bytes``, at 3.35 TB/s).  The
defaults are the routes' shapes: f64 ``14:1716`` and ``16:495`` (the
(14e,14o) streamed and (16e,16o) hosted Phi chunks); f32 ``16:14:15``
(the (16e,16o) Gram route's stack of 15 states, 14 rows) and ``16:990``
(the mixed hosted pass's chunk).  It checks the kernel with the wrapper's
plan against the plain version (a slab of 28 pairs at a time), equal as
values, and times it, with the alpha half's working set (its valid
entries' reads, the distinct source rows, and the distinct rows one wave
of 132 window rows reads); then:

- ``--baseline SRC``: an earlier grid_gather.cu whose two-spin kernel took
  the dense tables (entry point ``grid_gather_two_spin_f64/_f32(x, srcA,
  sgnA, tB, srcB, sgnB, tA, out, B, n2, Na, Nb, r0, R, vec, rows,
  threads, pairs, stream)``, e.g. the tree of commit 35542d0 unpacked
  with ``git archive`` into ``build/``), run with its own plan
  (``old_plan``), equal to the new kernel as values and timed against it
  in turns (baseline, new, new, baseline);
- unless ``--no-plans``: the wrapper's plan and its neighbours
  (``plans``: threads, pairs per block, the beta tables staged or read in
  memory, 32- or 128-byte store lines), each equal to the wrapper's as
  values, the ten fastest printed (5 calls a round, 3 rounds), and the
  fastest with the beta tables staged the other way than the wrapper's.

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

HBM_BYTES_PER_S = 3.35e12
STEP = 28
DTYPES = {"f64": torch.float64, "f32": torch.float32}
DEFAULT_SHAPES = {"f64": ["14:1716", "16:495"], "f32": ["16:14:15", "16:990"]}
_DENSE_ARGS = [PTR] * 8 + [I64] + [I32] * 9 + [PTR]


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


def old_plan(B, R, Nb, n2, itemsize, aligned=True):
    """The launch plan of the earlier kernel (vec, rows, threads, pairs):
    two staged rows where two such blocks share an SM, 512 threads at
    most, the pairs split until ~32 blocks per SM."""
    row = Nb * itemsize
    vec = 16 // itemsize
    if not aligned or Nb % vec:
        vec = 1
    rows = 2 if R >= 2 and 2 * row <= 233472 // 2 - 1024 else 1
    step = max(1, 8 // (vec * rows))
    threads = min(512, gk._warps(-(-max(1, Nb // vec) // step)))
    blocks = B * -(-R // rows)
    splits = max(1, min(n2, -(-(32 * 132) // max(blocks, 1))))
    return vec, rows, threads, max(1, -(-n2 // splits))


def dense_kernel(lib, symbol):
    """A launcher of a dense-table entry point, with the earlier kernel's
    plan."""
    def run(x, tabs, r0, r1):
        n2, Na, Nb = tabs[0].shape[0], x.shape[-2], x.shape[-1]
        B = x.numel() // (Na * Nb)
        out = torch.empty(x.shape[:-2] + (n2, r1 - r0, Nb), dtype=x.dtype,
                          device=x.device)
        plan = old_plan(B, r1 - r0, Nb, n2, x.element_size(),
                        x.data_ptr() % 16 == 0)
        lib.launch(symbol, *[v.data_ptr() for v in (x, *tabs, out)],
                   B, n2, Na, Nb, r0, r1 - r0, *plan,
                   torch.cuda.current_stream().cuda_stream)
        return out
    return run


def check_plain(out, x, tabs, r0, r1, what):
    for k0 in range(0, tabs[0].shape[0], STEP):
        ref = gk.gather_two_spin_plain(
            x, *(t[k0:k0 + STEP] for t in tabs), r0, r1)
        if not torch.equal(out[..., k0:k0 + STEP, :, :], ref):
            raise SystemExit(f"{what}: not equal to the plain version")
        del ref


def plans(base, Nb, n2, itemsize):
    """The wrapper's plan and its neighbours: threads in equal rounds or
    256 and 512 of them, the pairs per block a quarter, half, twice and
    four times the wrapper's, the beta tables staged by each warp or read
    in memory, rows' stores from 32- and 128-byte lines; those that fit a
    block's shared memory."""
    out = [base]
    idx = 4 if Nb > gk._INT16_COLS else 2
    step = gk.two_spin_unroll(base.vec, itemsize)
    for line in (32, 128):
        slots = Nb // base.vec + line // (base.vec * itemsize)
        most = gk.two_spin_threads(slots, step)
        for threads in sorted({min(t, most) for t in (256, 512, most)}):
            for pairs in sorted({min(n2, max(1, base.pairs * f // 4))
                                 for f in (1, 2, 4, 8, 16)}):
                for staged in (0, 1):
                    p = gk.TwoSpinPlan(base.vec, threads, pairs, staged,
                                       line)
                    if (p not in out and gk.two_spin_smem(
                            Nb, n2, itemsize, p, idx) <= gk._BLOCK_SMEM):
                        out.append(p)
    return out


def alpha_working_set(gm, r0, r1, wave):
    """The alpha half's source rows over the window: valid entries, the
    distinct rows they read, and the distinct rows per group of ``wave``
    consecutive window rows (the rows one wave of blocks holds, all pairs)
    on average."""
    src = gm.srcA[:, r0:r1].long()
    valid = gm.sgnA[:, r0:r1] != 0
    per = [int(torch.unique(src[:, g:g + wave][valid[:, g:g + wave]])
               .numel()) for g in range(0, r1 - r0, wave)]
    return (int(valid.sum()), int(torch.unique(src[valid]).numel()),
            sum(per) / len(per))


def sweep(spec, dtype, baseline, with_plans):
    ncas, rows, B = (spec.split(":") + ["", ""])[:3]
    ncas, B = int(ncas), int(B) if B else 1
    gm = grid.build_grid_maps(ncas, ncas, device="cuda")
    Na, Nb, n2 = gm.Na, gm.Nb, gm.n2
    rows = int(rows) if rows else Na
    r0 = (Na - rows) // 2
    r1 = r0 + rows
    gen = torch.Generator(device="cuda").manual_seed(ncas)
    x = torch.randn((B, Na, Nb), generator=gen, dtype=dtype, device="cuda")
    tabs = gm.phi_tables(x)
    compact = gm.two_spin_tables()
    nbytes = gk.two_spin_bytes(x, compact, r0, r1)
    bound = nbytes.bound / HBM_BYTES_PER_S * 1e3
    floor = (None if nbytes.reread is None
             else nbytes.reread / HBM_BYTES_PER_S * 1e3)

    def shares(t):
        return (f"bound {100 * bound / t:.1f}%" + ("" if floor is None else
                f", floor {100 * floor / t:.1f}%"))
    base = gk.plan_two_spin(B, Na, rows, Nb, n2, x.element_size())

    def new(plan=None):
        return gk.gather_two_spin(x, compact, r0, r1, plan=plan)

    ref = new()
    torch.cuda.synchronize()
    check_plain(ref, x, tabs, r0, r1, f"({ncas}e,{ncas}o)")
    ms = time_ms(new)
    tag = str(dtype)[6:]
    reread = ("no re-read floor (x fits half the L2)" if floor is None else
              f"re-read floor {floor:.4f} ms ({nbytes.reread / 1e9:.3f} GB)")
    print(f"({ncas}e,{ncas}o) {tag} B={B} rows [{r0}, {r1}) of {Na}, Nb {Nb},"
          f" n2 {n2}: bound {bound:.4f} ms ({nbytes.bound / 1e9:.3f} GB), "
          f"{reread}; kernel {ms:.4f} ms ({shares(ms)}), plan "
          f"{tuple(base)}; equal to plain")
    reads, distinct, per_wave = alpha_working_set(gm, r0, r1, 132)
    print(f"  alpha source rows: {reads} reads of {distinct} distinct rows;"
          f" per 132 window rows (all pairs) {per_wave:.1f} distinct, "
          f"{per_wave * Nb * x.element_size() / 1e6:.1f} MB per state")
    if baseline is not None:
        old = baseline(x, tabs, r0, r1)
        torch.cuda.synchronize()
        if not torch.equal(old, ref):
            raise SystemExit(f"({ncas}e,{ncas}o): baseline != new kernel")
        del old
        t = [time_ms(lambda: baseline(x, tabs, r0, r1)), time_ms(new),
             time_ms(new), time_ms(lambda: baseline(x, tabs, r0, r1))]
        print(f"  in turns: baseline {t[0]:.4f}, new {t[1]:.4f}, new "
              f"{t[2]:.4f}, baseline {t[3]:.4f} ms; baseline/new "
              f"{(t[0] + t[3]) / (t[1] + t[2]):.3f}; shares of the bound: "
              f"new {100 * bound / min(t[1:3]):.1f}%, baseline "
              f"{100 * bound / min(t[0], t[3]):.1f}% (plan "
              f"{old_plan(B, rows, Nb, n2, x.element_size())})")
    if with_plans:
        results = []
        for p in plans(base, Nb, n2, x.element_size()):
            out = new(p)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise SystemExit(f"plan {tuple(p)}: not equal")
            del out
            results.append((time_ms(lambda: new(p), reps=5, rounds=3), p))
        results.sort(key=lambda r: r[0])
        for pms, p in results[:10]:
            mark = " (the wrapper's)" if p == base else ""
            print(f"  plan vec={p.vec} threads={p.threads} pairs={p.pairs} "
                  f"staged={p.staged} line={p.line}: {pms:.4f} ms, "
                  f"{shares(pms)}{mark}")
        rank = [p for _, p in results].index(base) + 1
        print(f"  the wrapper's plan ranks {rank} of {len(results)}")
        other = [(pms, p) for pms, p in results if p.staged != base.staged]
        if other:
            pms, p = other[0]
            how = "read in memory" if base.staged else "staged"
            print(f"  fastest plan with the beta tables {how}: threads="
                  f"{p.threads} pairs={p.pairs} staged={p.staged} line="
                  f"{p.line}: {pms:.4f} ms, {shares(pms)}")
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
        print("sweep_two_spin: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sfx = args.dtype
    baseline = None
    if args.baseline:
        sym = f"grid_gather_two_spin_{sfx}"
        lib = CudaLibrary(args.baseline, {sym: _DENSE_ARGS})
        baseline = dense_kernel(lib, sym)
    for spec in args.shapes or DEFAULT_SHAPES[sfx]:
        sweep(spec, DTYPES[sfx], baseline, not args.no_plans)
    return 0


if __name__ == "__main__":
    sys.exit(main())
