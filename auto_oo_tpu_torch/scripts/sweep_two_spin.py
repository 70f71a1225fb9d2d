"""gather_two_spin's launch plan swept at the routes' Phi shapes on the card.

    python -m auto_oo_tpu_torch.scripts.sweep_two_spin [ncas:rows:B ...]

For each sector (ncas electrons in ncas orbitals; default 14:1716 and
16:495, the row chunks the streamed and hosted routes take there; a
sector given without rows takes its whole grid, and B states, default 1,
are gathered at once) it builds the grid maps on the card and a seeded
f64 x, and times one Phi chunk of that many grid rows from the middle of
the grid: the composite the kernel replaced
(two gather_rows_scaled launches, the transposed copy and add), then
gather_two_spin with the wrapper's plan and with other plans (threads per
block, staged rows, pairs per block), each equal to the first as values.
A time is the device time of one call: 10 calls back to back behind a
spin kernel, median of 5 rounds.  Needs a card; prints the card's name
and power limit first.
"""

import statistics
import subprocess
import sys

import torch

from ..ops import grid, grid_kernels as gk

HBM_BYTES_PER_S = 3.35e12


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


def composite(x, gm, r0, r1):
    srcA_k, sgnA_k, tA_k = grid._row_tables(gm, x, r0, r1)
    _, _, tB, srcB, sgnB, _ = gm.tables(x)
    pa = gk.gather_rows_scaled(x, srcA_k, sgnA_k, tB)
    zt = x[..., r0:r1, :].transpose(-1, -2).contiguous()
    pb = gk.gather_rows_scaled(zt, srcB, sgnB, tA_k)
    return pa.add_(pb.transpose(-1, -2))


def sweep(ncas, rows, B):
    gm = grid.build_grid_maps(ncas, ncas, device="cuda")
    Na, Nb, n2 = gm.Na, gm.Nb, gm.n2
    rows = rows or Na
    r0 = (Na - rows) // 2
    r1 = r0 + rows
    gen = torch.Generator(device="cuda").manual_seed(ncas)
    x = torch.randn((B, Na, Nb), generator=gen, dtype=torch.float64,
                    device="cuda")
    tabs = gm.phi_tables(x)
    nbytes = (B * n2 * rows * Nb * 8 + x.numel() * 8
              + n2 * (rows + Nb) * 6)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    ref = gk.gather_two_spin(x, *tabs, r0, r1)
    check = composite(x, gm, r0, r1)
    torch.cuda.synchronize()
    if not torch.equal(ref, check):
        raise SystemExit(f"({ncas}e,{ncas}o): kernel != composite")
    del check
    c_ms = time_ms(lambda: composite(x, gm, r0, r1))
    print(f"({ncas}e,{ncas}o) B={B} rows [{r0}, {r1}) of {Na}, Nb {Nb}, "
          f"n2 {n2}: "
          f"bound {bound:.4f} ms ({nbytes / 1e9:.3f} GB); composite "
          f"{c_ms:.4f} ms")
    base = gk.plan_two_spin(B, rows, Nb, n2, 8)
    plans = [base]
    for r in (1, gk.TWO_SPIN_ROWS):
        if r * Nb * 8 > gk._BLOCK_SMEM:
            continue
        step = gk.two_spin_unroll(base.vec, r)
        most = gk._warps(-(-(Nb // base.vec) // step))
        for threads in sorted({min(t, most) for t in (128, 256, 384, 512)}):
            for pairs in (n2, base.pairs, max(1, base.pairs // 2),
                          max(1, base.pairs // 4)):
                p = gk.TwoSpinPlan(base.vec, r, threads, pairs)
                if p not in plans:
                    plans.append(p)
    for p in plans:
        out = gk.gather_two_spin(x, *tabs, r0, r1, plan=p)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise SystemExit(f"plan {tuple(p)}: not equal")
        del out
        ms = time_ms(lambda: gk.gather_two_spin(x, *tabs, r0, r1, plan=p))
        tag = " (the wrapper's)" if p == base else ""
        print(f"  plan vec={p.vec} rows={p.rows} threads={p.threads} "
              f"pairs={p.pairs}: {ms:.4f} ms, share {100 * bound / ms:.1f}%"
              f", composite/kernel {c_ms / ms:.2f}{tag}")
    del ref, x
    torch.cuda.empty_cache()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("sweep_two_spin: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for spec in argv or ["14:1716", "16:495"]:
        ncas, rows, B = (spec.split(":") + ["", ""])[:3]
        sweep(int(ncas), int(rows) if rows else None, int(B) if B else 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
