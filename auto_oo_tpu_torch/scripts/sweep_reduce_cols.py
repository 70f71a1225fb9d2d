"""gather_reduce_cols' list tile and launch plan swept at the routes' shapes.

    python -m auto_oo_tpu_torch.scripts.sweep_reduce_cols
        [--baseline SRC] [--tiles 64,128,256,512] [shape ...]

Shapes (default 14e 16e): ``10e`` the (10e,10o) grid with B = 5 tangents,
``12e`` the (12e,12o) grid, ``14e`` and ``14e2`` the (14e,14o) streamed
route's two Y blocks (pairs 0-97 and 98-195, Y (98, 3432, 3432) each;
the second touches more lines of Y), ``16e`` the (16e,16o) hosted route's
chunk (Y (256, 495, 12870), the middle row window, t's window).
For each it builds the grid maps on the card and a seeded f64 Y, checks
the kernel with the wrapper's lists and plan against the plain version
(1e-13 relative; a slab of 28 pairs at a time), prints the bound (bytes
at 3.35 TB/s) and the 32- and 128-byte floors (the sectors and the
lines of Y that the valid entries touch), then times every plan
(rows per warp, unroll, warps per block) at each list tile, each equal
to the first as values (the sums run in the same order whatever the
plan).  ``--baseline SRC`` builds an earlier grid_gather.cu whose column
form took the dense tables, entry point ``grid_gather_reduce_cols_f64(Y,
src, s, t, out, B, n2, Na, Ns, Nc, stream)``, and times it against the
wrapper's plan in turns (baseline, new, new, baseline), with its
values held to the same 1e-13.  A time is the device time of one call:
10 calls back to back behind a spin kernel, median of 5 rounds.  Needs a
card; prints the card's name and power limit first.
"""

import argparse
import subprocess
import sys

import torch

from ..ops import grid, grid_kernels as gk
from ..ops.cuda_build import I32, I64, PTR, CudaLibrary
from .sweep_two_spin import HBM_BYTES_PER_S, time_ms

# (ncas, row window or None for all rows, pair block or None for all, B)
SHAPES = {"10e": (10, None, None, 5), "12e": (12, None, None, 1),
          "14e": (14, None, (0, 98), 1), "14e2": (14, None, (98, 196), 1),
          "16e": (16, 495, None, 1)}
STEP = 28


def sector_floor_bytes(Y, src, s, sector=32):
    """The ``sector``-byte pieces of Y that the valid entries touch."""
    per = sector // Y.element_size()
    B = Y.numel() // (Y.shape[-3] * Y.shape[-2] * Y.shape[-1])
    key = (torch.arange(src.shape[0], device=src.device)[:, None]
           * (Y.shape[-1] // per + 1) + src.long() // per)[s != 0]
    return B * int(torch.unique(key).numel()) * Y.shape[-2] * sector


def bound_bytes(Y, src, s, t):
    """The valid Y elements once, the tables (src, s, t) once, out once
    (chip_smoke.py's count)."""
    B = Y.numel() // (Y.shape[-3] * Y.shape[-2] * Y.shape[-1])
    n_valid = int((s != 0).sum())
    tables = sum(v.numel() * v.element_size() for v in (src, s, t))
    return (B * n_valid * Y.shape[-2] * Y.element_size() + tables
            + B * Y.shape[-2] * src.shape[1] * Y.element_size())


def rel_err(out, Y, src, s, t):
    ref = sum(gk.gather_reduce_cols_plain(
        Y[..., k0:k0 + STEP, :, :], src[k0:k0 + STEP].long(),
        s[k0:k0 + STEP], t[k0:k0 + STEP])
        for k0 in range(0, src.shape[0], STEP))
    return float((out - ref).abs().max()) / float(ref.abs().max())


def baseline_kernel(path):
    """The earlier column form's f64 entry point, built from ``path``."""
    lib = CudaLibrary(path, {"grid_gather_reduce_cols_f64":
                             [PTR] * 5 + [I64] + [I32] * 4 + [PTR]})
    lib.load()

    def run(Y, src, s, t):
        n2, Nc = src.shape
        Na, Ns = Y.shape[-2:]
        out = torch.empty(Y.shape[:-3] + (Na, Nc), dtype=Y.dtype,
                          device=Y.device)
        B = Y.numel() // (n2 * Na * Ns)
        lib.launch("grid_gather_reduce_cols_f64",
                   *[v.data_ptr() for v in (Y, src, s, t, out)], B, n2, Na,
                   Ns, Nc, torch.cuda.current_stream().cuda_stream)
        return out
    return run


def plans(tile):
    """Every plan the kernel takes whose f64 block fits shared memory."""
    out = []
    for rows in (1, 2, 4, 8):
        for unroll in (2, 4, 8):
            for warps in (2, 4, 8):
                if (rows * unroll <= 32
                        and warps * rows * tile * 8 <= gk._BLOCK_SMEM):
                    out.append(gk.ReduceColsPlan(rows, unroll, warps))
    return out


def sweep(name, tiles, baseline):
    ncas, rows, pairs, B = SHAPES[name]
    gm = grid.build_grid_maps(ncas, ncas, device="cuda")
    maps = grid.pair_slice(gm, *pairs) if pairs else gm
    like = torch.zeros((), dtype=torch.float64, device="cuda")
    _, _, _, src, s, tA = maps.tables(like)
    Na, Nb = gm.Na, gm.Nb
    r0, r1 = (0, Na) if rows is None else ((Na - rows) // 2,
                                           (Na - rows) // 2 + rows)
    t = tA if rows is None else grid._row_tables(maps, like, r0, r1)[2]
    gen = torch.Generator(device="cuda").manual_seed(ncas)
    lead = (B,) if B > 1 else ()
    Y = torch.randn(lead + (maps.n2, r1 - r0, Nb), generator=gen,
                    dtype=torch.float64, device="cuda")
    bound = bound_bytes(Y, src, s, t) / HBM_BYTES_PER_S * 1e3
    floor = sector_floor_bytes(Y, src, s) / HBM_BYTES_PER_S * 1e3
    lines = sector_floor_bytes(Y, src, s, 128) / HBM_BYTES_PER_S * 1e3
    lists = maps.col_lists()
    ref = gk.gather_reduce_cols(Y, src, s, t, lists=lists)
    torch.cuda.synchronize()
    rel = rel_err(ref, Y, src, s, t)
    if rel > 1e-13:
        raise SystemExit(f"{name}: relative error {rel:.3e} against plain")
    base = gk.plan_reduce_cols(B, r1 - r0, Nb, lists.tile, 8)
    print(f"{name}: Y {tuple(Y.shape)}, bound {bound:.4f} ms, 32-byte floor "
          f"{floor:.4f} ms, 128-byte floor {lines:.4f} ms, rel err "
          f"{rel:.2e}; the wrapper's tile "
          f"{lists.tile}, plan {tuple(base)}")

    def new():
        return gk.gather_reduce_cols(Y, src, s, t, lists=lists)

    if baseline is not None:
        old = baseline(Y, src, s, t)
        torch.cuda.synchronize()
        old_rel = float((old - ref).abs().max()) / float(ref.abs().max())
        if old_rel > 1e-13:
            raise SystemExit(f"{name}: baseline differs by {old_rel:.3e}")
        del old
        times = [time_ms(lambda: baseline(Y, src, s, t)), time_ms(new),
                 time_ms(new), time_ms(lambda: baseline(Y, src, s, t))]
        print(f"  in turns: baseline {times[0]:.4f}, new {times[1]:.4f}, "
              f"new {times[2]:.4f}, baseline {times[3]:.4f} ms; new share "
              f"of bound {100 * bound / min(times[1:3]):.1f}% (of the floor "
              f"{100 * floor / min(times[1:3]):.1f}%, of the 128-byte floor "
              f"{100 * lines / min(times[1:3]):.1f}%), baseline "
              f"{100 * bound / min(times[0], times[3]):.1f}% "
              f"({100 * floor / min(times[0], times[3]):.1f}%)")
    results = []
    for tile in tiles:
        tl = gk.reduce_cols_lists(src, s, tile)
        for p in plans(tile):
            out = gk.gather_reduce_cols(Y, src, s, t, lists=tl, plan=p)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise SystemExit(f"{name} tile {tile} plan {tuple(p)}: not "
                                 "equal to the wrapper's plan")
            del out
            ms = time_ms(lambda: gk.gather_reduce_cols(Y, src, s, t,
                                                       lists=tl, plan=p))
            results.append((ms, tile, p))
    results.sort(key=lambda r: r[0])
    for ms, tile, p in results[:12]:
        tag = " (the wrapper's)" if (tile, p) == (lists.tile, base) else ""
        print(f"  tile {tile:4d} rows {p.rows} unroll {p.unroll} warps "
              f"{p.warps}: {ms:.4f} ms, bound {100 * bound / ms:.1f}%, "
              f"floor {100 * floor / ms:.1f}%, 128-byte floor "
              f"{100 * lines / ms:.1f}%{tag}")
    mine = [r for r in results if (r[1], r[2]) == (lists.tile, base)]
    if mine:
        rank = results.index(mine[0]) + 1
        print(f"  the wrapper's: {mine[0][0]:.4f} ms, rank {rank} of "
              f"{len(results)}")
    by_tile = {}
    for ms, tile, _ in results:
        by_tile.setdefault(tile, ms)
    print("  best by tile: " + ", ".join(f"{tile} {ms:.4f} ms"
                                         for tile, ms in sorted(
                                             by_tile.items())))
    del Y, ref
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="*", default=["14e", "16e"],
                    choices=sorted(SHAPES))
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--tiles", default="64,128,256,512")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_reduce_cols: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    baseline = (baseline_kernel(args.baseline) if args.baseline else None)
    tiles = [int(v) for v in args.tiles.split(",")]
    for name in args.shapes:
        sweep(name, tiles, baseline)
    return 0


if __name__ == "__main__":
    sys.exit(main())
