"""Time the gate kernels (ops/gate_kernels.py) at the sweeps' shapes.

    python -m auto_oo_tpu_torch.scripts.sweep_gate_kernels [--dtype f32]
        [ncas ...]

On the card only.  For each (ncas e, ncas o) np_fabric L = 1 sector grid
(default 14 and 16, the benchmark cells' circuits) it prints, per
kernel, one sweep's launches over the circuit's gates at the shapes its
sweep uses: ``gate_rotate`` on one grid (the state sweep),
``gate_adjoint_step`` on (P, Q) with the dot products (the Adam step's
adjoint sweep, pair_row with v = 0), and at the circuit's nt tangents
(14 for the cells) where the stacks fit (ncas <= 14)
``gate_adjoint_step`` on (P, E, D, Q) (the circuit-Hessian sweep) and
``gate_generator_add`` plus two ``gate_rotate`` (the state + J sweep),
and the state sweep's launches by gate shape.  Each line gives the
device ms of the sweep's launches (CUDA events around repeated sweeps
queued behind a spin kernel, median of rounds), the bound (the bytes of
``gate_kernels.gate_bytes`` at 3.35 TB/s) and the share, the sector
floor (the touched 32-byte sectors read and written once, the floor of a
kernel that moves whole sectors: ``sector_bytes``) and its share, the plain
versions' ms on the card, and for the state and adjoint sweeps the whole
sweep (its copies at entry included) against the functional sweep of
simulator/program.py, which it replaced, with their largest relative
difference.  The last line is JSON.

``compare`` holds each kernel to its plain version on one gate (the card
tests and chip_smoke.py's phase 38 call it); ``measure`` is the timing
that chip_smoke.py's kernels line reports for the gate kernels.
"""

import argparse
import json
import statistics
import subprocess
import sys
from collections import namedtuple
from types import SimpleNamespace

import numpy as np
import torch

from ..ops import gate_kernels as gk
from ..simulator import ansatze as A
from ..simulator import grid_gates
from ..simulator.grid_program import _DENSE_SIGNS_MAX
from ..simulator.program import _SweepProgram
from ..utils.flops import HBM_BYTES_PER_S

#: a set of the three gate steps: the kernels, or their plain versions
Kernels = namedtuple("Kernels", "rotate generator_add adjoint_step")
CARD = Kernels(gk.gate_rotate, gk.gate_generator_add, gk.gate_adjoint_step)
PLAIN = Kernels(gk.gate_rotate_plain, gk.gate_generator_add_plain,
                gk.gate_adjoint_step_plain)
# cycles of the spin kernel that hides the host's launches (~50 ms)
SPIN = 85_000_000


def device_ms(fn, reps=5, rounds=5):
    """Device ms of one fn(): CUDA events around ``reps`` calls queued
    behind a spin kernel, median of ``rounds`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def wall_ms(fn, reps=5):
    """Ms of one fn() on an idle card, host launches included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


def circuit(ncas, dev):
    prog = grid_gates.build_direct(ncas, ncas, "np_fabric", n_layers=1,
                                   device=dev)
    redundant = A.gatefabric_redundant_idx(ncas, ncas)
    tangents = [p for p in range(prog.n_params) if p not in redundant]
    return prog, tangents


def sector_bytes(tab, itemsize, sector=32):
    """The bytes one grid's touched 32-byte sectors hold: a step that
    reads and writes memory in whole sectors moves at least twice this.
    Where the touched columns are scattered along a row (alpha-identity
    and subgrid gates) a sector holds untouched elements too."""
    src = set(tab.Ai_src.tolist())
    dst = set(tab.Ai_dst.tolist())
    cols = {(True, False): tab.Bj_src.cpu().numpy(),
            (False, True): tab.Bj_dst.cpu().numpy()}
    cols[True, True] = np.union1d(cols[True, False], cols[False, True])
    # rows of one kind (source, destination or both) whose start lies at
    # the same offset in a sector touch as many sectors
    count = {}
    for r in src | dst:
        key = ((r * tab.Nb * itemsize) % sector, r in src, r in dst)
        count[key] = count.get(key, 0) + 1
    total = 0
    for (start, in_src, in_dst), n in count.items():
        c = cols[in_src, in_dst]
        total += n * np.unique((start + c * itemsize) // sector).size
    return total * sector


def gate_shape(tab):
    return ("beta-identity" if tab.beta_identity else
            "alpha-identity" if tab.alpha_identity else "subgrid")


def shapes(prog):
    """The circuit's gates by shape."""
    out = {}
    for g, t in enumerate(prog._gt):
        out.setdefault(gate_shape(t), []).append(g)
    return out


def row_slice(g, m, Na, Nb, dev):
    """Gate ``g`` of a larger grid cut to its first ``m`` row pairs (every
    row of an alpha-identity gate up to m), its rows renumbered: a (R, Nb)
    grid that keeps the gate's full-width column tables."""
    if g.alpha_identity:
        rows = np.arange(min(m, Na))
        src = dst = rows
    else:
        src, dst = np.asarray(g.Ai_src[:m]), np.asarray(g.Ai_dst[:m])
        rows = np.union1d(src, dst)
    cut = SimpleNamespace(
        Ai_src=np.searchsorted(rows, src), Ai_dst=np.searchsorted(rows, dst),
        Bj_src=g.Bj_src, Bj_dst=g.Bj_dst, sA=np.asarray(g.sA)[:len(src)],
        sB=g.sB, alpha_identity=g.alpha_identity,
        beta_identity=g.beta_identity)
    return gk.GateTables(cut, rows.size, Nb, dev, _DENSE_SIGNS_MAX)


def dot_bound(tab, P, Q, D, E, dtype):
    """Per (lane, t): the rounding bound of a gate_adjoint_step launch's
    dot products, which sum their N products in another order than the
    plain version: 4 eps sqrt(sum of the squared products) sqrt(m +
    log2 N), m the products a thread adds before the kernel's fixed-order
    trees."""
    def sq(X):
        return X.double() ** 2

    def terms(Ct, Y):
        cta, ctb = gk.blocks(sq(Ct), tab)
        ya, yb = gk.blocks(sq(Y), tab)
        return (ctb * ya).sum((-2, -1)) + (cta * yb).sum((-2, -1))

    s2 = terms(Q, P) + (terms(E, D) if D is not None else 0.0)
    n = 2 * tab.ka * tab.kb * (2 if D is not None else 1)
    m = -(-tab.kb // 256) + 2
    return (4 * torch.finfo(dtype).eps * s2.sqrt()
            * float(np.sqrt(m + np.log2(n)))).to(dtype)


def compare(tab, dtype, seed, L=2, nt=3):
    """Each kernel on gate ``tab`` (on the card) against its plain version
    on seeded operands of L lanes: gate_rotate both ways, on 2 grids a
    lane; gate_generator_add; gate_adjoint_step on (P, Q), nt tangents,
    and on (P, Q, D, E) with the generator terms of tangent 1.  The
    rotations and generator terms round every product and sum in the plain
    versions' order, so the stepped operands must equal them as values
    (torch.equal); the dot products are held to ``dot_bound`` (and the
    rounding of the final add to out = 1 + dot / 2); a second launch must
    give the same bits.  Returns ({kernel: max abs difference}, [faults])."""
    dev = tab.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shape = gate_shape(tab)
    errs = dict.fromkeys(gk.KERNELS, 0.0)
    faults = []

    def grids(m):
        # drawn on the card: numpy's draws of the (14e,14o) grids took
        # most of the card tests' time
        return torch.randn((L, m, tab.Na, tab.Nb), generator=gen,
                           device=dev, dtype=dtype)

    def same(name, got, want, what):
        errs[name] = max(errs[name], float((got - want).abs().max()))
        if not torch.equal(got, want):
            faults.append(f"{name} on a {shape} gate ({what}) differs from "
                          "its plain version")

    ang = (torch.rand(L, generator=gen, device=dev, dtype=dtype) - 0.5) * 6
    c, s = torch.cos(ang), torch.sin(ang)
    coef = torch.tensor([0.5], dtype=dtype, device=dev)
    X = grids(2)
    for inverse in (False, True):
        same("gate_rotate", gk.gate_rotate(X.clone(), tab, c, s, inverse),
             gk.gate_rotate_plain(X.clone(), tab, c, s, inverse),
             f"inverse={inverse}")
    del X
    Dst, Src = grids(1), grids(1)
    same("gate_generator_add",
         gk.gate_generator_add(Dst.clone(), Src, tab, coef, -1),
         gk.gate_generator_add_plain(Dst.clone(), Src, tab, coef, -1), "")
    del Dst, Src
    ops = [grids(1), grids(nt), grids(nt), grids(1)]
    eps = torch.finfo(dtype).eps
    for live in (False, True):
        used = ops if live else ops[:2] + [None, None]
        bound = 0.5 * dot_bound(tab, *used, dtype)

        def run(fn):
            P, Q, D, E = (None if x is None else x.clone() for x in used)
            out = torch.ones((L, nt), dtype=dtype, device=dev)
            fn(P, Q, D, E, tab, c, s, out=out, h=0.5,
               ti=1 if live else -1, coef=coef)
            return [P, Q, D, E], out

        what = "(P, Q, D, E), generator terms" if live else "(P, Q)"
        kern, kout = run(gk.gate_adjoint_step)
        plain, pout = run(gk.gate_adjoint_step_plain)
        for a, b in zip(kern, plain):
            if a is not None:
                same("gate_adjoint_step", a, b, what)
        del plain
        err = (kout - pout).abs()
        errs["gate_adjoint_step"] = max(errs["gate_adjoint_step"],
                                        float(err.max()))
        if not bool((err <= bound + 2 * eps * pout.abs()).all()):
            faults.append(f"gate_adjoint_step on a {shape} gate ({what}): "
                          f"dot products off by {err.tolist()}, bound "
                          f"{bound.tolist()}")
        again, aout = run(gk.gate_adjoint_step)
        if not (torch.equal(kout, aout) and all(
                torch.equal(a, r) for a, r in zip(kern, again)
                if a is not None)):
            faults.append(f"gate_adjoint_step on a {shape} gate ({what}): "
                          "another result on a second launch")
        del kern, again
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return errs, faults


def measure(ncas, dtype, dev, rng):
    prog, tangents = circuit(ncas, dev)
    n, item = len(prog._gt), torch.empty((), dtype=dtype).element_size()
    theta = torch.zeros(prog.n_params, dtype=dtype, device=dev)
    theta[tangents] = torch.from_numpy(
        rng.uniform(-0.3, 0.3, len(tangents))).to(dev, dtype)
    cos_t, sin_t = prog._trig_rows(theta, dtype)
    half = prog._half_dev.to(dtype)

    def grids(m):
        return torch.from_numpy(rng.standard_normal(
            (1, m, prog.Na, prog.Nb))).to(dev, dtype)

    floors = [sector_bytes(t, item) for t in prog._gt]

    def floor(rotated, gates=None):
        """ms of the touched sectors of ``rotated`` operands, read and
        written once."""
        return 1e3 * 2 * rotated * sum(
            floors[g] for g in (range(n) if gates is None else gates)) \
            / HBM_BYTES_PER_S

    def bound(rotated, read=0, grids=1, gates=None):
        return 1e3 * sum(gk.gate_bytes(prog._gt[g], item, rotated, read,
                                       grids)
                         for g in (range(n) if gates is None else gates)) \
            / HBM_BYTES_PER_S

    rows = []

    def row(name, form, fn, bytes_ms, floor_ms, sweep=None, launches=n):
        """One sweep's launches, fn(CARD), and its plain versions,
        fn(PLAIN), timed on the card."""
        ms = device_ms(lambda: fn(CARD))
        plain = device_ms(lambda: fn(PLAIN), reps=1, rounds=3)
        line = dict(ncas=ncas, kernel=name, form=form, launches=launches,
                    ms=ms, bound_ms=bytes_ms, share=bytes_ms / ms,
                    floor_ms=floor_ms, plain_ms=plain)
        if sweep is not None:
            new, old, err = sweep()
            line.update(sweep_ms=new, functional_ms=old, max_rel_diff=err)
        rows.append(line)
        print(f"  ({ncas}e,{ncas}o) {dtype} {name} [{form}]: {ms:.4f} ms a "
              f"sweep of {launches} gates, bound {bytes_ms:.4f} ms "
              f"({100 * bytes_ms / ms:.1f}%), sector floor {floor_ms:.4f} "
              f"ms ({100 * floor_ms / ms:.1f}%), plain {plain:.4f} ms"
              + (f"; whole sweep {line['sweep_ms']:.4f} ms (host "
                 f"included), functional {line['functional_ms']:.4f} ms, "
                 f"max rel diff {line['max_rel_diff']:.2e}"
                 if sweep is not None else ""), flush=True)

    X = grids(1)

    def state_sweep():
        got = prog.apply(theta)
        want = _SweepProgram.apply(prog, theta)
        return (wall_ms(lambda: prog.apply(theta)),
                wall_ms(lambda: _SweepProgram.apply(prog, theta)),
                rel(got, want))

    row("gate_rotate", "state sweep, one grid",
        lambda k: [k.rotate(X, t, cos_t[g], sin_t[g])
                   for g, t in enumerate(prog._gt)], bound(1), floor(1),
        state_sweep)
    for shape, gates in shapes(prog).items():
        ms = device_ms(lambda: [gk.gate_rotate(X, prog._gt[g], cos_t[g],
                                               sin_t[g]) for g in gates])
        b, f = bound(1, gates=gates), floor(1, gates=gates)
        rows.append(dict(ncas=ncas, kernel="gate_rotate", form=shape,
                         launches=len(gates), ms=ms, bound_ms=b,
                         share=b / ms, floor_ms=f))
        print(f"    {shape} gates ({len(gates)}): {ms:.4f} ms, bound "
              f"{b:.4f} ms ({100 * b / ms:.1f}%), sector floor {f:.4f} ms "
              f"({100 * f / ms:.1f}%)", flush=True)
    del X
    P, Q = grids(1), grids(1)
    out = torch.zeros(prog.n_params, dtype=dtype, device=dev)
    part = P.new_empty(prog._max_ka)

    def adjoint(k):
        for g in reversed(range(n)):
            p = int(prog._param[g])
            k.adjoint_step(P, Q, None, None, prog._gt[g], cos_t[g],
                           sin_t[g], out=out[p:p + 1].view(1, 1),
                           h=prog._half[g], part=part)

    def adjoint_sweep():
        psi = prog.apply(theta)
        a = torch.from_numpy(rng.standard_normal(prog.dim)).to(dev, dtype)
        zero = a.new_zeros(()).expand(a.shape)
        v = torch.zeros_like(theta)
        args = (theta, v, a, zero, psi, zero)
        got = prog.pair_row(*args)
        want = _SweepProgram.pair_row(prog, *args)
        return (wall_ms(lambda: prog.pair_row(*args)),
                wall_ms(lambda: _SweepProgram.pair_row(prog, *args)),
                rel(got, want))

    row("gate_adjoint_step", "adjoint sweep (P, Q), v = 0", adjoint,
        bound(2), floor(2), adjoint_sweep)
    del P, Q
    if ncas <= 14:
        tang = prog._tangent_of_gate(tangents)
        live = [g for g in range(n) if tang[g] >= 0]
        nt = len(tangents)
        P, E, D, Q = grids(1), grids(1), grids(nt), grids(nt)
        O = torch.zeros((1, nt, nt), dtype=dtype, device=dev)
        part = P.new_empty(nt * prog._max_ka)

        def hessian(k):
            for g in reversed(range(n)):
                ti = int(tang[g])
                k.adjoint_step(
                    P, Q, D, E, prog._gt[g], cos_t[g], sin_t[g],
                    out=O[:, :, ti] if ti >= 0 else None, h=prog._half[g],
                    ti=ti, coef=half[g], part=part)

        row("gate_adjoint_step", f"circuit-Hessian sweep, nt = {nt}",
            hessian, bound(2 + 2 * nt), floor(2 + 2 * nt))

        def jacobian(k):
            for g in range(n):
                ti = int(tang[g])
                if ti >= 0:
                    k.generator_add(D[:, ti:ti + 1], P, prog._gt[g],
                                    half[g])
                k.rotate(D, prog._gt[g], cos_t[g], sin_t[g])
                k.rotate(P, prog._gt[g], cos_t[g], sin_t[g])

        row("gate_generator_add + gate_rotate",
            f"state + J sweep, nt = {nt}", jacobian,
            bound(1 + nt) + bound(1, 1, gates=live),
            floor(1 + nt) + 1.5 * floor(1, gates=live))
        row("gate_generator_add", "the J sweep's generator terms",
            lambda k: [k.generator_add(D[:, int(tang[g]):int(tang[g]) + 1],
                                       P, prog._gt[g], half[g])
                       for g in live], bound(1, 1, gates=live),
            1.5 * floor(1, gates=live), launches=len(live))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ncas", nargs="*", type=int, default=[14, 16])
    ap.add_argument("--dtype", choices=("f64", "f32"), default="f64")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_gate_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gk.LIBRARY.load()
    rng = np.random.default_rng(2147483647)
    rows = []
    for ncas in args.ncas:
        rows += measure(ncas, dtype, torch.device("cuda"), rng)
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "dtype": args.dtype, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
