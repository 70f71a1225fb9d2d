"""Where the time goes in one (16e,16o) damped-Newton iteration on the card.

    python -m auto_oo_tpu_torch.scripts.profile_16e16o [--precision f64|mixed]
        [--hosted-form gram|per_tangent]

Builds the H16 chain of scripts/demo_16e16o.py (sto-3g, np_fabric L=1,
freeze_active, D = 165,636,900; the hosted route) in ``--precision``
(default f64), its hosted form the JAX package's choice (per-tangent in
f64, Gram in mixed) or ``--hosted-form``, and takes one NR iteration from
the demo's theta0 = 0.02 * arange(n_theta) apart on the host clock (each
part ends in a synchronize): the whole iteration (grad_hess, then the
Newton update with its line-search energies), its peak and reserved
device memory and its kernel launches; then one more grad_hess with the
core's part timer on (``_core["parts"]``): per part (the state sweep,
the pair sweeps, the cross sweep or the (H psi, RDMs) pass and the H J_i
passes, the reverse pair sweeps) its seconds summed over the tangents
and its peak memory.  Then it runs the iteration again under
torch.profiler (device time by kernel and by op, and the busy share
against the unprofiled wall).  Needs a card; prints the card's name and
power limit first.
"""

import argparse
import subprocess
import sys
import time

import torch

import auto_oo_tpu_torch as P
from auto_oo_tpu_torch.ops import cuda_build
from auto_oo_tpu_torch.ops import grid_hosted as _gh
from auto_oo_tpu_torch.ops import grid_kernels as _gk
from auto_oo_tpu_torch.scripts.demo_16e16o import GEOMETRY, STEP
from auto_oo_tpu_torch.scripts.profile_14e14o import (_timed, device_profile,
                                                      grad_hess_parts)


def chunk_memory(oo, x):
    """Device memory allocated after each step of one scatter-form chunk
    (the middle one) of an H-apply of x, and the step's peak above the
    memory before the chunk (no c1eff x term: the buffers are what
    counts)."""
    from auto_oo_tpu_torch.ops import grid as _grid

    maps = oo.pqc.sector_maps
    chunks = _grid._row_chunks(maps.Na, oo._core["plan_lp"].row_chunk)
    r0, r1 = chunks[len(chunks) // 2]
    xg = x.reshape(maps.Na, maps.Nb)
    acc = torch.zeros_like(xg)
    C2 = torch.eye(maps.n2, dtype=x.dtype, device=x.device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    steps = []

    def mark(label):
        torch.cuda.synchronize()
        now = torch.cuda.memory_allocated() - base
        peak = torch.cuda.max_memory_allocated() - base
        steps.append(f"{label} {now / 1e9:.2f} (peak {peak / 1e9:.2f})")

    phi_c = _grid._phi_chunk(xg, maps, r0, r1)
    mark("Phi chunk")
    yc = torch.matmul(C2, phi_c.reshape(maps.n2, -1))
    mark("Y = C2 Phi")
    del phi_c
    yc = yc.reshape(maps.n2, r1 - r0, maps.Nb)
    srcA, sgnA, tB, srcB, sgnB, _ = maps.tables(yc)
    _gk.scatter_rows(acc, yc, srcA, sgnA, tB,
                     *_gh._inverse_tables(maps, yc), r0)
    _gk.gather_reduce_cols(yc, srcB, sgnB,
                           _grid._row_tables(maps, yc, r0, r1)[2],
                           out=acc[r0:r1], lists=maps.col_lists())
    mark("scatter + column form")
    del yc, acc
    print(f"  one chunk [{r0}, {r1}), GB above the resident set: "
          + "; ".join(steps))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="profile_16e16o")
    ap.add_argument("--precision", choices=("f64", "mixed"), default="f64")
    ap.add_argument("--hosted-form", choices=("gram", "per_tangent"))
    args_ = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_16e16o: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.perf_counter()
    mol = P.Moldata(GEOMETRY, "sto-3g")
    pqc = P.Parameterized_circuit(16, 16, ansatz="np_fabric", n_layers=1,
                                  sector=True)
    oo = P.OO_pqc(pqc, mol, 16, 16, freeze_active=True,
                  precision=args_.precision, hosted_form=args_.hosted_form)
    torch.cuda.synchronize()
    core, args = oo._core, oo._mol_args
    print(f"setup {time.perf_counter() - t0:.2f} s, route {core['route']} "
          f"({core['hosted_form']} form, {args_.precision}), plan "
          f"{core['plan_lp']}, cross sweep row chunk {core['cross_rows']}")
    theta = 0.02 * torch.arange(pqc.theta_shape, dtype=torch.float64,
                                device=pqc.device)
    print(f"kernel build + load {cuda_build.load_all([_gk.LIBRARY]):.2f} s "
          "(before any timing)")

    def iteration():
        e0, grad, hess = core["grad_hess"](theta, oo.oao_mo_coeff, *args)
        return core["newton_update"](theta, oo.oao_mo_coeff, *args, e0,
                                     grad, hess, *STEP)

    parts = []
    torch.cuda.reset_peak_memory_stats()
    _gk.reset_launches()
    out = _timed("NR iteration", iteration, parts)
    launches = dict(_gk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    step = float((out[0] - theta).norm())
    grad_hess_parts(oo, theta, parts)
    for label, sec in parts:
        print(f"  {label:32s} {sec * 1e3:10.1f} ms")
    print(f"  peak device memory of the iteration {peak / 1e9:.3f} GB "
          f"allocated, {reserved / 1e9:.3f} GB reserved; launches "
          f"{launches}; energy after it {float(out[3]):.12f}, step length "
          f"|dtheta| {step:.6e}")
    torch.cuda.empty_cache()
    if core["hosted_form"] == "per_tangent":
        chunk_memory(oo, pqc._state_impl_grid(theta).to(
            torch.float32 if args_.precision == "mixed" else torch.float64))
    device_profile(iteration, parts[0][1])
    return 0

if __name__ == "__main__":
    sys.exit(main())
