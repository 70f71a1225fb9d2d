"""Where the time goes in one (14e,14o) damped-Newton iteration on the card.

    python -m auto_oo_tpu_torch.scripts.profile_14e14o [n_warm]
        [--precision f64|mixed]

Builds the H14 chain of scripts/bench_14e14o.py (sto-3g, np_fabric L=1,
freeze_active, D = 11,778,624; the streamed route) in ``--precision``
(default f64), runs ``n_warm`` NR iterations from init_zeros (default
1), then takes the next iteration apart on the host clock (each part
ends in a synchronize): the whole iteration, the grad_hess and the
Newton update (eigh, line search, MO fold), then one more grad_hess with
the core's part timer on (``_core["parts"]``: the state + J sweep, H
psi, the H J rows, the circuit-Hessian sweep, the RDMs).  Then it runs
that iteration again under torch.profiler and prints the device time by
kernel and the device busy share against the unprofiled wall.  Needs a
card; prints the card's name and power limit first.
"""

import argparse
import subprocess
import sys
import time

import torch

import auto_oo_tpu_torch as P

GEOMETRY = "; ".join(f"H 0 0 {0.9 * i:.2f}" for i in range(14))
STEP = dict(alpha=1e-4, beta=0.5, mu=1e-6, rho=1.1, lambda_min=1e-6)


def _timed(label, fn, parts):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    parts.append((label, time.perf_counter() - t0))
    return out


def _device_us(event):
    """Self device time of a profiler row in microseconds (the attribute
    was renamed between PyTorch versions)."""
    return (getattr(event, "self_device_time_total", None)
            or getattr(event, "self_cuda_time_total", 0))


def grad_hess_parts(oo, theta, parts):
    """One grad_hess at ``theta`` with the core's part timer on: appends
    each part's seconds (summed over tangents) to ``parts``."""
    timer = oo._core["parts"]
    timer.seconds, timer.enabled = {}, True
    try:
        oo._core["grad_hess"](theta, oo.oao_mo_coeff, *oo._mol_args)
    finally:
        timer.enabled = False
    parts.extend(timer.seconds.items())


def main(argv=None):
    ap = argparse.ArgumentParser(prog="profile_14e14o")
    ap.add_argument("n_warm", nargs="?", type=int, default=1)
    ap.add_argument("--precision", choices=("f64", "mixed"), default="f64")
    args_ = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_14e14o: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.perf_counter()
    mol = P.Moldata(GEOMETRY, "sto-3g")
    pqc = P.Parameterized_circuit(14, 14, ansatz="np_fabric", n_layers=1,
                                  sector=True)
    oo = P.OO_pqc(pqc, mol, 14, 14, freeze_active=True,
                  precision=args_.precision)
    torch.cuda.synchronize()
    print(f"setup {time.perf_counter() - t0:.2f} s, route "
          f"{oo._core['route']} ({args_.precision}), plan "
          f"{oo._core['plan']}, f32 plan {oo._core['plan_lp']}")
    theta = pqc.init_zeros()
    if args_.n_warm:
        theta = oo.full_optimization(theta, max_iterations=args_.n_warm,
                                     **STEP)[1][-1]
    core, args = oo._core, oo._mol_args

    def iteration():
        e0, grad, hess = core["grad_hess"](theta, oo.oao_mo_coeff, *args)
        return core["newton_update"](theta, oo.oao_mo_coeff, *args, e0,
                                     grad, hess, *STEP.values())

    parts = []
    torch.cuda.reset_peak_memory_stats()
    energy = _timed("NR iteration", iteration, parts)[3]
    peak = torch.cuda.max_memory_allocated()
    gh = _timed("grad_hess", lambda: core["grad_hess"](
        theta, oo.oao_mo_coeff, *args), parts)
    _timed("newton_update", lambda: core["newton_update"](
        theta, oo.oao_mo_coeff, *args, *gh, *STEP.values()), parts)
    grad_hess_parts(oo, theta, parts)
    for label, sec in parts:
        print(f"  {label:32s} {sec * 1e3:10.1f} ms")
    print(f"  peak device memory of the iteration {peak / 1e9:.3f} GB "
          f"(max_memory_allocated); energy after it {float(energy):.12f}")

    device_profile(iteration, parts[0][1])
    return 0


def device_profile(iteration, it_s, top=15):
    """Run ``iteration()`` once under torch.profiler and print its device
    kernel time against the unprofiled wall ``it_s`` (busy and idle
    share), the ``top`` kernels and PyTorch ops by self device time.
    Returns the busy share (None when the trace holds no device time)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        iteration()
        torch.cuda.synchronize()

    def on_device(e):
        return "cuda" in str(getattr(e, "device_type", "")).lower()

    rows = [e for e in prof.key_averages()
            if on_device(e) and _device_us(e) > 0]
    if not rows:
        print("  profiled: no device time in the trace (not measured)")
        return None
    device_us = sum(_device_us(e) for e in rows)
    print(f"  profiled: device kernel time {device_us / 1e3:.1f} ms against "
          f"the unprofiled iteration's {it_s * 1e3:.1f} ms: busy "
          f"{100 * device_us / 1e6 / it_s:.1f}%, idle "
          f"{100 - 100 * device_us / 1e6 / it_s:.1f}%")
    print("  by kernel:")
    for e in sorted(rows, key=lambda e: -_device_us(e))[:top]:
        print(f"    {e.key[:60]:60s} {_device_us(e) / 1e3:9.1f} ms"
              f" {e.count:6d} calls")
    # the device time of the kernels each PyTorch op launched itself, by
    # op and input shapes (the grid kernels launch outside any op; the
    # runtime's "Command Buffer Full" waits are host time, not an op)
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if not on_device(e) and _device_us(e) > 0
           and e.key != "Command Buffer Full"]
    print("  by PyTorch op and input shapes (self device time):")
    for e in sorted(ops, key=lambda e: -_device_us(e))[:top]:
        shapes = str(e.input_shapes)[:70]
        print(f"    {e.key[:24]:24s} {shapes:70s} "
              f"{_device_us(e) / 1e3:9.1f} ms {e.count:6d} calls")
    return device_us / 1e6 / it_s


if __name__ == "__main__":
    sys.exit(main())
