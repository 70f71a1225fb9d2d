"""What the metric readers (``metrics/<name>.py``) share.

Each function returns None where its run has nothing to read: another
optimizer, no traced stretch, no launch of the kernel.
"""

import re

import numpy as np

from . import counts

#: the part timer's labels of the gradient-only pass (models/oo_pqc.py
#: ``energy_gradient_staged`` and ``hosted_pass``)
HAM_RDMS = ("H psi", "RDMs", "(H psi, RDMs) pass")
SWEEPS = ("state sweep", "gradient sweep")

#: the device kernels of the program's entry points, by name in the trace
KERNELS = {
    "gather_two_spin": re.compile(r"gather_two_spin_kernel"),
    # scatter_rows launches the row-form reduction with its add flag set
    "scatter_rows": re.compile(r"gather_reduce_kernel<[^>]*true>"),
}


def _optimizer(run):
    return run.cell.traffic["optimizer"]


def per_step(run, optimizer):
    """Seconds of the first stretch over its steps."""
    if _optimizer(run) != optimizer or run.trace:
        return None
    steps = run.steps_of(0)
    return run.stretch_seconds(0) / len(steps) if steps else None


def step_percentile(run, optimizer, q):
    if _optimizer(run) != optimizer or run.trace:
        return None
    steps = run.steps_of(0)
    return float(np.percentile([s.seconds for s in steps], q)) if steps \
        else None


def _timed_steps(run):
    """The steps of the traced stretch with the part timer on."""
    return run.steps_of(0) if run.trace else []


def parts_ms(run, optimizer, labels):
    """Milliseconds per step in the part timer's ``labels`` (None: every
    part)."""
    if _optimizer(run) != optimizer:
        return None
    steps = _timed_steps(run)
    if not steps:
        return None
    total = sum(v for s in steps for k, v in s.parts.items()
                if labels is None or k in labels)
    if total == 0.0:
        return None
    return 1e3 * total / len(steps)


def update_ms(run):
    """Milliseconds per iteration outside the grad_hess parts."""
    if _optimizer(run) != "newton":
        return None
    steps = _timed_steps(run)
    if not steps or not any(s.parts for s in steps):
        return None
    rest = sum(s.seconds - sum(s.parts.values()) for s in steps)
    return 1e3 * rest / len(steps)


def roofline(run, optimizer, kernel):
    """Percent: the kernel's bound (its frozen bytes over 3.35 TB/s)
    over its device time in the profiled stretch.  None unless the trace
    holds as many of its launches as were recorded."""
    if optimizer is not None and _optimizer(run) != optimizer:
        return None
    if run.summary is None or kernel not in run.launch_bytes:
        return None
    pattern = KERNELS[kernel]
    seconds, n = run.summary.device_seconds(
        lambda name: pattern.search(name) is not None)
    launches = sum(1 for rec in run.launch_records if rec[0] == kernel)
    if n == 0 or n != launches or seconds <= 0.0:
        return None
    return 100.0 * run.launch_bytes[kernel] / counts.HBM_BYTES_PER_S / seconds


def idle_share(run, optimizer):
    if _optimizer(run) != optimizer or run.summary is None:
        return None
    window = run.summary.window_s
    busy = run.summary.busy_s
    if window <= 0.0 or busy <= 0.0:
        return None
    return 100.0 * (1.0 - busy / window)


def mfu(run, optimizer):
    """Percent of the f64 peak over the profiled stretch (its length in
    the trace): the problem's frozen count of each step
    (``step_flops``)."""
    if _optimizer(run) != optimizer or run.profiled is None:
        return None
    steps = run.steps_of(run.profiled)
    seconds = run.summary.window_s if run.summary is not None else 0.0
    if not steps or seconds <= 0.0:
        return None
    step_flops = run.cell.problem.step_flops
    flops = sum(step_flops(run.cell, run.shapes, s.trials) for s in steps)
    return 100.0 * flops / (seconds * counts.FP64_PEAK)
