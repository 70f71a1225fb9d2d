"""The benchmark's harness: cells from data files, the program driven through
its public optimizers, a measured window, the trace, and the check.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs/<config>.json``), a traffic mix (``traffic/<traffic>.json``)
and the limits of its check (``checks/<cell>.json``).  The configuration
names its problem (``"problem"``), a module ``problems/<problem>.py``
that holds everything particular to one kind of problem: the seed's
draws, building and driving the program, the hooks that record its
steps, the plain reference, and a step's FLOP count.  Every metric is a
reader ``metrics/<name>.py`` with ``read(run)`` returning a number, or
None where it finds nothing to read.  New cells, mixes, problems and
metrics are new files: nothing here names one.

A run: set-up builds the problem from the seed's inputs and runs a
warm-up solve through the window's own call; the window runs solves of
``steps_per_solve`` iterations (damped Newton) or steps (Adam) from the
seeded start, one after another, and ends at the first step boundary
past its length; the check follows the first steps of the plain
reference once the program is freed.  A step may carry one problem or
a batch of them (lanes): its energy and lowest eigenvalue are then one
number per lane, and the check holds every lane to its own reference.
"""

import gc
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

from . import counts

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "auto_oo_tpu")


class WindowClosed(Exception):
    """Raised by the monitor at the first step boundary past the window."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of the manifest with its configuration, traffic mix and
    check limits, read from the benchmark's files under ``root``."""

    def __init__(self, name, root=HERE, manifest=None):
        manifest = manifest or os.path.join(os.path.dirname(root),
                                            "BENCHMARK.json")
        self.manifest = load_json(manifest)
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {manifest}")
        self.name = name
        self.entry = cells[name]
        self.config = load_json(os.path.join(
            root, "configs", self.entry["config"] + ".json"))
        if "problem" not in self.config:
            raise ValueError(
                f"configs/{self.entry['config']}.json names no \"problem\": "
                "the key that picks the module problems/<problem>.py")
        self.problem = load(root, "problems", self.config["problem"])
        self.traffic = load_json(os.path.join(
            root, "traffic", self.entry["traffic"] + ".json"))
        self.limits = load_json(os.path.join(root, "checks", name + ".json"))
        self.chips = int(self.entry["chips"])

    def metrics(self, trace):
        """The manifest's metrics this cell reports: end-to-end without a
        trace, per-layer with one; a metric with ``workloads`` only in
        those cells."""
        group = self.manifest["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or self.name in m["workloads"]]


def load(root, kind, name):
    """The module ``<kind>/<name>.py`` under ``root``, loaded by path."""
    path = os.path.join(root, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root, name):
    """The ``read`` function of ``metrics/<name>.py``."""
    return load(root, "metrics", name).read


class Step:
    """One iteration or step: where it ended on the host clock, its
    seconds since the previous boundary, what the optimizer reported, and
    the counters read at its end."""

    __slots__ = ("stretch", "solve", "index", "seconds", "energy", "lowest",
                 "theta", "grad", "parts", "trials")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


class Recorders:
    """The benchmark's records of one run:

    * ``pending``: the iterate (``"theta"``) and gradient (``"grad"``) of
      the step under way, kept by the problem's hooks and taken by the
      monitor at the step's boundary;
    * ``evaluations``: the energy evaluations the problem's hooks counted
      (each trial energy of a line search, each gradient step);
    * ``parts``: the program's part timer, on in the stretch that reads
      it;
    * the arguments of each ``gather_two_spin`` and ``scatter_rows`` call
      while ``launches`` is a list."""

    def __init__(self, program):
        self.program = program
        self.pending = {}
        self.evaluations = 0
        self.launches = None
        self._patched = []

    @property
    def parts(self):
        return self.program.parts

    def record_launches(self):
        """Wrap the kernels' Python entry points wherever the port's
        modules hold them; ``restore`` puts them back."""
        from auto_oo_tpu_torch.ops import grid_kernels as gk
        self.launches = []
        launches = self.launches

        def two_spin(orig):
            def wrapped(x, tables, r0, r1, *a, **k):
                launches.append(("gather_two_spin", tuple(x.shape),
                                 x.element_size(), tables, r0, r1))
                return orig(x, tables, r0, r1, *a, **k)
            return wrapped

        def scatter(orig):
            def wrapped(acc, Y, src, s, t, dst, dsg, r0):
                launches.append(("scatter_rows", tuple(Y.shape),
                                 Y.element_size(), src, s, t, r0))
                return orig(acc, Y, src, s, t, dst, dsg, r0)
            return wrapped

        for name, wrap in (("gather_two_spin", two_spin),
                           ("scatter_rows", scatter)):
            orig = getattr(gk, name)
            new = wrap(orig)
            for mod in list(sys.modules.values()):
                if (getattr(mod, "__name__", "").startswith(
                        "auto_oo_tpu_torch")
                        and getattr(mod, name, None) is orig):
                    setattr(mod, name, new)
                    self._patched.append((mod, name, orig))

    def restore(self):
        for mod, name, orig in self._patched:
            setattr(mod, name, orig)
        self._patched = []


class Monitor:
    """The optimizers' ``monitor``: a Step per ``log`` call, and the window
    closed at the first boundary at or past ``deadline`` once at least
    ``min_steps`` steps ran."""

    def __init__(self, run, stretch, t0, deadline, min_steps):
        self.run, self.stretch = run, stretch
        self.deadline, self.min_steps = deadline, min_steps
        self.solve, self.index, self.count = 0, 0, 0
        rec = run.recorders
        self.t_last = t0
        self.parts_last = dict(rec.parts.seconds)
        self.evals_last = rec.evaluations

    def next_solve(self):
        self.solve += 1
        self.index = 0

    def log(self, n, energy, lowest_hess_eig=None):
        """A step's boundary: ``energy`` and ``lowest_hess_eig`` are each a
        number, or one number per lane, read to the host before the
        clock."""
        energy, lowest_hess_eig = _host(energy), _host(lowest_hess_eig)
        now = time.perf_counter()
        rec = self.run.recorders
        parts = dict(rec.parts.seconds)
        diff = {k: v - self.parts_last.get(k, 0.0) for k, v in parts.items()
                if v - self.parts_last.get(k, 0.0) > 0.0}
        self.parts_last = parts
        step = Step(stretch=self.stretch, solve=self.solve, index=self.index,
                    seconds=now - self.t_last, energy=energy,
                    lowest=lowest_hess_eig,
                    theta=rec.pending.pop("theta", None),
                    grad=rec.pending.pop("grad", None), parts=diff,
                    trials=rec.evaluations - self.evals_last)
        self.evals_last = rec.evaluations
        self.run.steps.append(step)
        self.t_last = now
        self.index += 1
        self.count += 1
        if now >= self.deadline and self.count >= self.min_steps:
            raise WindowClosed


def _host(x):
    """A number as it is; one number per lane as a float64 array."""
    if x is None or isinstance(x, (int, float)):
        return x
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, dtype=np.float64)


class Run:
    """Everything a metric reader sees of one run."""

    def __init__(self, cell, seconds, trace):
        self.cell, self.seconds, self.trace = cell, seconds, trace
        self.steps = []
        self.stretches = []     # (t_start, t_end) of each stretch
        self.setup_s = None
        self.summary = None     # trace.TraceSummary of the profiled stretch
        self.launch_records = []
        self.launch_bytes = {}  # kernel -> summed bound bytes
        self.shapes = None
        self.recorders = None

    def steps_of(self, stretch):
        return [s for s in self.steps if s.stretch == stretch]

    def stretch_seconds(self, stretch):
        a, b = self.stretches[stretch]
        return b - a

    @property
    def profiled(self):
        """The stretch under the profiler (the last of a traced run)."""
        return len(self.stretches) - 1 if self.trace else None


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure(run, program, device):
    """The window: stretches of solves.  Without a trace one stretch of
    ``seconds``; with one, a first half with the part timer on and a
    second half under torch.profiler, the part timer off."""
    tr = run.cell.traffic
    steps = int(tr["steps_per_solve"])
    rec = run.recorders
    halves = [run.seconds / 2.0, run.seconds / 2.0] if run.trace else [
        float(run.seconds)]
    for stretch, length in enumerate(halves):
        profiled = run.trace and stretch == len(halves) - 1
        rec.parts.enabled = run.trace and not profiled
        prof = None
        _sync(device)
        if profiled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.device(device).type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            rec.record_launches()
            span = torch.profiler.record_function("bench.window")
            span.__enter__()
        t0 = time.perf_counter()
        mon = Monitor(run, stretch, t0, t0 + length,
                      tr["checked_steps"] + 1 if stretch == 0 else 1)
        try:
            while True:
                program.solve(steps, monitor=mon)
                mon.next_solve()
        except WindowClosed:
            pass
        t1 = mon.t_last
        if profiled:
            _sync(device)
            span.__exit__(None, None, None)
            prof.stop()
            rec.restore()
        rec.parts.enabled = False
        run.stretches.append((t0, t1))
        if prof is not None:
            from . import trace as _trace
            run.summary = _trace.summarize(prof)


def launch_bytes(run):
    """The frozen byte counts of the recorded launches, summed by kernel
    (identical launches counted once and multiplied)."""
    seen, total = {}, {}
    for rec in run.launch_records:
        kern = rec[0]
        if kern == "gather_two_spin":
            _, shape, size, tables, r0, r1 = rec
            key = (kern, shape, size, id(tables.srcA), r0, r1)
            if key not in seen:
                seen[key] = counts.two_spin_bytes(shape, size, tables, r0, r1)
        else:
            _, shape, size, src, s, t, r0 = rec
            key = (kern, shape, size, id(src), r0)
            if key not in seen:
                seen[key] = counts.scatter_bytes(shape, size, src, s, t, r0)
        total[kern] = total.get(kern, 0) + seen[key]
    return total


class Trajectory:
    """The first ``checked_steps`` steps of one solve, as the check compares
    them: ``energies`` (index, energy) pairs of every solve held (the
    energy after iteration index + 1, or before update index), ``lowest``
    (index, lowest Hessian eigenvalue) for damped Newton, ``theta`` the
    angles after the checked steps and ``grad`` Adam's first gradient.
    Of a batch, each energy and eigenvalue is an array over the lanes and
    ``theta`` and ``grad`` have a leading lane axis."""

    def __init__(self, energies, theta, lowest=(), grad=None):
        self.energies, self.theta = list(energies), np.asarray(theta)
        self.lowest, self.grad = list(lowest), grad


def _gap(a, b):
    """The largest |a - b| over the lanes (a number of one problem)."""
    return float(np.max(np.abs(np.subtract(a, b))))


def _lanes(*arrays):
    """The rows of each array, lane by lane (a 1-D array is one lane; a
    start shared by every lane is broadcast)."""
    return zip(*np.broadcast_arrays(*map(np.atleast_2d, arrays)))


def compare(theta0, got, ref):
    """The numbers compared: ``energy_gap``, the largest |E - E_ref| over
    the held steps (Ha); ``step_gap``, the gap between the norms of the
    angles' change over the checked steps, over the reference's;
    ``grad_gap`` (Adam), the same of the first gradient's norms;
    ``eig_gap`` (damped Newton), the largest |l0 - l0_ref| of the lowest
    Hessian eigenvalues (Ha / rad^2).  Of a batch, every number is the
    largest over the lanes, each lane against its own reference."""
    e_ref = dict(ref.energies)
    values = {"energy_gap": max(_gap(e, e_ref[i]) for i, e in got.energies)}
    values["step_gap"] = max(
        abs(np.linalg.norm(g - t0) - np.linalg.norm(r - t0))
        / np.linalg.norm(r - t0)
        for g, r, t0 in _lanes(got.theta, ref.theta, theta0))
    if ref.grad is not None:
        values["grad_gap"] = max(
            abs(np.linalg.norm(g) - np.linalg.norm(r)) / np.linalg.norm(r)
            for g, r in _lanes(got.grad, ref.grad))
    if ref.lowest:
        low = dict(ref.lowest)
        values["eig_gap"] = max(_gap(v, low[i]) for i, v in got.lowest)
    return values


def verdict(values, limits):
    """(correct, lines): each number beside its limit."""
    lines, correct = [], True
    for key, value in values.items():
        limit = float(limits[key]["limit"])
        ok = value <= limit
        correct = correct and ok
        lines.append(f"check {key}: {value:.6e} limit {limit:.6e} "
                     f"{'ok' if ok else 'FAIL'}")
    return correct, lines


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(name, seed, seconds, trace, device, root=HERE, manifest=None,
             t_start=None, log=sys.stderr):
    """One run of a cell on ``device``; returns the result's dict (the
    caller prints it).  ``t_start`` is the process's start on the host
    clock: set-up runs from it to the window."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(name, root, manifest)
    run = Run(cell, seconds, trace)
    marks = [("imports", time.perf_counter())]
    problem = cell.problem
    inputs = problem.inputs(cell, seed)
    marks.append(("inputs", time.perf_counter()))
    program = problem.build(cell, inputs, device)
    run.shapes = program.shapes
    _sync(device)
    marks.append(("program", time.perf_counter()))
    program.solve(int(cell.traffic["warmup_steps"]))
    _sync(device)
    marks.append(("warm-up", time.perf_counter()))
    run.recorders = Recorders(program)
    run.setup_s = marks[-1][1] - t_start
    last, parts = t_start, []
    for label, t in marks:
        parts.append(f"{label} {t - last:.3f}")
        last = t
    print(f"{cell.name}: route {program.route}, {inputs.describe}, "
          f"set-up {run.setup_s:.3f} s ({', '.join(parts)})", file=log,
          flush=True)
    with program.hook(run.recorders):
        measure(run, program, device)
    run.launch_records = run.recorders.launches or []
    run.launch_bytes = launch_bytes(run)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics = {}
    for m in cell.metrics(trace):
        value = reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    # the program's state goes before the reference runs on the card
    steps = run.steps
    run.recorders = None
    del program
    for s in steps:
        s.theta = None if s.theta is None else s.theta.detach().cpu()
        s.grad = None if s.grad is None else s.grad.detach().cpu()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    got = problem.program_trajectory(run)
    t_ref = time.perf_counter()
    values = compare(np.asarray(inputs.theta0, dtype=np.float64), got,
                     problem.reference_trajectory(cell, inputs, device))
    limits = cell.limits
    correct, lines = verdict(values, limits)
    print(f"reference {time.perf_counter() - t_ref:.2f} s; steps "
          f"{len(steps)}; trials {[s.trials for s in steps[:8]]}",
          file=log, flush=True)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": cell.chips if cuda else 1,
                   "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(steps),
        "failed": sum(1 for line in lines if line.endswith("FAIL")),
        "metrics": metrics, "device": device_info}
    if trace and run.summary is not None:
        device_info["busy_s"] = run.summary.busy_s
        device_info["window_s"] = run.summary.window_s
        result["breakdown"] = {"device_ops": run.summary.top_ops(),
                               "idle_gaps": run.summary.idle_gaps()}
    result["checks"] = {k: {"value": float(v),
                            "limit": float(limits[k]["limit"])}
                        for k, v in values.items()}
    for line in lines:
        print(line, file=log, flush=True)
    return result
