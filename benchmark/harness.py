"""The benchmark's harness: cells from data files, the program driven through
its public optimizers, a measured window, the trace, and the check.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs/<config>.json``), a traffic mix (``traffic/<traffic>.json``)
and the limits of its check (``checks/<cell>.json``).  Every metric is a
reader ``metrics/<name>.py`` with ``read(run)`` returning a number, or
None where it finds nothing to read.  New cells, mixes and metrics are
new files: nothing here names one.

A run: set-up builds the problem from the seed's inputs (``inputs``) and
runs a warm-up solve through the window's own call; the window runs
solves of ``steps_per_solve`` iterations (damped Newton) or steps (Adam)
from the seeded start, one after another, and ends at the first step
boundary past its length; the check follows the first steps of the plain
reference once the program is freed.
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


def reader(root, name):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(root, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Inputs:
    """What the seed draws, the same for the program and the reference:
    the chain's uniform spacing (a point of a PES scan), its geometry
    string, the start angles, and the sign-fixed RHF orbitals that both
    sides' circuits are written in."""

    def __init__(self, cell, seed):
        from .reference import chem
        cfg, tr = cell.config, cell.traffic
        rng = np.random.default_rng(int(seed))
        lo, hi = tr["spacing_angstrom"]
        self.spacing = round(float(rng.uniform(lo, hi)), 6)
        self.geometry = chem.chain_geometry(cfg["atoms"], self.spacing)
        lo, hi = tr["theta0"]
        self.theta0 = rng.uniform(lo, hi, cfg["n_theta"])
        S, hcore, eri, _ = chem.integrals(self.geometry)
        self.mo_coeff = chem.fix_signs(
            chem.rhf(S, hcore, eri, cfg["nelecas"])[1])


class Step:
    """One iteration or step: where it ended on the host clock, its
    seconds since the previous boundary, what the optimizer reported, and
    the counters read at its end."""

    __slots__ = ("stretch", "solve", "index", "seconds", "energy", "lowest",
                 "theta", "grad", "parts", "trials")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


class Program:
    """The port, built for one cell and driven through ``OO_pqc``'s
    ``full_optimization`` (damped Newton) or ``gradient_optimization``
    (Adam), with the benchmark's recorders around its calls."""

    def __init__(self, cell, inputs, device):
        import auto_oo_tpu_torch as P
        from auto_oo_tpu_torch.models.oo_energy import mo_ao_to_mo_oao
        cfg = cell.config
        self.cell = cell
        self.mol = P.Moldata(inputs.geometry, cfg["basis"])
        self.pqc = P.Parameterized_circuit(
            cfg["ncas"], cfg["nelecas"], ansatz=cfg["ansatz"],
            n_layers=cfg["n_layers"], sector=True, device=device)
        if int(self.pqc.theta_shape) != cfg["n_theta"]:
            raise ValueError(f"{cfg['name']}: the circuit has "
                             f"{self.pqc.theta_shape} angles, the "
                             f"configuration states {cfg['n_theta']}")
        oao = mo_ao_to_mo_oao(inputs.mo_coeff, self.mol.overlap)
        self.oo = P.OO_pqc(self.pqc, self.mol, cfg["ncas"], cfg["nelecas"],
                           oao_mo_coeff=oao,
                           freeze_active=cfg["freeze_active"],
                           precision=cfg["precision"])
        self.oao0 = self.oo.oao_mo_coeff.clone()
        self.theta0 = torch.as_tensor(inputs.theta0, dtype=torch.float64,
                                      device=device)
        self.route = self.oo._core["route"]
        self.shapes = (cfg["ncas"], int(self.pqc.state_dim),
                       int(self.pqc.theta_shape), int(self.oo.n_kappa),
                       int(self.oo.nao),
                       len(self.oo._occ) + len(self.oo._act),
                       counts.pairs_per_apply(cfg["ncas"], cfg["n_layers"]))

    def solve(self, steps, monitor=None):
        """One solve of ``steps`` from the seeded start, as a user runs it:
        no convergence stop (a negative tolerance)."""
        tr = self.cell.traffic
        self.oo.oao_mo_coeff = self.oao0.clone()
        if tr["optimizer"] == "newton":
            self.oo.full_optimization(
                self.theta0, max_iterations=steps, conv_tol=-1.0,
                alpha=tr["alpha"], beta=tr["beta"], mu=tr["mu"],
                rho=tr["rho"], lambda_min=tr["lambda_min"], monitor=monitor)
        elif tr["optimizer"] == "adam":
            self.oo.gradient_optimization(
                self.theta0, max_iterations=steps,
                learning_rate=tr["learning_rate"], conv_tol=-1.0,
                orbital_every=0, monitor=monitor)
        else:
            raise ValueError(f"unknown optimizer {tr['optimizer']!r}")


class Recorders:
    """The benchmark's spans and counters around the program's calls, on
    one Program's instances (the port is not edited):

    * the iterate and gradient of each step (``OO_pqc._nr_iteration``,
      ``OO_pqc.energy_and_gradient``), kept as references;
    * the energy evaluations (``Parameterized_circuit._state_impl_grid``,
      one per trial energy of a line search and per gradient step);
    * the Newton core's part timer (``_core["parts"]``), on in the
      stretch that reads it;
    * the arguments of each ``gather_two_spin`` and ``scatter_rows`` call
      while ``launches`` is a list."""

    def __init__(self, program):
        self.program = program
        self.pending = {}
        self.evaluations = 0
        self.launches = None
        oo, pqc = program.oo, program.pqc
        nr, eg, st = oo._nr_iteration, oo.energy_and_gradient, \
            pqc._state_impl_grid

        def nr_iteration(theta, oao, *args):
            out = nr(theta, oao, *args)
            self.pending["theta"] = out[0]
            return out

        def energy_and_gradient(theta):
            out = eg(theta)
            self.pending["theta"], self.pending["grad"] = theta, out[1]
            return out

        def state(theta):
            self.evaluations += 1
            return st(theta)

        oo._nr_iteration = nr_iteration
        oo.energy_and_gradient = energy_and_gradient
        pqc._state_impl_grid = state
        self._patched = []

    @property
    def parts(self):
        return self.program.oo._core["parts"]

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
    angles after the checked steps and ``grad`` Adam's first gradient."""

    def __init__(self, energies, theta, lowest=(), grad=None):
        self.energies, self.theta = list(energies), np.asarray(theta)
        self.lowest, self.grad = list(lowest), grad


def program_trajectory(run):
    """The program's Trajectory: every solve's first steps, in every
    stretch; the angles and gradient of the window's first solve."""
    cell = run.cell
    k = int(cell.traffic["checked_steps"])
    first = [s for s in run.steps if s.stretch == 0 and s.solve == 0]
    held = [s for s in run.steps if s.index < k]
    newton = cell.traffic["optimizer"] == "newton"
    theta = (first[k - 1] if newton else first[k]).theta
    grad = None if newton else first[0].grad[:cell.config["n_theta"]]
    return Trajectory(
        [(s.index, s.energy) for s in held],
        theta.double().cpu().numpy(),
        [(s.index, s.lowest) for s in held] if newton else (),
        None if grad is None else grad.double().cpu().numpy())


def reference_trajectory(cell, inputs, device, dtype=torch.float64):
    """The plain reference's Trajectory from the same inputs, computed in
    ``dtype`` (float32: the control)."""
    from .reference.problem import Reference
    cfg, tr = cell.config, cell.traffic
    k = int(tr["checked_steps"])
    ref = Reference(inputs.geometry, cfg["ncas"], cfg["n_layers"], device,
                    dtype)
    theta0 = np.asarray(inputs.theta0, dtype=np.float64)
    if tr["optimizer"] == "newton":
        out = ref.newton(theta0, k, tr["alpha"], tr["beta"], tr["mu"],
                         tr["rho"], tr["lambda_min"])
        return Trajectory(enumerate(o[1] for o in out), out[-1][0].numpy(),
                          enumerate(o[2] for o in out))
    energies, grad, theta = ref.adam(theta0, k, tr["learning_rate"])
    return Trajectory(enumerate(energies), theta, grad=grad)


def compare(theta0, got, ref):
    """The numbers compared: ``energy_gap``, the largest |E - E_ref| over
    the held steps (Ha); ``step_gap``, the gap between the norms of the
    angles' change over the checked steps, over the reference's;
    ``grad_gap`` (Adam), the same of the first gradient's norms;
    ``eig_gap`` (damped Newton), the largest |l0 - l0_ref| of the lowest
    Hessian eigenvalues (Ha / rad^2)."""
    e_ref = dict(ref.energies)
    values = {"energy_gap": max(abs(e - e_ref[i]) for i, e in got.energies)}
    moved = np.linalg.norm(ref.theta - theta0)
    values["step_gap"] = abs(np.linalg.norm(got.theta - theta0)
                             - moved) / moved
    if ref.grad is not None:
        norm = np.linalg.norm(ref.grad)
        values["grad_gap"] = abs(np.linalg.norm(got.grad) - norm) / norm
    if ref.lowest:
        low = dict(ref.lowest)
        values["eig_gap"] = max(abs(v - low[i]) for i, v in got.lowest)
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
    inputs = Inputs(cell, seed)
    marks.append(("inputs", time.perf_counter()))
    program = Program(cell, inputs, device)
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
    print(f"{cell.name}: route {program.route}, spacing {inputs.spacing} A, "
          f"set-up {run.setup_s:.3f} s ({', '.join(parts)})", file=log,
          flush=True)
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
    got = program_trajectory(run)
    t_ref = time.perf_counter()
    values = compare(np.asarray(inputs.theta0, dtype=np.float64), got,
                     reference_trajectory(cell, inputs, device))
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
