"""Per-iteration records of the optimizer loops, and the port's layer
spans and counters.

Port of auto_oo_tpu/utils/observe.py (pure Python): a structured
record stream with pluggable sinks (stdout, a JSONL file, memory)
carrying the physics diagnostics (energy, lowest Hessian eigenvalue,
wall time), in place of the reference's print + verbose flags
(SURVEY.md section 5).  ``OO_pqc.full_optimization(monitor=)`` and
``gradient_optimization(monitor=)`` call ``log`` once per iteration.

The spans (``span(layer, label)``) mark the port's layers: ``loop`` (the
optimizer loops: a root span per Newton iteration or gradient step,
carrying its (solve, step) id, and the Newton update, the Armijo trials,
the Adam update and the monitor under it), ``core`` (the Newton core's
``grad_hess`` and its orbital parts), ``ham`` (the H-applies and RDM
passes), ``sim`` (the simulator's sweeps) and ``kernel`` (one per launch
of a grid kernel).  ``count(name, n)`` adds to a counter: ``evaluations``
(energy evaluations), ``host_syncs`` (the port's own reads of a device
value on the host, each of which waits for the queue to drain).

Spans record while ``tracing(True)`` is set or a ``torch.profiler`` is
recording; otherwise ``span`` costs one flag check and returns a shared
empty context.  A recorded span keeps its name ``oo/<layer>:<label>``,
its parent, its step id, its host start and end (``perf_counter_ns``)
and, on the card, a pair of CUDA events at its edges whose elapsed time
(``dev_ms``) is read without a synchronize once the events are done, or
at ``flush()``.  It also opens ``torch.profiler.record_function`` under
its name, so it appears in a profiler's trace (and under ``emit_nvtx``)
on the device ops' clock.  At most ``MAX_RECORDS`` spans are kept; the
oldest go first and the ``dropped`` counter counts them.

``PartTimer`` is the synced mode of ``span`` (the Newton core's
``_core["parts"]``): while ``enabled`` each part starts and ends in a
synchronize and its host seconds add up by label in ``seconds``.
"""

import collections
import contextlib
import itertools
import json
import threading
import time

import torch
from torch.autograd import profiler as _profiler

#: the span records kept, the oldest dropped past it
MAX_RECORDS = 100_000

_ON = False
_RECORDS = collections.deque()
_COUNTS = {}
_IDS = itertools.count()
_SOLVES = itertools.count()
_LOCAL = threading.local()
_NULL = contextlib.nullcontext()


def tracing(on=None):
    """Turn recording on or off (``on`` None leaves it); returns whether
    it was on.  A ``torch.profiler`` that records turns it on as well, for
    as long as it records."""
    global _ON
    was = _ON
    if on is not None:
        _ON = bool(on)
    return was


def active():
    """Whether spans and counters record now."""
    return _ON or _profiler._is_profiler_enabled


def _stack():
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


class Span:
    """One recorded span: ``name`` (``oo/<layer>:<label>``), ``id``,
    ``parent`` (the enclosing span's id, or None), ``step`` (the root
    span's (solve, step) id), host ``t0_ns`` / ``t1_ns`` (``t1_ns`` None
    while open), ``dev_ms`` (device milliseconds between its events, None
    until read or off the card) and ``counts`` (the counters added while
    it was the innermost open span)."""

    __slots__ = ("name", "layer", "label", "id", "parent", "step", "t0_ns",
                 "t1_ns", "dev_ms", "counts", "_events", "_fn")

    def __init__(self, layer, label, step):
        self.layer, self.label, self.step = layer, label, step
        self.name = f"oo/{layer}:{label}"
        self.t1_ns = self.dev_ms = self._events = None
        self.counts = {}

    def __enter__(self):
        st = _stack()
        parent = st[-1] if st else None
        self.parent = parent.id if parent is not None else None
        if self.step is None and parent is not None:
            self.step = parent.step
        self.id = next(_IDS)
        self._fn = _profiler.record_function(self.name)
        self._fn.__enter__()
        if torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._events = (start, None)
        if len(_RECORDS) >= MAX_RECORDS:
            _RECORDS.popleft()
            _COUNTS["dropped"] = _COUNTS.get("dropped", 0) + 1
        _RECORDS.append(self)
        st.append(self)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1_ns = time.perf_counter_ns()
        if self._events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events = (self._events[0], end)
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:
            st.remove(self)
        self._fn.__exit__(*exc)
        self._fn = None
        return False

    def resolve(self, wait=False):
        """Read ``dev_ms`` from the span's events once both are done (with
        ``wait``, after a synchronize of the end event); True once read."""
        ev = self._events
        if ev is None or ev[1] is None:
            return self.dev_ms is not None
        if wait:
            ev[1].synchronize()
        elif not (ev[0].query() and ev[1].query()):
            return False
        self.dev_ms = ev[0].elapsed_time(ev[1])
        self._events = None
        return True


def span(layer, label, step=None):
    """The context of one span of ``layer`` (loop, core, ham, sim,
    kernel) named by ``label``; ``step`` is a root span's (solve, step)
    id, which its children inherit.  Off, a shared empty context."""
    if not (_ON or _profiler._is_profiler_enabled):
        return _NULL
    return Span(layer, label, step)


def count(name, n=1):
    """Add ``n`` to the counter ``name``, and to the innermost open span's
    counts, while recording."""
    if not (_ON or _profiler._is_profiler_enabled):
        return
    _COUNTS[name] = _COUNTS.get(name, 0) + n
    st = _stack()
    if st:
        c = st[-1].counts
        c[name] = c.get(name, 0) + n


def new_solve():
    """The next solve id: one per optimizer loop run."""
    return next(_SOLVES)


def counters():
    """The counters' totals since the last ``clear`` (``dropped`` among
    them)."""
    return dict(_COUNTS)


def flush():
    """Read the device time of every closed span (waiting for its end
    event where it is not done yet)."""
    for rec in _RECORDS:
        if rec.t1_ns is not None:
            rec.resolve(wait=True)


def records():
    """The recorded spans, oldest first (closed ones with their device
    time read; ``flush`` first)."""
    flush()
    return list(_RECORDS)


def clear():
    """Forget the records and counters."""
    _RECORDS.clear()
    _COUNTS.clear()


class PartTimer:
    """Host-clock seconds of the parts of a grad_hess or gradient pass,
    summed by label over a call, while ``enabled`` (the profile scripts
    and the benchmark's part-timed stretch): each part is a ``span`` that
    starts and ends in a synchronize.  Off, a part is a plain ``span``."""

    def __init__(self, device):
        self.device = device
        self.enabled = False
        self.seconds = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def _synced(self, layer, label):
        self._sync()
        t0 = time.perf_counter()
        with span(layer, label):
            yield
            self._sync()
        self.seconds[label] = (self.seconds.get(label, 0.0)
                               + time.perf_counter() - t0)

    def __call__(self, layer, label):
        if self.enabled:
            return self._synced(layer, label)
        return span(layer, label)


def _step_spans():
    """The closed spans of the innermost open root span's step, from the
    newest back to the root."""
    st = _stack()
    if not st:
        return []
    root = st[0]
    out = []
    for rec in reversed(_RECORDS):
        if rec is root:
            break
        if rec.t1_ns is not None and rec.step == root.step:
            out.append(rec)
    return out


def _layer_seconds(spans):
    """Host and device seconds of ``spans`` by layer, each layer counted
    over its outermost spans (those with no ancestor of the same layer
    among them); device seconds only where every such span's events were
    read."""
    by_id = {rec.id: rec for rec in spans}
    host, dev, complete = {}, {}, {}
    for rec in spans:
        up = by_id.get(rec.parent)
        while up is not None and up.layer != rec.layer:
            up = by_id.get(up.parent)
        if up is not None:
            continue
        host[rec.layer] = host.get(rec.layer, 0.0) + (
            rec.t1_ns - rec.t0_ns) * 1e-9
        read = rec.resolve()
        complete[rec.layer] = complete.get(rec.layer, True) and read
        if read and rec.dev_ms is not None:
            dev[rec.layer] = dev.get(rec.layer, 0.0) + rec.dev_ms * 1e-3
    dev = {k: v for k, v in dev.items() if complete[k]}
    return host, dev


class Monitor:
    """Collects per-iteration records; optionally tees to stdout/JSONL.

    Every record has ``wall_s`` (time.time since the monitor was made),
    ``t_ns`` (``time.perf_counter_ns`` at the call) and ``step_s``
    (seconds since the previous record, or since the monitor was made).
    While spans record (``tracing(True)`` or a profiler), a record made
    inside a root span also has ``layer_s`` (host seconds of the step's
    closed spans by layer, each layer over its outermost spans),
    ``layer_dev_s`` (the same in device seconds on the card, for the
    layers whose events are done) and ``counts`` (the counters added since
    the previous record, with ``launches.<kernel>`` for each grid kernel
    launched)."""

    def __init__(self, stdout=False, jsonl_path=None, label=""):
        self.records = []
        self.stdout = stdout
        self.label = label
        self._fh = open(jsonl_path, "a") if jsonl_path else None
        self._t0 = time.time()
        self._last_ns = time.perf_counter_ns()
        self._last_counts = self._counts()

    @staticmethod
    def _counts():
        from ..ops.grid_kernels import LAUNCHES
        now = dict(_COUNTS)
        now.update({f"launches.{k}": v for k, v in LAUNCHES.items()})
        return now

    def log(self, iteration, energy, **metrics):
        t_ns = time.perf_counter_ns()
        rec = {"label": self.label, "iter": int(iteration),
               "energy": float(energy),
               "wall_s": round(time.time() - self._t0, 6),
               "t_ns": t_ns, "step_s": (t_ns - self._last_ns) * 1e-9}
        self._last_ns = t_ns
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        now, last = self._counts(), self._last_counts
        self._last_counts = now
        if active():
            spans = _step_spans()
            if spans:
                rec["layer_s"], rec["layer_dev_s"] = _layer_seconds(spans)
            rec["counts"] = {k: v - last.get(k, 0) for k, v in now.items()
                             if v != last.get(k, 0)}
        self.records.append(rec)
        if self.stdout:
            shown = {k: v for k, v in rec.items() if k != "label"}
            print(" ".join(f"{k}={v}" for k, v in shown.items()),
                  flush=True)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def energies(self):
        return [r["energy"] for r in self.records]
