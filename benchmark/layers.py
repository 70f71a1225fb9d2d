"""What the readers of the port's layer spans share.

The port names its layers with spans (``auto_oo_tpu_torch/utils/
observe.py``): ``oo/<layer>:<label>`` for the layers ``loop``, ``core``,
``ham``, ``sim`` and ``kernel``.  They record in the profiled stretch
(a profiler is recording there), each with its host interval and, on
the card, its device time between two CUDA events; each also lands in
the profiler's trace as a ``user_annotation`` on the device ops' clock.

Two readings come from them:

* device milliseconds of a set of spans, from the program's records
  (``dev_ms``), summed over the outermost spans of the set (a span
  inside another of the set is not counted again);
* the device's idle time inside ``bench.window`` (the gaps between the
  union of device operations, as ``idle_share`` computes it) and the
  host calls that wait on the device, charged instant by instant to the
  innermost ``oo/`` span open on the host.  Kernel spans name a launch,
  not a layer: an instant inside one is charged to the span around it.

Each function returns None where its run has nothing to read: another
optimizer, no traced stretch, or a program without spans.
"""

import bisect
import re

PREFIX = "oo/"
KERNEL = "oo/kernel:"

#: the host runtime calls that wait on the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaFree")
_VERSION = re.compile(r"_v\d+$")


def profiled_steps(run, optimizer):
    """The steps of the profiled stretch of a run of ``optimizer``."""
    if run.cell.traffic["optimizer"] != optimizer or run.profiled is None:
        return None
    return run.steps_of(run.profiled) or None


def span_records(run):
    """The program's span records that started inside the profiled
    stretch, their device time read; None where the program keeps
    none."""
    from auto_oo_tpu_torch.utils import observe
    records = getattr(observe, "records", None)
    if records is None or run.profiled is None:
        return None
    t0, t1 = run.stretches[run.profiled]
    lo, hi = t0 * 1e9, t1 * 1e9
    return [r for r in records()
            if r.t1_ns is not None and lo <= r.t0_ns <= hi]


def outermost(records, match):
    """The records whose name ``match`` accepts and that lie inside no
    other accepted record (by their parent links)."""
    by_id = {r.id: r for r in records}
    out = []
    for r in records:
        if not match(r.name):
            continue
        up = by_id.get(r.parent)
        while up is not None and not match(up.name):
            up = by_id.get(up.parent)
        if up is None:
            out.append(r)
    return out


def dev_ms(run, optimizer, match):
    """Device milliseconds per step in the outermost spans that ``match``
    accepts, between each span's CUDA events."""
    steps = profiled_steps(run, optimizer)
    records = span_records(run) if steps else None
    if not records:
        return None
    sel = outermost(records, match)
    if not sel or any(r.dev_ms is None for r in sel):
        return None
    return sum(r.dev_ms for r in sel) / len(steps)


def segments(summary):
    """(start, end, name) in microseconds of the innermost non-kernel
    ``oo/`` span open on the host, piece by piece, inside the window; the
    spans of one thread nest (a child that outlasts its parent by the
    trace's rounding ends with it).  Empty in a trace without device
    operations (a run on the CPU)."""
    if summary is None or summary.window is None or not summary.ops:
        return []
    w0, w1 = summary.window
    spans = sorted(((max(t, w0), min(t + d, w1), name)
                    for name, t, d in summary.host
                    if name.startswith(PREFIX)
                    and not name.startswith(KERNEL)),
                   key=lambda s: (s[0], -s[1]))
    out, stack, cur = [], [], None

    def emit(a, b, name):
        if b > a:
            out.append((a, b, name))

    for a, b, name in spans:
        if b <= a:
            continue
        while stack and stack[-1][0] <= a:
            end, top = stack.pop()
            emit(cur, end, top)
            cur = end
        if stack:
            emit(cur, a, stack[-1][1])
            b = min(b, stack[-1][0])
        cur = a
        stack.append((b, name))
    while stack:
        end, top = stack.pop()
        emit(cur, end, top)
        cur = end
    return out


def idle_gaps(summary):
    """The device's idle intervals inside the window, in microseconds."""
    w0, w1 = summary.window
    edges = [w0]
    for a, b in summary.busy_intervals():
        edges += [a, b]
    edges.append(w1)
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_by_span(summary):
    """Idle microseconds of the device by the name of the innermost span
    open on the host, and the whole idle time; None without spans."""
    segs = segments(summary)
    if not segs:
        return None
    gaps = idle_gaps(summary)
    charged, i = {}, 0
    for g0, g1 in gaps:
        while i < len(segs) and segs[i][1] <= g0:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < g1:
            a, b = max(segs[j][0], g0), min(segs[j][1], g1)
            if b > a:
                charged[segs[j][2]] = charged.get(segs[j][2], 0.0) + b - a
            j += 1
    return charged, sum(b - a for a, b in gaps)


def idle_ms(run, optimizer, layer):
    """Idle device milliseconds per step charged to the spans of
    ``layer``."""
    steps = profiled_steps(run, optimizer)
    out = idle_by_span(run.summary) if steps else None
    if out is None:
        return None
    head = f"{PREFIX}{layer}:"
    us = sum(v for k, v in out[0].items() if k.startswith(head))
    return 1e-3 * us / len(steps)


def syncs_by_span(summary):
    """The host calls of ``SYNC_CALLS`` inside the window that start
    inside an ``oo/`` span, counted by the innermost span's name; None
    without spans."""
    segs = segments(summary)
    if not segs:
        return None
    starts = [s[0] for s in segs]
    out = {}
    for name, t, _ in summary.host:
        if _VERSION.sub("", name) not in SYNC_CALLS:
            continue
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and segs[k][0] <= t < segs[k][1]:
            out[segs[k][2]] = out.get(segs[k][2], 0) + 1
    return out


def host_syncs(run, optimizer):
    """Host calls that wait on the device, per step, inside ``oo/``
    spans."""
    steps = profiled_steps(run, optimizer)
    out = syncs_by_span(run.summary) if steps else None
    if out is None:
        return None
    return sum(out.values()) / len(steps)
