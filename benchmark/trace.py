"""Reading a torch.profiler trace: device busy time, kernel times and the
host's activity in the device's idle gaps.

The trace is read from its Chrome-trace export, whose event categories
("kernel", "gpu_memcpy", "gpu_memset" on the device; "cpu_op",
"user_annotation", "cuda_runtime" on the host) and microsecond
timestamps are PyTorch's stable export format.
"""

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


class TraceSummary:
    """The device side of one traced stretch.

    ``window`` is the (start, end) in microseconds of the stretch's
    ``bench.window`` annotation; ``ops`` the device operations (name,
    start, duration) that overlap it, clipped to it; ``host`` the host
    events (name, start, duration)."""

    def __init__(self, events):
        self.window = None
        self.ops, self.host = [], []
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat, ts, dur = ev.get("cat"), float(ev["ts"]), float(ev["dur"])
            if cat == "user_annotation" and ev.get("name") == WINDOW:
                self.window = (ts, ts + dur)
            if cat in DEVICE_CATS:
                self.ops.append((ev.get("name", "?"), ts, dur))
            elif cat in HOST_CATS and ev.get("name") != WINDOW:
                self.host.append((ev.get("name", "?"), ts, dur))
        if self.window is None and self.ops:
            self.window = (min(t for _, t, _ in self.ops),
                           max(t + d for _, t, d in self.ops))
        if self.window is not None:
            w0, w1 = self.window
            clipped = []
            for name, t, d in self.ops:
                a, b = max(t, w0), min(t + d, w1)
                if b > a:
                    clipped.append((name, a, b - a))
            self.ops = clipped

    @property
    def window_s(self):
        return 0.0 if self.window is None else (
            self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self):
        """The union of the device operations' intervals, merged, in
        microseconds."""
        spans = sorted((t, t + d) for _, t, d in self.ops)
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def device_seconds(self, match):
        """Summed device seconds of the operations whose name ``match``
        accepts, and their count."""
        sel = [d for name, _, d in self.ops if match(name)]
        return sum(sel) * 1e-6, len(sel)

    def top_ops(self, k=10):
        by = {}
        for name, _, d in self.ops:
            by[name] = by.get(name, 0.0) + d
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        # a kernel's name carries its template arguments; its head names it
        return [[name[:160], us * 1e-6] for name, us in top]

    def idle_gaps(self, k=10):
        """The ``k`` longest idle gaps of the device inside the window, each
        named by the innermost host event running at its middle."""
        if self.window is None:
            return []
        w0, w1 = self.window
        edges = [w0]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(w1)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:k]
        host = sorted(self.host, key=lambda h: h[1])
        out = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inner = [(d, name) for name, t, d in host if t <= mid <= t + d]
            label = min(inner)[1] if inner else "python"
            out.append([label, (b - a) * 1e-6])
        return out


def summarize(prof):
    """A TraceSummary of a stopped torch.profiler.profile, through its
    Chrome-trace export in a temporary file that is removed after."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return TraceSummary(events)
