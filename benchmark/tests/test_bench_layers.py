"""The readers of the port's layer spans, on hand-built traces and span
records with known times: the idle readers charge each gap of the device
to the innermost span open on the host and sum to the idle total, the
sync readers count only the listed calls inside ``oo/`` spans, the
device-time readers sum the outermost spans of the profiled stretch, and
every reader returns None in a run of the other optimizer, without a
trace, or against a program without spans."""

import types

import pytest

from benchmark import harness, layers
from benchmark.trace import TraceSummary

IDLE = {"grad": ("ham_rdms_idle_ms.grad", "sweep_idle_ms.grad",
                 "loop_idle_ms.grad")}
DEV = {"newton": ("grad_hess_dev_ms", "update_dev_ms"),
       "adam": ("ham_rdms_dev_ms.grad", "sweep_dev_ms.grad")}
NEW = ("grad_hess_dev_ms", "update_dev_ms", "ham_rdms_dev_ms.grad",
       "sweep_dev_ms.grad", "ham_rdms_idle_ms.grad", "sweep_idle_ms.grad",
       "loop_idle_ms.grad", "host_syncs.nr", "host_syncs.grad")


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _events():
    """A window [0, 100] us: device busy [2, 8], [15, 40], [45, 60],
    [75, 90] (idle 39 us in five gaps); on the host a root step span over
    it all, a sweep [5, 30] with a launch [10, 12] inside, an H-apply
    [30, 70] and the Adam update [80, 95]; runtime calls in and out of
    the spans."""
    ev = [_x("user_annotation", "bench.window", 0, 100)]
    ev += [_x("kernel", "k", a, b - a)
           for a, b in ((2, 8), (15, 40), (45, 60), (75, 90))]
    ev += [_x("user_annotation", n, a, b - a) for n, a, b in (
        ("oo/loop:grad_step", 0, 100), ("oo/sim:state sweep", 5, 30),
        ("oo/kernel:gather_two_spin", 10, 12), ("oo/ham:H psi", 30, 70),
        ("oo/loop:adam_update", 80, 95))]
    ev += [_x("cuda_runtime", n, t, 1) for n, t in (
        ("cudaStreamSynchronize", 20), ("cudaMemcpyAsync", 25),
        ("cudaEventSynchronize", 11), ("cudaLaunchKernel", 11),
        ("cudaFree", 50), ("cudaStreamSynchronize_v3020", 52),
        ("cudaMemcpy", 85), ("cudaDeviceSynchronize", 105))]
    return ev


def _run(optimizer="adam", steps=2, summary=True, trace=True):
    cell = types.SimpleNamespace(traffic={"optimizer": optimizer})
    run = harness.Run(cell, 1.0, trace)
    run.stretches = [(0.0, 1.0), (1.0, 2.0)] if trace else [(0.0, 1.0)]
    last = len(run.stretches) - 1
    run.steps = [harness.Step(stretch=last, index=i) for i in range(steps)]
    run.summary = TraceSummary(_events()) if summary and trace else None
    return run


def test_idle_is_charged_to_the_innermost_span_and_sums_to_the_total():
    summary = TraceSummary(_events())
    charged, total = layers.idle_by_span(summary)
    assert total == pytest.approx(39.0)
    # [0, 2] root; [8, 15] the sweep (the launch inside it is no layer);
    # [40, 45] H psi; [60, 75] H psi 10, root 5; [90, 100] Adam 5, root 5
    assert charged == pytest.approx({
        "oo/loop:grad_step": 12.0, "oo/sim:state sweep": 7.0,
        "oo/ham:H psi": 15.0, "oo/loop:adam_update": 5.0})
    assert sum(charged.values()) == pytest.approx(total)
    run = _run(steps=2)
    got = [harness.reader(harness.HERE, name)(run) for name in IDLE["grad"]]
    assert got == pytest.approx([15.0e-3 / 2, 7.0e-3 / 2, 17.0e-3 / 2])
    share = harness.reader(harness.HERE, "idle_share.grad")(run)
    assert sum(got) * 2 == pytest.approx(share / 100 * 100e-3)


def test_uncovered_idle_is_charged_to_nothing():
    ev = [e for e in _events() if e["name"] != "oo/loop:grad_step"]
    charged, total = layers.idle_by_span(TraceSummary(ev))
    assert total == pytest.approx(39.0)
    assert charged == pytest.approx({"oo/sim:state sweep": 7.0,
                                     "oo/ham:H psi": 15.0,
                                     "oo/loop:adam_update": 5.0})


def test_segments_nest_and_clip():
    ev = [_x("user_annotation", "bench.window", 0, 50),
          _x("kernel", "k", 0, 1),
          _x("user_annotation", "oo/loop:a", -5, 40),
          _x("user_annotation", "oo/ham:b", 10, 32),   # outlasts a by 2
          _x("user_annotation", "oo/sim:c", 20, 5),
          _x("user_annotation", "oo/sim:d", 45, 10)]
    assert layers.segments(TraceSummary(ev)) == [
        (0, 10, "oo/loop:a"), (10, 20, "oo/ham:b"), (20, 25, "oo/sim:c"),
        (25, 35, "oo/ham:b"), (45, 50, "oo/sim:d")]


def test_host_syncs_count_the_listed_calls_inside_spans():
    summary = TraceSummary(_events())
    assert layers.syncs_by_span(summary) == {
        "oo/sim:state sweep": 2, "oo/ham:H psi": 2,
        "oo/loop:adam_update": 1}
    assert harness.reader(harness.HERE, "host_syncs.grad")(
        _run(steps=2)) == 2.5
    assert harness.reader(harness.HERE, "host_syncs.nr")(
        _run("newton", steps=5)) == 1.0


def _rec(i, name, parent, t0, dev):
    return types.SimpleNamespace(id=i, name=name, parent=parent,
                                 t0_ns=t0 * 1e9, t1_ns=t0 * 1e9 + 1,
                                 dev_ms=dev)


@pytest.fixture
def records(monkeypatch):
    """Span records of two steps of the profiled stretch [1, 2] s and one
    before it."""
    from auto_oo_tpu_torch.utils import observe
    recs = [_rec(0, "oo/loop:grad_step", None, 0.5, 99.0),
            _rec(1, "oo/ham:H psi", 0, 0.5, 50.0)]
    for s, t in ((0, 1.1), (1, 1.6)):
        r = 10 * (s + 1)
        recs += [_rec(r, "oo/loop:nr_iteration", None, t, 9.0),
                 _rec(r + 1, "oo/core:grad_hess", r, t, 6.0),
                 _rec(r + 2, "oo/ham:(H psi, RDMs) pass", r + 1, t, 4.0),
                 _rec(r + 3, "oo/ham:H psi", r + 2, t, 3.0),
                 _rec(r + 4, "oo/kernel:scatter_rows", r + 3, t, 1.0),
                 _rec(r + 5, "oo/sim:state sweep", r + 1, t, 1.5),
                 _rec(r + 6, "oo/loop:newton_update", r, t, 2.5)]
    monkeypatch.setattr(observe, "records", lambda: recs)
    return recs


def test_device_time_sums_the_outermost_spans_of_the_stretch(records):
    newton = _run("newton", steps=2)
    adam = _run("adam", steps=2)
    read = {n: harness.reader(harness.HERE, n) for n in NEW}
    assert read["grad_hess_dev_ms"](newton) == 6.0
    assert read["update_dev_ms"](newton) == 2.5
    assert read["ham_rdms_dev_ms.grad"](adam) == 4.0
    assert read["sweep_dev_ms.grad"](adam) == 1.5
    records[4].dev_ms = None
    assert read["ham_rdms_dev_ms.grad"](adam) is None


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_elsewhere(records, monkeypatch, name):
    read = harness.reader(harness.HERE, name)
    newton = name in DEV["newton"] or name.endswith(".nr")
    mine, other = ("newton", "adam") if newton else ("adam", "newton")
    assert read(_run(mine)) is not None
    assert read(_run(other)) is None
    assert read(_run(mine, trace=False)) is None
    assert read(_run(mine, steps=0)) is None
    # a program without spans: no records, no oo/ span in its trace
    from auto_oo_tpu_torch.utils import observe
    monkeypatch.delattr(observe, "records")
    run = _run(mine)
    run.summary = TraceSummary([e for e in _events()
                                if not e["name"].startswith("oo/")])
    assert read(run) is None
    # a trace without device operations (a run on the CPU)
    run.summary = TraceSummary([e for e in _events()
                                if e["cat"] != "kernel"])
    assert read(run) is None
