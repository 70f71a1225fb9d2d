"""The port's layer spans, counters, part timer and Monitor, on the CPU.

``utils/observe.py`` records spans ``oo/<layer>:<label>`` while
``tracing(True)`` is set or a profiler records: one root span per Newton
iteration or gradient step carrying its (solve, step) id, the core's
parts under it as ``core``, ``ham`` and ``sim`` spans on every route, and
counters attributed to the innermost open span.  Off, nothing is
recorded and no CUDA event is made.  The part timer (``_core["parts"]``)
keeps its labels and never resets the process's peak memory statistic.
Here on the (4e,4o) H4 chain, ``np_fabric`` L=1, on the fused,
streamed and hosted routes.
"""

import json

import pytest
import torch

import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.ops import grid, grid_hosted
from auto_oo_tpu_torch.utils import observe

GEO = "H 0 0 0; H 0 0 0.9; H 0 0 1.8; H 0 0 2.7"
ROUTES = ("fused", "streamed", "hosted")

#: the part timer's labels of one call, by route (the benchmark's
#: ham_rdms_ms.grad and sweep_ms.grad read the gradient pass's)
GRAD_LABELS = {
    "fused": {"state sweep", "H psi", "gradient sweep", "RDMs"},
    "streamed": {"state sweep", "H psi", "gradient sweep", "RDMs"},
    "hosted": {"state sweep", "(H psi, RDMs) pass", "gradient sweep"}}
HESS_LABELS = {
    "fused": {"state + J sweep",
              "Phi folds (H psi, H J, RDMs, transition RDMs)",
              "circuit-Hessian sweep", "Fock blocks"},
    "streamed": {"state + J sweep", "H psi", "H J (2 rows)",
                 "circuit-Hessian sweep", "RDMs of psi",
                 "transition RDMs and Fock blocks"},
    "hosted": {"state sweep", "pair sweeps (J_i)", "cross sweep",
               "H psi pass", "reverse pair sweeps (rows)"}}


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    before = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(before)


@pytest.fixture(autouse=True)
def _fresh():
    """Every test starts with tracing off and no records."""
    was = observe.tracing(False)
    observe.clear()
    yield
    observe.tracing(was)
    observe.clear()


@pytest.fixture(scope="module")
def mol():
    return P.Moldata(GEO, "sto-3g")


def _oo(mol, route, monkeypatch):
    kw = {}
    if route == "hosted":
        monkeypatch.setattr(grid_hosted, "_HOSTED_MIN_BYTES", 1)
        kw["stream_plan"] = grid.StreamPlan(3, 1, None)
    elif route == "streamed":
        kw["stream_plan"] = grid.StreamPlan(3, 5, None)
    pqc = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=1,
                                  sector=True)
    oo = P.OO_pqc(pqc, mol, 4, 4, freeze_active=True, **kw)
    assert oo._core["route"] == route
    return oo


def _theta(oo):
    n = int(oo.pqc.theta_shape)
    return 0.05 * torch.arange(n, dtype=torch.float64) - 0.1


def _both(oo, monitor=None):
    """Two Adam steps and two Newton iterations."""
    oo.gradient_optimization(_theta(oo), max_iterations=2, conv_tol=-1.0,
                             orbital_every=0, monitor=monitor)
    oo.full_optimization(_theta(oo), max_iterations=2, conv_tol=-1.0,
                         monitor=monitor)


class _Counting:
    """A stand-in that counts its calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self


def test_off_records_nothing_and_makes_no_event(mol, monkeypatch):
    events = _Counting()
    monkeypatch.setattr(torch.cuda, "Event", events)
    oo = _oo(mol, "fused", monkeypatch)
    mon = observe.Monitor()
    _both(oo, mon)
    assert not observe.active()
    assert observe.records() == [] and observe.counters() == {}
    assert events.calls == 0
    assert observe.span("sim", "x") is observe.span("ham", "y")
    assert all("counts" not in r and "layer_s" not in r
               for r in mon.records)


def _layers_by_root(recs):
    """{root id: set of layers under it}, checking that every span of a
    step nests under its one root and carries the root's step id."""
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent is None]
    out = {r.id: set() for r in roots}
    for r in recs:
        up = r
        while up.parent is not None:
            up = by_id[up.parent]
        assert up in roots
        assert r.step == up.step
        out[up.id].add(r.layer)
    return roots, out


@pytest.mark.parametrize("route", ROUTES)
def test_each_step_has_one_root_and_the_same_layers(mol, monkeypatch,
                                                    route):
    oo = _oo(mol, route, monkeypatch)
    observe.tracing(True)
    _both(oo)
    observe.tracing(False)
    recs = observe.records()
    assert all(r.t1_ns is not None and r.t1_ns >= r.t0_ns for r in recs)
    roots, layers = _layers_by_root(recs)
    assert [r.name for r in roots] == ["oo/loop:grad_step"] * 2 + [
        "oo/loop:nr_iteration"] * 2
    steps = [r.step for r in roots]
    assert steps[0][1:] == (0,) and steps[1][1:] == (1,)
    assert steps[2][1:] == (1,) and steps[3][1:] == (2,)
    assert steps[0][0] == steps[1][0] != steps[2][0] == steps[3][0]
    for root in roots[:2]:
        assert layers[root.id] == {"loop", "ham", "sim"}
    for root in roots[2:]:
        assert layers[root.id] == {"loop", "core", "ham", "sim"}
    names = {r.name for r in recs}
    assert {"oo/core:grad_hess", "oo/loop:newton_update",
            "oo/loop:armijo_trial", "oo/loop:adam_update"} <= names
    counts = observe.counters()
    assert counts["evaluations"] >= 4
    assert counts["host_syncs"] >= 4
    trials = [r for r in recs if r.name == "oo/loop:armijo_trial"]
    assert sum(r.counts.get("evaluations", 0) for r in trials) \
        == len(trials)


def test_spans_reach_the_profiler_trace(mol, monkeypatch, tmp_path):
    oo = _oo(mol, "fused", monkeypatch)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        assert observe.active()
        oo.gradient_optimization(_theta(oo), max_iterations=2,
                                 conv_tol=-1.0, orbital_every=0)
    assert not observe.active()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    names = [ev["name"] for ev in events
             if ev.get("cat") == "user_annotation"
             and ev.get("name", "").startswith("oo/")]
    assert names.count("oo/loop:grad_step") == 2
    assert {"oo/sim:state sweep", "oo/ham:H psi", "oo/sim:gradient sweep",
            "oo/ham:RDMs", "oo/loop:adam_update"} <= set(names)
    assert len(observe.records()) == len(names)


@pytest.mark.parametrize("route", ROUTES)
def test_part_timer_keeps_its_labels(mol, monkeypatch, route):
    oo = _oo(mol, route, monkeypatch)
    parts = oo._core["parts"]
    parts.enabled = True
    try:
        oo.energy_and_gradient(_theta(oo))
        assert set(parts.seconds) == GRAD_LABELS[route]
        parts.seconds = {}
        oo._grad_hess(_theta(oo))
        assert set(parts.seconds) == HESS_LABELS[route]
    finally:
        parts.enabled = False
    assert all(v >= 0.0 for v in parts.seconds.values())
    assert not hasattr(parts, "peaks")


def test_part_timer_never_resets_the_peak(mol, monkeypatch):
    """On a card the synced part syncs at its edges and leaves the
    process-wide peak alone; the card's calls are stand-ins here."""
    resets, syncs = _Counting(), _Counting()
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", resets)
    monkeypatch.setattr(torch.cuda, "synchronize", syncs)
    timer = observe.PartTimer(torch.device("cuda"))
    timer.enabled = True
    with timer("sim", "state sweep"):
        pass
    assert syncs.calls == 2 and set(timer.seconds) == {"state sweep"}
    oo = _oo(mol, "streamed", monkeypatch)
    oo._core["parts"].enabled = True
    _both(oo)
    assert resets.calls == 0


def test_the_record_cap_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(observe, "MAX_RECORDS", 4)
    observe.tracing(True)
    for i in range(10):
        with observe.span("sim", f"s{i}"):
            observe.count("host_syncs")
    recs = observe.records()
    assert [r.label for r in recs] == ["s6", "s7", "s8", "s9"]
    assert observe.counters() == {"dropped": 6, "host_syncs": 10}
    assert all(r.counts == {"host_syncs": 1} for r in recs)


def test_nested_spans_and_counters(monkeypatch):
    observe.tracing(True)
    with observe.span("loop", "grad_step", (7, 3)) as root:
        with observe.span("ham", "H psi") as ham:
            with observe.span("kernel", "gather_two_spin") as k:
                observe.count("launches")
            observe.count("host_syncs", 2)
    assert (k.parent, ham.parent, root.parent) == (ham.id, root.id, None)
    assert k.step == ham.step == (7, 3)
    assert k.name == "oo/kernel:gather_two_spin"
    assert ham.counts == {"host_syncs": 2} and k.counts == {"launches": 1}
    assert root.counts == {} and k.dev_ms is None
    with pytest.raises(KeyError):
        with observe.span("loop", "grad_step", (7, 4)):
            with observe.span("sim", "state sweep"):
                raise KeyError
    assert observe._stack() == []
    assert [r.t1_ns is not None for r in observe.records()] == [True] * 5


def test_monitor_timestamps_and_traced_fields(mol, monkeypatch, tmp_path):
    oo = _oo(mol, "streamed", monkeypatch)
    path = tmp_path / "run.jsonl"
    mon = observe.Monitor(jsonl_path=str(path))
    oo.gradient_optimization(_theta(oo), max_iterations=2, conv_tol=-1.0,
                             orbital_every=0, monitor=mon)
    observe.tracing(True)
    _both(oo, mon)
    mon.close()
    recs = mon.records
    assert [r["iter"] for r in recs] == [0, 1, 0, 1, 1, 2]
    t = [r["t_ns"] for r in recs]
    assert t == sorted(t)
    for a, b in zip(recs, recs[1:]):
        assert b["step_s"] == pytest.approx((b["t_ns"] - a["t_ns"]) * 1e-9)
    assert all("layer_s" not in r for r in recs[:2])
    for r in recs[2:4]:
        assert set(r["layer_s"]) == {"ham", "sim"}
        assert r["layer_dev_s"] == {}
        assert r["counts"]["evaluations"] == 1
        assert r["counts"]["host_syncs"] >= 2
    for r in recs[4:]:
        assert set(r["layer_s"]) == {"core", "ham", "sim", "loop"}
        assert r["counts"]["evaluations"] >= 1
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert lines == recs
