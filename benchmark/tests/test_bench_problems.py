"""A problem of a new kind is files alone: a geometry batch of hydrogen
chains (``geometry_batch.py``), written into a tiny root as
``problems/hbatch.py`` with its configuration, check and manifest entry,
runs through ``harness.run_cell`` with the readers and metric files as
they are, comes out correct, and fails its check under planted faults."""

import hashlib
import json
import os
import shutil

import pytest
import torch

from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.parallel import sharding

from benchmark import control, harness

import tiny

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 2 ** 31 + 23


def _digests():
    """The harness's common files, as bytes' digests."""
    names = ["harness.py", "readers.py", "control.py"] + [
        os.path.join("metrics", f)
        for f in sorted(os.listdir(os.path.join(harness.HERE, "metrics")))
        if f.endswith(".py")]
    return {n: hashlib.sha256(open(os.path.join(harness.HERE, n),
                                   "rb").read()).hexdigest() for n in names}


@pytest.fixture(scope="module")
def batch_root(tmp_path_factory):
    """A tiny root with the cell ``tiny-batch``: two H4 chains in one
    GeometryBatch, damped Newton (``nr_restart4``)."""
    previous = config.get_device()
    config.set_device("cpu")
    before = _digests()
    root, path = tiny.make_root(str(tmp_path_factory.mktemp("batch")),
                                atoms=4)
    shutil.copy(os.path.join(HERE, "geometry_batch.py"),
                os.path.join(root, "problems", "hbatch.py"))
    cfg = harness.load_json(os.path.join(root, "configs", "h4.json"))
    cfg.update(name="h4_batch2", problem="hbatch", lanes=2)
    with open(os.path.join(root, "configs", "h4_batch2.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(root, "checks", "tiny-nr.json"),
                os.path.join(root, "checks", "tiny-batch.json"))
    man = harness.load_json(path)
    man["workloads"].append({"name": "tiny-batch", "config": "h4_batch2",
                             "traffic": "nr_restart4", "chips": 1,
                             "why": "test"})
    for group in ("end_to_end", "per_layer"):
        for m in man[group]:
            if "tiny-nr" in m.get("workloads", ()):
                m["workloads"].append("tiny-batch")
    with open(path, "w") as f:
        json.dump(man, f)
    yield root, path, before
    config.set_device(previous)


def _run(batch_root, trace=False):
    root, path, _ = batch_root
    return harness.run_cell("tiny-batch", SEED, 0.5, trace, "cpu",
                            root=root, manifest=path)


@pytest.mark.parametrize("trace", [False, True])
def test_a_geometry_batch_runs_correct_from_files_alone(batch_root, trace):
    root, _, before = batch_root
    result = _run(batch_root, trace)
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == {"energy_gap", "step_gap", "eig_gap"}
    assert result["checks"]["energy_gap"]["value"] < 1e-11
    assert ("nr_mfu" if trace else "nr_iter_s") in result["metrics"]
    assert result["metrics"].get("nr_mfu", {"value": 1.0})["value"] > 0.0
    # the harness, the readers, the control and every metric reader as
    # they were, and the tiny root's readers the benchmark's own files
    assert _digests() == before
    for name in os.listdir(os.path.join(harness.HERE, "metrics")):
        if name.endswith(".py"):
            with open(os.path.join(harness.HERE, "metrics", name)) as a, \
                    open(os.path.join(root, "metrics", name)) as b:
                assert a.read() == b.read(), name


def test_one_lane_left_unchanged_fails_the_check(batch_root, monkeypatch):
    orig = sharding.GeometryBatch.newton_steps

    def unchanged(self, thetas, oaos, **kw):
        out = list(orig(self, thetas, oaos, **kw))
        out[0] = out[0].clone()
        out[0][1] = torch.as_tensor(thetas)[1]
        return tuple(out)

    monkeypatch.setattr(sharding.GeometryBatch, "newton_steps", unchanged)
    result = _run(batch_root)
    assert result["correct"] is False
    assert result["checks"]["step_gap"]["value"] == pytest.approx(1.0)


def test_one_lane_energy_altered_fails_the_check(batch_root, monkeypatch):
    orig = sharding.GeometryBatch.newton_steps

    def altered(self, thetas, oaos, **kw):
        out = list(orig(self, thetas, oaos, **kw))
        out[3] = out[3] + torch.tensor([0.0, 1e-7], dtype=out[3].dtype)
        return tuple(out)

    monkeypatch.setattr(sharding.GeometryBatch, "newton_steps", altered)
    result = _run(batch_root)
    assert result["correct"] is False
    assert result["checks"]["energy_gap"]["value"] > 5e-8


def test_the_control_goes_through_the_problem(batch_root):
    root, path, _ = batch_root
    cell = harness.Cell("tiny-batch", root, path)
    values = control.readings(cell, 3, "cpu")
    assert not harness.verdict(values, cell.limits)[0], values


def test_a_configuration_without_a_problem_is_refused(batch_root):
    root, path, _ = batch_root
    cfg_path = os.path.join(root, "configs", "h4.json")
    cfg = harness.load_json(cfg_path)
    del cfg["problem"]
    bare = os.path.join(root, "configs", "h4_bare.json")
    with open(bare, "w") as f:
        json.dump(cfg, f)
    man = harness.load_json(path)
    man["workloads"] = [dict(w, config="h4_bare") for w in man["workloads"]
                        if w["name"] == "tiny-nr"]
    bare_manifest = os.path.join(os.path.dirname(path), "bare.json")
    with open(bare_manifest, "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match='"problem"'):
        harness.Cell("tiny-nr", root, bare_manifest)
