"""The harness: its manifest, its data-driven lookups, its refusal without
a card, and whole runs of tiny cells on the CPU."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness, readers

import tiny

ROOT = os.path.dirname(harness.HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_manifest_names_units_and_files(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in names
            names.add(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert os.path.exists(os.path.join(
                    harness.HERE, "metrics", entry["name"] + ".py"))
    for cfg in manifest["configs"]:
        assert os.path.exists(os.path.join(ROOT, cfg["file"]))
        data = harness.load_json(os.path.join(ROOT, cfg["file"]))
        assert data["reduced"] == cfg["reduced"] == []
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(cfg["why"]) <= 200 and len(cfg["source"]) <= 200
    for w in manifest["workloads"]:
        for sub, key in (("traffic", w["traffic"]), ("checks", w["name"])):
            assert os.path.exists(os.path.join(harness.HERE, sub,
                                               key + ".json"))
        assert len(w["why"]) <= 200


def test_each_layer_metric_moves_a_metric_its_cells_report(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = [w["name"] for w in manifest["workloads"]]
    for m in manifest["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for cell in cells:
        reported = [m for m in manifest["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in manifest["per_layer"])


def test_chips(manifest):
    cells = manifest["workloads"]
    four = [w for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)
    assert all(w["chips"] == 1 for w in cells)


def test_new_files_are_found_by_name(tmp_path):
    root, path = tiny.make_root(str(tmp_path))
    man = harness.load_json(path)
    # a new traffic mix, a new cell and a new metric reader: files only
    tr = harness.load_json(os.path.join(root, "traffic",
                                        "adam_lr05.json"))
    tr["learning_rate"] = 0.02
    with open(os.path.join(root, "traffic", "adam_lr02.json"), "w") as f:
        json.dump(tr, f)
    shutil.copy(os.path.join(root, "checks", "tiny-adam.json"),
                os.path.join(root, "checks", "tiny-adam2.json"))
    man["workloads"].append({"name": "tiny-adam2", "config": "h6",
                             "traffic": "adam_lr02", "chips": 1,
                             "why": "test"})
    with open(os.path.join(root, "metrics", "steps_n.py"), "w") as f:
        f.write("def read(run):\n    return len(run.steps)\n")
    man["end_to_end"].append({"name": "steps_n", "unit": "1",
                              "better": "higher", "bound": 0.25,
                              "source": "host_clock"})
    with open(path, "w") as f:
        json.dump(man, f)
    cell = harness.Cell("tiny-adam2", root, path)
    assert cell.traffic["learning_rate"] == 0.02
    assert "steps_n" in [m["name"] for m in cell.metrics(False)]
    assert harness.reader(root, "steps_n")(type("R", (), {"steps": [1]})) \
        == 1


def test_the_chip_path_refuses_without_a_card(tmp_path):
    """Without a card the command exits non-zero and prints no result; a
    checkout without the program fails too."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "h14-nr-f64",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    bare = tmp_path / "bare"
    shutil.copytree(harness.HERE, bare / "benchmark")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), bare)
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; import benchmark.harness as h; "
         "h.run_cell('h14-nr-f64', 1, 1, False, 'cpu')"],
        cwd=bare, capture_output=True, text=True, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_tiny_run_loads_no_jax(tmp_path):
    """Importing benchmark.run and running a tiny cell loads no module
    whose top-level name is jax, jaxlib, flax or auto_oo_tpu."""
    root, path = tiny.make_root(str(tmp_path), atoms=4)
    code = ("import sys, json; import benchmark.run; "
            "from auto_oo_tpu_torch import config; config.set_device('cpu'); "
            "from benchmark import harness; "
            f"r = harness.run_cell('tiny-adam', 7, 0.2, False, 'cpu', "
            f"root={root!r}, manifest={path!r}); "
            "print(json.dumps([r['correct'], harness.forbidden_modules()]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    from auto_oo_tpu_torch import config
    previous = config.get_device()
    config.set_device("cpu")
    yield tiny.make_root(str(tmp_path_factory.mktemp("tiny")))
    config.set_device(previous)


@pytest.mark.parametrize("cell", ["tiny-nr", "tiny-adam"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_runs_are_correct_and_report_their_metrics(tiny_root, cell,
                                                        trace):
    root, path = tiny_root
    result = harness.run_cell(cell, 2 ** 31 + 11, 1.0, trace, "cpu",
                              root=root, manifest=path)
    assert result["correct"] is True
    assert result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert all(v["value"] <= v["limit"] for v in result["checks"].values())
    names = set(result["metrics"])
    if not trace:
        assert "setup_s" in names
        assert ({"nr_iter_s"} if cell == "tiny-nr"
                else {"grad_step_s", "grad_step_p95_s"}) <= names
    else:
        # the part timer's metrics; the device's need a card
        assert ({"grad_hess_ms", "update_ms"} if cell == "tiny-nr"
                else {"ham_rdms_ms.grad", "sweep_ms.grad"}) <= names
        assert "busy_s" in result["device"]


def test_readers_read_nothing_from_another_optimizer(tiny_root):
    root, path = tiny_root
    cell = harness.Cell("tiny-adam", root, path)
    run = harness.Run(cell, 1.0, False)
    assert readers.per_step(run, "newton") is None
    assert readers.update_ms(run) is None
    assert readers.idle_share(run, "adam") is None
