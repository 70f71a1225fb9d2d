"""A benchmark root of tiny cells for the CPU tests: the real metric
readers, problem modules, check limits and traffic mixes, on a hydrogen
chain of a few atoms (the cells' configuration with its sizes cut)."""

import json
import os
import shutil

from benchmark import harness

CELLS = {"tiny-nr": ("h14-nr-f64", "nr_restart4"),
         "tiny-adam": ("h14-adam-f64", "adam_lr05")}
N_THETA = {4: 2, 6: 6, 8: 6}


def make_root(path, atoms=6):
    """Write the tiny root under ``path``; returns (root, manifest)."""
    src = harness.HERE
    root = os.path.join(path, "bench")
    for sub in ("metrics", "problems"):
        shutil.copytree(os.path.join(src, sub), os.path.join(root, sub))
    for sub in ("configs", "traffic", "checks"):
        os.makedirs(os.path.join(root, sub))
    cfg = harness.load_json(os.path.join(
        src, "configs", "h14_chain_sto3g_npfabric1.json"))
    cfg.update(name=f"h{atoms}", atoms=atoms, ncas=atoms, nelecas=atoms,
               n_theta=N_THETA[atoms])
    with open(os.path.join(root, "configs", f"h{atoms}.json"), "w") as f:
        json.dump(cfg, f)
    manifest = harness.load_json(os.path.join(os.path.dirname(src),
                                              "BENCHMARK.json"))
    rename = {}
    workloads = []
    for name, (real, traffic) in CELLS.items():
        shutil.copy(os.path.join(src, "traffic", traffic + ".json"),
                    os.path.join(root, "traffic", traffic + ".json"))
        shutil.copy(os.path.join(src, "checks", real + ".json"),
                    os.path.join(root, "checks", name + ".json"))
        workloads.append({"name": name, "config": f"h{atoms}",
                          "traffic": traffic, "chips": 1, "why": "test"})
        for w in manifest["workloads"]:
            if w["traffic"] == traffic:
                rename[w["name"]] = name
    manifest["workloads"] = workloads
    for group in ("end_to_end", "per_layer"):
        for m in manifest[group]:
            if "workloads" in m:
                m["workloads"] = sorted({rename[w] for w in m["workloads"]})
    path = os.path.join(path, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(manifest, f)
    return root, path
