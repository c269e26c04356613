"""Fixtures of the benchmark's CPU tests: the repository and the
benchmark on sys.path, and a checkout copy holding a tiny cell made only
of new files (a configuration, a traffic mix, limits and a metric)."""
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MODEL = {"n_layers": 2, "hidden_dim": 8, "out_dim": 8,
              "sign_inv_layers": 2}


def tiny_checkout(tmp, base_config="gin_signnet_zinc", name="tiny_gin"):
    """A copy of BENCHMARK.json and benchmark/ under `tmp` with one more
    cell, `<name>.tiny_traffic`, added as new files and entries only."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp)
    shutil.copytree(BENCH, os.path.join(tmp, "benchmark"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = os.path.join(tmp, "benchmark")
    with open(os.path.join(bench, "configs", f"{base_config}.json")) as f:
        cfg = json.load(f)
    cfg["model"].update(TINY_MODEL)
    with open(os.path.join(bench, "configs", f"{name}.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(bench, "counts", f"{base_config}.py"),
                os.path.join(bench, "counts", f"{name}.py"))
    with open(os.path.join(bench, "traffic", "tiny_traffic.json"), "w") as f:
        json.dump({"molecules": 96, "batch_graphs": 16, "prefetch": 2,
                   "dataset_seed": 7}, f)
    cell = f"{name}.tiny_traffic"
    with open(os.path.join(bench, "limits", f"{cell}.json"), "w") as f:
        json.dump({"loss1": 1e-4, "grad_median": 1e-3, "change_median": 1e-3,
                   "bn_median": 1e-3}, f)
    with open(os.path.join(bench, "metrics", "tiny.steps.py"), "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx.window.real))\n")
    with open(os.path.join(tmp, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": name, "source": "a test fixture",
                            "file": f"benchmark/configs/{name}.json",
                            "reduced": [], "why": "tiny"})
    spec["workloads"].append({"name": cell, "config": name,
                              "traffic": "tiny_traffic", "chips": 1,
                              "why": "tiny"})
    spec["per_layer"].append({"name": "tiny.steps", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "train step", "moves":
                              "train_graphs_per_s", "workloads": [cell]})
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return cell


@pytest.fixture
def tiny_cell(tmp_path):
    from harness.spec import load_cell
    cell = tiny_checkout(str(tmp_path))
    return load_cell(str(tmp_path), cell)
