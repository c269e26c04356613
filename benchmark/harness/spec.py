"""Finds what a cell is made of, by the names in BENCHMARK.json.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell sits in files of its own under the benchmark's directory,
and nothing here names one of them:

- a configuration: the JSON file that its BENCHMARK.json entry names
  (`file`), with the analytic counts `counts/<config>.py` and the plain
  reference `reference/<module>.py` that the file names (`reference`);
- a traffic mix: `traffic/<name>.json`, parameters that `run.py`'s one
  generator reads;
- a per-layer metric: `metrics/<name>.py`, whose `read(ctx)` returns the
  value or None where the run has nothing to read;
- a cell: its BENCHMARK.json entry and `limits/<cell>.json`, the limits of
  the comparison that decides `correct`.

A later change adds a cell, a configuration, a mix or a metric by adding
such files and entries; none of this code changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import List


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names."""
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # traffic/<name>.json
    limits: dict          # limits/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: str

    def module(self, kind: str, name: str) -> ModuleType:
        return load_module(self.bench_dir, kind, name)


def load_module(bench_dir: str, kind: str, name: str) -> ModuleType:
    """`<bench_dir>/<kind>/<name>.py` as a module (a name may hold dots)."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str) -> Cell:
    """The cell `name` of `<root>/BENCHMARK.json`; `root` is the checkout."""
    spec = _read_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(known: {sorted(work)})")
    w = work[name]
    configs = {c["name"]: c for c in spec["configs"]}
    bench_dir = os.path.join(root, spec["paths"][0])
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    config["name"] = w["config"]
    traffic = _read_json(os.path.join(bench_dir, "traffic",
                                      f"{w['traffic']}.json"))
    traffic["name"] = w["traffic"]
    limits = _read_json(os.path.join(bench_dir, "limits", f"{name}.json"))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"]
                           if _applies(m, name)],
                bench_dir=bench_dir)
