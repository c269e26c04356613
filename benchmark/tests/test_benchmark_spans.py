"""The per-layer metrics that read the program's own counters and device
spans (harness/spans.py) read numbers in a traced run of a tiny cell on
the CPU, and `step.gate_pct` only in a cell it lists (a GatedGCN one)."""
import json
import os
import time

import pytest
import torch

from conftest import tiny_checkout

SPAN_METRICS = ("pipeline.first_batch_ms", "pipeline.pack_ms", "step.pe_pct",
                "step.convs_pct", "step.bn_pct", "step.adam_pct")


def _traced_run(tmp, base_config, name, gate_applies):
    from harness.cell import run_cell
    from harness.spec import load_cell
    cell = tiny_checkout(tmp, base_config=base_config, name=name)
    if gate_applies:
        path = os.path.join(tmp, "BENCHMARK.json")
        with open(path) as f:
            spec = json.load(f)
        for m in spec["per_layer"]:
            if m["name"] == "step.gate_pct":
                m["workloads"].append(cell)
        with open(path, "w") as f:
            json.dump(spec, f)
    cell = load_cell(tmp, cell)
    return run_cell(cell, 2 ** 31 + 23, 0.5, True, torch.device("cpu"),
                    time.monotonic(), say=lambda m: None)


@pytest.mark.parametrize("base_config,gate", [("gin_signnet_zinc", False),
                                              ("gatedgcn_signnet_zinc", True)])
def test_the_span_metrics_read_numbers(tmp_path, base_config, gate):
    out = _traced_run(str(tmp_path), base_config, "tiny_" + base_config,
                      gate)
    assert out["correct"] is True
    metrics = out["metrics"]
    for name in SPAN_METRICS + (("step.gate_pct",) if gate else ()):
        value = metrics[name]["value"]
        assert isinstance(value, float) and value > 0, (name, value)
    for name in SPAN_METRICS[2:] + (("step.gate_pct",) if gate else ()):
        assert metrics[name]["value"] <= 100.0, name
    if not gate:
        assert "step.gate_pct" not in metrics


def test_a_program_without_the_registry_reads_none(monkeypatch):
    """The reader on a program that lacks the counters (an older program)
    gives None and raises nothing."""
    from types import SimpleNamespace

    from harness import spans
    monkeypatch.setattr(spans, "registry", lambda: None)
    ctx = SimpleNamespace(window=SimpleNamespace(epochs=3))
    assert spans.median(ctx, "pipeline.pack_ms") is None
    assert spans.share_pct(ctx, "pe") is None
