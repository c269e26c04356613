"""A cell made only of new files (a configuration, a traffic mix, limits
and a per-layer metric, with their BENCHMARK.json entries) is found by
name and runs; its run reports what the contract asks for."""
import time

import pytest
import torch


def test_new_files_make_a_cell(tiny_cell):
    assert tiny_cell.config["model"]["hidden_dim"] == 8
    assert tiny_cell.traffic["batch_graphs"] == 16
    assert set(tiny_cell.limits) >= {"loss1", "grad_median"}
    assert "tiny.steps" in [m["name"] for m in tiny_cell.per_layer]
    assert [m["name"] for m in tiny_cell.end_to_end] == [
        "train_graphs_per_s", "step_ms_p95", "setup_s"]


@pytest.mark.parametrize("traced", [False, True])
def test_a_run_of_the_new_cell(tiny_cell, traced):
    from harness.cell import run_cell
    out = run_cell(tiny_cell, 2 ** 31 + 11, 0.5, traced,
                   torch.device("cpu"), time.monotonic(), say=lambda m: None)
    assert list(out)[:3] == ["correct", "attempted", "failed"]
    assert list(out)[-1] == "compared"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    if traced:
        assert out["metrics"]["tiny.steps"]["value"] == out["attempted"]
        assert {"pipeline.wait_pct", "step.host_ms", "step_mfu",
                "device.idle_pct"} <= set(out["metrics"])
        # no kernel ran, so no roofline is read (and none reads 0)
        assert "k1_roofline" not in out["metrics"]
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(out["device"])
    else:
        assert set(out["metrics"]) == {"train_graphs_per_s", "step_ms_p95",
                                       "setup_s"}
        assert all(m["value"] > 0 for m in out["metrics"].values())


def test_the_window_runs_whole_epochs(tiny_cell):
    from harness.cell import first_batches, make_inputs
    from harness.program import Program
    from harness.window import run_epochs
    dev = torch.device("cpu")
    graphs, params, buffers = make_inputs(tiny_cell, 5, dev)
    program = Program(tiny_cell.config, tiny_cell.traffic, graphs, 5, dev,
                      params, buffers)
    program.make_step(first_batches(program, 1)[0])
    steps = run_epochs(program, first_epoch=1, seconds=0.0)
    assert steps.epochs == 1
    assert sum(r["graphs"] for r in steps.real) == len(graphs)
    assert len(steps.step_ms) == len(steps.real) == len(steps.losses)
