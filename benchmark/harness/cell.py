"""One run of one cell: set-up, the timed window, with `trace` a traced
epoch, then the comparison with the plain reference; returns the result
line's fields.

Set-up (all counted in `setup_s`): the molecules and their eigenvectors
(from the traffic's dataset seed); the initial weights on the device from
the run's seed; the program's model, optimizer and step (on the card: its
kernels built or loaded, the step warmed up and captured); then its first
three steps, through the step the window calls and on the first three
batches of the program's feed (epoch 0), read for the comparison.  The
window then trains on from that state, epochs 1, 2, ... .
"""
from __future__ import annotations

import gc
import importlib
import math
import sys
import time
from types import SimpleNamespace

import torch

from . import check, costs, molecules, trace, weights
from .program import Program
from .window import percentile, run_epochs

FIRST_STEPS = 3


def set_precision(tf32: bool) -> None:
    """float32 matmuls in full f32 (TF32 off), or TF32 for the control."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def reference_module(cell):
    return importlib.import_module(f"reference.{cell.config['reference']}")


def make_inputs(cell, seed: int, device):
    """The molecules and the initial weights (parameters, buffers).  The
    molecules come from the traffic's `dataset_seed`, so that every run
    trains on graphs of the same sizes; the run's seed draws the weights
    and, through the feed, each epoch's order and batches."""
    cfg = cell.config
    graphs = molecules.make_molecules(int(cell.traffic["molecules"]),
                                      int(cell.traffic["dataset_seed"]),
                                      cfg["model"]["pos_enc_dim"])
    pspec, bspec = reference_module(cell).spec(cfg)
    w = weights.make(pspec + bspec, seed, device)
    return (graphs, {n: w[n] for n, *_ in pspec},
            {n: w[n] for n, *_ in bspec})


def first_batches(program, count: int = FIRST_STEPS):
    """The first `count` batches of epoch 0 of the program's feed; the
    rest of the epoch is drained so that its producer thread ends."""
    it = program.feed(0)
    out = [next(it) for _ in range(count)]
    for _ in it:
        pass
    return out


def reference_run(cell, graphs, params, buffers, seed, device, tf32=False):
    """The plain reference's readings of the first steps: the graphs of
    epoch 0's first batches worked out by the reference's own batching."""
    from reference import batches as ref_batches
    from reference import common
    cfg = cell.config
    d = cfg["data"]
    slots = ref_batches.budgets(graphs, int(cell.traffic["batch_graphs"]),
                                d["batch_slack"], d["batch_align"],
                                d.get("tile"))
    groups = ref_batches.epoch_batches(graphs, slots, seed, d.get("tile"),
                                       FIRST_STEPS)
    batches = []
    for idx in groups:
        chosen = [graphs[i] for i in idx]
        real = sum(len(g["node_feat"]) for g in chosen)
        batches.append(common.make_batch(chosen, slots[0] - real, device))
    set_precision(tf32)
    try:
        out = common.three_steps(reference_module(cell), cfg, params,
                                 buffers, batches, cfg["train"]["init_lr"])
    finally:
        set_precision(False)
    readings = check.reference_readings(out, params, buffers)
    readings["graphs"] = [len(idx) for idx in groups]
    return readings


def end_to_end(cell, steps, setup_s: float) -> dict:
    graphs = sum(r["graphs"] for r in steps.real)
    values = {"train_graphs_per_s": (graphs / steps.seconds, "graphs/s"),
              "step_ms_p95": (percentile(steps.step_ms, 95), "ms"),
              "setup_s": (setup_s, "s")}
    return {m["name"]: {"value": values[m["name"]][0], "unit": m["unit"]}
            for m in cell.end_to_end}


def per_layer(cell, ctx) -> dict:
    out = {}
    for m in cell.per_layer:
        value = cell.module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, say=lambda msg: print(msg, file=sys.stderr,
                                                  flush=True)) -> dict:
    """One run; `t_start` is the process's start on the monotonic clock."""
    device = torch.device(device)
    set_precision(False)
    graphs, params, buffers = make_inputs(cell, seed, device)
    program = Program(cell.config, cell.traffic, graphs, seed, device,
                      params, buffers)
    first = first_batches(program)
    program.make_step(first[0])
    readings = program.first_steps(first)
    readings["graphs"] = [int(b.graph_mask.sum()) for b in first]
    del first
    setup_s = time.monotonic() - t_start
    say(f"# set-up {setup_s:.3f} s; slots {program.slots}")

    steps = run_epochs(program, first_epoch=1, seconds=seconds)
    say(f"# window {steps.seconds:.3f} s: {len(steps.real)} steps, "
        f"{steps.epochs} epochs; step ms p50/p90/p95/p99/max " + "/".join(
            f"{percentile(steps.step_ms, q):.3f}" for q in (50, 90, 95, 99,
                                                            100)))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    traced_epoch = None
    if traced:
        traced_epoch = trace.traced(lambda: run_epochs(
            program, first_epoch=steps.next_epoch, epochs=1, spans=True))
    n_params = program.param_count()
    slots = program.slots
    program.free()
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.monotonic()
    ref = reference_run(cell, graphs, params, buffers, seed, device)
    values = check.readings(readings, ref)
    limits = {k: float(cell.limits[k]) for k in check.NUMBERS}
    correct = check.verdict(values, limits)
    say(f"# reference {time.monotonic() - t_ref:.3f} s; batch graphs "
        f"program {readings['graphs']}, reference {ref['graphs']}; losses "
        f"program {readings['losses']}, reference {ref['losses']}")
    say("# readings not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in values.items() if k not in limits))

    result = {"correct": correct, "attempted": len(steps.losses),
              "failed": sum(not math.isfinite(x) for x in steps.losses)}
    if traced:
        ctx = SimpleNamespace(cell=cell, cfg=cell.config, window=steps,
                              trace=traced_epoch, slots=slots,
                              params=n_params, costs=costs,
                              counts=cell.module("counts", cell.config["name"]))
        result["metrics"] = per_layer(cell, ctx)
    else:
        result["metrics"] = end_to_end(cell, steps, setup_s)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if traced:
        dev["busy_s"] = traced_epoch.busy_s
        dev["window_s"] = traced_epoch.window_s
        result["device"] = dev
        result["breakdown"] = trace.breakdown(traced_epoch)
    else:
        result["device"] = dev
    result["compared"] = {k: {"value": values[k], "limit": limits[k]}
                          for k in check.NUMBERS}
    return result
