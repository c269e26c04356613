"""Profiling: step timing, edges/s counters, traces, a CUDA-event timer
and CUDA memory statistics.

Port of signnet_basisnet_tpu/utils/profiling.py: `Throughput`, `timed`,
`trace` (a `torch.profiler` trace written into a directory, where the JAX
one is a `jax.profiler` trace), `device_memory_stats` (from
`torch.cuda.memory_stats`) and `log_memory`.  `cuda_event_ms` (no JAX
counterpart) times a function's device work with CUDA events.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, List, Optional

import torch

from ..graph.dense import DenseGraphBatch


class Throughput:
    """Accumulates (edges, nodes, graphs, seconds) across steps: the real
    (unmasked) edges, nodes and graphs of each batch."""

    def __init__(self):
        self.edges = 0.0
        self.nodes = 0.0
        self.graphs = 0.0
        self.seconds = 0.0
        self.steps = 0

    def add(self, gb, seconds: float) -> None:
        """Count one step over batch `gb` that took `seconds` (reads the
        masks on the host: a sync if they lie on the card).  A dense batch's
        edges are its adjacency's ones."""
        edges = gb.adj if isinstance(gb, DenseGraphBatch) else gb.edge_mask
        self.edges += float(edges.sum())
        self.nodes += float(gb.node_mask.sum())
        self.graphs += float(gb.graph_mask.sum())
        self.seconds += seconds
        self.steps += 1

    @property
    def edges_per_s(self) -> float:
        return self.edges / max(self.seconds, 1e-9)

    def summary(self) -> dict:
        s = max(self.seconds, 1e-9)
        return dict(edges_per_s=self.edges / s, nodes_per_s=self.nodes / s,
                    graphs_per_s=self.graphs / s,
                    step_ms=1e3 * self.seconds / max(self.steps, 1))


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """torch.profiler trace of the block (host ops and, with a card, its
    kernels), written into `log_dir` as a Chrome trace (view it with
    Perfetto or chrome://tracing).  No trace without a log_dir."""
    if not log_dir:
        yield None
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def timed():
    """Host-clock seconds of the block, in box["seconds"] after it."""
    t0 = time.perf_counter()
    box = {}
    yield box
    box["seconds"] = time.perf_counter() - t0


def cuda_event_ms(fn: Callable, reps: int = 50, warmup: int = 3,
                  flush: Optional[torch.Tensor] = None,
                  hold_cycles: int = 2_000_000) -> List[float]:
    """Per-call CUDA-event times of fn()'s device work in ms, `reps` calls
    after `warmup`.  Before each call `flush` (a tensor larger than the L2
    cache, if given) is zeroed, so fn finds its inputs cold, and the card is
    held with `torch.cuda._sleep(hold_cycles)` (about 1 ms) so that the host
    has enqueued fn() before the start event fires: the events then time the
    device work, not the host's enqueue.  Work whose enqueue outlasts the
    hold (a host-bound train step) is timed from the start event to its
    last op's end."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(hold_cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def device_memory_stats(device=None) -> dict:
    """CUDA memory of `device` in MB: in use now, peak in use, reserved by
    the caching allocator (`torch.cuda.memory_stats`).  {} for a CPU
    device, or where no card is present."""
    device = torch.device(device if device is not None else
                          ("cuda" if torch.cuda.is_available() else "cpu"))
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    mb = 1024 ** 2
    return {"mb_in_use": stats.get("allocated_bytes.all.current", 0) / mb,
            "peak_mb_in_use": stats.get("allocated_bytes.all.peak", 0) / mb,
            "mb_reserved": stats.get("reserved_bytes.all.current", 0) / mb}


def log_memory(logger=None, device=None, prefix: str = "") -> dict:
    """`device_memory_stats` of `device`, logged as one line when there
    are any (none for the CPU)."""
    stats = device_memory_stats(device)
    if stats:
        msg = prefix + " ".join(f"{k}={v:.1f}MB" for k, v in stats.items())
        (logger or print)(msg)
    return stats


def card_label() -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` prints them (first card), or
    "not measured" where nvidia-smi gives nothing."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out.splitlines()[0] if out else "not measured"


def device_kernels(fn: Callable, calls: int = 3) -> dict:
    """{device op name: count} over `calls` calls of fn() from
    torch.profiler, one trace a call: each trace has one call as the
    profiler's warm-up step (on the card the first device ops after a
    profiler starts were now and then missing from its trace) and one as
    its active step.  The count is `calls` times the most any one trace
    shows: every call launches the same device ops, and a trace may drop
    some but never adds any (on the card one trace of three CUDA-graph
    replays, about 26,000 device ops, lacked 5 of their 45 K1 launches).
    A trace that holds no device op at all is taken again, up to 3 times
    (seen once on the card, in a phase that had read one the call
    before)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def one_trace():
        out = {}

        def ready(prof):  # the active step's events, when it ends
            out.update({e.key: e.count for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and not getattr(e, "is_user_annotation", False)})

        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1),
                         on_trace_ready=ready) as prof:
                fn()
                torch.cuda.synchronize()
                prof.step()
                fn()
                torch.cuda.synchronize()
                prof.step()
            if out:
                break
        return out

    traces = [one_trace() for _ in range(calls)]
    keys = set().union(*traces)
    return {k: calls * max(t.get(k, 0) for t in traces) for k in keys}


def device_kernel_counts(fn: Callable, names, calls: int = 3) -> dict:
    """Device kernels per call of fn() (`device_kernels`): for each of
    `names` the kernels whose name holds it, and under "all" every device
    op.  The way to count the launches of a CUDA graph's replay, which the
    wrappers' counters (counted once, at capture) do not see."""
    ops = device_kernels(fn, calls)
    out = {n: sum(c for k, c in ops.items() if n in k) / calls
           for n in names}
    out["all"] = sum(ops.values()) / calls
    return out
