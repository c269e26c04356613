"""Profiling: step timing, edges/s counters, traces, a CUDA-event timer,
CUDA memory statistics, and the program's own spans and counters.

Port of signnet_basisnet_tpu/utils/profiling.py: `Throughput`, `timed`,
`trace` (a `torch.profiler` trace written into a directory, where the JAX
one is a `jax.profiler` trace), `device_memory_stats` (from
`torch.cuda.memory_stats`) and `log_memory`.  `cuda_event_ms` (no JAX
counterpart) times a function's device work with CUDA events.

The tracing layer (no JAX counterpart):

- `COUNTERS`, a `Registry` of named values, each kept with the ordinal of
  the feed iterator it belongs to (`Registry.new_feed`; the input
  pipeline, data/batcher.py, takes one per iterator) and bounded to the
  last `KEEP` values of a name.  Host-clock counters (`time.perf_counter`)
  are always on.
- `span(name)`: a `torch.profiler.record_function` range while a profiler
  runs, else nothing, so the program's host spans share the clock of the
  profiler's kernel records.
- Device spans of the train step: `mark(region, enter, *xs)` is an
  identity autograd Function that stamps where the forward enters and
  leaves a region and where the backward's gradient reaches its output
  and leaves its input; `stamp(region, enter)` a plain stamp (the
  optimizer, the step's ends).  On the card a stamp is the card's global
  timer written in stream order by a one-thread kernel
  (`ops.timer_stamp`; in a captured step a kernel node of a second graph,
  captured with the stamps, which the step replays when it samples); on
  the CPU a `perf_counter` reading.  Both are no-ops unless a train step's
  `StepSpans` is recording (`recording`), so models outside a train step
  see no change; a tensor subclass (a DTensor) passes untouched.
  `DeviceSpans` picks the steps that record, one in `EVERY`, and reads
  such a step's regions into `COUNTERS` as one sample (`step.regions`),
  without a sync.  `DEVICE_SPANS` (default on), read when a step is built
  or captured, turns the markers off, to measure what they cost.
"""
from __future__ import annotations

import contextlib
import statistics
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
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


# ------------------------------------------------------------------ counters

KEEP = 4096


class Registry:
    """Named values, the last `keep` of each name, each with the ordinal of
    the feed iterator it belongs to (None for none).  Thread-safe: the input
    pipeline's producer thread records here too."""

    def __init__(self, keep: int = KEEP):
        self.keep = keep
        self._lock = threading.Lock()
        self._values: Dict[str, deque] = {}
        self._feeds = 0

    def new_feed(self) -> int:
        """The next feed iterator's ordinal: 0, 1, ... in creation order."""
        with self._lock:
            self._feeds += 1
            return self._feeds - 1

    @property
    def newest_feed(self) -> Optional[int]:
        return self._feeds - 1 if self._feeds else None

    def record(self, name: str, value, feed: Optional[int] = None) -> None:
        with self._lock:
            if name not in self._values:
                self._values[name] = deque(maxlen=self.keep)
            self._values[name].append((feed, value))

    def values(self, name: str, feeds=None) -> list:
        """The kept values of `name`, oldest first; with `feeds` only those
        of these feed ordinals."""
        with self._lock:
            recs = list(self._values.get(name, ()))
        return [v for f, v in recs if feeds is None or f in feeds]

    def snapshot(self) -> Dict[str, list]:
        """{name: [(feed, value), ...]}, a copy."""
        with self._lock:
            return {k: list(v) for k, v in self._values.items()}

    def reset(self) -> None:
        """Forget every value and start the feed ordinals at 0 again."""
        with self._lock:
            self._values.clear()
            self._feeds = 0


COUNTERS = Registry()

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A `record_function(name)` range while a profiler runs (one flag
    check), else a context that does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


# ------------------------------------------------------------- device spans

DEVICE_SPANS = True
# the regions a train step marks, besides `step` (first to last stamp)
REGIONS = ("pe", "convs", "head", "bn", "gate", "adam")

_ACTIVE: Optional["StepSpans"] = None


def _intervals(marks):
    """The intervals of a step's stamps (`StepSpans.marks`): (region names,
    and for each interval its region's index and the indices of its first
    and last stamp), every region over its calls, forward and backward.
    A backward left open (a region whose input carries no gradient, as the
    PE encoder's eigenvectors) closes at the next plain stamp, which
    follows the backward; a backward of a region whose forward was not
    marked in the step is left out."""
    names: Dict[str, int] = {}
    pairs = []
    entered, open_ = set(), {}

    def close(region, i0, i):
        pairs.append((names.setdefault(region, len(names)), i0, i))

    for i, (region, phase, _, plain) in enumerate(marks):
        if plain:
            for (r, d), i0 in list(open_.items()):
                if d == "b":
                    close(r, i0, i)
                    del open_[(r, d)]
        if phase == "fs":
            entered.add(region)
            open_[(region, "f")] = i
        elif phase == "bs":
            if region in entered:
                open_[(region, "b")] = i
        else:
            i0 = open_.pop((region, phase[0]), None)
            if i0 is not None:
                close(region, i0, i)
    idx = np.array(pairs, dtype=np.int64).reshape(-1, 3)
    return list(names), idx


def _regions(intervals, stamps: np.ndarray, scale: float) -> Dict[str, float]:
    """Milliseconds by region: `stamps` (one a mark, in units of `scale`
    ms) summed over `_intervals`' intervals, and `step` from the first
    stamp to the last."""
    names, idx = intervals
    spans = (stamps[idx[:, 2]] - stamps[idx[:, 1]]) * scale
    sums = np.bincount(idx[:, 0], weights=spans, minlength=len(names))
    out = {n: float(v) for n, v in zip(names, sums)}
    out["step"] = float((stamps[-1] - stamps[0]) * scale)
    return out


class StepSpans:
    """The stamps of one train step: (region, phase, stamp, plain) in the
    order the host made them, which is the stream's order.  Phases: "fs" and
    "fe" where the forward enters and leaves a region (a plain stamp's too),
    "bs" and "be" where the backward's gradient reaches the region's output
    and leaves its input.

    On the card a stamp is a launch of `ops.timer_stamp`, the card's global
    timer (ns) written into slot i of a device buffer, in chunks of `CHUNK`
    made by the first step that needs them (so a capture reuses its
    warm-up step's); the stamp in `marks` is i.  On the CPU it is a
    `perf_counter` reading, complete when taken (`read`)."""

    CHUNK = 1024

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.marks: list = []
        self.chunks: list = []    # device buffers of the stamps
        self._host: list = []     # open host spans (region, record_function)

    def restart(self) -> None:
        self.marks = []

    def stamp(self, region: str, phase: str, plain: bool = False) -> None:
        if self.cuda:
            from ..ops.timer_stamp import timer_stamp
            t = len(self.marks)
            if t // self.CHUNK == len(self.chunks):
                self.chunks.append(torch.zeros(self.CHUNK, dtype=torch.int64,
                                               device=self.device))
            timer_stamp(self.chunks[t // self.CHUNK], t % self.CHUNK)
        else:
            t = time.perf_counter()
        self.marks.append((region, phase, t, plain))
        if phase == "fs" and torch.autograd._profiler_enabled():
            rf = torch.profiler.record_function(
                "step.body" if region == "step" else f"step.{region}")
            rf.__enter__()
            self._host.append((region, rf))
        elif phase == "fe" and self._host and self._host[-1][0] == region:
            self._host.pop()[1].__exit__(None, None, None)

    def close_host_spans(self) -> None:
        while self._host:
            self._host.pop()[1].__exit__(None, None, None)

    def read(self) -> Dict[str, float]:
        """The CPU step's milliseconds by region (`_intervals`)."""
        stamps = np.array([t for _, _, t, _ in self.marks])
        return _regions(_intervals(self.marks), stamps, 1e3)


@contextlib.contextmanager
def recording(spans: Optional[StepSpans]):
    """Marks and stamps record into `spans` inside the block (a train
    step); with None they stay no-ops."""
    global _ACTIVE
    if spans is None:
        yield
        return
    prev, _ACTIVE = _ACTIVE, spans
    spans.restart()
    try:
        yield
    finally:
        _ACTIVE = prev
        spans.close_host_spans()


def stamp(region: str, enter: bool) -> None:
    """A plain stamp where region `region` starts (`enter`) or ends, in the
    train step that records; no-op outside one."""
    if _ACTIVE is not None:
        _ACTIVE.stamp(region, "fs" if enter else "fe", plain=True)


class _Mark(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spans, region, enter, *xs):
        spans.stamp(region, "fs" if enter else "fe")
        ctx.spans, ctx.region, ctx.enter = spans, region, enter
        ctx.set_materialize_grads(False)
        out = tuple(x.view_as(x) for x in xs)
        return out[0] if len(out) == 1 else out

    @staticmethod
    def backward(ctx, *grads):
        ctx.spans.stamp(ctx.region, "be" if ctx.enter else "bs")
        return (None, None, None) + grads


def mark(region: str, enter: bool, *xs):
    """The tensors `xs` (None entries pass through) unchanged, entering
    (`enter`) or leaving `region` of the train step that records: its
    forward stamps here, its backward where the gradient of these tensors
    arrives.  Outside a recording train step, or on a tensor subclass (a
    DTensor), it returns `xs` themselves.  Returns one tensor for one."""
    spans = _ACTIVE
    if spans is None or any(x is not None and type(x) is not torch.Tensor
                            for x in xs):
        return xs[0] if len(xs) == 1 else xs
    idx = [i for i, x in enumerate(xs) if x is not None]
    out = _Mark.apply(spans, region, enter, *(xs[i] for i in idx))
    if len(xs) == 1:
        return out
    out = out if isinstance(out, tuple) else (out,)
    full = list(xs)
    for i, o in zip(idx, out):
        full[i] = o
    return tuple(full)


class _HostCopy:
    """A step's stamps copied from the card to pinned host memory without
    blocking, and the event after the copy.  A captured step's stamps keep
    their order, so their intervals are worked out once."""

    def __init__(self):
        self.host: list = []
        self.marks: list = []
        self.event = None
        self._intervals = (None, None)   # (marks, their intervals)

    def take(self, spans: StepSpans) -> None:
        used = spans.chunks[:-(-len(spans.marks) // spans.CHUNK)]
        while len(self.host) < len(used):
            self.host.append(torch.zeros(spans.CHUNK, dtype=torch.int64,
                                         pin_memory=True))
        for dev, host in zip(used, self.host):
            host.copy_(dev, non_blocking=True)
        if self.event is None:
            self.event = torch.cuda.Event()
        self.event.record()
        self.marks = spans.marks

    def done(self) -> bool:
        return self.event.query()

    def read(self) -> Dict[str, float]:
        if self._intervals[0] is not self.marks:
            self._intervals = (self.marks, _intervals(self.marks))
        stamps = torch.cat(self.host).numpy()[:len(self.marks)]
        return _regions(self._intervals[1], stamps, 1e-6)


class DeviceSpans:
    """The device spans of one train step function: which of its calls
    record and are read, and the sampling of such a step into `COUNTERS`
    (`step.regions`: {region: ms}), tagged with the newest feed iterator's
    ordinal.

    The first call's step is read, and then one every `EVERY` calls, but
    none while another waits to be read (`due`).  Only such a step records:
    an eager step marks its regions, a captured step replays the graph
    captured with the stamps (`capture_train_step`).  On the CPU the step
    is read when it ends; on the card its stamps are copied to pinned host
    memory behind an event, and `sample()`, at the start of each call,
    reads them once they have arrived (a non-blocking query, never a
    wait), so a step waits to be read where the host runs ahead of the
    card."""

    EVERY = 8

    def __init__(self, device=None):
        self.recorder: Optional[StepSpans] = None
        self._copy: Optional[_HostCopy] = None
        self._since = self.EVERY - 1    # calls since the last one recorded
        self._pending = False
        if device is not None:
            self._make(device)

    def _make(self, device) -> None:
        self.recorder = StepSpans(device)
        self._copy = _HostCopy() if self.recorder.cuda else None

    def due(self) -> bool:
        """Whether this call's step is to record its spans and be read."""
        self._since += 1
        if self._pending or self._since < self.EVERY:
            return False
        self._since = 0
        return True

    def start(self, device) -> Optional[StepSpans]:
        """The recorder of this eager call's step, or None where the step
        is not to be read; the first call fixes the device (the
        model's)."""
        if self.recorder is None:
            self._make(device)
        return self.recorder if self.due() else None

    def finished(self) -> None:
        """A step that was `due` has run (an eager step) or been launched (a
        replay): read at once on the CPU, copied to the host on the card."""
        if self._copy is not None:
            self._copy.take(self.recorder)
            self._pending = True
        else:
            self._record(self.recorder.read())

    def sample(self) -> bool:
        """Read the step that waits to be read into COUNTERS if its stamps
        are on the host; True if it was read."""
        if not self._pending or not self._copy.done():
            return False
        self._pending = False
        self._record(self._copy.read())
        return True

    @staticmethod
    def _record(regions: Dict[str, float]) -> None:
        COUNTERS.record("step.regions", regions, COUNTERS.newest_feed)


def counters_line(feed: Optional[int] = None) -> str:
    """What the counters saw, for a log line, read from `COUNTERS` alone
    (no sync): feed `feed`'s `first_batch_ms`, `plan_ms`, median `pack_ms`,
    the consumer's wait over its `get()`s (`get_ms` summed) and their
    median queue depth, and the last step sample's regions as shares of
    its step."""
    parts = []
    if feed is not None:
        def of(name):
            return COUNTERS.values(f"pipeline.{name}", {feed})

        first, plan, pack = of("first_batch_ms"), of("plan_ms"), of("pack_ms")
        waits, depth = of("get_ms"), of("queue_depth")
        if first:
            parts.append(f"first_batch {first[-1]:.1f}ms")
        if plan:
            parts.append(f"plan {plan[-1]:.1f}ms")
        if pack:
            parts.append(f"pack {statistics.median(pack):.2f}ms")
        if waits:
            parts.append(f"wait {sum(waits):.1f}ms")
        if depth:
            parts.append(f"queue {statistics.median(depth):g}")
    samples = COUNTERS.values("step.regions")
    if samples and samples[-1].get("step", 0.0) > 0:
        last = samples[-1]
        parts.append(f"step {last['step']:.2f}ms " + " ".join(
            f"{r} {100.0 * last[r] / last['step']:.0f}%"
            for r in REGIONS if r in last))
    return " ".join(parts)
