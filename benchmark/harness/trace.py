"""Reading one traced epoch: the card's busy time, each kernel's device
time, and the card's idle gaps by what the host was doing.

The epoch runs under `torch.profiler` (the card's activity and the host's
annotated spans, harness/window.py) inside a span `bench.window` that
starts before the epoch's iterator is made and ends after its closing
synchronize, so the epoch-start stall is in the window.  The raw events
are read (`kineto_results.events()`), not the profiler's per-op tables,
whose assembly takes far longer over an epoch of CUDA-graph replays.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "bench.window"
HOST_SPANS = ("pipeline.wait", "step.call", "epoch.fetch")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    op_s: Dict[str, float]              # device seconds by op name
    gaps: List[Tuple[str, float]] = field(default_factory=list)
    steps: object = None                # the epoch's window.Steps

    def seconds(self, needle: str) -> float:
        """Device seconds of the ops whose name holds `needle`."""
        return sum(s for n, s in self.op_s.items() if needle in n)

    @property
    def device_s(self) -> float:
        return sum(self.op_s.values())


def traced(fn) -> Trace:
    """Run fn() (one epoch, returning its Steps) under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            steps = fn()
    out = read(prof.profiler.kineto_results.events())
    out.steps = steps
    return out


def read(events) -> Trace:
    window = None
    host: List[Tuple[int, int, str]] = []
    dev: List[Tuple[int, int, str]] = []
    for e in events:
        name = e.name()
        on_card = str(e.device_type()).endswith("CUDA")
        if e.is_user_annotation():
            if not on_card:
                if name == WINDOW:
                    window = (e.start_ns(), e.end_ns())
                elif name in HOST_SPANS:
                    host.append((e.start_ns(), e.end_ns(), name))
        elif on_card:
            dev.append((e.start_ns(), e.end_ns(), name))
    if window is None:
        raise RuntimeError(f"the trace lacks its {WINDOW} span")
    w0, w1 = window
    dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev if b > w0 and a < w1]
    op_s: Dict[str, float] = defaultdict(float)
    for a, b, n in dev:
        op_s[n] += (b - a) * 1e-9
    # the union of the device ops' intervals, and the gaps between them
    busy, gaps, end = 0, [], w0
    for a, b, _ in sorted(dev):
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((end, w1))
    host.sort()
    starts = [s for s, _, _ in host]
    by_host: Dict[str, List[float]] = defaultdict(list)
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        what = host[i][2] if i >= 0 and mid <= host[i][1] else "other"
        by_host[what].append((b - a) * 1e-9)
    gap_rows = sorted(((f"{n}: {len(v)} gaps, longest {max(v):.6f} s",
                        sum(v)) for n, v in by_host.items()),
                      key=lambda r: -r[1])
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                 op_s=dict(op_s), gaps=gap_rows)


def breakdown(trace: Trace, top: int = 10, width: int = 96) -> dict:
    ops = sorted(trace.op_s.items(), key=lambda r: -r[1])[:top]
    return {"device_ops": [[n[:width], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in trace.gaps[:top]]}
