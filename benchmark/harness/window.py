"""The timed loop: epochs of the program's own feed through its step, as
the ZINC trainer's `fit` runs them, without the per-epoch evaluation.

The loop runs whole epochs, so that the rate does not hang on where the
clock cuts an epoch.  Each epoch takes a fresh iterator from the feed;
every batch goes through the step; the epoch's losses (and, in the same fetch, the real graphs,
nodes and edges of its batches) come to the host once, after its last
step, as `fit` fetches its losses.  A marker after each step call (a CUDA
event on the card, read after the loop; the host clock on the CPU) gives
each step's interval, the idle time before it included.  The host's time
blocked in the iterator is summed; of the step calls only each epoch's
first is timed, made after the fetch has emptied the card's queue: once
the host runs ahead, a call also waits for room in that queue.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch


@dataclass
class Steps:
    seconds: float = 0.0          # the loop's host-clock length
    step_ms: List[float] = field(default_factory=list)
    real: List[dict] = field(default_factory=list)   # a dict a step
    losses: List[float] = field(default_factory=list)
    wait_s: float = 0.0           # blocked in the iterator's next()
    first_call_s: List[float] = field(default_factory=list)  # an epoch's
    # first step call, made with the card's queue empty
    epochs: int = 0               # iterators taken
    next_epoch: int = 0


class _Marks:
    """Step markers: CUDA events on the card, else host-clock stamps."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.add()

    def add(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_epochs(program, first_epoch: int, seconds: float = None,
               epochs: int = None, spans: bool = False) -> Steps:
    """Whole epochs from `first_epoch`: until `seconds` have passed, the
    loop finishing the epoch it is in (so that every window holds whole
    epochs, each with its start), or until `epochs` are done; ends with a
    synchronize.  With `spans` the host's work is annotated for the
    profiler (pipeline.wait, step.call, epoch.fetch)."""
    span = (torch.profiler.record_function if spans
            else lambda name: contextlib.nullcontext())
    out = Steps()
    marks = _Marks(program.device)
    clock = time.perf_counter
    t0 = clock()
    epoch = first_epoch
    while True:
        it = program.feed(epoch)
        epoch += 1
        out.epochs += 1
        losses, batches = [], []
        while True:
            with span("pipeline.wait"):
                t = clock()
                gb = next(it, None)
                out.wait_s += clock() - t
            if gb is None:
                break
            with span("step.call"):
                t = clock()
                m = program.step(gb, program.lr)
                if not losses:
                    out.first_call_s.append(clock() - t)
            marks.add()
            losses.append(m["loss"])
            batches.append(gb)
        with span("epoch.fetch"):
            if losses:
                real = torch.stack([
                    torch.stack([gb.graph_mask for gb in batches]).sum(1),
                    torch.stack([gb.node_mask for gb in batches]).sum(1),
                    torch.stack([gb.edge_mask for gb in batches]).sum(1),
                    torch.stack(losses).to(torch.float32)], 1).cpu()
                for g, n, e, loss in real.tolist():
                    out.real.append({"graphs": g, "nodes": n, "edges": e})
                    out.losses.append(loss)
        if seconds is not None and clock() - t0 >= seconds:
            break
        if epochs is not None and out.epochs >= epochs:
            break
    _sync(program.device)
    out.seconds = clock() - t0
    out.next_epoch = epoch
    out.step_ms = marks.intervals_ms()
    return out


def percentile(values, q: float) -> float:
    """The q-th percentile, numpy's linear interpolation between ranks."""
    return float(np.percentile(np.asarray(values, np.float64), q))
