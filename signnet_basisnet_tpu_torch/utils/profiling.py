"""Profiling: a CUDA-event timer and CUDA memory statistics.

`device_memory_stats` is the counterpart of the memory half of
signnet_basisnet_tpu/utils/profiling.py and reads `torch.cuda.memory_stats`;
`cuda_event_ms` (no JAX counterpart) times a function's device work with
CUDA events.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch


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
