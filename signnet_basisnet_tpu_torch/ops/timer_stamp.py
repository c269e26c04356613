"""The card's global timer, stamped in stream order: the device spans of
the train step (utils/profiling.py: `StepSpans`).

`timer_stamp(buf, idx)` launches csrc/timer_stamp.cu: one thread writes
the GPU's global nanosecond timer into `buf[idx]` (int64, on the card)
after the work enqueued before it and before the work after it.  Under a
CUDA graph capture the launch is a kernel node, which every replay runs
again.  `timer_stamp.launches` counts the launches; nothing else touches
it.  There is no plain version: a CPU step's stamps are the host clock,
which the CPU's synchronous ops make exact (`StepSpans` takes it there).
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc

LAUNCH_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def build() -> ctypes.CDLL:
    """Compile csrc/timer_stamp.cu (once per source content) and load it."""
    return _nvcc.load("timer_stamp",
                      {"timer_stamp_launch": LAUNCH_ARGTYPES})


def timer_stamp(buf: torch.Tensor, idx: int) -> None:
    """Write the card's global timer (ns) into `buf[idx]`, in stream order
    on the current stream of `buf`'s card."""
    if buf.device.type != "cuda" or buf.dtype != torch.int64:
        raise TypeError(f"timer_stamp takes an int64 buffer on the card, "
                        f"got {buf.dtype} on {buf.device}")
    if not (buf.dim() == 1 and buf.is_contiguous() and 0 <= idx < len(buf)):
        raise IndexError(f"slot {idx} of a buffer of {tuple(buf.shape)}")
    err = build().timer_stamp_launch(
        buf.data_ptr(), idx, torch.cuda.current_stream(buf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"timer_stamp launch failed: CUDA error {err}")
    timer_stamp.launches += 1


timer_stamp.launches = 0
