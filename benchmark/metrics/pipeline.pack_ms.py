"""The producer thread's host milliseconds to make one batch ready
(data/batcher.py: its batch_np, from_arrays and pinning, no wait on a full
queue).  The median over the window's batches."""
from harness import spans


def read(ctx):
    return spans.median(ctx, "pipeline.pack_ms")
