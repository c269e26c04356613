"""Milliseconds from a feed iterator's start to its first batch in the
queue, on the producer thread's clock (data/batcher.py: the plan and the
whole epoch's packing come first): the epoch-start stall as the input
pipeline sees it.  The median over the window's epochs."""
from harness import spans


def read(ctx):
    return spans.median(ctx, "pipeline.first_batch_ms")
