"""Share of the train step's device time in the convs, forward and
backward (the layer loop of the net's forward; models/conv.py).
Read from the program's device spans (utils/profiling.py: `mark`),
which are device timer stamps (ops/timer_stamp.py, one-thread kernels
in the stream) taken in one step in 8 over the untraced window: the
region's milliseconds over the step's, the median over the window's
samples."""
from harness import spans


def read(ctx):
    return spans.share_pct(ctx, "convs")
