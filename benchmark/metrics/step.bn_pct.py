"""Share of the train step's device time in masked BatchNorm, forward and
backward (nn/norm.py: every MaskedBatchNorm.forward, rho's included).
Read from the program's device spans (utils/profiling.py: `mark`),
which are device timer stamps (ops/timer_stamp.py, one-thread kernels
in the stream) taken in one step in 8 over the untraced window: the
region's milliseconds over the step's, the median over the window's
samples."""
from harness import spans


def read(ctx):
    return spans.share_pct(ctx, "bn")
