"""Host milliseconds of a train step call (training/train.py: the copy
into the static batch, the LR, the replay, the metric copies) with the
card's queue empty: the median over the window's epochs of each epoch's
first call, which follows the epoch-end fetch.  Later calls of an epoch
also wait for room in the card's queue once the host runs ahead."""
import statistics


def read(ctx):
    return 1e3 * statistics.median(ctx.window.first_call_s)
