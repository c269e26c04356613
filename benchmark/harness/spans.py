"""Reading the program's own counters and device spans after a run: the
registry `COUNTERS` of signnet_basisnet_tpu_torch/utils/profiling.py,
which outlives the program (`Program.free`).

Only the window's records are read.  Each feed iterator takes an ordinal
when it starts: set-up takes one (epoch 0's first batches), the window one
an epoch, and the traced epoch after it the newest; so the window's are
the `ctx.window.epochs` ordinals before the newest.  Each device-span
sample (`step.regions`: milliseconds by region and `step` from its first
stamp to its last) carries the ordinal that was newest when it was read.

A program that lacks the registry gives None: the metric is left out of
the line, and nothing raises.
"""
from __future__ import annotations

import statistics


def registry():
    """The program's COUNTERS, or None where the program has none."""
    try:
        from signnet_basisnet_tpu_torch.utils.profiling import COUNTERS
    except ImportError:
        return None
    return COUNTERS


def window_feeds(ctx, counters):
    newest = counters.newest_feed
    if newest is None or ctx.window.epochs <= 0:
        return None
    return set(range(newest - ctx.window.epochs, newest))


def window_values(ctx, name: str):
    """The window's values of counter `name` (an empty list for none)."""
    counters = registry()
    if counters is None:
        return []
    feeds = window_feeds(ctx, counters)
    return counters.values(name, feeds) if feeds else []


def median(ctx, name: str):
    """The median of the window's values of `name`, or None."""
    values = window_values(ctx, name)
    return statistics.median(values) if values else None


def share_pct(ctx, region: str):
    """The median over the window's samples of the region's milliseconds
    over the step's, in %; None where no sample holds the region."""
    values = [100.0 * s[region] / s["step"]
              for s in window_values(ctx, "step.regions")
              if region in s and s.get("step", 0.0) > 0]
    return statistics.median(values) if values else None
