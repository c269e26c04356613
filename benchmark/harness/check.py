"""The comparison that decides `correct`: the program's first three
training steps against the plain reference's, from the same weights on the
same graphs.

Per leaf (a parameter or a BatchNorm statistic) the gap between the
program's norm and the reference's, over the larger of the reference's
norm of that leaf and of the median leaf (some gradients are all but
zero).  The readings:
- `loss1`, `loss`: the relative gap of the first step's loss, and the
  largest of the three steps';
- `grad_*`: the first gradient as Adam holds it after one step;
- `change_*`: each parameter's change over the three steps, leaving out
  the leaves whose reference gradient is under a thousandth of the median
  leaf's (biases that a BatchNorm right after cancels: Adam moves them by
  round-off alone);
- `bn_*`: each BatchNorm running statistic's change;
each by the worst leaf (`_worst`) and by the median leaf (`_median`).
`NUMBERS` are the ones held to limits (`limits/<cell>.json`); PERF.md
gives the readings each limit was set from and why the others are not
compared.  A leaf that one side never moves and the other does reads
about 1.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

NUMBERS = ("loss1", "grad_median", "change_median", "bn_median")


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> np.ndarray:
    names = [n for n in ref if keep is None or keep(n)]
    if not names:
        return np.array([math.inf])
    median = float(np.median([ref[n] for n in names]))
    return np.array([abs(prog.get(n, 0.0) - ref[n])
                     / max(ref[n], median, 1e-30) for n in names])


def readings(prog: dict, ref: dict) -> Dict[str, float]:
    """`prog`: Program.first_steps; `ref`: the reference's readings in the
    same form (losses, grad1, params, buffers: norms a leaf)."""
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not all(
            math.isfinite(x) for x in prog["losses"]):
        gaps = [math.inf]
    g_med = float(np.median(list(ref["grad1"].values())))
    moved = lambda n: ref["grad1"].get(n, 0.0) >= 1e-3 * g_med
    out = {"loss1": gaps[0], "loss": max(gaps)}
    for key, got in (("grad", leaf_gaps(prog["grad1"], ref["grad1"])),
                     ("change", leaf_gaps(prog["params"], ref["params"],
                                          moved)),
                     ("bn", leaf_gaps(prog["buffers"], ref["buffers"]))):
        out[f"{key}_worst"] = float(np.max(got))
        out[f"{key}_median"] = float(np.median(got))
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def reference_readings(out: dict, params0: dict, buffers0: dict) -> dict:
    """reference.common.three_steps' output as norms a leaf."""
    norm = lambda t: float(t.norm())
    return {"losses": out["losses"],
            "grad1": {n: norm(g) for n, g in out["grad1"].items()},
            "params": {n: norm(t - params0[n])
                       for n, t in out["params"].items()},
            "buffers": {n: norm(t - buffers0[n])
                        for n, t in out["buffers"].items()}}


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(values[k] <= limits[k] for k in NUMBERS)
