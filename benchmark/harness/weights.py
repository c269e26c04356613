"""The initial weights of a run, made on the device from the seed, which
both the program and the plain reference start from.

The layout (`spec`: name, shape, init, fan_in) is the reference's; the
values come from two large draws of one generator on the device, a
uniform one for every Linear (scaled to +-1/sqrt(fan_in), PyTorch's
default) and a normal one for every embedding; BatchNorm's scale is one
and its shift, running mean zero, its running variance one.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def make(spec: List[Tuple[str, tuple, str, int]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    size = lambda kind: sum(math.prod(s) for _, s, k, _ in spec if k == kind)
    draws = {"uniform": torch.rand(size("uniform"), generator=gen,
                                   device=device) * 2.0 - 1.0,
             "normal": torch.randn(size("normal"), generator=gen,
                                   device=device)}
    at = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, kind, fan_in in spec:
        if kind in ("ones", "zeros"):
            out[name] = (torch.ones if kind == "ones" else torch.zeros)(
                shape, device=device)
            continue
        n = math.prod(shape)
        t = draws[kind][at[kind]:at[kind] + n].reshape(shape)
        at[kind] += n
        out[name] = (t / math.sqrt(fan_in) if kind == "uniform"
                     else t.clone())
    return out
