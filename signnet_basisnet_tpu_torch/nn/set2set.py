"""The GRU update between PNA layers.

Port of signnet_basisnet_tpu/nn/set2set.py:52-62 (`GRUStep`, over flax's
`GRUCell`).  `Set2Set` and `S2SReadout` of that file are a later slice
(ROADMAP.md queue 1 item 17).
"""
from __future__ import annotations

import torch
from torch import nn

from .init import Linear


class GRUCell(nn.Module):
    """flax's GRUCell: r = sigmoid(ir x + hr h), z = sigmoid(iz x + hz h),
    n = tanh(in x + r * hn h), h' = (1 - z) n + z h.  Six Linears with
    flax's names; `hr` and `hz` have no bias (torch.nn.GRUCell's b_hr and
    b_hz have no counterpart)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, Linear(in_features, features))
        for name in ("hr", "hz"):
            self.add_module(name, Linear(features, features, use_bias=False))
        self.hn = Linear(features, features)

    def forward(self, h, x):
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class GRUStep(nn.Module):
    """h' = GRU(x, h) with h the carry: `GRUStep(x, h)` runs `cell(h, x)`,
    as the JAX module does.  The cell is `cell`."""

    def __init__(self, features: int):
        super().__init__()
        self.cell = GRUCell(features, features)

    def forward(self, x, h):
        return self.cell(h, x)
