"""Equivariant DeepSets encoder (the LearningFilters nets and PEs).

Port of signnet_basisnet_tpu/nn/deepsets.py: `EqDeepSetsEncoder`.  Each
layer computes relu(lin1(x) + lin2(mean of x over the set axis -2)), then
optional BatchNorm with batch statistics in eval mode too
(`track_running_stats=False`), optional LayerNorm and dropout; the last
layer has no activation.  Names follow flax: `lin1_i`, `lin2_i`, `bn_i`,
`ln_i`.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .dropout import Dropout, DropoutRNG
from .init import Linear
from .norm import MaskedBatchNorm, MaskedLayerNorm


class EqDeepSetsEncoder(nn.Module):
    def __init__(self, in_features: int, hidden: int = 32, out: int = 1,
                 num_layers: int = 3, use_bn: bool = False,
                 use_ln: bool = False, dropout: float = 0.0,
                 rng: Optional[DropoutRNG] = None):
        super().__init__()
        self.widths = ([hidden] * (num_layers - 1) + [out] if num_layers > 1
                       else [out])
        self.use_bn = use_bn
        self.use_ln = use_ln
        self.drop = Dropout(dropout, rng)
        d_in = in_features
        for i, w in enumerate(self.widths):
            self.add_module(f"lin1_{i}", Linear(d_in, w))
            self.add_module(f"lin2_{i}", Linear(d_in, w))
            if i < len(self.widths) - 1:
                if use_bn:
                    self.add_module(f"bn_{i}", MaskedBatchNorm(
                        w, track_running_stats=False))
                if use_ln:
                    self.add_module(f"ln_{i}", MaskedLayerNorm(w))
            d_in = w

    def _layer(self, i, x):
        return (getattr(self, f"lin1_{i}")(x)
                + getattr(self, f"lin2_{i}")(x.mean(dim=-2, keepdim=True)))

    def forward(self, x):
        last = len(self.widths) - 1
        for i in range(last):
            x = torch.relu(self._layer(i, x))
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x)
            if self.use_ln:
                x = getattr(self, f"ln_{i}")(x)
            x = self.drop(x)
        return self._layer(last, x)
