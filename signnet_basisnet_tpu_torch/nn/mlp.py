"""MLP blocks on the ZINC path.

Port of signnet_basisnet_tpu/nn/mlp.py: `MLP` (lin -> relu -> [BN] per hidden
layer, plain final linear; 2-D [N, D] and 3-D [N, K, D] input, 3-D BN
normalising over N*K rows), `ElementsMLP` and `MaskedMLP` (lin -> BN ->
relu, the Alchemy/GINE style), `MLPReadout` (the halving-width readout
head) and `MLPReadout2` (the same with dropout before every hidden Linear,
drawn from the model's `DropoutRNG`; no model path of either package uses
it).  Submodule names follow the flax names (`lin_i`, `bn_i`, `fc_i`).
Dropout follows each hidden layer's BN, as in the JAX MLP.  The JAX MLP's
residual and other activations are not on the ported path.  With
`bn_track_running_stats=False` (the LearningFilters MLPs) its BNs use batch
statistics in eval mode too.

`ElementsMLP` and `MaskedMLP` keep the JAX bias rule: a Linear has a bias
only if it is the last one and takes no activation (with `bias`), or if
`with_norm` is off.  Every layer but the last, and the last with
`with_final_activation`, is followed by BN (with `with_norm`; its
statistics over the rows where `mask` is 1) and ReLU.  `MaskedMLP` also
zeroes the masked slots after every Linear.  The hidden width is the
input's unless `hidden` is given.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .dropout import Dropout, DropoutRNG
from .init import Linear
from .norm import MaskedBatchNorm


class MLP(nn.Module):
    def __init__(self, in_features: int, hidden: int, out: int,
                 num_layers: int, use_bn: bool = False, dropout: float = 0.0,
                 rng: Optional[DropoutRNG] = None,
                 bn_track_running_stats: bool = True):
        super().__init__()
        self.num_layers = num_layers
        self.use_bn = use_bn
        self.drop = Dropout(dropout, rng)
        dims = [in_features] + [hidden] * (num_layers - 1) + [out]
        for i in range(num_layers):
            self.add_module(f"lin_{i}", Linear(dims[i], dims[i + 1]))
            if use_bn and i < num_layers - 1:
                self.add_module(f"bn_{i}", MaskedBatchNorm(
                    hidden, track_running_stats=bn_track_running_stats))

    def forward(self, x, mask=None):
        for i in range(self.num_layers - 1):
            x = torch.relu(getattr(self, f"lin_{i}")(x))
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x, mask=mask)
            x = self.drop(x)
        return getattr(self, f"lin_{self.num_layers - 1}")(x)


class MLPReadout(nn.Module):
    def __init__(self, in_features: int, out: int, num_hidden_layers: int = 2):
        super().__init__()
        self.num_hidden_layers = num_hidden_layers
        dims = [in_features // 2 ** l for l in range(num_hidden_layers + 1)]
        for l in range(num_hidden_layers):
            self.add_module(f"fc_{l}", Linear(dims[l], dims[l + 1]))
        self.add_module(f"fc_{num_hidden_layers}", Linear(dims[-1], out))

    def forward(self, x):
        for l in range(self.num_hidden_layers):
            x = torch.relu(getattr(self, f"fc_{l}")(x))
        return getattr(self, f"fc_{self.num_hidden_layers}")(x)


class MLPReadout2(MLPReadout):
    def __init__(self, in_features: int, out: int, num_hidden_layers: int = 2,
                 dropout: float = 0.0, rng: Optional[DropoutRNG] = None):
        super().__init__(in_features, out, num_hidden_layers)
        self.drop = Dropout(dropout, rng)

    def forward(self, x):
        for l in range(self.num_hidden_layers):
            x = torch.relu(getattr(self, f"fc_{l}")(self.drop(x)))
        return getattr(self, f"fc_{self.num_hidden_layers}")(x)


class ElementsMLP(nn.Module):
    def __init__(self, in_features: int, out: int, num_layers: int = 2,
                 with_final_activation: bool = True, with_norm: bool = True,
                 bias: bool = True, hidden: Optional[int] = None,
                 zero_masked: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.with_final_activation = with_final_activation
        self.with_norm = with_norm
        self.zero_masked = zero_masked
        n_hid = in_features if hidden is None else hidden
        d_in = in_features
        for i in range(num_layers):
            last = i == num_layers - 1
            feats = out if last else n_hid
            use_bias = ((last and not with_final_activation and bias)
                        or not with_norm)
            self.add_module(f"lin_{i}", Linear(d_in, feats, use_bias))
            if self._activated(i) and with_norm:
                self.add_module(f"bn_{i}", MaskedBatchNorm(feats))
            d_in = feats

    def _activated(self, i: int) -> bool:
        return i < self.num_layers - 1 or self.with_final_activation

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        for i in range(self.num_layers):
            x = getattr(self, f"lin_{i}")(x)
            if self.zero_masked and mask is not None:
                x = x * mask[..., None].to(x.dtype)
            if self._activated(i):
                if self.with_norm:
                    x = getattr(self, f"bn_{i}")(x, mask=mask)
                x = torch.relu(x)
        return x


class MaskedMLP(ElementsMLP):
    """ElementsMLP that zeroes the masked slots after every Linear."""

    def __init__(self, in_features: int, out: int, num_layers: int = 2,
                 with_final_activation: bool = True, with_norm: bool = True,
                 bias: bool = True, hidden: Optional[int] = None):
        super().__init__(in_features, out, num_layers, with_final_activation,
                         with_norm, bias, hidden, zero_masked=True)
