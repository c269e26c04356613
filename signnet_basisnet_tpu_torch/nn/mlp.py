"""MLP blocks on the ZINC path.

Port of signnet_basisnet_tpu/nn/mlp.py: `MLP` (lin -> relu -> [BN] per hidden
layer, plain final linear; 2-D [N, D] and 3-D [N, K, D] input, 3-D BN
normalising over N*K rows) and `MLPReadout` (the halving-width readout
head).  Submodule names follow the flax names (`lin_i`, `bn_i`, `fc_i`).
Dropout follows each hidden layer's BN, as in the JAX MLP.  The JAX MLP's
residual and other activations are not on the ported path.
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
                 rng: Optional[DropoutRNG] = None):
        super().__init__()
        self.num_layers = num_layers
        self.use_bn = use_bn
        self.drop = Dropout(dropout, rng)
        dims = [in_features] + [hidden] * (num_layers - 1) + [out]
        for i in range(num_layers):
            self.add_module(f"lin_{i}", Linear(dims[i], dims[i + 1]))
            if use_bn and i < num_layers - 1:
                self.add_module(f"bn_{i}", MaskedBatchNorm(hidden))

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
