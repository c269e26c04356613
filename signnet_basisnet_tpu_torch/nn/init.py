"""Linear and Embedding with the reference's PyTorch-default init.

Port of signnet_basisnet_tpu/nn/init.py.  `Linear` draws weight and bias
(none with `use_bias=False`) from uniform(+-1/sqrt(fan_in)), `Embedding`
from N(0, 1), each from an explicit `torch.Generator` (`init_parameters`).
`ACTIVATIONS` maps the JAX package's activation names to torch functions.
Weights are [out, in] (the flax kernel is [in, out]; bridge.py transposes).

`Linear` follows JAX's type promotion: an f32 input against bf16 weights
computes in f32 with the bf16-rounded weights, as the JAX package's
whole-model bf16 mode does after a BatchNorm that normalises with f32
running statistics.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True):
        super().__init__()
        self.in_features = in_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features)) if use_bias
                     else None)

    def reset_parameters(self, generator: torch.Generator):
        bound = 1.0 / math.sqrt(max(self.in_features, 1))
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, idx):
        return self.weight[idx.long()]


# the JAX package's activation names, as far as the ported layers use them
ACTIVATIONS = {"relu": torch.relu, "elu": F.elu}


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of `module` that a submodule's
    `reset_parameters(generator)` draws (Linear, Embedding and the layers
    with parameters of their own, such as GAT's attention vectors) from
    `generator`, in module order."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
