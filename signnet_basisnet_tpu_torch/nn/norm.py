"""Masked batch and layer norm with the reference's (PyTorch) semantics.

Port of signnet_basisnet_tpu/nn/norm.py (`MaskedBatchNorm`,
`MaskedLayerNorm`).  Batch norm: statistics come from the rows where
`mask` is 1 only; normalisation uses the biased variance and the running
variance is updated with the unbiased one; momentum 0.1, eps 1e-5; masked
rows are zero on output.  Running statistics stay float32 whatever the input
type (the JAX package's bf16 mode keeps batch_stats f32).  With
`track_running_stats=False` (the LearningFilters MLP and DeepSets) batch
statistics are used in eval mode too and the running buffers, still
registered at mean 0 and var 1 as flax creates them, never change.  While a
rematerialised layer's forward runs again in the backward pass
(nn/remat.py) the running statistics stay as the first run left them.
On a model-parallel shard (parallel/mp_halo.py: `mp_axis_ctx` set) the
batch statistics come from the count, sum and sum of squares summed over
the mp group, with the uncentred variance s2/cnt - mean^2, as the JAX
layer computes them there.
Inside a train step that records device spans, `MaskedBatchNorm.forward`
is the region `bn` (utils/profiling.py: `mark`).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.profiling import mark
from .remat import recomputing

MOMENTUM = 0.1
EPS = 1e-5


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, track_running_stats: bool = True):
        super().__init__()
        self.features = features
        self.track_running_stats = track_running_stats
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        d = self.features
        x = mark("bn", True, x)
        x2 = x.reshape(-1, d)
        m = None if mask is None else mask.reshape(-1, 1).to(x2.dtype)
        # a model-parallel shard: the statistics span every shard of the
        # node (or edge) axis, from the moment sums over the mp group, with
        # the uncentred variance (JAX nn/norm.py:48-70)
        from ..parallel.mp_halo import get_mp_axis, mp_psum
        mp_axis = get_mp_axis()
        if self.training or not self.track_running_stats:
            if mp_axis is not None:
                if m is None:
                    cnt = x2.new_full((1,), float(x2.shape[0]))
                    s1, s2 = x2.sum(dim=0), (x2 ** 2).sum(dim=0)
                else:
                    cnt = m.sum().reshape(1)
                    s1, s2 = (x2 * m).sum(dim=0), ((x2 ** 2) * m).sum(dim=0)
                cnt, s1, s2 = mp_psum(torch.cat([cnt, s1, s2]),
                                      mp_axis).split([1, d, d])
                cnt = torch.clamp(cnt[0], min=1.0)
                mean = s1 / cnt
                var = torch.clamp(s2 / cnt - mean ** 2, min=0.0)
            elif m is None:
                # filled on the device: a host tensor copied in would be a
                # copy from pageable memory, which a CUDA graph capture
                # refuses (SignNet's rho reaches this branch)
                cnt = x2.new_full((), float(x2.shape[0]))
                mean = x2.mean(dim=0)
                var = ((x2 - mean) ** 2).mean(dim=0)
            else:
                cnt = torch.clamp(m.sum(), min=1.0)
                mean = (x2 * m).sum(dim=0) / cnt
                var = (((x2 - mean) ** 2) * m).sum(dim=0) / cnt
            if (self.training and self.track_running_stats
                    and not recomputing()):
                with torch.no_grad():
                    unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                    self.running_mean.copy_(
                        (1 - MOMENTUM) * self.running_mean + MOMENTUM * mean)
                    self.running_var.copy_((1 - MOMENTUM) * self.running_var
                                           + MOMENTUM * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y2 = (x2 - mean) / torch.sqrt(var + EPS) * self.weight + self.bias
        if m is not None:
            y2 = y2 * m
        return mark("bn", False, y2.reshape(x.shape[:-1] + (d,)))


class MaskedLayerNorm(nn.Module):
    """Layer norm over the last axis (biased variance, eps 1e-6), output
    times the node mask: port of signnet_basisnet_tpu/nn/norm.py:
    MaskedLayerNorm."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias
        if mask is not None:
            y = y * mask[..., None].to(y.dtype)
        return y
