"""Metrics (port of signnet_basisnet_tpu/training/metrics.py:masked_l1)."""
from __future__ import annotations

import torch


def masked_l1(pred, target, mask):
    """Mean absolute error over valid entries (torch L1Loss semantics)."""
    err = torch.abs(pred - target)
    while mask.dim() < err.dim():
        mask = mask[..., None]
    denom = torch.clamp((mask * torch.ones_like(err)).sum(), min=1.0)
    return (err * mask).sum() / denom
