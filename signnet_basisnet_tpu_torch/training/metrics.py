"""Metrics: masked MAE/MSE/r2 and classification scores.

Port of signnet_basisnet_tpu/training/metrics.py.  Graph-level metrics are
weighted by the graph mask, so padding graphs never count.
"""
from __future__ import annotations

import torch


def _expand(mask, like):
    while mask.dim() < like.dim():
        mask = mask[..., None]
    return mask


def masked_l1(pred, target, mask):
    """Mean absolute error over valid entries (torch L1Loss semantics)."""
    err = torch.abs(pred - target)
    mask = _expand(mask, err)
    denom = torch.clamp((mask * torch.ones_like(err)).sum(), min=1.0)
    return (err * mask).sum() / denom


masked_mae = masked_l1


def masked_mse_sum(pred, target, mask):
    """Sum of squared masked errors (the LearningFilters loss)."""
    err = pred - target
    return ((_expand(mask, err) * err) ** 2).sum()


def masked_r2(pred, target, mask):
    w = _expand(mask, target) * torch.ones_like(target)
    denom = torch.clamp(w.sum(), min=1.0)
    mean = (target * w).sum() / denom
    ss_res = (((pred - target) * w) ** 2).sum()
    ss_tot = torch.clamp((((target - mean) * w) ** 2).sum(), min=1e-12)
    return 1.0 - ss_res / ss_tot


def accuracy(logits, labels, mask):
    pred = torch.argmax(logits, dim=-1)
    correct = (pred == labels).to(mask.dtype) * mask
    return correct.sum() / torch.clamp(mask.sum(), min=1.0)


def binary_f1(pred, target, mask, threshold=0.5):
    p = (pred > threshold).to(mask.dtype) * mask
    t = (target > threshold).to(mask.dtype) * mask
    tp = (p * t).sum()
    prec = tp / torch.clamp(p.sum(), min=1.0)
    rec = tp / torch.clamp(t.sum(), min=1.0)
    return 2 * prec * rec / torch.clamp(prec + rec, min=1e-12)


def masked_l1_per_target(pred, target, mask):
    """Per-target MAE over real graphs, a [T] vector (per-target sums of
    absolute errors over the graph count); logMAE is the mean of the
    per-target logs."""
    err = torch.abs(pred - target) * mask[:, None]
    return err.sum(0) / torch.clamp(mask.sum(), min=1.0)


def accuracy_sbm(logits, labels, mask, num_classes: int):
    """Class-balanced accuracy: the mean over classes of per-class recall,
    x100."""
    pred = torch.argmax(logits, dim=-1)
    accs = []
    for c in range(num_classes):
        in_c = (labels == c).to(mask.dtype) * mask
        correct = ((pred == c).to(mask.dtype) * in_c).sum()
        n_c = in_c.sum()
        accs.append(torch.where(n_c > 0, correct / torch.clamp(n_c, min=1.0),
                                torch.zeros_like(n_c)))
    return 100.0 * torch.stack(accs).sum() / num_classes


def weighted_f1(logits, labels, mask, num_classes: int):
    """Support-weighted multi-class F1 (sklearn's average='weighted')."""
    pred = torch.argmax(logits, dim=-1)
    total = torch.clamp(mask.sum(), min=1.0)
    f1_sum = 0.0
    for c in range(num_classes):
        p = (pred == c).to(mask.dtype) * mask
        t = (labels == c).to(mask.dtype) * mask
        tp = (p * t).sum()
        prec = tp / torch.clamp(p.sum(), min=1e-12)
        rec = tp / torch.clamp(t.sum(), min=1e-12)
        f1 = 2 * prec * rec / torch.clamp(prec + rec, min=1e-12)
        f1_sum = f1_sum + f1 * t.sum()
    return f1_sum / total
