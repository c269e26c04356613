"""Adam and the plateau LR schedule.

Port of signnet_basisnet_tpu/training/optim.py.  Adam with the torch-default
hyperparameters (b1 0.9, b2 0.999, eps 1e-8) — optax's scale_by_adam is the
same update — with the LR set at run time before every step (`set_lr`), and
the host-side `ReduceLROnPlateau` of the reference loop.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


def adam(params, weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """Adam; with weight decay the decoupled (AdamW) form, as the JAX chain
    scale_by_adam -> add_decayed_weights -> scale_by_learning_rate is."""
    kw = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    if weight_decay:
        return torch.optim.AdamW(params, weight_decay=weight_decay, **kw)
    return torch.optim.Adam(params, **kw)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


@dataclass
class ReduceLROnPlateau:
    """Host-side plateau scheduler (torch semantics, mode='min')."""
    factor: float = 0.5
    patience: int = 25
    min_lr: float = 1e-6
    lr: float = 1e-3
    best: float = float("inf")
    bad_epochs: int = 0

    def step(self, metric: float) -> float:
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr

    @property
    def converged(self) -> bool:
        """The reference's stop condition: lr fell to/below min_lr."""
        return self.lr <= self.min_lr * (1 + 1e-9)
