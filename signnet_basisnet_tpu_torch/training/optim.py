"""Adam and the LR schedules.

Port of signnet_basisnet_tpu/training/optim.py.  Adam with the torch-default
hyperparameters (b1 0.9, b2 0.999, eps 1e-8) — optax's scale_by_adam is the
same update — with the LR set at run time before every step (`set_lr`), and
the host-side `ReduceLROnPlateau` and `StepLR` of the reference loops.

The JAX step takes the LR as a traced scalar.  A CUDA graph of the train
step would bake a Python float in, so `adam(..., capturable=True)` keeps
the LR in a 0-dim float32 tensor on the parameters' device, which
`set_lr` fills in place before each replay (torch's `capturable` Adam reads
it on the device).  Eager steps, and every step on the CPU, keep a float LR:
`capturable` refuses CPU parameters, and torch's default (foreach) Adam
refuses a tensor LR without it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


def adam(params, weight_decay: float = 0.0,
         capturable: bool = False) -> torch.optim.Optimizer:
    """Adam; with weight decay the decoupled (AdamW) form, as the JAX chain
    scale_by_adam -> add_decayed_weights -> scale_by_learning_rate is.
    With `capturable` (CUDA parameters only) the LR is a device tensor and
    the step can be captured in a CUDA graph."""
    params = list(params)
    lr = 1e-3
    if capturable:
        lr = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
    kw = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=capturable)
    if weight_decay:
        return torch.optim.AdamW(params, weight_decay=weight_decay, **kw)
    return torch.optim.Adam(params, **kw)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The LR of every group: written into a tensor LR in place (which a
    captured step reads), else as a float."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(float(lr))
        else:
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


@dataclass
class StepLR:
    """StepLR(step_size, gamma): the GINESignNetPyG scheduler."""
    step_size: int = 300
    gamma: float = 0.5
    lr: float = 1e-3
    epoch: int = 0

    def step(self, metric: float = 0.0) -> float:
        self.epoch += 1
        if self.epoch % self.step_size == 0:
            self.lr *= self.gamma
        return self.lr

    @property
    def converged(self) -> bool:
        return False
