"""Checkpoint / restore of the train state, keeping the last N.

Counterpart of signnet_basisnet_tpu/training/checkpoint.py (orbax's
`CheckpointManager`): `torch.save` of one dict per epoch, written to a
temporary file and renamed into place, as ``<directory>/epoch_<n>.pt``.
`train_state` gathers what the JAX checkpoint holds: the model's
parameters and BatchNorm statistics (its state dict), the optimizer's
state, the LR for the next epoch and the epoch, plus the state of every
generator the net owns (`nn.dropout.model_rngs`: dropout's, and under
sign flips the train and eval flip generators), so that a resumed run
draws what an uninterrupted one would.

A `capturable` optimizer keeps Adam's `step` and its LR on the card.  Its
state dict loads into a capturable optimizer as it was saved (torch puts
`step` back on the parameters' device); `load_train_state` keeps each
group's LR tensor, the one a captured step reads, and writes the saved LR
into it (a float LR is set to it too).  A step captured before the restore
reads the old Adam state: capture after restoring.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from ..nn.dropout import model_rngs
from .optim import set_lr

_NAME = re.compile(r"^epoch_(\d+)\.pt$")


class Checkpointer:
    def __init__(self, directory: str, keep: int = 2):
        if keep < 1:
            raise ValueError("keep at least one checkpoint")
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"epoch_{step}.pt")

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _NAME.match(f)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict) -> None:
        tmp = f"{self.path(step)}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, self.path(step))
        for old in self.steps()[:-self.keep]:
            os.remove(self.path(old))

    def restore(self, step: Optional[int] = None) -> Optional[dict]:
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)


def train_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                lr: float, epoch: int) -> dict:
    state = {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
             "lr": float(lr), "epoch": int(epoch)}
    for name, rng in model_rngs(model).items():
        if rng.generator is not None:
            state[name] = rng.generator.get_state()
    return state


def load_train_state(model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, state: dict) -> float:
    """Load `state` (from `train_state`) into `model` and `optimizer` in
    place; the optimizer takes the saved LR, which is returned."""
    model.load_state_dict(state["model"])
    lrs = [g["lr"] for g in optimizer.param_groups]
    optimizer.load_state_dict(state["optimizer"])
    for group, lr in zip(optimizer.param_groups, lrs):
        if isinstance(lr, torch.Tensor):
            group["lr"] = lr
    set_lr(optimizer, state["lr"])
    dev = next(model.parameters()).device
    for name, rng in model_rngs(model).items():
        if name in state:
            rng.on(dev).set_state(state[name])
    return float(state["lr"])
