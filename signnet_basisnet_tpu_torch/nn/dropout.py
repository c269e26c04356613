"""Dropout drawing from a model's own seeded generator.

Counterpart of flax `nn.Dropout` as the JAX nets apply it: in training, an
element is kept with probability 1 - rate and scaled by 1 / (1 - rate),
else zeroed; at eval, and at rate 0, the input passes unchanged (no draw).
The JAX package draws from the step's `dropout` rng key; here every
`Dropout` of a model draws from one `DropoutRNG`, a `torch.Generator`
seeded from the run's seed and made on the device of the first tensor it
masks.  The two packages draw different bits from the same seed, so they
agree only at rate 0, or in distribution.  A CUDA graph of the train step
must register the generator (`training.train.capture_train_step` does), so
that each replay draws a fresh mask.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn


class DropoutRNG:
    """A seeded generator, made on the device of its first use: the one a
    model's dropout layers share, and each of the sign-flip generators
    (models/pe.py: `sign_flip`, which counts its draws in `draws`)."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self.generator: Optional[torch.Generator] = None
        self.draws = 0

    def on(self, device: torch.device) -> torch.Generator:
        """The generator on `device`, seeded anew if it lived elsewhere."""
        if self.generator is None or self.generator.device != device:
            self.generator = torch.Generator(device=device)
            self.generator.manual_seed(self.seed)
        return self.generator


def model_rngs(model: nn.Module) -> Dict[str, DropoutRNG]:
    """The seeded generators `model` owns, by attribute name
    (`dropout_rng`, and under sign flips `flip_rng` and `eval_flip_rng`)."""
    return {k: v for k, v in vars(model).items()
            if isinstance(v, DropoutRNG)}


class Dropout(nn.Module):
    def __init__(self, rate: float, rng: Optional[DropoutRNG] = None):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate {rate} outside [0, 1)")
        if rate and rng is None:
            raise ValueError("dropout needs the model's DropoutRNG")
        self.rate = float(rate)
        self.rng = rng

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = torch.empty_like(x).bernoulli_(
            1.0 - self.rate, generator=self.rng.on(x.device))
        return x * keep / (1.0 - self.rate)
