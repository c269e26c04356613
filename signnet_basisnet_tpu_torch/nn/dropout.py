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
that each replay draws a fresh mask.  On a DTensor (parallel/gspmd.py) the
mask is drawn on the full shape from the same generator on every rank and
placed as the input is placed (`place_like`): the sharded step draws the
single-device step's bits, as JAX's partitionable PRNG does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..graph.segment import is_dtensor


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


def place_like(full: torch.Tensor, like: DTensor) -> DTensor:
    """`full`, which every rank holds alike, as a DTensor placed as `like`
    is (a `Partial` axis replicated), each rank keeping its own shard with
    no communication."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    placements = [Replicate() if p.is_partial() else p
                  for p in like.placements]
    return distribute_tensor(full, like.device_mesh, placements,
                             src_data_rank=None)


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
        if is_dtensor(x):
            keep = place_like(torch.empty_strided(
                x.shape, x.stride(), dtype=x.dtype, device=x.device
            ).bernoulli_(1.0 - self.rate, generator=self.rng.on(x.device)),
                x)
        else:
            keep = torch.empty_like(x).bernoulli_(
                1.0 - self.rate, generator=self.rng.on(x.device))
        return x * keep / (1.0 - self.rate)
