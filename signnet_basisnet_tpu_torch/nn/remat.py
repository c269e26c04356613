"""Rematerialised layers: activations recomputed in the backward pass
instead of kept.

Counterpart of flax `nn.remat` around each conv layer of the JAX ZINC nets
(`models/zinc_models.py: maybe_remat`).  `checkpoint(layer, *args)` runs
`layer(*args)` under `torch.utils.checkpoint.checkpoint(use_reentrant=
False)`, which keeps the layer's inputs and runs its forward again when
the backward needs what the forward would have kept.  Two things that
`nn.remat` gives by construction are kept here:

- the recompute draws the dropout masks of the first run: every
  `DropoutRNG` the layer's `Dropout` modules draw from is set back, for the
  recompute, to its state when the layer first ran, and put back to where
  it stood afterwards (torch's checkpoint restores only the global RNG,
  which these layers never draw from, so `preserve_rng_state=False`);
- the BatchNorm running statistics move once: `MaskedBatchNorm` leaves
  them alone while `recomputing()`, as `nn.remat` returns the statistics
  of the first forward only.

A kernel launched in the layer's forward (K1 in GIN, K2 in the
Transformer, K4 in GatedGCN) launches again in the recompute.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from .dropout import Dropout

_STATE = threading.local()


def recomputing() -> bool:
    """Whether a checkpointed layer's forward is being run again (in the
    thread that runs the backward)."""
    return getattr(_STATE, "depth", 0) > 0


def layer_rngs(layer: torch.nn.Module):
    """The generators the dropouts of `layer` draw from, once each."""
    rngs = {id(m.rng): m.rng for m in layer.modules()
            if isinstance(m, Dropout) and m.rate and m.training}
    return list(rngs.values())


@contextlib.contextmanager
def _recompute(rngs, first):
    now = [None if r.generator is None else r.generator.get_state()
           for r in rngs]
    for r, state in zip(rngs, first):
        if r.generator is not None:
            if state is None:   # the first run made the generator
                r.generator.manual_seed(r.seed)
            else:
                r.generator.set_state(state)
    _STATE.depth = getattr(_STATE, "depth", 0) + 1
    try:
        yield
    finally:
        _STATE.depth -= 1
        for r, state in zip(rngs, now):
            if state is not None:
                r.generator.set_state(state)


def checkpoint(layer: torch.nn.Module, *args):
    """layer(*args), its activations recomputed in the backward pass."""
    rngs = layer_rngs(layer)
    first = [None if r.generator is None else r.generator.get_state()
             for r in rngs]
    return _checkpoint(
        layer, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(),
                            _recompute(rngs, first)))
