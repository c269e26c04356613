"""Checks: the run's device (`card_or_cpu`), and NaN-filled allocation for
checking kernels that allocate their outputs unfilled."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def nan_filled_empty():
    """torch.empty and torch.empty_like hand out NaN-filled float tensors
    while the block runs, so an output entry a kernel leaves unwritten
    shows as NaN and fails its check."""
    empty, empty_like = torch.empty, torch.empty_like

    def fill(t):
        return t.fill_(float("nan")) if t.is_floating_point() else t

    torch.empty = lambda *a, **k: fill(empty(*a, **k))
    torch.empty_like = lambda *a, **k: fill(empty_like(*a, **k))
    try:
        yield
    finally:
        torch.empty, torch.empty_like = empty, empty_like


def card_or_cpu(name: str) -> torch.device:
    """The entry points' device: `cuda` needs a card and raises without
    one; `cpu` is taken only when asked for."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu "
                           "(device='cpu') to run on the CPU")
    return device
