"""Helpers for checking kernels that allocate their outputs unfilled."""
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
