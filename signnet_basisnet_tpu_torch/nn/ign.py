"""Invariant Graph Network (IGN) equivariant linear layers.

Port of signnet_basisnet_tpu/nn/ign.py: the permutation-equivariant linear
bases of Maron et al., 2->2 (15 ops), 2->1 (5), 1->2 (5) and 1->1 (2), with
the 'inf' normalisation (summed ops divided by m or m^2), applied channel
by channel through a learnt coefficient tensor [D, S, b]; inputs are
[B, D, m, m] or [B, D, m].  Plain reductions, broadcasts and one einsum:
no Pallas kernel in the JAX package, none here.

`IGN2to1` (BasisNet's encoder): a 2->1 layer, then two 1->1 layers, each
followed by ReLU and BatchNorm over [B*m, C] (running statistics
tracked); then `fc1`, ReLU, `fc2`.  The JAX package makes no BatchNorm for
`fc1`, so neither does the port.  Names follow flax: `equi_i`, `bn_i`,
`fc1`, `fc2`; a layer's `coeffs`, `bias` and (2->2) `diag_bias`.

On the 2D grid the 2->1 layer's input is the stack of eigenspace
projectors, constant through training: it takes no gradient, so the
backward never reads it.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .init import Linear
from .norm import MaskedBatchNorm


def _reductions(x):
    """diag [B, D, m], trace [B, D, 1], row and column sums [B, D, m] and
    the total [B, D] of x [B, D, m, m]."""
    diag = torch.diagonal(x, dim1=-2, dim2=-1)
    sum_rows = x.sum(-1)
    sum_cols = x.sum(-2)
    return (diag, diag.sum(-1, keepdim=True), sum_rows, sum_cols,
            sum_rows.sum(-1))


def contractions_2_to_2(x, normalize: bool = True):
    """[B, D, m, m] -> [B, D, 15, m, m] stacked basis ops."""
    m = x.shape[-1]
    diag, sum_diag, sum_rows, sum_cols, sum_all = _reductions(x)
    tile = lambda v: v[..., None, :].expand(x.shape)      # rows of v
    tile_t = lambda v: v[..., :, None].expand(x.shape)    # columns of v
    const = lambda s: s[..., None, None].expand(x.shape)
    ops = [
        torch.diag_embed(diag),
        torch.diag_embed(sum_diag.expand(diag.shape)),
        torch.diag_embed(sum_rows),
        torch.diag_embed(sum_cols),
        torch.diag_embed(sum_all[..., None].expand(diag.shape)),
        tile_t(sum_cols),
        tile_t(sum_rows),
        tile(sum_cols),
        tile(sum_rows),
        x,
        x.transpose(-1, -2),
        tile_t(diag),
        tile(diag),
        const(sum_diag[..., 0]),
        const(sum_all),
    ]
    if normalize:
        fm = float(m)
        scale = [1, 1 / fm, 1 / fm, 1 / fm, 1 / fm ** 2, 1 / fm, 1 / fm,
                 1 / fm, 1 / fm, 1, 1, 1, 1, 1 / fm, 1 / fm ** 2]
        ops = [o * s for o, s in zip(ops, scale)]
    return torch.stack(ops, dim=2)


def contractions_2_to_1(x, normalize: bool = True):
    """[B, D, m, m] -> [B, D, 5, m]."""
    m = x.shape[-1]
    diag, sum_diag, sum_rows, sum_cols, sum_all = _reductions(x)
    ops = [diag, sum_diag.expand(diag.shape), sum_rows, sum_cols,
           sum_all[..., None].expand(diag.shape)]
    if normalize:
        fm = float(m)
        scale = [1, 1 / fm, 1 / fm, 1 / fm, 1 / fm ** 2]
        ops = [o * s for o, s in zip(ops, scale)]
    return torch.stack(ops, dim=2)


def contractions_1_to_2(x, normalize: bool = True):
    """[B, D, m] -> [B, D, 5, m, m]."""
    m = x.shape[-1]
    sum_all = x.sum(-1, keepdim=True)          # B D 1
    full = x.shape[:-1] + (m, m)
    ops = [
        torch.diag_embed(x),
        torch.diag_embed(sum_all.expand(x.shape)),
        x[..., None, :].expand(full),          # element i in row slots
        x[..., :, None].expand(full),          # element i in column slots
        sum_all[..., None].expand(full),
    ]
    if normalize:
        fm = float(m)
        scale = [1, 1 / fm, 1, 1, 1 / fm]
        ops = [o * s for o, s in zip(ops, scale)]
    return torch.stack(ops, dim=2)


def contractions_1_to_1(x, normalize: bool = True):
    """[B, D, m] -> [B, D, 2, m]."""
    m = x.shape[-1]
    sum_all = x.sum(-1, keepdim=True).expand(x.shape)
    if normalize:
        sum_all = sum_all / float(m)
    return torch.stack([x, sum_all], dim=2)


BASES = {(2, 2): (contractions_2_to_2, 15), (2, 1): (contractions_2_to_1, 5),
         (1, 2): (contractions_1_to_2, 5), (1, 1): (contractions_1_to_1, 2)}


def _coeff_init(coeffs: torch.Tensor, generator: torch.Generator):
    """randn * sqrt(2) / (D + S), the reference's init."""
    d, s, _ = coeffs.shape
    with torch.no_grad():
        coeffs.normal_(0.0, 1.0, generator=generator)
        coeffs.mul_(math.sqrt(2.0) / (d + s))


class EquivariantLayer(nn.Module):
    """One equivariant linear map from rank `in_rank` to `out_rank` over
    `in_depth` input channels."""

    def __init__(self, in_depth: int, out_depth: int, in_rank: int = 2,
                 out_rank: int = 1):
        super().__init__()
        self.key = (in_rank, out_rank)
        self.basis_fn, basis_dim = BASES[self.key]
        self.out_rank = out_rank
        self.coeffs = nn.Parameter(torch.empty(in_depth, out_depth,
                                               basis_dim))
        tail = (1, 1) if out_rank == 2 else (1,)
        self.bias = nn.Parameter(torch.zeros((1, out_depth) + tail))
        if self.key == (2, 2):
            self.diag_bias = nn.Parameter(torch.zeros(1, out_depth, 1, 1))

    def reset_parameters(self, generator: torch.Generator):
        _coeff_init(self.coeffs, generator)

    def forward(self, x):
        ops = self.basis_fn(x)  # B D b m [m]
        if self.out_rank == 2:
            out = torch.einsum("dsb,ndbij->nsij", self.coeffs, ops)
            if self.key == (2, 2):
                m = out.shape[-1]
                eye = torch.eye(m, dtype=out.dtype, device=out.device)
                out = out + eye * self.diag_bias
            return out + self.bias
        return torch.einsum("dsb,ndbi->nsi", self.coeffs, ops) + self.bias


class BasicEquivariantLayer(nn.Module):
    """The 4-op 'basic' 2->2 layer: identity, column-mean, row-mean and
    total-mean broadcasts."""

    def __init__(self, in_depth: int, out_depth: int):
        super().__init__()
        self.coeffs = nn.Parameter(torch.empty(in_depth, out_depth, 4))
        self.bias = nn.Parameter(torch.zeros(1, out_depth, 1, 1))

    def reset_parameters(self, generator: torch.Generator):
        _coeff_init(self.coeffs, generator)

    def forward(self, x):
        fm = float(x.shape[-1])
        sum_cols = x.sum(-2) / fm
        sum_rows = x.sum(-1) / fm
        sum_all = sum_rows.sum(-1) / fm
        ops = torch.stack([
            x,
            sum_cols[..., None, :].expand(x.shape),
            sum_rows[..., :, None].expand(x.shape),
            sum_all[..., None, None].expand(x.shape),
        ], dim=2)
        out = torch.einsum("dsb,ndbij->nsij", self.coeffs, ops)
        return out + self.bias


class IGN2to1(nn.Module):
    """[B, 1, m, m] -> [B, out, m] equivariant node outputs."""

    RANKS = ((2, 1), (1, 1), (1, 1))

    def __init__(self, hidden: int, out: int, use_bn: bool = True):
        super().__init__()
        self.use_bn = use_bn
        d = 1
        for i, (ri, ro) in enumerate(self.RANKS):
            self.add_module(f"equi_{i}", EquivariantLayer(
                d, hidden, in_rank=ri, out_rank=ro))
            if use_bn:
                self.add_module(f"bn_{i}", MaskedBatchNorm(hidden))
            d = hidden
        self.fc1 = Linear(hidden, hidden)
        self.fc2 = Linear(hidden, out)

    def forward(self, x):
        for i in range(len(self.RANKS)):
            x = torch.relu(getattr(self, f"equi_{i}")(x))
            if self.use_bn:
                # BatchNorm1d on [B, C, m]: statistics per channel over B*m
                x = getattr(self, f"bn_{i}")(x.transpose(1, 2))
                x = x.transpose(1, 2)
        x = torch.relu(self.fc1(x.transpose(1, 2)))   # B m hidden
        return self.fc2(x).transpose(1, 2)            # B out m
