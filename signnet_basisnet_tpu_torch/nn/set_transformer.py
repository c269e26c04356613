"""Masked set-transformer blocks: the SignNet rho over the eigenvector axis.

Port of signnet_basisnet_tpu/nn/set_transformer.py: `PositionalEncoding`,
`MultiHeadAttention`, `PositionwiseFeedForward`, `TransformerEncoderLayer`
and `SetTransformer`, on [n, k, d] inputs with a [n, k] mask:

- the attention is two einsums over [n, h, k, k] scores; a score whose
  query or key slot is masked is replaced by -1e10 before the softmax, and
  the softmax is multiplied by the pair mask after its dropout, so a row
  whose query slot is masked (a padding node, or an eigenvector slot at or
  beyond its graph's size) gets a uniform softmax and is then zeroed, as in
  JAX (an -inf fill would give NaN there);
- attention dropout 0.1 on the softmax (the JAX default, `attn_dropout`),
  drawn from the model's `DropoutRNG`; the other dropouts default to 0;
- Q/K/V/O projections without bias, of `n_head * (d_model // n_head)`
  features (108 for d_model = 110 and 4 heads);
- masked LayerNorm (eps 1e-6) after each residual add, and the masked
  slots zeroed between the sublayers.

`SetTransformer` adds the positional input, runs `nlayer` encoder layers of
4 heads, sums over k, then `out_lin` and `out_bn`, a BatchNorm with no mask:
its statistics run over all n rows, the padding nodes' zero rows included,
as in JAX.  Names follow flax (`slf_attn`, `pos_ffn`, `w_qs`, `fc`,
`norm`, `w_1`, `layer_i`, `out_lin`, `out_bn`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .dropout import Dropout, DropoutRNG
from .init import Linear
from .norm import MaskedBatchNorm, MaskedLayerNorm

# the masked scores' fill, as in JAX: finite, so that an all-masked row
# softmaxes to a uniform row (then zeroed by the pair mask)
MASK_FILL = -1e10


def _masked(x, mask):
    return x if mask is None else x * mask[..., None].to(x.dtype)


class PositionalEncoding(nn.Module):
    """Sinusoidal encoding of continuous positions (eigenvalues in [0, 2]):
    [n, k] -> [n, k, d], sines at the even features, cosines at the odd."""

    def __init__(self, dim_model: int, freq: float = 100.0):
        super().__init__()
        self.dim_model = dim_model
        self.freq = freq

    def forward(self, pos, mask: Optional[torch.Tensor] = None):
        d = self.dim_model
        div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                     device=pos.device)
                        * (-math.log(self.freq) / d))
        ang = pos[..., None] * div.to(pos.dtype)
        enc = pos.new_zeros(pos.shape + (d,))
        enc[..., 0::2] = torch.sin(ang)
        enc[..., 1::2] = torch.cos(ang[..., :d - d // 2])
        return _masked(enc, mask)


class MultiHeadAttention(nn.Module):
    def __init__(self, n_head: int, d_model: int, dropout: float = 0.0,
                 attn_dropout: float = 0.1,
                 rng: Optional[DropoutRNG] = None):
        super().__init__()
        self.n_head = n_head
        self.d_k = d_model // n_head
        width = n_head * self.d_k
        self.w_qs = Linear(d_model, width, use_bias=False)
        self.w_ks = Linear(d_model, width, use_bias=False)
        self.w_vs = Linear(d_model, width, use_bias=False)
        self.attn_drop = Dropout(attn_dropout, rng)
        self.fc = Linear(width, d_model, use_bias=False)
        self.drop = Dropout(dropout, rng)
        self.norm = MaskedLayerNorm(d_model)

    def forward(self, q, k, v, mask: Optional[torch.Tensor] = None):
        n, lq, _ = q.shape
        h, dk = self.n_head, self.d_k

        def split_heads(x, lin):
            return lin(x).reshape(n, -1, h, dk).transpose(1, 2)

        qh = split_heads(q, self.w_qs)
        kh = split_heads(k, self.w_ks)
        vh = split_heads(v, self.w_vs)
        attn = torch.einsum("nhqd,nhkd->nhqk", qh / math.sqrt(dk), kh)
        if mask is not None:
            m = mask.to(attn.dtype)
            pair = m[:, None, :, None] * m[:, None, None, :]
            attn = attn.masked_fill(pair <= 0, MASK_FILL)
        attn = torch.softmax(attn, dim=-1)
        attn = self.attn_drop(attn)
        if mask is not None:
            attn = attn * pair
        out = torch.einsum("nhqk,nhkd->nhqd", attn, vh)
        out = out.transpose(1, 2).reshape(n, lq, h * dk)
        out = self.drop(self.fc(out)) + q
        return self.norm(out, mask=mask)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model: int, dropout: float = 0.0,
                 rng: Optional[DropoutRNG] = None):
        super().__init__()
        self.w_1 = Linear(d_model, d_model)
        self.w_2 = Linear(d_model, d_model)
        self.drop = Dropout(dropout, rng)
        self.norm = MaskedLayerNorm(d_model)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        y = _masked(torch.relu(self.w_1(x)), mask)
        y = self.drop(_masked(self.w_2(y), mask))
        return self.norm(y + x, mask=mask)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, n_head: int = 4, dropout: float = 0.0,
                 rng: Optional[DropoutRNG] = None):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model, dropout=dropout,
                                           rng=rng)
        self.pos_ffn = PositionwiseFeedForward(d_model, dropout=dropout,
                                               rng=rng)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        x = _masked(self.slf_attn(x, x, x, mask=mask), mask)
        return _masked(self.pos_ffn(x, mask=mask), mask)


class SetTransformer(nn.Module):
    """rho: masked transformer over the k axis, sum over k, Linear + BN."""

    def __init__(self, nhid: int, nlayer: int,
                 rng: Optional[DropoutRNG] = None):
        super().__init__()
        self.nlayer = nlayer
        for i in range(nlayer):
            self.add_module(f"layer_{i}",
                            TransformerEncoderLayer(nhid, n_head=4, rng=rng))
        self.out_lin = Linear(nhid, nhid, use_bias=False)
        self.out_bn = MaskedBatchNorm(nhid)

    def forward(self, x, pos, mask: Optional[torch.Tensor] = None):
        x = x + pos
        for i in range(self.nlayer):
            x = getattr(self, f"layer_{i}")(x, mask=mask)
        return self.out_bn(self.out_lin(x.sum(dim=1)))
