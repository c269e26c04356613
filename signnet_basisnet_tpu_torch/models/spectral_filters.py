"""Spectral-filter nets (the LearningFilters baselines).

Port of signnet_basisnet_tpu/models/spectral_filters.py: node-level
regression on one graph with MLP, equivariant DeepSets, a Transformer, and
the polynomial spectral filters GPRNet, ARMANet, GcnNet, GatNet, ChebNet
and BernNet.  Propagation is an explicit edge weight and a separate
self-loop term (`propagate`), a gather and `graph/segment.py:
segment_sum`, as `seg.segment_sum` is XLA in the JAX package: no Pallas
kernel is on this path in either package.  Every net takes its input width
`in_features` first (flax infers it), then the JAX module's fields.  Names
follow flax.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..graph import segment as seg
from ..nn.deepsets import EqDeepSetsEncoder
from ..nn.init import Linear
from ..nn.mlp import MLP as _MLP
from ..nn.norm import MaskedLayerNorm
from .conv import GATConv


def gcn_norm_weights(gb, add_self_loops: bool = True):
    """Edge weights of D^-1/2 (A [+ I]) D^-1/2, and the self-loop diagonal
    (None without self loops)."""
    deg = gb.in_degrees()
    if add_self_loops:
        deg = deg + gb.node_mask
    dis = torch.where(deg > 0, deg.rsqrt(), torch.zeros_like(deg))
    src, dst = gb.senders.long(), gb.receivers.long()
    w = dis[src] * dis[dst] * gb.edge_mask
    self_w = dis * dis * gb.node_mask if add_self_loops else None
    return w, self_w


def propagate(gb, x, w, self_w=None):
    """x'_i = sum_j w_ij x_j (+ self_w_i x_i)."""
    msg = w[:, None] * x.index_select(0, gb.senders.long())
    out = seg.segment_sum(msg, gb.receivers, gb.num_nodes)
    if self_w is not None:
        out = out + self_w[:, None] * x
    return out


class MLPNet(nn.Module):
    """The MLP with BN on batch statistics (track_running_stats=False)."""

    def __init__(self, in_features: int, hidden: int = 32, out: int = 1,
                 num_layers: int = 3, use_bn: bool = False):
        super().__init__()
        self.mlp = _MLP(in_features, hidden, out, num_layers, use_bn=use_bn,
                        bn_track_running_stats=False)

    def forward(self, gb, x):
        return self.mlp(x)


class DeepSetsNet(nn.Module):
    """EqDeepSets over the node axis."""

    def __init__(self, in_features: int, hidden: int = 32, out: int = 1,
                 num_layers: int = 3, use_bn: bool = False):
        super().__init__()
        self.ds = EqDeepSetsEncoder(in_features, hidden=hidden, out=out,
                                    num_layers=num_layers, use_bn=use_bn)

    def forward(self, gb, x):
        return self.ds(x)


class _DenseGeneral(nn.Module):
    """One of flax `MultiHeadDotProductAttention`'s projections, its heads
    flattened: weight [out, in], bias [out]; init uniform(+-bound) (torch
    MultiheadAttention's xavier bound on the stacked in_proj), bias 0.
    bridge.py reshapes the flax [in, H, hd] and [H, hd, out] kernels."""

    def __init__(self, in_features: int, out_features: int, bound: float):
        super().__init__()
        self.bound = bound
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.weight.uniform_(-self.bound, self.bound, generator=generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class MultiHeadDotProductAttention(nn.Module):
    """flax's self-attention over axis -2 of [..., L, d]: `query`, `key`,
    `value` to H heads of d / H, queries scaled by 1/sqrt(d / H), softmax,
    `out` back to d.  Dense einsums: not the edge attention kernel K2."""

    def __init__(self, features: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        bound = math.sqrt(1.5 / features)
        for name in ("query", "key", "value", "out"):
            self.add_module(name, _DenseGeneral(features, features, bound))

    def forward(self, x):
        heads = lambda t: t.unflatten(-1, (self.num_heads, -1))
        q, k, v = (heads(self.query(x)), heads(self.key(x)),
                   heads(self.value(x)))
        q = q / math.sqrt(q.shape[-1])
        a = torch.softmax(torch.einsum("...qhd,...khd->...hqk", q, k), dim=-1)
        return self.out(torch.einsum("...hqk,...khd->...qhd", a, v)
                        .flatten(-2))


class TransformerNet(nn.Module):
    """Pre-norm Transformer encoder layers over the node axis (dim_ff =
    hidden, LayerNorm eps 1e-5): fc1, then per layer x + attn(ln1(x)) and
    x + ff2(relu(ff1(ln2(x)))), then fc2."""

    def __init__(self, in_features: int, hidden: int = 32, out: int = 1,
                 num_layers: int = 2, num_heads: int = 4):
        super().__init__()
        self.num_layers = num_layers
        self.fc1 = Linear(in_features, hidden)
        for i in range(num_layers):
            self.add_module(f"ln1_{i}", MaskedLayerNorm(hidden, eps=1e-5))
            self.add_module(f"attn_{i}",
                            MultiHeadDotProductAttention(hidden, num_heads))
            self.add_module(f"ln2_{i}", MaskedLayerNorm(hidden, eps=1e-5))
            self.add_module(f"ff1_{i}", Linear(hidden, hidden))
            self.add_module(f"ff2_{i}", Linear(hidden, hidden))
        self.fc2 = Linear(hidden, out)

    def forward(self, gb, x):
        x = self.fc1(x)
        for i in range(self.num_layers):
            x = x + getattr(self, f"attn_{i}")(getattr(self, f"ln1_{i}")(x))
            h = getattr(self, f"ln2_{i}")(x)
            h = getattr(self, f"ff2_{i}")(torch.relu(
                getattr(self, f"ff1_{i}")(h)))
            x = x + h
        return self.fc2(x)


class GPRNet(nn.Module):
    """Generalised PageRank: `num_layers` Linear + ReLU, then sum_k
    temp_k A_hat^k x over K hops (A_hat with self loops), then fc2."""

    def __init__(self, in_features: int, hidden: int = 32,
                 num_layers: int = 2, K: int = 10):
        super().__init__()
        self.num_layers, self.K = num_layers, K
        d = in_features
        for i in range(num_layers):
            self.add_module(f"lin_{i}", Linear(d, hidden))
            d = hidden
        self.temp = nn.Parameter(torch.empty(K + 1))
        self.fc2 = Linear(d, 1)

    def reset_parameters(self, generator: torch.Generator):
        bound = math.sqrt(3.0 / (self.K + 1))
        with torch.no_grad():
            self.temp.uniform_(-bound, bound, generator=generator)
            self.temp.div_(self.temp.abs().sum())

    def forward(self, gb, x):
        for i in range(self.num_layers):
            x = torch.relu(getattr(self, f"lin_{i}")(x))
        w, sw = gcn_norm_weights(gb, add_self_loops=True)
        hidden = x * self.temp[0]
        for k in range(self.K):
            x = propagate(gb, x, w, sw)
            hidden = hidden + self.temp[k + 1] * x
        return self.fc2(hidden)


class ARMANet(nn.Module):
    """1-stack 1-layer ARMA convs x' = relu(A_hat x W + x V), A_hat =
    D^-1/2 A D^-1/2 without self loops, then fc2."""

    def __init__(self, in_features: int, hidden: int = 32,
                 num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        d = in_features
        for i in range(num_layers):
            self.add_module(f"w_{i}", Linear(d, hidden, use_bias=False))
            self.add_module(f"v_{i}", Linear(d, hidden))
            d = hidden
        self.fc2 = Linear(d, 1)

    def forward(self, gb, x):
        w, _ = gcn_norm_weights(gb, add_self_loops=False)
        for i in range(self.num_layers):
            h = propagate(gb, getattr(self, f"w_{i}")(x), w)
            x = torch.relu(h + getattr(self, f"v_{i}")(x))
        return self.fc2(x)


class GcnNet(nn.Module):
    """GCN convs (self loops, symmetric normalisation, a bare `bias_i`)
    with ReLU, then fc2."""

    def __init__(self, in_features: int, hidden: int = 32,
                 num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        d = in_features
        for i in range(num_layers):
            self.add_module(f"w_{i}", Linear(d, hidden, use_bias=False))
            self.register_parameter(f"bias_{i}",
                                    nn.Parameter(torch.zeros(hidden)))
            d = hidden
        self.fc2 = Linear(d, 1)

    def forward(self, gb, x):
        w, sw = gcn_norm_weights(gb, add_self_loops=True)
        for i in range(self.num_layers):
            x = propagate(gb, getattr(self, f"w_{i}")(x), w, sw)
            x = torch.relu(x + getattr(self, f"bias_{i}"))
        return self.fc2(x)


class GatNet(nn.Module):
    """GATConv layers (hidden / heads per head, concatenated, self loops,
    ELU), then fc2."""

    def __init__(self, in_features: int, hidden: int = 32,
                 num_heads: int = 4, num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        d = in_features
        for i in range(num_layers):
            self.add_module(f"conv_{i}", GATConv(
                d, hidden // num_heads, num_heads=num_heads, concat=True,
                add_self_loops=True, activation="elu"))
            d = (hidden // num_heads) * num_heads
        self.fc2 = Linear(d, 1)

    def forward(self, gb, x):
        for i in range(self.num_layers):
            x = getattr(self, f"conv_{i}")(gb, x)
        return self.fc2(x)


class ChebNet(nn.Module):
    """Chebyshev filters of order K over L_hat = -D^-1/2 A D^-1/2
    (lambda_max = 2): sum_k T_k(L_hat) x W_k + bias_i, ReLU; then fc2."""

    def __init__(self, in_features: int, hidden: int = 32,
                 num_layers: int = 2, K: int = 3):
        super().__init__()
        self.num_layers, self.K = num_layers, K
        d = in_features
        for i in range(num_layers):
            for k in range(K):
                self.add_module(f"w_{i}_{k}",
                                Linear(d, hidden, use_bias=False))
            self.register_parameter(f"bias_{i}",
                                    nn.Parameter(torch.zeros(hidden)))
            d = hidden
        self.fc2 = Linear(d, 1)

    def forward(self, gb, x):
        w, _ = gcn_norm_weights(gb, add_self_loops=False)
        w = -w
        for i in range(self.num_layers):
            lin = lambda k, v: getattr(self, f"w_{i}_{k}")(v)
            tx0 = x
            out = lin(0, tx0)
            if self.K > 1:
                tx1 = propagate(gb, x, w)
                out = out + lin(1, tx1)
                for k in range(2, self.K):
                    tx2 = 2.0 * propagate(gb, tx1, w) - tx0
                    out = out + lin(k, tx2)
                    tx0, tx1 = tx1, tx2
            x = torch.relu(out + getattr(self, f"bias_{i}"))
        return self.fc2(x)


class BernNet(nn.Module):
    """Bernstein-polynomial filter of order K with the coefficients
    relu(coe) shared by all layers: sum_j comb(K, j) / 2^K relu(coe_j)
    L^j (2I - L)^(K-j) x, L = I - D^-1/2 A D^-1/2, then Linear `w_i` and
    ReLU per layer; then fc2."""

    def __init__(self, in_features: int, hidden: int = 32,
                 num_layers: int = 2, K: int = 10):
        super().__init__()
        self.num_layers, self.K = num_layers, K
        self.coe = nn.Parameter(torch.ones(K + 1))
        d = in_features
        for i in range(num_layers):
            self.add_module(f"w_{i}", Linear(d, hidden))
            d = hidden
        self.fc2 = Linear(d, 1)

    def forward(self, gb, x):
        from scipy.special import comb
        temp = torch.relu(self.coe)
        w, _ = gcn_norm_weights(gb, add_self_loops=False)
        nm = gb.node_mask[:, None]
        prop_l = lambda v: v * nm - propagate(gb, v, w)         # L v
        prop_2i_l = lambda v: v * nm + propagate(gb, v, w)      # (2I - L) v
        K = self.K
        for i in range(self.num_layers):
            tmp = [x]
            for _ in range(K):
                tmp.append(prop_2i_l(tmp[-1]))
            out = (comb(K, 0) / 2 ** K) * temp[0] * tmp[K]
            for j in range(K):
                v = tmp[K - j - 1]
                for _ in range(j + 1):
                    v = prop_l(v)
                out = out + (comb(K, j + 1) / 2 ** K) * temp[j + 1] * v
            x = torch.relu(getattr(self, f"w_{i}")(out))
        return self.fc2(x)


FILTER_MODEL_REGISTRY = {
    "MLP": MLPNet,
    "DS": DeepSetsNet,
    "Transformer": TransformerNet,
    "GPRNet": GPRNet,
    "ARMANet": ARMANet,
    "GcnNet": GcnNet,
    "GatNet": GatNet,
    "ChebNet": ChebNet,
    "BernNet": BernNet,
}
