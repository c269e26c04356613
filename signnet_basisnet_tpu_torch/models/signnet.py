"""SignNet's DeepSigns encoders with a GIN or GAT phi.

Port of signnet_basisnet_tpu/models/signnet.py:38-48 (`sign_fuse`,
`sign_unfuse`), :137-182 (`_KChannelGNN`, gin and gat kinds), :185-210
(`GINDeepSigns`, fixed k) and :213-239 (`MaskedGINDeepSigns`, all
eigenvectors): f(v_1..v_k) = rho([phi(v_i) + phi(-v_i)]_i), with the
(+v, -v) pair fused along the k axis into one phi call over [N, 2k, D].
The gcn kind is refused: the JAX package's GCN phi multiplies the
[N, 2k, D] stack by a [N, 1] degree column and raises on any batch.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.dropout import Dropout
from ..nn.mlp import MLP
from ..nn.norm import MaskedBatchNorm
from .conv import GATConv, GINConv, node_mask_like

# the JAX GAT phi's heads, averaged in each layer
PHI_GAT_HEADS = 4


def sign_fuse(x, mask=None):
    """Stack (+x, -x) along the k axis (-2 of x, -1 of mask)."""
    x2 = torch.cat([x, -x], dim=-2)
    m2 = None if mask is None else torch.cat([mask, mask], dim=-1)
    return x2, m2


def sign_unfuse(y):
    k = y.shape[-2] // 2
    return y[..., :k, :] + y[..., k:, :]


class KChannelGNN(nn.Module):
    """GIN or GAT phi over [N, K, D] x; BN normalises per feature over all
    N*K slots (masked by the node mask); dropout before each but the first
    layer.  GIN (`kind='gin'`): dropout inside each layer's MLP too. GAT:
    PHI_GAT_HEADS heads averaged, no self loops, ReLU after all but the
    last layer.  Names: `conv_i` (with `.mlp` under GIN) and the
    between-layer `bn_{i-1}`, as in flax."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 n_layers: int, use_bn: bool = True, dropout: float = 0.0,
                 rng=None, kind: str = "gin"):
        super().__init__()
        if kind == "gcn":
            raise ValueError(
                "sign_inv_net 'gcn' cannot run: the JAX package's GCN phi "
                "multiplies the [N, 2k, D] stack by a [N, 1] degree column "
                "(models/conv.py: GCNConv), which does not broadcast, so it "
                "has no behaviour to port")
        if kind not in ("gin", "gat"):
            raise ValueError(f"unknown phi kind {kind!r}")
        self.n_layers = n_layers
        self.use_bn = use_bn
        self.drop = Dropout(dropout, rng)
        d_in = in_features
        for i in range(n_layers):
            if i != 0 and use_bn:
                self.add_module(f"bn_{i - 1}", MaskedBatchNorm(d_in))
            feats = out if i == n_layers - 1 else hidden
            if kind == "gin":
                conv = GINConv(MLP(d_in, hidden, feats, num_layers=2,
                                   use_bn=use_bn, dropout=dropout, rng=rng))
            else:
                conv = GATConv(d_in, feats, num_heads=PHI_GAT_HEADS,
                               concat=False, add_self_loops=False,
                               activation="relu" if i < n_layers - 1
                               else None)
            self.add_module(f"conv_{i}", conv)
            d_in = feats

    def forward(self, gb, x):
        for i in range(self.n_layers):
            if i != 0:
                x = self.drop(x)
            if i != 0 and self.use_bn:
                x = getattr(self, f"bn_{i - 1}")(x, mask=node_mask_like(gb, x))
            x = getattr(self, f"conv_{i}")(gb, x)
        return x


class GINDeepSigns(nn.Module):
    """Fixed-k DeepSigns: phi (GIN or GAT, `kind`) over k channels,
    flatten, rho MLP -> [N, K]."""

    def __init__(self, hidden: int, phi_out: int, num_layers: int, k: int,
                 use_bn: bool = False, dropout: float = 0.0, rng=None,
                 kind: str = "gin"):
        super().__init__()
        self.enc = KChannelGNN(1, hidden, phi_out, num_layers, use_bn=use_bn,
                               dropout=dropout, rng=rng, kind=kind)
        self.rho = MLP(k * phi_out, hidden, k, num_layers=num_layers,
                       use_bn=use_bn, dropout=dropout, rng=rng)

    def forward(self, gb, eigvecs):
        x = eigvecs[..., None]                          # N K 1
        x2, _ = sign_fuse(x)
        x = sign_unfuse(self.enc(gb, x2))               # N K phi_out
        x = x.reshape(x.shape[:-2] + (-1,))
        # rho's BN runs over every row, padding included, as in flax
        return self.rho(x)                              # N K


class MaskedGINDeepSigns(nn.Module):
    """Variable-k DeepSigns over a graph's full eigendecomposition: the GIN
    phi over the k padded eigenvector slots, the slots i >= n_g of a graph
    with n_g nodes masked out, a sum over k, then the rho MLP -> [N, k]."""

    def __init__(self, hidden: int, phi_out: int, num_layers: int, k: int,
                 use_bn: bool = False, dropout: float = 0.0, rng=None):
        super().__init__()
        self.enc = KChannelGNN(1, hidden, phi_out, num_layers, use_bn=use_bn,
                               dropout=dropout, rng=rng)
        self.rho = MLP(phi_out, hidden, k, num_layers=num_layers,
                       use_bn=use_bn, dropout=dropout, rng=rng)

    def forward(self, gb, eigvecs):
        x = eigvecs[..., None]                          # N K 1
        x2, _ = sign_fuse(x)
        x = sign_unfuse(self.enc(gb, x2))               # N K phi_out
        K = x.shape[-2]
        slots = torch.arange(K, device=x.device)
        kmask = (slots < gb.nodes_per_graph()[:, None]).to(x.dtype)
        x = (x * kmask[..., None]).sum(dim=-2)          # N phi_out
        # rho's BN runs over every row, padding included, as in flax
        return self.rho(x)                              # N K
