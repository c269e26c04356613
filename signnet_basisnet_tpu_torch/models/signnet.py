"""SignNet encoders: the Alchemy/GINE SignNet and the DeepSigns ones.

Port of signnet_basisnet_tpu/models/signnet.py:38-48 (`sign_fuse`,
`sign_unfuse`), :51-134 (`GNN3d`, `SignNet`, `SignPlus`), :137-182
(`_KChannelGNN`, gin and gat kinds), :185-210 (`GINDeepSigns`, fixed k),
:213-239 (`MaskedGINDeepSigns`, all eigenvectors) and :245-297
(`TransformerDeepSigns`): f(v_1..v_k) = rho([phi(v_i) + phi(-v_i)]_i),
with the (+v, -v) pair fused along the k axis into one phi call over
[N, 2k, D] (the GNN phis, flat or dense batches) or along the attention
batch (the transformer phi).

`SignNet` (the Alchemy and GINE-ZINC encoder) runs over all of a batch's
eigenvector slots with the batch's `eig_mask`: `GNN3d`, a stack of masked
GIN(E) convs, as phi; the masked set transformer (nn/set_transformer.py)
as rho; and, unless `ignore_eigval`, a MaskedMLP `eigen_encoder` of each
node's graph's eigenvalues as rho's positional input.
The gcn kind of the DeepSigns phi is refused: the JAX package's GCN phi
multiplies the [N, 2k, D] stack by a [N, 1] degree column and raises on
any batch.
"""
from __future__ import annotations

import torch
from torch import nn

from ..graph.batch import from_dense_nodes, to_dense_nodes
from ..nn.dropout import Dropout
from ..nn.encoders import DiscreteEncoder
from ..nn.init import Linear
from ..nn.mlp import MLP, MaskedMLP
from ..nn.norm import MaskedBatchNorm
from ..nn.set_transformer import SetTransformer, TransformerEncoderLayer
from .conv import (GATConv, GINConv, MaskedGINConv, MaskedGINEConv,
                   node_mask_like)

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


class GNN3d(nn.Module):
    """`n_layer` masked GIN (`MaskedGINConv`) or GINE (`MaskedGINEConv`)
    convs `conv_i` over x [N, K, D] with mask [N, K]; after each, x times
    the mask, the masked BatchNorm `norm_i`, ReLU and the residual (the sum
    of the earlier layers' outputs, from 0).  Under GINE each layer encodes
    the batch's edge codes with its own `edge_enc_i` (`edge_vocab` values,
    `edge_code_dims` code columns) to n_out features, against which layer
    0's D = 1 input broadcasts."""

    GNN_TYPES = ("MaskedGINConv", "MaskedGINEConv")

    def __init__(self, in_features: int, n_out: int, n_layer: int,
                 gnn_type: str = "MaskedGINConv", edge_vocab: int = 500,
                 edge_code_dims: int = 1):
        super().__init__()
        if gnn_type not in self.GNN_TYPES:
            raise ValueError(f"unsupported GNN3d gnn_type {gnn_type!r}")
        self.n_layer = n_layer
        self.gine = gnn_type == "MaskedGINEConv"
        d_in = in_features
        for i in range(n_layer):
            if self.gine:
                self.add_module(f"edge_enc_{i}", DiscreteEncoder(
                    n_out, max_num_values=edge_vocab,
                    num_features=edge_code_dims))
                # the encoded edges set the width the MLP takes
                conv = MaskedGINEConv(n_out, n_out, hidden=n_out)
            else:
                conv = MaskedGINConv(d_in, n_out, hidden=n_out)
            self.add_module(f"conv_{i}", conv)
            self.add_module(f"norm_{i}", MaskedBatchNorm(n_out))
            d_in = n_out

    def forward(self, gb, x, mask=None):
        prev = 0.0
        for i in range(self.n_layer):
            conv = getattr(self, f"conv_{i}")
            if self.gine:
                e = getattr(self, f"edge_enc_{i}")(gb.edge_feat)
                x = conv(gb, x, e, mask=mask)
            else:
                x = conv(gb, x, mask=mask)
            if mask is not None:
                x = x * mask[..., None].to(x.dtype)
            x = torch.relu(getattr(self, f"norm_{i}")(x, mask=mask))
            x = x + prev
            prev = x
        return x


class SignNet(nn.Module):
    """[N, K] eigenvector entries -> [N, n_hid] sign-invariant PE: phi
    (GNN3d) over the sign-fused [N, 2K, 1] stack, phi(v) + phi(-v), then
    rho (SetTransformer, `nl_rho` layers) with the encoded eigenvalues
    (`eigen_encoder`, absent with `ignore_eigval`) as positions.  The
    attention dropout draws from `rng`."""

    def __init__(self, n_hid: int, nl_phi: int, nl_rho: int = 2,
                 ignore_eigval: bool = False,
                 phi_gnn_type: str = "MaskedGINConv", edge_vocab: int = 500,
                 edge_code_dims: int = 1, rng=None):
        super().__init__()
        self.ignore_eigval = ignore_eigval
        if not ignore_eigval:
            self.eigen_encoder = MaskedMLP(1, n_hid, num_layers=2)
        self.phi = GNN3d(1, n_hid, nl_phi, gnn_type=phi_gnn_type,
                         edge_vocab=edge_vocab,
                         edge_code_dims=edge_code_dims)
        self.rho = SetTransformer(n_hid, nl_rho, rng=rng)

    def forward(self, gb):
        x = gb.eigvecs[..., None]                       # N K 1
        mask = gb.eig_mask                              # N K
        if self.ignore_eigval:
            pos = 0.0
        else:
            rows = gb.eigvals.index_select(0, gb.graph_id.long())
            pos = self.eigen_encoder(rows[..., None], mask=mask)
        x2, m2 = sign_fuse(x, mask)
        x = sign_unfuse(self.phi(gb, x2, mask=m2))
        return self.rho(x, pos, mask=mask)


class SignPlus(nn.Module):
    """phi(v) + phi(-v) for any inner module `model`; extra features x that
    are not negated are concatenated to v first."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, v, x=None):
        if x is None:
            return self.model(v) + self.model(-v)
        return (self.model(torch.cat([v, x], dim=-1))
                + self.model(torch.cat([-v, x], dim=-1)))


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
        # nodes_per_graph is [N] flat, [G, M] dense
        kmask = (slots < gb.nodes_per_graph()[..., None]).to(x.dtype)
        x = (x * kmask[..., None]).sum(dim=-2)          # N phi_out
        # rho's BN runs over every row, padding included, as in flax
        return self.rho(x)                              # N K


class TransformerDeepSigns(nn.Module):
    """phi: a set-transformer encoder over each graph's nodes, per
    eigenvector; rho: flatten and a 4-layer MLP -> [N, k].

    In the dense per-graph layout [G, n_max, ...] (graph.batch.
    to_dense_nodes): a shared `embed` of +v and of -v, the k eigenvector
    channels and the two signs folded into the attention batch
    [(2 k G), n_max, hidden], `num_layers` encoder layers `sab_i` of
    `num_heads` heads (attention dropout 0.1 in training, drawn from
    `rng`), the two signs' halves summed, back to the flat [N, k, hidden]
    and `rho` over [N, k * hidden].  A graph's padding slots, and the
    padding graph's all-masked rows, come out as zeros."""

    def __init__(self, hidden: int, num_layers: int, k: int, n_max: int,
                 num_heads: int = 2, use_bn: bool = False,
                 dropout: float = 0.0, rng=None):
        super().__init__()
        self.hidden, self.num_layers, self.k, self.n_max = (
            hidden, num_layers, k, n_max)
        self.embed = Linear(1, hidden)
        for i in range(num_layers):
            self.add_module(f"sab_{i}", TransformerEncoderLayer(
                hidden, n_head=num_heads, rng=rng))
        self.rho = MLP(k * hidden, hidden, k, num_layers=4, use_bn=use_bn,
                       dropout=dropout, rng=rng)

    def forward(self, gb, eigvecs):
        n, k, H = eigvecs.shape[0], self.k, self.hidden
        dense_p, mask = to_dense_nodes(gb, self.embed(eigvecs[..., None]),
                                       self.n_max)            # G M K H
        dense_n, _ = to_dense_nodes(gb, self.embed(-eigvecs[..., None]),
                                    self.n_max)
        G, M = dense_p.shape[:2]

        def fold(d):   # G M K H -> (K G) M H
            return d.movedim(2, 0).reshape(k * G, M, H)

        h = torch.cat([fold(dense_p), fold(dense_n)], dim=0)
        m = mask[None].expand(k, G, M).reshape(k * G, M)
        m = torch.cat([m, m], dim=0)
        for i in range(self.num_layers):
            h = getattr(self, f"sab_{i}")(h, mask=m)
        h = (h[:k * G] + h[k * G:]).reshape(k, G, M, H).movedim(0, 2)
        flat = from_dense_nodes(gb, h).reshape(n, -1)         # N (K H)
        return self.rho(flat)
