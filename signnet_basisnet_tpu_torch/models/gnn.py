"""PyG-style GNN backbone and the SignNetGNN composition (the Alchemy and
GINE-ZINC nets).

Port of signnet_basisnet_tpu/models/gnn.py: `make_conv`, `GNN` and
`SignNetGNN`.  `GNN`: the node codes through a `DiscreteEncoder` (or float
features through a one-layer ElementsMLP), the optional node-level (L)DOS
features concatenated, the PE merged by the Linear `merge`; per layer an
edge encoder (`edge_encoder_i`), the conv (`conv_i`), masked BatchNorm
(`norm_i`), ReLU, dropout and the residual; add or mean pooling (with the
graph-size embedding `size_embedder` under mean pooling, if asked), the
graph-level DOS through `dos_encoder`, and the two-layer ElementsMLP head
`output_encoder`, normed unless the pooling is mean.  Under add pooling
that head's BatchNorm has no mask: its statistics run over every graph
slot, the padding graph included, as in JAX.

`SignNetGNN`: pos = SignNet(batch); out = GNN(batch, additional_x=pos),
[G, n_out].  It owns the dropout generator `dropout_rng` (seeded from
`seed`), from which the SignNet rho's attention dropout (0.1) and the
GNN's dropout draw, and draws its parameters from a generator seeded from
`seed`.

flax makes the encoders' embeddings from the codes' shape at the first
call; here `node_code_dims` and `edge_code_dims` give the code columns (1
for 1-D codes: ZINC's nodes and every shipped edge code; 6 for Alchemy's
[N, 6] node codes).  The flax name of a PyG GIN(E) layer's update net,
`conv_i_nn`, beside the layer, is the port's `conv_i.mlp` (bridge.py).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.dropout import Dropout, DropoutRNG
from ..nn.encoders import DiscreteEncoder
from ..nn.init import Embedding, Linear, init_parameters
from ..nn.mlp import ElementsMLP
from ..nn.norm import MaskedBatchNorm
from .conv import (GATConv, GCNConv, GINConv, GINEConv, SimplifiedPNAConv,
                   pool_any)
from .signnet import SignNet

# the convs whose forward takes the encoded edges
EDGE_CONVS = ("GINEConv", "SimplifiedPNAConv")


def make_conv(gnn_type: str, nhid: int, use_bias: bool) -> nn.Module:
    """The (gb, x[, edge_attr]) conv of `GNN` layer width `nhid`."""
    if gnn_type == "GINConv":
        return GINConv(ElementsMLP(nhid, nhid, num_layers=2,
                                   with_final_activation=False,
                                   with_norm=False, bias=use_bias),
                       learn_eps=True)
    if gnn_type == "GINEConv":
        return GINEConv(ElementsMLP(nhid, nhid, num_layers=2,
                                    with_final_activation=False,
                                    bias=use_bias), learn_eps=True)
    if gnn_type == "GCNConv":
        return GCNConv(nhid, nhid, add_self_loops=True)
    if gnn_type == "GATConv":
        return GATConv(nhid, nhid, num_heads=1, add_self_loops=True)
    if gnn_type == "SimplifiedPNAConv":
        return SimplifiedPNAConv(nhid, nhid, edge_features=nhid)
    raise ValueError(f"unknown gnn_type {gnn_type!r}")


class GNN(nn.Module):
    def __init__(self, nhid: int, nout: int, nlayer: int,
                 gnn_type: str = "GINEConv", dropout: float = 0.0,
                 pooling: str = "add", res: bool = True, bn: bool = True,
                 nfeat_node: Optional[int] = None,
                 nfeat_edge: Optional[int] = None, node_vocab: int = 100,
                 edge_vocab: int = 100, use_size_embedder: bool = False,
                 dos_bins: int = 0, additional_features: int = 0,
                 node_code_dims: int = 1, edge_code_dims: int = 1,
                 rng: Optional[DropoutRNG] = None):
        super().__init__()
        self.nlayer = nlayer
        self.gnn_type = gnn_type
        self.pooling = pooling
        self.res = res
        self.bn = bn
        self.nfeat_node = nfeat_node
        self.nfeat_edge = nfeat_edge
        self.use_size_embedder = use_size_embedder
        self.dos_bins = dos_bins
        nin = nhid - dos_bins
        if nfeat_node is None:
            self.input_encoder = DiscreteEncoder(
                nin, max_num_values=node_vocab, num_features=node_code_dims)
        else:
            self.input_encoder = ElementsMLP(nfeat_node, nin, num_layers=1)
        if additional_features:
            self.merge = Linear(nhid + additional_features, nhid)
        for i in range(nlayer):
            if nfeat_edge is None:
                enc = DiscreteEncoder(nhid, max_num_values=edge_vocab,
                                      num_features=edge_code_dims)
            else:
                enc = ElementsMLP(nfeat_edge, nhid, num_layers=1)
            self.add_module(f"edge_encoder_{i}", enc)
            self.add_module(f"conv_{i}", make_conv(gnn_type, nhid,
                                                   use_bias=not bn))
            if bn:
                self.add_module(f"norm_{i}", MaskedBatchNorm(nhid))
        self.drop = Dropout(dropout, rng)
        if pooling == "mean" and use_size_embedder:
            self.size_embedder = Embedding(200, nhid)
        if dos_bins > 0:
            self.dos_encoder = ElementsMLP(dos_bins, nhid, num_layers=2,
                                           with_final_activation=False)
        self.output_encoder = ElementsMLP(nhid, nout, num_layers=2,
                                          with_final_activation=False,
                                          with_norm=pooling != "mean")

    def forward(self, gb, additional_x=None):
        if self.nfeat_node is None:
            x = self.input_encoder(gb.node_feat)
        else:
            x = self.input_encoder(gb.node_feat.to(gb.node_mask.dtype))
        if self.dos_bins > 0:
            x = torch.cat([x, gb.extras["pdos"].to(x.dtype)], dim=-1)
        if additional_x is not None:
            x = self.merge(torch.cat([x, additional_x], dim=-1))
        edge_codes = (gb.edge_feat if gb.edge_feat is not None else
                      torch.zeros(gb.num_edges, dtype=torch.int32,
                                  device=gb.senders.device))
        if self.nfeat_edge is not None:
            edge_codes = edge_codes.to(gb.edge_mask.dtype)
        prev = x
        for i in range(self.nlayer):
            e = getattr(self, f"edge_encoder_{i}")(edge_codes)
            conv = getattr(self, f"conv_{i}")
            if self.gnn_type in EDGE_CONVS:
                x = conv(gb, x, e)
            else:
                x = conv(gb, x)
            if self.bn:
                x = getattr(self, f"norm_{i}")(x, mask=gb.node_mask)
            x = self.drop(torch.relu(x))
            if self.res:
                x = x + prev
                prev = x
        if self.pooling == "mean":
            hg = pool_any(gb, x, reduce="mean")
            if self.use_size_embedder:
                hg = hg + self.size_embedder(torch.clamp(gb.n_node, 0, 199))
        else:
            hg = pool_any(gb, x, reduce="sum")
        if self.dos_bins > 0:
            hg = hg + self.dos_encoder(gb.extras["dos"].to(hg.dtype))
        return self.output_encoder(hg)


class SignNetGNN(nn.Module):
    """SignNet PE + the base GNN: [G, n_out] (the GINESignNetPyG form fixes
    ignore_eigval=True, nl_rho=1)."""

    def __init__(self, n_hid: int, n_out: int, nl_signnet: int, nl_gnn: int,
                 nl_rho: int = 4, ignore_eigval: bool = False,
                 gnn_type: str = "GINEConv",
                 phi_gnn_type: str = "MaskedGINConv", node_vocab: int = 100,
                 edge_vocab: int = 100, node_code_dims: int = 1,
                 edge_code_dims: int = 1, seed: int = 0):
        super().__init__()
        self.dropout_rng = DropoutRNG(seed)
        self.sign_net = SignNet(n_hid, nl_signnet, nl_rho=nl_rho,
                                ignore_eigval=ignore_eigval,
                                phi_gnn_type=phi_gnn_type,
                                edge_vocab=edge_vocab,
                                edge_code_dims=edge_code_dims,
                                rng=self.dropout_rng)
        self.gnn = GNN(n_hid, n_out, nl_gnn, gnn_type=gnn_type,
                       node_vocab=node_vocab, edge_vocab=edge_vocab,
                       additional_features=n_hid,
                       node_code_dims=node_code_dims,
                       edge_code_dims=edge_code_dims, rng=self.dropout_rng)
        init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, gb):
        return self.gnn(gb, additional_x=self.sign_net(gb))


def set_attention_dropout(model: nn.Module, rate: float) -> None:
    """Set the rate of every set-transformer attention dropout in `model`
    (0 turns it off, as the parity checks do)."""
    from ..nn.set_transformer import MultiHeadAttention
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.attn_drop.rate = float(rate)
