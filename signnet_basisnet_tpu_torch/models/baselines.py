"""Baseline nets: NetGINE, Alchemy's GINE + Set2Set baseline.

Port of signnet_basisnet_tpu/models/baselines.py: `GINEBondConv` (bond
features through two Linears, messages relu(x_j + W e), summed into the
destination, an eps-weighted self term, a two-Linear MLP) and `NetGINE`
(an input Linear, `num_layers` convs with ReLU, Set2Set pooling over 6
steps, a two-Linear regression head).  Float node features (1-D ones as
one column, `in_features` wide); 1-D edge codes become one-hot rows of
`edge_dim`, float edge features are taken as they are.  Names follow flax
(`input`, `conv_i` with `bond_1`, `bond_2`, `eps`, `mlp_1`, `mlp_2`,
`set2set`, `fc1`, `fc4`); parameters are drawn from a generator seeded
from `seed`.
"""
from __future__ import annotations

import torch
from torch import nn

from ..graph import segment as seg
from ..nn.init import Linear, init_parameters
from ..nn.set2set import Set2Set
from .conv import refuse_dense, src_features


class GINEBondConv(nn.Module):
    def __init__(self, features: int, edge_dim: int):
        super().__init__()
        self.bond_1 = Linear(edge_dim, features)
        self.bond_2 = Linear(features, features)
        self.eps = nn.Parameter(torch.zeros(()))
        self.mlp_1 = Linear(features, features)
        self.mlp_2 = Linear(features, features)

    def forward(self, gb, x, edge_attr):
        refuse_dense(gb, "GINEBondConv")
        e = self.bond_2(torch.relu(self.bond_1(edge_attr)))
        src = src_features(x, gb).index_select(0, gb.senders.long())
        agg = seg.aggregate_edges(torch.relu(src + e), gb.receivers,
                                  gb.num_nodes, edge_mask=gb.edge_mask)
        h = (1 + self.eps) * x + agg
        return self.mlp_2(torch.relu(self.mlp_1(h)))


class NetGINE(nn.Module):
    def __init__(self, hidden: int = 64, num_layers: int = 6, out: int = 12,
                 edge_dim: int = 4, in_features: int = 6, seed: int = 0):
        super().__init__()
        self.num_layers = num_layers
        self.edge_dim = edge_dim
        self.input = Linear(in_features, hidden)
        for i in range(num_layers):
            self.add_module(f"conv_{i}", GINEBondConv(hidden, edge_dim))
        self.set2set = Set2Set(hidden, processing_steps=6)
        self.fc1 = Linear(2 * hidden, hidden)
        self.fc4 = Linear(hidden, out)
        init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, gb):
        dt = gb.node_mask.dtype
        x = gb.node_feat.to(dt)
        if x.dim() == 1:
            x = x[:, None]
        if gb.edge_feat.dim() == 1:
            e = torch.eye(self.edge_dim, dtype=dt,
                          device=x.device)[gb.edge_feat.long()]
        else:
            e = gb.edge_feat.to(dt)
        x = torch.relu(self.input(x))
        for i in range(self.num_layers):
            x = torch.relu(getattr(self, f"conv_{i}")(gb, x, e))
        hg = self.set2set(x, gb.graph_id, gb.num_graphs, gb.node_mask)
        return self.fc4(torch.relu(self.fc1(hg)))
