"""ZINC graph-regression nets: GatedGCNNet, GINNet and TransformerNet with
their SignNet PE encoder.

Port of signnet_basisnet_tpu/models/zinc_models.py:67-166 (`_Base`:
`sign_inv_module`, `embed_inputs`, `readout_head`), :169-203 (`GatedGCNNet`
without its LSPE branch), :206-231 (`GINNet`) and :298-316
(`TransformerNet`, sparse path).  Signature:
``model(gb, pos_enc) -> [G]`` scores.  Submodule names follow the flax ones
(`embedding_h`, `embedding_p`, `embedding_hp`, `embedding_e`,
`sign_inv_net`, `layer_i` with `layer_i.mlp` for flax's `mlp_i`,
`mlp_readout`), so the weight bridge (bridge.py) is a name mapping.
Dropout (`dropout`, `in_feat_dropout`) is applied where the JAX nets apply
it, the SignNet phi and rho included, drawing from the model's
`dropout_rng`, a generator seeded from `seed` (nn/dropout.py).

`gnn_model` builds GatedGCN, GIN and Transformer; the other nets raise
NotImplementedError naming their ROADMAP.md item.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.dropout import Dropout, DropoutRNG
from ..nn.init import Embedding, Linear, init_parameters
from ..nn.mlp import MLP, MLPReadout
from .conv import GatedGCNLayer, GINConv, GraphTransformerLayer, pool_any
from .signnet import GINDeepSigns


class ZincNet(nn.Module):
    """What the ZINC nets share (the JAX `_Base`): atom, bond and PE
    embeddings, the SignNet encoder and the readout head over
    `readout_dim` features, and the dropout generator seeded from `seed`.
    Subclasses add their layers, then draw every parameter with
    `init_parameters`."""

    def __init__(self, num_atom_type: int = 28, num_bond_type: int = 4,
                 hidden_dim: int = 95, readout_dim: int = 95,
                 readout: str = "mean", in_feat_dropout: float = 0.0,
                 dropout: float = 0.0, edge_feat: bool = True,
                 pe_init: str = "lap_pe", lap_method: str = "none",
                 pos_enc_dim: int = 8, sign_inv_net: str = "gin",
                 sign_inv_layers: int = 8, phi_out_dim: int = 4,
                 pe_aggregate: str = "add", use_lspe: bool = False,
                 max_nodes: int = 40, remat: bool = False, seed: int = 0):
        super().__init__()
        # max_nodes sizes the transformer phi only
        del max_nodes
        if use_lspe or pe_init == "rand_walk":
            raise NotImplementedError(
                "LSPE / rand_walk PE are not ported yet (ROADMAP.md queue 1 "
                "item 15)")
        if pe_init not in ("none", "lap_pe"):
            raise ValueError(f"unknown pe_init {pe_init!r}")
        if remat:
            raise NotImplementedError(
                "remat is not ported yet (ROADMAP.md queue 1 item 16)")
        self.readout = readout
        self.pe_init = pe_init
        self.lap_method = lap_method
        self.pe_aggregate = pe_aggregate
        self.edge_feat = edge_feat
        self.dropout = dropout
        self.dropout_rng = DropoutRNG(seed)
        self.in_feat_drop = Dropout(in_feat_dropout, self.dropout_rng)
        self.embedding_h = Embedding(num_atom_type, hidden_dim)
        if pe_init == "lap_pe":
            if lap_method == "sign_inv":
                self.sign_inv_net = sign_inv_module(
                    sign_inv_net, hidden_dim, phi_out_dim, sign_inv_layers,
                    pos_enc_dim, dropout, self.dropout_rng)
            self.embedding_p = Linear(pos_enc_dim, hidden_dim)
            if pe_aggregate == "concat":
                self.embedding_hp = Linear(2 * hidden_dim, hidden_dim)
        self.embedding_e = (Embedding(num_bond_type, hidden_dim) if edge_feat
                            else Linear(1, hidden_dim))
        self.mlp_readout = MLPReadout(readout_dim, 1)

    def embed_inputs(self, gb, pos_enc):
        """(h [N, hidden], e [E, hidden]): atom embedding merged with the PE,
        and the bond embedding (a Linear of ones without edge features)."""
        codes = gb.node_feat
        if codes.dim() == 2:
            codes = codes[:, 0]
        h = self.in_feat_drop(self.embedding_h(codes))
        if self.pe_init == "lap_pe" and pos_enc is not None:
            if self.lap_method == "sign_inv":
                pos_enc = self.sign_inv_net(gb, pos_enc)
            p = self.embedding_p(pos_enc)
            if self.pe_aggregate == "concat":
                h = self.embedding_hp(torch.cat([h, p], dim=-1))
            else:
                h = h + p
        if self.edge_feat:
            e = self.embedding_e(gb.edge_feat)
        else:
            e = self.embedding_e(torch.ones((gb.num_edges, 1),
                                            device=gb.senders.device))
        return h, e

    def readout_head(self, gb, h):
        hg = pool_any(gb, h, reduce=self.readout)
        return self.mlp_readout(hg)[:, 0]


class GatedGCNNet(ZincNet):
    """GatedGCN layers of width hidden_dim (the last one out_dim), on the
    node and the bond embeddings.  The ZINC net disables graph norm in its
    layers, as the JAX net does.  The LSPE branch is refused by `ZincNet`
    (ROADMAP.md queue 1 item 15)."""

    def __init__(self, hidden_dim: int = 95, out_dim: int = 95,
                 n_layers: int = 16, batch_norm: bool = True,
                 residual: bool = True, seed: int = 0, **base):
        super().__init__(hidden_dim=hidden_dim, readout_dim=out_dim,
                         seed=seed, **base)
        self.n_layers = n_layers
        for i in range(n_layers):
            out = hidden_dim if i < n_layers - 1 else out_dim
            self.add_module(f"layer_{i}", GatedGCNLayer(
                hidden_dim, out, batch_norm=batch_norm, residual=residual,
                graph_norm=False, dropout=self.dropout,
                rng=self.dropout_rng))
        init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, gb, pos_enc=None):
        h, e = self.embed_inputs(gb, pos_enc)
        for i in range(self.n_layers):
            h, e = getattr(self, f"layer_{i}")(gb, h, e)
        return self.readout_head(gb, h)


class GINNet(ZincNet):
    def __init__(self, hidden_dim: int = 95, out_dim: int = 95,
                 n_layers: int = 16, batch_norm: bool = True,
                 residual: bool = True, seed: int = 0, **base):
        # the JAX GINNet's GIN layers carry no residual either
        del residual
        super().__init__(hidden_dim=hidden_dim, readout_dim=out_dim,
                         seed=seed, **base)
        self.n_layers = n_layers
        for i in range(n_layers):
            out = hidden_dim if i < n_layers - 1 else out_dim
            self.add_module(f"layer_{i}", GINConv(MLP(
                hidden_dim, hidden_dim, out, num_layers=2,
                use_bn=batch_norm, dropout=self.dropout,
                rng=self.dropout_rng)))
        init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, gb, pos_enc=None):
        h, _ = self.embed_inputs(gb, pos_enc)
        for i in range(self.n_layers):
            h = getattr(self, f"layer_{i}")(gb, h)
        return self.readout_head(gb, h)


class TransformerNet(ZincNet):
    """Graph transformer layers of width hidden_dim (out_dim unused, as in
    the JAX net), attention modulated by the bond embedding when edge_feat
    is set."""

    def __init__(self, hidden_dim: int = 95, out_dim: int = 95,
                 n_layers: int = 16, batch_norm: bool = True,
                 residual: bool = True, num_heads: int = 8,
                 full_graph: bool = False, layer_norm: bool = False,
                 seed: int = 0, **base):
        del out_dim
        if full_graph:
            raise NotImplementedError(
                "the full-graph transformer (make_full_graph, edge_real, "
                "gamma) is not ported yet (ROADMAP.md queue 1 item 10)")
        super().__init__(hidden_dim=hidden_dim, readout_dim=hidden_dim,
                         seed=seed, **base)
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"layer_{i}", GraphTransformerLayer(
                hidden_dim, num_heads, layer_norm=layer_norm,
                batch_norm=batch_norm, residual=residual,
                use_edge=self.edge_feat, dropout=self.dropout,
                rng=self.dropout_rng))
        init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, gb, pos_enc=None):
        h, e = self.embed_inputs(gb, pos_enc)
        for i in range(self.n_layers):
            h = getattr(self, f"layer_{i}")(gb, h, e)
        return self.readout_head(gb, h)


def sign_inv_module(kind: str, hidden: int, phi_out: int, num_layers: int,
                    k: int, dropout: float = 0.0, rng=None) -> nn.Module:
    """sign_inv_net factory.  use_bn=True always, as the reference hardcodes
    it for every sign_inv variant (without BN the 8-layer sum-aggregation phi
    produces unbounded activations)."""
    if kind == "gin":
        return GINDeepSigns(hidden=hidden, phi_out=phi_out,
                            num_layers=num_layers, k=k, use_bn=True,
                            dropout=dropout, rng=rng)
    items = {"masked_gin": 12, "gcn": 14, "gat": 14, "transformer": 16}
    if kind in items:
        raise NotImplementedError(
            f"sign_inv_net {kind!r} is not ported yet (ROADMAP.md queue 1 "
            f"item {items[kind]})")
    raise ValueError(f"unknown sign_inv_net {kind!r}")


_NETS = {"GatedGCN": GatedGCNNet, "GIN": GINNet,
         "Transformer": TransformerNet}
_NOT_PORTED = {"GAT": 14, "PNA": 13}


def gnn_model(name: str, **net_params) -> nn.Module:
    """Model registry (the JAX package's `gnn_model`)."""
    if name in _NETS:
        return _NETS[name](**net_params)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md queue 1 item "
            f"{_NOT_PORTED[name]})")
    raise KeyError(name)
