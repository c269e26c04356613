"""ZINC graph-regression nets: GatedGCNNet, GINNet, GATNet, PNANet and
TransformerNet with their PE encoders.

Port of signnet_basisnet_tpu/models/zinc_models.py:28-64 (`lapeig_loss`,
`normalize_p`), :67-166 (`_Base`: `sign_inv_module`, `embed_inputs`,
`readout_head`), :169-203 (`GatedGCNNet`, its LSPE branch included),
:206-231 (`GINNet`, likewise), :234-250 (`GATNet`), :253-296 (`PNANet`)
and :298-316 (`TransformerNet`, with `full_graph`).  Signature: ``model(gb, pos_enc) -> [G]`` scores; GIN and GatedGCN also
return the LSPE positional channel p, as ``(scores, p)``, with
``return_p=True`` (p is None off the LSPE path).  PE: `pe_init` in {none, lap_pe, rand_walk};
with `rand_walk`, or `use_lspe` on GIN and GatedGCN, the embedded PE p
stays apart from h, GatedGCN updates it in its GatedGCN-LSPE layers, and
both nets merge it after the last layer (`p_out`, `normalize_p`, `Whp`
over [h || p]).  Submodule names follow the flax ones
(`embedding_h`, `embedding_p`, `embedding_hp`, `embedding_e`,
`sign_inv_net`, `layer_i` with `layer_i.mlp` for flax's `mlp_i`,
`gru`, `p_out`, `Whp`, `mlp_readout`), so the weight bridge (bridge.py) is
a name mapping.  With lap_method `sign_flip` the net also owns the generators its
flips draw from: `flip_rng` (train steps, seeded from `seed`) and
`eval_flip_rng` (eval batches, seeded from `seed + 10007`, the JAX
`fit`'s eval key).
Dropout (`dropout`, `in_feat_dropout`) is applied where the JAX nets apply
it, the SignNet phi and rho included, drawing from the model's
`dropout_rng`, a generator seeded from `seed` (nn/dropout.py).

With `remat` each conv layer of GatedGCN, GIN, PNA and the Transformer
(not GAT's, not the SignNet phi's) runs under `nn.remat.checkpoint` in a
train step, as the JAX `maybe_remat` wraps them in `nn.remat`: its
activations are recomputed in the backward pass.  The parameter and
buffer names do not change, so a checkpoint loads either way.

GIN takes a dense batch (`graph.dense.DenseGraphBatch`) as the JAX net
does: `embed_inputs` embeds [G, M] atom codes and the GIN layers, the
SignNet phi and the readout take their dense branches (`bench --mode
dense`).

`gnn_model` builds the five ZINC nets: GatedGCN, GIN, GAT, PNA and
Transformer.

Inside a train step that records device spans (utils/profiling.py:
`mark`) the nets mark three regions: `pe` (the SignNet encoder's call in
`embed_inputs`), `convs` (the layer loop) and `head` (from the readout
on; the train step closes it after the loss).  Elsewhere the marks return
their tensors themselves.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.dropout import Dropout, DropoutRNG
from ..nn.init import Embedding, Linear, init_parameters
from ..nn.mlp import MLP, MLPReadout
from ..nn.remat import checkpoint
from ..nn.set2set import GRUStep
from ..utils.profiling import mark
from ..graph import segment as seg
from ..graph.dense import DenseGraphBatch
from .conv import (GATConv, GatedGCNLayer, GatedGCNLSPELayer, GINConv,
                   GraphTransformerLayer, PNALayer, PNANoTowersLayer,
                   pool_any)
from .signnet import GINDeepSigns, MaskedGINDeepSigns, TransformerDeepSigns

# the JAX fit's eval key is PRNGKey(seed + 10007)
EVAL_FLIP_SEED_OFFSET = 10007


def lapeig_loss(gb, p):
    """The LSPE Laplacian-eigenvector auxiliary terms, batched on the
    device: (trace(p^T L p), sum over real graphs of ||P^T P - I||_F^2),
    with L the degree-normalised Laplacian over the real edges (degrees
    clipped at 1)."""
    deg = torch.clamp(gb.in_degrees(), min=1.0)
    dis = deg ** -0.5
    src, dst = gb.senders.long(), gb.receivers.long()
    # trace(p^T L p) = sum_i |p_i|^2 - sum_e p_s.p_r / sqrt(d_s d_r)
    tr = (p ** 2 * gb.node_mask[:, None]).sum()
    cross = ((p[src] * p[dst]).sum(-1) * dis[src] * dis[dst]
             * gb.edge_mask).sum()
    outer = p[:, :, None] * p[:, None, :] * gb.node_mask[:, None, None]
    ptp = seg.segment_sum(outer, gb.graph_id, gb.num_graphs)    # G K K
    eye = torch.eye(p.shape[1], dtype=p.dtype, device=p.device)[None]
    ortho = (((ptp - eye) ** 2).sum((-2, -1)) * gb.graph_mask).sum()
    return tr - cross, ortho


def normalize_p(gb, p):
    """LSPE's positional post-processing: centre p per graph, then divide
    by its per-graph column L2 norm, with 1e-12 inside the sqrt (a padding
    graph's p is all zero, and the sqrt's gradient at 0 is NaN)."""
    means = pool_any(gb, p, reduce="mean")
    gid = gb.graph_id.long()
    p = (p - means[gid]) * gb.node_mask[:, None]
    norms = torch.sqrt(pool_any(gb, p ** 2 * gb.node_mask[:, None],
                                reduce="sum") + 1e-12)
    return p / norms[gid]


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
        if pe_init not in ("none", "lap_pe", "rand_walk"):
            raise ValueError(f"unknown pe_init {pe_init!r}")
        self.remat = remat
        self.readout = readout
        self.pe_init = pe_init
        self.lap_method = lap_method
        self.pe_aggregate = pe_aggregate
        self.use_lspe = use_lspe
        self.pos_enc_dim = pos_enc_dim
        self.edge_feat = edge_feat
        self.dropout = dropout
        self.dropout_rng = DropoutRNG(seed)
        if lap_method == "sign_flip":
            self.flip_rng = DropoutRNG(seed)
            self.eval_flip_rng = DropoutRNG(seed + EVAL_FLIP_SEED_OFFSET)
        self.in_feat_drop = Dropout(in_feat_dropout, self.dropout_rng)
        self.embedding_h = Embedding(num_atom_type, hidden_dim)
        if pe_init in ("lap_pe", "rand_walk"):
            if pe_init == "lap_pe" and lap_method == "sign_inv":
                # max_nodes sizes the transformer phi's dense layout
                self.sign_inv_net = sign_inv_module(
                    sign_inv_net, hidden_dim, phi_out_dim, sign_inv_layers,
                    pos_enc_dim, dropout, self.dropout_rng, max_nodes)
            self.embedding_p = Linear(pos_enc_dim, hidden_dim)
            if (pe_init == "lap_pe" and not use_lspe
                    and pe_aggregate == "concat"):
                self.embedding_hp = Linear(2 * hidden_dim, hidden_dim)
        self.embedding_e = (Embedding(num_bond_type, hidden_dim) if edge_feat
                            else Linear(1, hidden_dim))
        self.mlp_readout = MLPReadout(readout_dim, 1)

    @property
    def lspe(self) -> bool:
        """Whether the embedded PE stays apart from h, to be merged after
        the last layer (LSPE)."""
        return self.pe_init != "none" and (self.use_lspe
                                           or self.pe_init == "rand_walk")

    def run_layer(self, i: int, *args):
        """layer_i(*args), under `nn.remat.checkpoint` with `remat` where
        autograd records (an eval step runs it plainly)."""
        layer = getattr(self, f"layer_{i}")
        if self.remat and torch.is_grad_enabled():
            return checkpoint(layer, *args)
        return layer(*args)

    def embed_inputs(self, gb, pos_enc):
        """(h [N, hidden], p, e [E, hidden]): the atom embedding, merged
        with the embedded PE under lap_pe without LSPE (p is then None),
        else beside it as p [N, hidden]; and the bond embedding (a Linear
        of ones without edge features).  On a dense batch h is [G, M,
        hidden] and e [G, M, M, hidden]."""
        dense = isinstance(gb, DenseGraphBatch)
        codes = gb.node_feat
        # scalar atom codes: [N] flat, [G, M] dense (a trailing feature
        # column dropped)
        if codes.dim() == 2 and not dense:
            codes = codes[:, 0]
        if codes.dim() == 3:
            codes = codes[..., 0]
        h = self.in_feat_drop(self.embedding_h(codes))
        p = None
        if self.pe_init in ("lap_pe", "rand_walk") and pos_enc is not None:
            if self.pe_init == "lap_pe" and self.lap_method == "sign_inv":
                pos_enc = mark("pe", True, pos_enc)
                pos_enc = mark("pe", False, self.sign_inv_net(gb, pos_enc))
            p = self.embedding_p(pos_enc)
        if self.pe_init == "lap_pe" and p is not None and not self.use_lspe:
            if self.pe_aggregate == "concat":
                h = self.embedding_hp(torch.cat([h, p], dim=-1))
            else:
                h = h + p
            p = None
        if self.edge_feat:
            e = self.embedding_e(gb.edge_feat)
        elif dense:
            e = self.embedding_e(torch.ones(gb.adj.shape + (1,),
                                            device=gb.adj.device))
        else:
            e = self.embedding_e(torch.ones((gb.num_edges, 1),
                                            device=gb.senders.device))
        return h, p, e

    def add_lspe_merge(self, p_dim: int, out_dim: int):
        """The LSPE merge's layers: `p_out` over p [N, p_dim] and `Whp` over
        [h || p]."""
        if self.lspe:
            self.p_out = Linear(p_dim, self.pos_enc_dim)
            self.Whp = Linear(out_dim + self.pos_enc_dim, out_dim)

    def merge_p(self, gb, h, p):
        """h merged with the normalised positional channel after the last
        layer: (Whp [h || normalize_p(p_out p)], that p); without LSPE,
        (h, None)."""
        if not (self.lspe and p is not None):
            return h, None
        p = normalize_p(gb, self.p_out(p))
        return self.Whp(torch.cat([h, p], dim=-1)), p

    def readout_head(self, gb, h):
        h = mark("head", True, h)
        hg = pool_any(gb, h, reduce=self.readout)
        return self.mlp_readout(hg)[:, 0]


class GatedGCNNet(ZincNet):
    """GatedGCN layers of width hidden_dim (the last one out_dim), on the
    node and the bond embeddings.  The ZINC net disables graph norm in its
    layers, as the JAX net does.  Under LSPE the layers are GatedGCN-LSPE
    layers, which update p too (no fused gate kernel runs there)."""

    def __init__(self, hidden_dim: int = 95, out_dim: int = 95,
                 n_layers: int = 16, batch_norm: bool = True,
                 residual: bool = True, seed: int = 0, **base):
        super().__init__(hidden_dim=hidden_dim, readout_dim=out_dim,
                         seed=seed, **base)
        self.n_layers = n_layers
        for i in range(n_layers):
            out = hidden_dim if i < n_layers - 1 else out_dim
            if self.lspe:
                layer = GatedGCNLSPELayer(
                    hidden_dim, out, batch_norm=batch_norm,
                    residual=residual, dropout=self.dropout,
                    rng=self.dropout_rng)
            else:
                layer = GatedGCNLayer(
                    hidden_dim, out, batch_norm=batch_norm,
                    residual=residual, graph_norm=False,
                    dropout=self.dropout, rng=self.dropout_rng)
            self.add_module(f"layer_{i}", layer)
        # the LSPE layers carry p at their width
        self.add_lspe_merge(out_dim, out_dim)
        init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, gb, pos_enc=None, return_p: bool = False):
        h, p, e = self.embed_inputs(gb, pos_enc)
        h, p, e = mark("convs", True, h, p, e)
        for i in range(self.n_layers):
            if isinstance(getattr(self, f"layer_{i}"), GatedGCNLSPELayer):
                if p is None:
                    raise ValueError("the LSPE layers need a PE")
                h, p, e = self.run_layer(i, gb, h, p, e)
            else:
                h, e = self.run_layer(i, gb, h, e)
        h, p = mark("convs", False, h, p)
        h, p = self.merge_p(gb, h, p)
        out = self.readout_head(gb, h)
        return (out, p) if return_p else out


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
        # the GIN layers leave p at the embedding's width
        self.add_lspe_merge(hidden_dim, out_dim)
        init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, gb, pos_enc=None, return_p: bool = False):
        h, p, _ = self.embed_inputs(gb, pos_enc)
        h = mark("convs", True, h)
        for i in range(self.n_layers):
            h = self.run_layer(i, gb, h)
        h = mark("convs", False, h)
        h, p = self.merge_p(gb, h, p)
        out = self.readout_head(gb, h)
        return (out, p) if return_p else out


class GATNet(ZincNet):
    """n_layers - 1 GAT layers of num_heads heads of width
    hidden_dim // num_heads, concatenated, with ELU; then one single-head
    layer of width out_dim.  No BN and no residual, as in the JAX net
    (batch_norm and residual are taken and unused); the bond embedding is
    made but unused, as flax makes it."""

    def __init__(self, hidden_dim: int = 95, out_dim: int = 95,
                 n_layers: int = 16, batch_norm: bool = True,
                 residual: bool = True, num_heads: int = 8, seed: int = 0,
                 **base):
        del batch_norm, residual
        super().__init__(hidden_dim=hidden_dim, readout_dim=out_dim,
                         seed=seed, **base)
        self.n_layers = n_layers
        head_dim = hidden_dim // num_heads
        d_in = hidden_dim
        for i in range(n_layers - 1):
            self.add_module(f"layer_{i}", GATConv(
                d_in, head_dim, num_heads=num_heads, concat=True,
                add_self_loops=False, activation="elu"))
            d_in = head_dim * num_heads
        self.add_module(f"layer_{n_layers - 1}", GATConv(
            d_in, out_dim, num_heads=1, concat=False, add_self_loops=False))
        init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, gb, pos_enc=None):
        h, _, _ = self.embed_inputs(gb, pos_enc)
        h = mark("convs", True, h)
        for i in range(self.n_layers):
            h = getattr(self, f"layer_{i}")(gb, h)
        return self.readout_head(gb, mark("convs", False, h))


class PNANet(ZincNet):
    """n_layers PNA layers of width hidden_dim (out_dim unused, as in the
    JAX net): `towers` towers each (`PNALayer`), or the towerless layer
    with `no_towers`; graph norm by the batch's snorm; with `gru`, one
    shared GRU (`gru`) updates the layer output from the layer input
    between layers.  `avg_d_log` is the train split's mean log(d + 1)
    (data.zinc.avg_degree_stats)."""

    def __init__(self, hidden_dim: int = 95, out_dim: int = 95,
                 n_layers: int = 16, batch_norm: bool = True,
                 residual: bool = True, seed: int = 0,
                 aggregators=("mean", "max", "min", "std"),
                 scalers=("identity", "amplification", "attenuation"),
                 avg_d_log: float = 1.0, towers: int = 5,
                 divide_input: bool = True, graph_norm: bool = True,
                 pretrans_layers: int = 1, posttrans_layers: int = 1,
                 gru: bool = False, no_towers: bool = False, **base):
        del out_dim
        super().__init__(hidden_dim=hidden_dim, readout_dim=hidden_dim,
                         seed=seed, **base)
        self.n_layers = n_layers
        kw = dict(dropout=self.dropout, graph_norm=graph_norm,
                  batch_norm=batch_norm, residual=residual,
                  edge_features=self.edge_feat,
                  pretrans_layers=pretrans_layers,
                  posttrans_layers=posttrans_layers, rng=self.dropout_rng)
        if not no_towers:
            kw.update(towers=towers, divide_input=divide_input)
        layer = PNANoTowersLayer if no_towers else PNALayer
        for i in range(n_layers):
            self.add_module(f"layer_{i}", layer(
                hidden_dim, hidden_dim, hidden_dim, aggregators, scalers,
                avg_d_log, **kw))
        self.gru = GRUStep(hidden_dim) if gru else None
        init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, gb, pos_enc=None):
        h, _, e = self.embed_inputs(gb, pos_enc)
        snorm = gb.snorm()
        h, e = mark("convs", True, h, e)
        for i in range(self.n_layers):
            h_t = self.run_layer(i, gb, h, e, snorm)
            if self.gru is not None and i != self.n_layers - 1:
                h_t = self.gru(h, h_t)
            h = h_t
        return self.readout_head(gb, mark("convs", False, h))


class TransformerNet(ZincNet):
    """Graph transformer layers of width hidden_dim (out_dim unused, as in
    the JAX net), attention modulated by the bond embedding when edge_feat
    is set.  With `full_graph` the net takes batches of
    `data.transforms.make_full_graph` graphs (the `edge_real` extra) and
    its attention mixes real and fake edges (models/conv.py)."""

    def __init__(self, hidden_dim: int = 95, out_dim: int = 95,
                 n_layers: int = 16, batch_norm: bool = True,
                 residual: bool = True, num_heads: int = 8,
                 full_graph: bool = False, layer_norm: bool = False,
                 seed: int = 0, **base):
        del out_dim
        super().__init__(hidden_dim=hidden_dim, readout_dim=hidden_dim,
                         seed=seed, **base)
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"layer_{i}", GraphTransformerLayer(
                hidden_dim, num_heads, layer_norm=layer_norm,
                batch_norm=batch_norm, residual=residual,
                use_edge=self.edge_feat, dropout=self.dropout,
                rng=self.dropout_rng, full_graph=full_graph))
        init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, gb, pos_enc=None):
        h, _, e = self.embed_inputs(gb, pos_enc)
        h, e = mark("convs", True, h, e)
        for i in range(self.n_layers):
            h = self.run_layer(i, gb, h, e)
        return self.readout_head(gb, mark("convs", False, h))


def sign_inv_module(kind: str, hidden: int, phi_out: int, num_layers: int,
                    k: int, dropout: float = 0.0, rng=None,
                    max_nodes: int = 40) -> nn.Module:
    """sign_inv_net factory: the GIN or GAT phi (`gin`, `gat`), the masked
    GIN one (`masked_gin`) or the set-transformer one (`transformer`:
    min(num_layers, 4) attention layers of 2 heads over each graph's
    nodes padded to `max_nodes`, no BN, no dropout but the attention's,
    as the JAX factory builds it); `gcn` raises ValueError (models/
    signnet.py says why).  Otherwise use_bn=True always, as the reference
    hardcodes it for every sign_inv variant (without BN the 8-layer
    sum-aggregation phi produces unbounded activations)."""
    if kind == "transformer":
        return TransformerDeepSigns(hidden=hidden,
                                    num_layers=min(num_layers, 4), k=k,
                                    n_max=max_nodes, rng=rng)
    kw = dict(hidden=hidden, phi_out=phi_out, num_layers=num_layers, k=k,
              use_bn=True, dropout=dropout, rng=rng)
    if kind == "masked_gin":
        return MaskedGINDeepSigns(**kw)
    if kind in ("gin", "gat", "gcn"):
        return GINDeepSigns(kind=kind, **kw)
    raise ValueError(f"unknown sign_inv_net {kind!r}")


_NETS = {"GatedGCN": GatedGCNNet, "GIN": GINNet, "GAT": GATNet,
         "PNA": PNANet, "Transformer": TransformerNet}


def gnn_model(name: str, **net_params) -> nn.Module:
    """Model registry (the JAX package's `gnn_model`)."""
    if name in _NETS:
        return _NETS[name](**net_params)
    raise KeyError(name)
