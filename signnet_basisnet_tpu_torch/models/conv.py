"""Graph convolution on padded batched graphs: the GIN family, GatedGCN,
Transformer, GCN, GAT and PNA layers.

Port of signnet_basisnet_tpu/models/conv.py:26-58,61-125 (`neighbor_sum`,
`src_features`, `node_mask_like`, `pool_any`, `GINConv`), :128-213
(`GINEConv`, `MaskedGINConv`, `MaskedGINEConv`), :216-244 (`GCNConv`),
:247-309 (`GATConv`), :312-381 (`GatedGCNLayer`), :384-447
(`GatedGCNLSPELayer`), :450-649 (`PNA_EPS`, `pna_aggregate`, `pna_scale`,
`PNATower`, `PNALayer`, `PNANoTowersLayer`), :652-679
(`SimplifiedPNAConv`) and :682-811 (`GraphTransformerAttention`,
`GraphTransformerLayer`, sparse path).  GCN, GAT, PNA, the GINE convs and
the simplified PNA reach no kernel: their JAX layers are XLA segment ops,
so here they are plain torch ops over `graph.segment` (the GIN convs'
`neighbor_sum` reaches K1 only on a tiled batch under 'pallas_tile').

Dense batches (`graph.dense.DenseGraphBatch`, [G, M, M] adjacency) take
the JAX package's dense branches: `neighbor_sum` as a batched einsum (so
`GINConv` and `MaskedGINConv` too), `pool_any` as a masked sum over the
node axis, and `GINEConv` and `MaskedGINEConv` with their messages over
[G, M(dst), M(src), ...] edge features; no kernel runs there.  The layers
with no dense branch in the JAX package (GCN, GAT, GatedGCN, PNA, the
simplified PNA, the Transformer and NetGINE's conv read `gb.senders`,
which a dense batch lacks) refuse a dense batch (`refuse_dense`).

The full-graph Transformer (`full_graph=True`, on batches of
`data.transforms.make_full_graph` graphs) mixes two score maps by the
`edge_real` flag of each edge and reweights the fake edges by a learnt
gamma, in plain torch: it never takes the K2/K3 path, as the JAX layer
never takes its fused kernel there.

On a model-parallel shard (`mp_send_idx` in extras, parallel/mp_halo.py)
every layer takes the JAX package's halo route: `neighbor_sum` sums the
local edges and the exchanged halo rows, the gather-based layers read
their source rows through `src_features` ([x ‖ halo]), the GatedGCN layer
applies B and D and the Transformer K and V (and K_2) to the exchanged
rows, and `pool_any` sums its per-graph partials over the group.  A shard
carries no tile ranges, so no kernel runs there, as in JAX.  Under GSPMD
(parallel/gspmd.py, DTensor features) `neighbor_sum` runs K1 on
replicated operands, as XLA runs a custom call it cannot partition.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..graph import CSR_KEYS, segment as seg
from ..graph.dense import DenseGraphBatch, dense_neighbor_sum, dense_pool
from ..nn.dropout import Dropout
from ..nn.init import ACTIVATIONS, Embedding, Linear
from ..nn.mlp import MLP, ElementsMLP, MaskedMLP
from ..nn.norm import MaskedBatchNorm, MaskedLayerNorm
from ..ops import (edge_softmax_attention_reference,
                   edge_softmax_attention_tiled, gatedgcn_gate_reference,
                   gatedgcn_gate_tiled, spmm_tile_dense, spmm_tiled)
from ..utils.profiling import mark


def neighbor_sum(x, gb):
    """sum_{j in N(i)} x_j for x [N, ...].

    Backend (graph.segment.set_agg_backend) on a tiled batch: 'pallas_tile'
    goes through the tile-local SpMM (its CUDA kernel on CUDA tensors, its
    plain version on CPU ones); 'tile_dense' through the block adjacency.
    Otherwise the flat masked gather + index_add_.  On a dense batch,
    adj @ x (x [G, M, ...]).
    """
    if isinstance(gb, DenseGraphBatch):
        return dense_neighbor_sum(gb.adj, x)
    if "mp_send_idx" in gb.extras:
        # a model-parallel shard: local sum + the halo exchange's remote one
        from ..parallel.mp_halo import mp_neighbor_sum
        return mp_neighbor_sum(x, gb)
    backend = seg.get_agg_backend()
    if backend == "tile_dense" and "tile_starts" in gb.extras:
        bn = gb.num_nodes // gb.extras["tile_starts"].shape[0]
        return spmm_tile_dense(x, gb.senders, gb.receivers, gb.edge_mask,
                               gb.num_nodes, bn)
    if backend == "pallas_tile" and "tile_starts" in gb.extras:
        bn = gb.num_nodes // gb.extras["tile_starts"].shape[0]
        flat = x.reshape(x.shape[0], -1)

        def sum_tiled(flat, senders, receivers, edge_mask, starts, ends,
                      *csr):
            return spmm_tiled(flat, senders, receivers, edge_mask, starts,
                              ends, gb.num_nodes, bn, csr=csr)
        if seg.is_dtensor(flat):
            # GSPMD (parallel/gspmd.py): K1 on replicated operands
            from ..parallel.gspmd import on_replicated
            sum_tiled = on_replicated(sum_tiled, flat.device_mesh)
        out = sum_tiled(flat, gb.senders, gb.receivers, gb.edge_mask,
                        gb.extras["tile_starts"], gb.extras["tile_ends"],
                        *batch_csr(gb))
        return out.reshape(x.shape)
    msg = x.index_select(0, gb.senders.long())
    return seg.aggregate_edges(msg, gb.receivers, gb.num_nodes,
                               edge_mask=gb.edge_mask)


def refuse_dense(gb, layer: str):
    """A layer with no dense branch in the JAX package refuses a dense
    batch, on which the JAX layer fails reading `gb.senders`."""
    if isinstance(gb, DenseGraphBatch):
        raise TypeError(
            f"{layer} has no dense-batch branch: the JAX layer reads "
            "gb.senders, which a DenseGraphBatch does not have; pack the "
            "graphs with graph.batch_np")


def src_features(x, gb):
    """Rows of ``x`` addressable by ``gb.senders``: on a plain batch ``x``
    itself; on a model-parallel shard (``mp_send_idx`` in extras) ``[x ‖
    halo rows]``, since senders >= shard_n index the halo block the
    exchange brings from the other ranks (parallel/mp_halo.py)."""
    if "mp_send_idx" in gb.extras:
        from ..parallel.mp_halo import mp_exchange
        return torch.cat([x, mp_exchange(x, gb.extras["mp_send_idx"])])
    return x


def batch_csr(gb):
    """The tiled batch's (dst_ptr, src_order, src_ptr), made by
    `graph.from_arrays`."""
    return tuple(gb.extras[k] for k in CSR_KEYS)


def pool_any(gb, x, reduce="sum"):
    """Per-graph pooling of node features, flat [N, ...] or dense [G, M,
    ...]."""
    if isinstance(gb, DenseGraphBatch):
        return dense_pool(x, gb.node_mask, reduce=reduce)
    if "mp_send_idx" in gb.extras:
        # a model-parallel shard: graphs may straddle shards
        from ..parallel.mp_halo import mp_pool_nodes
        return mp_pool_nodes(x, gb, reduce=reduce)
    return seg.pool_nodes(x, gb.graph_id, gb.num_graphs,
                          node_mask=gb.node_mask, reduce=reduce)


def node_mask_like(gb, x):
    """gb's node mask broadcast to x.shape[:-1] (adds eigvec-channel axes)."""
    m = gb.node_mask
    while m.dim() < x.dim() - 1:
        m = m[..., None]
    return m.expand(x.shape[:-1])


class GINConv(nn.Module):
    """x' = mlp((1 + eps) x + sum_j x_j).  `learn_eps=False`: DGL
    GINConv(MLP, 'sum'), eps = 0; `learn_eps=True`: PyG GINConv(train_eps),
    a learnt scalar `eps` starting at 0.  The update net is `mlp` (flax's
    `conv_i_nn` beside the layer in the PyG GNN, `mlp_i` in the ZINC
    nets)."""

    def __init__(self, mlp: nn.Module, learn_eps: bool = False):
        super().__init__()
        self.mlp = mlp
        self.eps = nn.Parameter(torch.zeros(())) if learn_eps else None

    def forward(self, gb, x):
        agg = neighbor_sum(x, gb)
        out = x + agg if self.eps is None else (1.0 + self.eps) * x + agg
        # BN inside the MLP must ignore padding rows
        return self.mlp(out, mask=node_mask_like(gb, out))


def _edge_sum(gb, msg):
    return seg.aggregate_edges(msg, gb.receivers, gb.num_nodes,
                               edge_mask=gb.edge_mask)


class GINEConv(nn.Module):
    """x' = mlp((1 + eps) x + sum_j relu(x_j + e_ij)): PyG GINEConv with a
    learnt `eps` (or 0 without `learn_eps`)."""

    def __init__(self, mlp: nn.Module, learn_eps: bool = True):
        super().__init__()
        self.mlp = mlp
        self.eps = nn.Parameter(torch.zeros(())) if learn_eps else None

    def forward(self, gb, x, edge_attr):
        if isinstance(gb, DenseGraphBatch):
            # edge_attr [G, M(dst), M(src), D]: relu(x_src + e) summed over
            # the sources the adjacency holds
            msg = torch.relu(x[:, None, :, :] + edge_attr)
            agg = torch.einsum("gmn,gmnd->gmd", gb.adj.to(msg.dtype), msg)
        else:
            src = src_features(x, gb).index_select(0, gb.senders.long())
            agg = _edge_sum(gb, torch.relu(src + edge_attr))
        out = x + agg if self.eps is None else (1.0 + self.eps) * x + agg
        return self.mlp(out, mask=node_mask_like(gb, out))


class MaskedGINConv(nn.Module):
    """The SignNet phi conv: (1 + eps) x + sum_j x_j through a two-layer
    MaskedMLP `nn` (no final activation), which zeroes the masked (node, k)
    slots.  x is [N, D] or [N, K, D], mask [N] or [N, K]."""

    def __init__(self, in_features: int, out: int,
                 hidden: Optional[int] = None):
        super().__init__()
        self.eps = nn.Parameter(torch.zeros(()))
        self.nn = MaskedMLP(in_features, out, num_layers=2,
                            with_final_activation=False, hidden=hidden)

    def forward(self, gb, x, mask=None):
        out = (1.0 + self.eps) * x + neighbor_sum(x, gb)
        return self.nn(out, mask=mask)


class MaskedGINEConv(nn.Module):
    """The GINE phi conv: (1 + eps) x + sum_j relu(x_j + e_ij), the masked
    slots zeroed, through the MaskedMLP `nn`.  x [N, D] or [N, K, D];
    edge_attr [E, D] broadcasts over K.  Layer 0 of GNN3d has D = 1 against
    `in_features`-wide encoded edges, which broadcasts on purpose; any
    other mismatch of widths raises ValueError."""

    def __init__(self, in_features: int, out: int,
                 hidden: Optional[int] = None):
        super().__init__()
        self.eps = nn.Parameter(torch.zeros(()))
        self.nn = MaskedMLP(in_features, out, num_layers=2,
                            with_final_activation=False, hidden=hidden)

    def forward(self, gb, x, edge_attr, mask=None):
        if isinstance(gb, DenseGraphBatch):
            # edge_attr [G, M(dst), M(src), D]; x [G, M, D] or [G, M, K, D]
            adj = gb.adj.to(x.dtype)
            if x.dim() == 4:
                msg = torch.relu(x[:, None] + edge_attr[:, :, :, None, :])
                agg = torch.einsum("gmn,gmnkd->gmkd", adj, msg)
            else:
                msg = torch.relu(x[:, None] + edge_attr)
                agg = torch.einsum("gmn,gmnd->gmd", adj, msg)
        else:
            src = src_features(x, gb).index_select(0, gb.senders.long())
            e = edge_attr
            if src.dim() == e.dim() + 1:
                e = e[:, None, :]
            if src.shape[-1] not in (1, e.shape[-1]):
                raise ValueError(
                    f"MaskedGINEConv feature mismatch: x D={src.shape[-1]} "
                    f"vs edge D={e.shape[-1]} (only D=1 may broadcast)")
            agg = _edge_sum(gb, torch.relu(src + e))
        out = (1.0 + self.eps) * x + agg
        if mask is not None:
            out = out * mask[..., None].to(out.dtype)
        return self.nn(out, mask=mask)


class GCNConv(nn.Module):
    """Symmetric-normalised graph convolution on [N, D]:
    out = d^-1/2 (sum_j d_j^-1/2 W x_j [+ d^-1/2 W x]) + bias, d the
    in-degree over the real edges (plus 1 on real nodes with
    `add_self_loops`, PyG's GCNConv; without, DGL's GraphConv with
    norm='both'), 0 where d = 0.  Names: `weight` (a Linear with its own
    bias) and the bare `bias`, as in flax."""

    def __init__(self, in_dim: int, features: int,
                 add_self_loops: bool = True,
                 activation: Optional[str] = None):
        super().__init__()
        self.add_self_loops = add_self_loops
        self.activation = activation
        self.weight = Linear(in_dim, features)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, gb, x):
        refuse_dense(gb, "GCNConv")
        deg = gb.in_degrees()
        if self.add_self_loops:
            deg = deg + gb.node_mask
        d = torch.where(deg > 0, deg ** -0.5, torch.zeros_like(deg))[:, None]
        h = self.weight(x)
        msg = src_features(h * d, gb).index_select(0, gb.senders.long())
        agg = seg.aggregate_edges(msg, gb.receivers, gb.num_nodes,
                                  edge_mask=gb.edge_mask)
        if self.add_self_loops:
            agg = agg + h * d
        out = agg * d + self.bias
        if self.activation:
            out = ACTIVATIONS[self.activation](out)
        return out


class GATConv(nn.Module):
    """Multi-head graph attention, GATv1 scores: LeakyReLU(a_src . W x_j +
    a_dst . W x_i), a softmax over each destination's real edges, the
    weighted sum of W x_j; heads concatenated (`concat`) or averaged, then
    `bias` and the activation.  With `add_self_loops` (PyG) the self term
    joins the softmax analytically; without (DGL, the ZINC net) a node with
    no real in-edge gets 0 before the bias.  x is [N, D] or [N, K, D]: the
    gathers run along axis 0 and the edge mask broadcasts over the middle
    axes.  Not the attention kernel K2: that computes the Transformer's
    clamped-exp dot-product score.  Names: `weight` (no bias), `attn_src`,
    `attn_dst` of shape (1, H, F), `bias`, as in flax."""

    def __init__(self, in_dim: int, features: int, num_heads: int = 1,
                 concat: bool = True, add_self_loops: bool = True,
                 negative_slope: float = 0.2,
                 activation: Optional[str] = None):
        super().__init__()
        self.features = features
        self.num_heads = num_heads
        self.concat = concat
        self.add_self_loops = add_self_loops
        self.negative_slope = negative_slope
        self.activation = activation
        self.weight = Linear(in_dim, num_heads * features, use_bias=False)
        self.attn_src = nn.Parameter(torch.empty(1, num_heads, features))
        self.attn_dst = nn.Parameter(torch.empty(1, num_heads, features))
        self.bias = nn.Parameter(torch.zeros(
            num_heads * features if concat else features))

    def reset_parameters(self, generator):
        # flax's glorot_uniform on (1, H, F): fan_in H, fan_out F
        bound = math.sqrt(6.0 / (self.num_heads + self.features))
        with torch.no_grad():
            for a in (self.attn_src, self.attn_dst):
                a.uniform_(-bound, bound, generator=generator)

    def forward(self, gb, x):
        refuse_dense(gb, "GATConv")
        H, Fh, n = self.num_heads, self.features, gb.num_nodes
        src, dst = gb.senders.long(), gb.receivers.long()
        h = self.weight(x)
        h = h.reshape(h.shape[:-1] + (H, Fh))
        el = (h * self.attn_src).sum(-1)                # N [K] H
        er = (h * self.attn_dst).sum(-1)
        # on an mp shard the source rows include the halo block
        h_all = src_features(h, gb)
        el_src = el if h_all is h else (h_all * self.attn_src).sum(-1)
        h_src = h_all.index_select(0, src)
        scores = F.leaky_relu(el_src.index_select(0, src)
                              + er.index_select(0, dst),
                              self.negative_slope)      # E [K] H
        emask = gb.edge_mask.reshape((-1,) + (1,) * (scores.dim() - 1))
        if self.add_self_loops:
            self_scores = F.leaky_relu(el + er, self.negative_slope)
            m = seg.segment_max(scores, gb.receivers, n, mask=gb.edge_mask,
                                empty_value=-1e30)
            m = torch.maximum(m, self_scores)
            ex = torch.exp(scores - m.index_select(0, dst)) * emask
            ex_self = torch.exp(self_scores - m)
            denom = torch.clamp(seg.segment_sum(ex, gb.receivers, n)
                                + ex_self, min=1e-16)
            alpha = ex / denom.index_select(0, dst)
            agg = seg.segment_sum(alpha[..., None] * h_src, gb.receivers, n)
            agg = agg + (ex_self / denom)[..., None] * h
        else:
            alpha = seg.segment_softmax(scores, gb.receivers, n,
                                        mask=gb.edge_mask)
            agg = seg.segment_sum(alpha[..., None] * h_src * emask[..., None],
                                  gb.receivers, n)
        out = (agg.reshape(agg.shape[:-2] + (H * Fh,)) if self.concat
               else agg.mean(dim=-2))
        out = out + self.bias
        if self.activation:
            out = ACTIVATIONS[self.activation](out)
        return out


class GatedGCNLayer(nn.Module):
    """Residual gated graph conv (Bresson & Laurent):
    e' = D h_src + E h_dst + C e; h' = A h + sum sigma(e') * B h_src /
    (sum sigma(e') + 1e-6), then graph norm, BatchNorm over the real nodes
    (bn_h) and the real edges (bn_e), ReLU, the residual on h and e, then
    dropout on both.

    Under the `pallas_tile` backend on a tiled batch the gate goes through
    `gatedgcn_gate_tiled` (kernel K4 on CUDA tensors, its plain version on
    CPU ones), as the JAX layer engages its fused kernel there; otherwise
    through the reference form.  That call is the region `gate` of a train
    step that records device spans (utils/profiling.py: `mark`).  Submodule names are the flax ones: `A`-`E`,
    `bn_h`, `bn_e`.
    """

    def __init__(self, in_dim: int, features: int, batch_norm: bool = True,
                 residual: bool = False, graph_norm: bool = True,
                 dropout: float = 0.0, rng=None):
        super().__init__()
        self.drop = Dropout(dropout, rng)
        self.batch_norm = batch_norm
        self.residual = residual
        self.graph_norm = graph_norm
        for name in "ABCDE":
            self.add_module(name, Linear(in_dim, features))
        if batch_norm:
            self.bn_h = MaskedBatchNorm(features)
            self.bn_e = MaskedBatchNorm(features)

    def forward(self, gb, h, e, snorm_n=None):
        refuse_dense(gb, "GatedGCNLayer")
        h_in, e_in = h, e
        Ah, Bh, Dh, Eh = (getattr(self, m)(h) for m in "ABDE")
        Ce = self.C(e)
        if "mp_send_idx" in gb.extras:
            # a model-parallel shard: one exchange of h, then B and D of the
            # received rows appended, so that senders >= shard_n read them
            from ..parallel.mp_halo import mp_exchange
            halo_h = mp_exchange(h, gb.extras["mp_send_idx"])
            Bh = torch.cat([Bh, self.B(halo_h)])
            Dh = torch.cat([Dh, self.D(halo_h)])
        if (seg.get_agg_backend() == "pallas_tile"
                and "tile_starts" in gb.extras):
            bn = gb.num_nodes // gb.extras["tile_starts"].shape[0]
            Bh, Dh, Eh, Ce = mark("gate", True, Bh, Dh, Eh, Ce)
            agg, e_new = mark("gate", False, *gatedgcn_gate_tiled(
                Bh, Dh, Eh, Ce, gb.senders, gb.receivers, gb.edge_mask,
                gb.extras["tile_starts"], gb.extras["tile_ends"],
                gb.num_nodes, bn, batch_csr(gb)))
        else:
            agg, e_new = gatedgcn_gate_reference(
                Bh, Dh, Eh, Ce, gb.senders, gb.receivers, gb.edge_mask,
                gb.num_nodes)
        h_new = Ah + agg
        if self.graph_norm and snorm_n is not None:
            h_new = h_new * snorm_n
        if self.batch_norm:
            h_new = self.bn_h(h_new, mask=gb.node_mask)
            e_new = self.bn_e(e_new, mask=gb.edge_mask)
        h_new, e_new = torch.relu(h_new), torch.relu(e_new)
        if self.residual and h_in.shape == h_new.shape:
            h_new = h_in + h_new
            e_new = e_in + e_new
        return self.drop(h_new), self.drop(e_new)


class GatedGCNLSPELayer(nn.Module):
    """GatedGCN layer with learnable structural and positional channels
    (LSPE, Dwivedi et al. eqs. 9-11), as the JAX package completes the
    reference's undefined class:

        ehat_ij = B1 h_i + B2 h_j + B3 e_ij ;  eta = sigma(ehat)
        h_i' = h_i + ReLU(BN(A1 [h_i||p_i] + sum_j eta A2 [h_j||p_j]
                               / (sum_j eta + 1e-6)))
        p_i' = p_i + tanh(C1 p_i + sum_j eta C2 p_j / (sum_j eta + 1e-6))
        e_ij' = e_ij + ReLU(BN(ehat_ij))

    then dropout on h and e.  The sums go through `graph.segment.
    segment_sum` (the one-hot backend where that is set), not the fused
    gate kernel: the JAX layer engages none.  Submodule names are the flax
    ones: `A1 A2 B1 B2 B3 C1 C2`, `bn_h`, `bn_e`.
    """

    def __init__(self, in_dim: int, features: int, batch_norm: bool = True,
                 residual: bool = True, dropout: float = 0.0, rng=None):
        super().__init__()
        self.drop = Dropout(dropout, rng)
        self.batch_norm = batch_norm
        self.residual = residual
        for name in ("A1", "A2"):
            self.add_module(name, Linear(2 * in_dim, features))
        for name in ("B1", "B2", "B3", "C1", "C2"):
            self.add_module(name, Linear(in_dim, features))
        if batch_norm:
            self.bn_h = MaskedBatchNorm(features)
            self.bn_e = MaskedBatchNorm(features)

    def forward(self, gb, h, p, e):
        refuse_dense(gb, "GatedGCNLSPELayer")
        h_in, p_in, e_in = h, p, e
        hp = torch.cat([h, p], dim=-1)
        src, dst = gb.senders.long(), gb.receivers.long()
        n = gb.num_nodes
        A2hp = src_features(self.A2(hp), gb)
        C2p = src_features(self.C2(p), gb)
        e_new = (self.B1(h)[dst] + src_features(self.B2(h), gb)[src]
                 + self.B3(e))
        eta = torch.sigmoid(e_new) * gb.edge_mask[:, None]
        sum_eta = seg.segment_sum(eta, gb.receivers, n) + 1e-6
        h_new = self.A1(hp) + seg.segment_sum(
            eta * A2hp[src], gb.receivers, n) / sum_eta
        p_new = self.C1(p) + seg.segment_sum(
            eta * C2p[src], gb.receivers, n) / sum_eta
        if self.batch_norm:
            h_new = self.bn_h(h_new, mask=gb.node_mask)
            e_new = self.bn_e(e_new, mask=gb.edge_mask)
        h_new, e_new = torch.relu(h_new), torch.relu(e_new)
        p_new = torch.tanh(p_new)
        if self.residual and h_in.shape == h_new.shape:
            h_new = h_in + h_new
            e_new = e_in + e_new
            p_new = p_in + p_new
        return self.drop(h_new), p_new, self.drop(e_new)


PNA_EPS = 1e-5
_MOMENTS = ("std", "var", "moment3", "moment4", "moment5")


def pna_aggregate(msg, gb, aggregators: Sequence[str]):
    """PNA's aggregators over the real edges into each destination, from
    masked segment sums (no neighbour mailbox): mean, sum, max, min (0 for
    a node with no real in-edge), var = relu(E[m^2] - E[m]^2), std =
    sqrt(var + PNA_EPS) and the centred moments 3-5 as
    sign(M_n) (|M_n| + PNA_EPS)^(1/n).  Returns (the list, deg [N, 1]),
    deg the real in-degree clamped at >= 1."""
    recv, n = gb.receivers, gb.num_nodes
    E = gb.edge_mask[:, None]
    deg = torch.clamp(seg.segment_sum(gb.edge_mask, recv, n), min=1.0)[:, None]
    s1 = seg.segment_sum(msg * E, recv, n)
    mean = s1 / deg
    if any(a in _MOMENTS for a in aggregators):
        s2 = seg.segment_sum(msg * msg * E, recv, n)
        var = torch.relu(s2 / deg - mean * mean)
    outs = []
    for a in aggregators:
        if a == "mean":
            outs.append(mean)
        elif a == "sum":
            outs.append(s1)
        elif a == "max":
            outs.append(seg.segment_max(msg, recv, n, mask=gb.edge_mask))
        elif a == "min":
            outs.append(seg.segment_min(msg, recv, n, mask=gb.edge_mask))
        elif a == "var":
            outs.append(var)
        elif a == "std":
            outs.append(torch.sqrt(var + PNA_EPS))
        elif a in ("moment3", "moment4", "moment5"):
            k = int(a[-1])
            centred = msg - mean.index_select(0, recv.long())
            mk = seg.segment_sum(centred ** k * E, recv, n) / deg
            outs.append(torch.sign(mk) * (torch.abs(mk) + PNA_EPS) ** (1.0 / k))
        else:
            raise ValueError(f"unknown aggregator {a!r}")
    return outs, deg


def pna_scale(h, deg, avg_d_log: float, scalers: Sequence[str]):
    """PNA's degree scalers of h: identity, amplification log(d + 1) /
    avg_d_log and attenuation avg_d_log / max(log(d + 1), 1e-6)."""
    logd = torch.log(deg + 1.0)
    outs = []
    for s in scalers:
        if s == "identity":
            outs.append(h)
        elif s == "amplification":
            outs.append(h * (logd / avg_d_log))
        elif s == "attenuation":
            outs.append(h * (avg_d_log / torch.clamp(logd, min=1e-6)))
        else:
            raise ValueError(f"unknown scaler {s!r}")
    return outs


def _pna_message(gb, h, e, edge_features: bool):
    """[h_src, h_dst(, e)] per edge: the pretrans input."""
    parts = [src_features(h, gb).index_select(0, gb.senders.long()),
             h.index_select(0, gb.receivers.long())]
    if edge_features:
        parts.append(e)
    return torch.cat(parts, dim=-1)


class PNATower(nn.Module):
    """One PNA tower over h [N, in_dim]: the pretrans MLP on [h_src, h_dst
    (, e)] (e the whole bond embedding, edge_dim wide), the aggregators
    times the scalers, the posttrans MLP on [h, those], then graph norm
    (times snorm), the masked BN `bn` and dropout.  Names: `pretrans`,
    `posttrans` (MLPs, `lin_i`) and `bn`, as in flax."""

    def __init__(self, in_dim: int, features: int, edge_dim: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 avg_d_log: float, dropout: float = 0.0,
                 graph_norm: bool = True, batch_norm: bool = True,
                 edge_features: bool = False, pretrans_layers: int = 1,
                 posttrans_layers: int = 1, rng=None):
        super().__init__()
        self.aggregators, self.scalers = tuple(aggregators), tuple(scalers)
        self.avg_d_log = avg_d_log
        self.graph_norm = graph_norm
        self.batch_norm = batch_norm
        self.edge_features = edge_features
        z_dim = 2 * in_dim + (edge_dim if edge_features else 0)
        self.pretrans = MLP(z_dim, in_dim, in_dim, pretrans_layers)
        post_in = in_dim * (1 + len(self.aggregators) * len(self.scalers))
        self.posttrans = MLP(post_in, features, features, posttrans_layers)
        if batch_norm:
            self.bn = MaskedBatchNorm(features)
        self.drop = Dropout(dropout, rng)

    def forward(self, gb, h, e, snorm_n=None):
        msg = self.pretrans(_pna_message(gb, h, e, self.edge_features))
        aggs, deg = pna_aggregate(msg, gb, self.aggregators)
        hcat = torch.cat(pna_scale(torch.cat(aggs, dim=-1), deg,
                                   self.avg_d_log, self.scalers), dim=-1)
        out = self.posttrans(torch.cat([h, hcat], dim=-1))
        if self.graph_norm and snorm_n is not None:
            out = out * snorm_n
        if self.batch_norm:
            out = self.bn(out, mask=gb.node_mask)
        return self.drop(out)


class PNALayer(nn.Module):
    """Towers `tower_{t}` over h (each over its in_dim // towers slice with
    `divide_input`, else over all of h), features // towers wide each, then
    the `mixing` Linear, leaky ReLU (slope 0.01) and the residual where the
    shapes match."""

    def __init__(self, in_dim: int, features: int, edge_dim: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 avg_d_log: float, towers: int = 1, dropout: float = 0.0,
                 graph_norm: bool = True, batch_norm: bool = True,
                 residual: bool = False, edge_features: bool = False,
                 divide_input: bool = True, pretrans_layers: int = 1,
                 posttrans_layers: int = 1, rng=None):
        super().__init__()
        self.towers = towers
        self.residual = residual
        self.divide_input = divide_input
        self.tower_in = in_dim // towers if divide_input else in_dim
        tower_out = features // towers
        for t in range(towers):
            self.add_module(f"tower_{t}", PNATower(
                self.tower_in, tower_out, edge_dim, aggregators, scalers,
                avg_d_log, dropout=dropout, graph_norm=graph_norm,
                batch_norm=batch_norm, edge_features=edge_features,
                pretrans_layers=pretrans_layers,
                posttrans_layers=posttrans_layers, rng=rng))
        self.mixing = Linear(towers * tower_out, features)

    def forward(self, gb, h, e, snorm_n=None):
        refuse_dense(gb, "PNALayer")
        w = self.tower_in
        outs = [getattr(self, f"tower_{t}")(
            gb, h[:, t * w:(t + 1) * w] if self.divide_input else h, e,
            snorm_n) for t in range(self.towers)]
        out = F.leaky_relu(self.mixing(torch.cat(outs, dim=-1)), 0.01)
        if self.residual and h.shape == out.shape:
            out = h + out
        return out


class PNANoTowersLayer(nn.Module):
    """The towerless PNA layer, with the reference's quirks: dropout on the
    input first; the pretrans MLP `pretrans_h` runs only with edge
    features (without, the messages are the raw source rows and posttrans
    sees the aggregations alone); the scalers apply only when there are
    more than one; graph norm only with edge features; then `bn_h`, ReLU
    and the residual where the shapes match."""

    def __init__(self, in_dim: int, features: int, edge_dim: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 avg_d_log: float, dropout: float = 0.0,
                 graph_norm: bool = True, batch_norm: bool = True,
                 residual: bool = True, edge_features: bool = False,
                 pretrans_layers: int = 1, posttrans_layers: int = 1,
                 rng=None):
        super().__init__()
        self.aggregators, self.scalers = tuple(aggregators), tuple(scalers)
        self.avg_d_log = avg_d_log
        self.graph_norm = graph_norm
        self.batch_norm = batch_norm
        self.residual = residual
        self.edge_features = edge_features
        self.drop = Dropout(dropout, rng)
        if edge_features:
            self.pretrans_h = MLP(2 * in_dim + edge_dim, in_dim, in_dim,
                                  pretrans_layers)
        n_scale = len(self.scalers) if len(self.scalers) > 1 else 1
        post_in = (in_dim * len(self.aggregators) * n_scale
                   + (in_dim if edge_features else 0))
        self.posttrans_h = MLP(post_in, features, features, posttrans_layers)
        if batch_norm:
            self.bn_h = MaskedBatchNorm(features)

    def forward(self, gb, h, e, snorm_n=None):
        refuse_dense(gb, "PNANoTowersLayer")
        h = self.drop(h)
        if self.edge_features:
            msg = self.pretrans_h(_pna_message(gb, h, e, True))
        else:
            msg = src_features(h, gb).index_select(0, gb.senders.long())
        aggs, deg = pna_aggregate(msg, gb, self.aggregators)
        hcat = torch.cat(aggs, dim=-1)
        if len(self.scalers) > 1:
            hcat = torch.cat(pna_scale(hcat, deg, self.avg_d_log,
                                       self.scalers), dim=-1)
        if self.edge_features:
            hcat = torch.cat([h, hcat], dim=-1)
        out = self.posttrans_h(hcat)
        if self.graph_norm and self.edge_features and snorm_n is not None:
            out = out * snorm_n
        if self.batch_norm:
            out = self.bn_h(out, mask=gb.node_mask)
        out = torch.relu(out)
        if self.residual and h.shape == out.shape:
            out = h + out
        return out


class SimplifiedPNAConv(nn.Module):
    """PyG-style simplified PNA: `pre_nn` on [x_i, x_j, e] per edge, the
    `aggregators` over each destination's real edges, an in-degree
    embedding `deg_embedder` (degrees clipped to max_degree - 1), then
    `post_nn` on [x, aggregates, degree embedding].  `edge_features` is
    the width of edge_attr (0 without)."""

    def __init__(self, in_features: int, features: int,
                 aggregators: Sequence[str] = ("mean",),
                 max_degree: int = 13, edge_features: int = 0):
        super().__init__()
        self.aggregators = tuple(aggregators)
        self.max_degree = max_degree
        nin = in_features
        self.pre_nn = ElementsMLP(2 * nin + edge_features, nin, num_layers=2,
                                  with_final_activation=False)
        self.deg_embedder = Embedding(max_degree, nin)
        self.post_nn = ElementsMLP((2 + len(self.aggregators)) * nin,
                                   features, num_layers=2,
                                   with_final_activation=False)

    def forward(self, gb, x, edge_attr=None):
        refuse_dense(gb, "SimplifiedPNAConv")
        x_src = src_features(x, gb)
        z = [x.index_select(0, gb.receivers.long()),
             x_src.index_select(0, gb.senders.long())]
        if edge_attr is not None:
            z.append(edge_attr)
        msg = self.pre_nn(torch.cat(z, dim=-1))
        aggs, _ = pna_aggregate(msg, gb, self.aggregators)
        deg = seg.segment_sum(gb.edge_mask, gb.receivers, gb.num_nodes)
        deg_emb = self.deg_embedder(
            torch.clamp(deg.long(), 0, self.max_degree - 1))
        return self.post_nn(torch.cat([x] + aggs + [deg_emb], dim=-1))


class GraphTransformerAttention(nn.Module):
    """Sparse edge-score attention: Q/K/V (and E) projections, then the
    clamped-exp edge softmax and value aggregation.

    Under the `pallas_tile` or `tile_dense` backend on a tiled batch it goes
    through `edge_softmax_attention_tiled` (kernels K2/K3 on CUDA tensors,
    their plain version on CPU ones), as the JAX layer engages its fused
    kernel there on any backend but the CPU; otherwise through the
    reference form, where every edge counts.

    With `full_graph` (batches of complete graphs whose `edge_real` extra
    flags the graph's own edges) it never takes the kernels' path: with
    `use_edge` a real edge scores K_src . Q_dst * E1 and a fake one
    K2_src . Q2_dst * E2 (projections `Q_2`, `K_2`, `E_2`); the clamped
    exp is divided by gamma + 1 on a real edge and multiplied by
    gamma / (gamma + 1) on a fake one, gamma a learnt scalar from 0.1,
    clipped to [0, 1].
    """

    def __init__(self, in_dim: int, out_dim: int, num_heads: int,
                 use_edge: bool = False, full_graph: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.out_dim = out_dim
        self.use_edge = use_edge
        self.full_graph = full_graph
        width = num_heads * out_dim
        # no biases, as on every JAX path that builds this layer
        self.Q = Linear(in_dim, width, use_bias=False)
        self.K = Linear(in_dim, width, use_bias=False)
        self.V = Linear(in_dim, width, use_bias=False)
        if use_edge:
            self.E = Linear(in_dim, width, use_bias=False)
        if use_edge and full_graph:
            self.Q_2 = Linear(in_dim, width, use_bias=False)
            self.K_2 = Linear(in_dim, width, use_bias=False)
            self.E_2 = Linear(in_dim, width, use_bias=False)
        if full_graph:
            self.gamma = nn.Parameter(torch.full((), 0.1))

    def _full_graph(self, gb, h, e, q, k, v, halo_h):
        H, D = self.num_heads, self.out_dim
        s, r = gb.senders.long(), gb.receivers.long()
        real = gb.extras["edge_real"][:, None, None] > 0
        score = k[s] * q[r] / math.sqrt(D)
        if self.use_edge:
            e1, e2 = (m(e).reshape(-1, H, D) for m in (self.E, self.E_2))
            q2, k2 = (m(h).reshape(-1, H, D) for m in (self.Q_2, self.K_2))
            if halo_h is not None:
                k2 = torch.cat([k2, self.K_2(halo_h).reshape(-1, H, D)])
            score = torch.where(real, score * e1,
                                k2[s] * q2[r] / math.sqrt(D) * e2)
        ex = torch.exp(torch.clamp(score.sum(-1, keepdim=True), -5.0, 5.0))
        gamma = torch.clamp(self.gamma, 0.0, 1.0)
        ex = torch.where(real, ex / (gamma + 1.0),
                         gamma * ex / (gamma + 1.0))
        ex = ex * gb.edge_mask[:, None, None].to(ex.dtype)
        wv = seg.segment_sum(ex * v[s], gb.receivers, gb.num_nodes)
        z = seg.segment_sum(ex, gb.receivers, gb.num_nodes)
        return wv / (z + 1e-6)

    def forward(self, gb, h, e):
        refuse_dense(gb, "GraphTransformerAttention")
        H, D = self.num_heads, self.out_dim
        q, k, v = (m(h).reshape(-1, H, D) for m in (self.Q, self.K, self.V))
        halo_h = None
        if "mp_send_idx" in gb.extras:
            # a model-parallel shard: one exchange of h, its rows projected
            # by K and V (and K_2) and appended for the sender gathers; the
            # softmax needs no collective, as every in-edge of a local node
            # is local (the halo covers a full graph's fake edges too)
            from ..parallel.mp_halo import mp_exchange
            halo_h = mp_exchange(h, gb.extras["mp_send_idx"])
            k = torch.cat([k, self.K(halo_h).reshape(-1, H, D)])
            v = torch.cat([v, self.V(halo_h).reshape(-1, H, D)])
        if self.full_graph:
            return self._full_graph(gb, h, e, q, k, v, halo_h)
        if self.use_edge:
            e1 = self.E(e).reshape(-1, H, D)
        else:
            e1 = torch.ones((gb.num_edges, H, D), dtype=q.dtype,
                            device=q.device)
        if (seg.get_agg_backend() in ("pallas_tile", "tile_dense")
                and "tile_starts" in gb.extras):
            starts = gb.extras["tile_starts"]
            bn = gb.num_nodes // starts.shape[0]
            return edge_softmax_attention_tiled(
                q, k, v, e1, gb.senders, gb.receivers, gb.edge_mask, starts,
                gb.extras["tile_ends"], bn, batch_csr(gb))
        return edge_softmax_attention_reference(
            q, k, v, e1, gb.senders, gb.receivers, gb.edge_mask,
            gb.num_nodes)


class GraphTransformerLayer(nn.Module):
    """Attention, O projection and FFN with LayerNorm/BatchNorm and
    residuals; dropout after the attention and after the FFN's ReLU.
    Submodule names are the flax ones: `attention.{Q,K,V,E}`, `O_h`, `ln1`,
    `bn1`, `ffn1`, `ffn2`, `ln2`, `bn2`."""

    def __init__(self, features: int, num_heads: int, layer_norm: bool = False,
                 batch_norm: bool = True, residual: bool = True,
                 use_edge: bool = False, dropout: float = 0.0, rng=None,
                 full_graph: bool = False):
        super().__init__()
        self.drop = Dropout(dropout, rng)
        self.features = features
        self.layer_norm = layer_norm
        self.batch_norm = batch_norm
        self.residual = residual
        self.attention = GraphTransformerAttention(
            features, features // num_heads, num_heads, use_edge=use_edge,
            full_graph=full_graph)
        self.O_h = Linear(features, features)
        self.ffn1 = Linear(features, 2 * features)
        self.ffn2 = Linear(2 * features, features)
        for i in (1, 2):
            if layer_norm:
                self.add_module(f"ln{i}", MaskedLayerNorm(features))
            if batch_norm:
                self.add_module(f"bn{i}", MaskedBatchNorm(features))

    def _norms(self, gb, h, i: int):
        if self.layer_norm:
            h = getattr(self, f"ln{i}")(h, mask=gb.node_mask)
        if self.batch_norm:
            h = getattr(self, f"bn{i}")(h, mask=gb.node_mask)
        return h

    def forward(self, gb, h, e):
        h_in1 = h
        h = self.drop(self.attention(gb, h, e).reshape(-1, self.features))
        h = self.O_h(h)
        if self.residual:
            h = h_in1 + h
        h = self._norms(gb, h, 1)
        h_in2 = h
        h = self.ffn2(self.drop(torch.relu(self.ffn1(h))))
        if self.residual:
            h = h_in2 + h
        return self._norms(gb, h, 2)
