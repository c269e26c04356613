"""Graph convolution on padded batched graphs: the GIN, GatedGCN and
Transformer paths.

Port of signnet_basisnet_tpu/models/conv.py:26-58,104-125 (`neighbor_sum`,
`node_mask_like`, `pool_any`, `GINConv`), :312-381 (`GatedGCNLayer`),
:384-447 (`GatedGCNLSPELayer`) and :682-811 (`GraphTransformerAttention`,
`GraphTransformerLayer`, sparse path).  The other layers of that file
(GINE, GCN, GAT, PNA) and the full-graph transformer are later slices of
the port (ROADMAP.md queue 1).
"""
from __future__ import annotations

import torch
from torch import nn

from ..graph import CSR_KEYS, segment as seg
from ..nn.dropout import Dropout
from ..nn.init import Linear
from ..nn.norm import MaskedBatchNorm, MaskedLayerNorm
from ..ops import (edge_softmax_attention_reference,
                   edge_softmax_attention_tiled, gatedgcn_gate_reference,
                   gatedgcn_gate_tiled, spmm_tile_dense, spmm_tiled)


def neighbor_sum(x, gb):
    """sum_{j in N(i)} x_j for x [N, ...].

    Backend (graph.segment.set_agg_backend) on a tiled batch: 'pallas_tile'
    goes through the tile-local SpMM (its CUDA kernel on CUDA tensors, its
    plain version on CPU ones); 'tile_dense' through the block adjacency.
    Otherwise the flat masked gather + index_add_.
    """
    backend = seg.get_agg_backend()
    if backend == "tile_dense" and "tile_starts" in gb.extras:
        bn = gb.num_nodes // gb.extras["tile_starts"].shape[0]
        return spmm_tile_dense(x, gb.senders, gb.receivers, gb.edge_mask,
                               gb.num_nodes, bn)
    if backend == "pallas_tile" and "tile_starts" in gb.extras:
        bn = gb.num_nodes // gb.extras["tile_starts"].shape[0]
        flat = x.reshape(x.shape[0], -1)
        out = spmm_tiled(flat, gb.senders, gb.receivers, gb.edge_mask,
                         gb.extras["tile_starts"], gb.extras["tile_ends"],
                         gb.num_nodes, bn, csr=batch_csr(gb))
        return out.reshape(x.shape)
    msg = x.index_select(0, gb.senders.long())
    return seg.aggregate_edges(msg, gb.receivers, gb.num_nodes,
                               edge_mask=gb.edge_mask)


def batch_csr(gb):
    """The tiled batch's (dst_ptr, src_order, src_ptr), made by
    `graph.from_arrays`."""
    return tuple(gb.extras[k] for k in CSR_KEYS)


def pool_any(gb, x, reduce="sum"):
    """Per-graph pooling of node features."""
    return seg.pool_nodes(x, gb.graph_id, gb.num_graphs,
                          node_mask=gb.node_mask, reduce=reduce)


def node_mask_like(gb, x):
    """gb's node mask broadcast to x.shape[:-1] (adds eigvec-channel axes)."""
    m = gb.node_mask
    while m.dim() < x.dim() - 1:
        m = m[..., None]
    return m.expand(x.shape[:-1])


class GINConv(nn.Module):
    """x' = mlp(x + sum_j x_j): DGL GINConv(MLP, 'sum') (the JAX GINConv with
    learn_eps=False, the only form on the ported path)."""

    def __init__(self, mlp: nn.Module):
        super().__init__()
        self.mlp = mlp

    def forward(self, gb, x):
        out = x + neighbor_sum(x, gb)
        # BN inside the MLP must ignore padding rows
        return self.mlp(out, mask=node_mask_like(gb, out))


class GatedGCNLayer(nn.Module):
    """Residual gated graph conv (Bresson & Laurent):
    e' = D h_src + E h_dst + C e; h' = A h + sum sigma(e') * B h_src /
    (sum sigma(e') + 1e-6), then graph norm, BatchNorm over the real nodes
    (bn_h) and the real edges (bn_e), ReLU, the residual on h and e, then
    dropout on both.

    Under the `pallas_tile` backend on a tiled batch the gate goes through
    `gatedgcn_gate_tiled` (kernel K4 on CUDA tensors, its plain version on
    CPU ones), as the JAX layer engages its fused kernel there; otherwise
    through the reference form.  Submodule names are the flax ones: `A`-`E`,
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
        if "mp_send_idx" in gb.extras:
            raise NotImplementedError(
                "the model-parallel halo exchange is not ported yet "
                "(ROADMAP.md queue 1 item 20)")
        h_in, e_in = h, e
        Ah, Bh, Dh, Eh = (getattr(self, m)(h) for m in "ABDE")
        Ce = self.C(e)
        if (seg.get_agg_backend() == "pallas_tile"
                and "tile_starts" in gb.extras):
            bn = gb.num_nodes // gb.extras["tile_starts"].shape[0]
            agg, e_new = gatedgcn_gate_tiled(
                Bh, Dh, Eh, Ce, gb.senders, gb.receivers, gb.edge_mask,
                gb.extras["tile_starts"], gb.extras["tile_ends"],
                gb.num_nodes, bn, batch_csr(gb))
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
        if "mp_send_idx" in gb.extras:
            raise NotImplementedError(
                "the model-parallel halo exchange is not ported yet "
                "(ROADMAP.md queue 1 item 20)")
        h_in, p_in, e_in = h, p, e
        hp = torch.cat([h, p], dim=-1)
        src, dst = gb.senders.long(), gb.receivers.long()
        n = gb.num_nodes
        A2hp, C2p = self.A2(hp), self.C2(p)
        e_new = self.B1(h)[dst] + self.B2(h)[src] + self.B3(e)
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


class GraphTransformerAttention(nn.Module):
    """Sparse edge-score attention: Q/K/V (and E) projections, then the
    clamped-exp edge softmax and value aggregation.

    Under the `pallas_tile` or `tile_dense` backend on a tiled batch it goes
    through `edge_softmax_attention_tiled` (kernels K2/K3 on CUDA tensors,
    their plain version on CPU ones), as the JAX layer engages its fused
    kernel there on any backend but the CPU; otherwise through the
    reference form, where every edge counts.
    """

    def __init__(self, in_dim: int, out_dim: int, num_heads: int,
                 use_edge: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.out_dim = out_dim
        self.use_edge = use_edge
        width = num_heads * out_dim
        # no biases, as on every JAX path that builds this layer
        self.Q = Linear(in_dim, width, use_bias=False)
        self.K = Linear(in_dim, width, use_bias=False)
        self.V = Linear(in_dim, width, use_bias=False)
        if use_edge:
            self.E = Linear(in_dim, width, use_bias=False)

    def forward(self, gb, h, e):
        H, D = self.num_heads, self.out_dim
        q, k, v = (m(h).reshape(-1, H, D) for m in (self.Q, self.K, self.V))
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
                 use_edge: bool = False, dropout: float = 0.0, rng=None):
        super().__init__()
        self.drop = Dropout(dropout, rng)
        self.features = features
        self.layer_norm = layer_norm
        self.batch_norm = batch_norm
        self.residual = residual
        self.attention = GraphTransformerAttention(
            features, features // num_heads, num_heads, use_edge=use_edge)
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
