"""Graph convolution on padded batched graphs: the GIN path.

Port of signnet_basisnet_tpu/models/conv.py:26-58,104-125 (`neighbor_sum`,
`node_mask_like`, `pool_any`, `GINConv`).  The other layers of that file
(GINE, GCN, GAT, GatedGCN, PNA, Transformer) are later slices of the port
(ROADMAP.md queue 1).
"""
from __future__ import annotations

from torch import nn

from ..graph import CSR_KEYS, segment as seg
from ..ops import spmm_tile_dense, spmm_tiled


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
