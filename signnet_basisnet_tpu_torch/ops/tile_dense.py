"""Tile-dense aggregation: the block adjacency built once, applied per layer.

Port of signnet_basisnet_tpu/ops/tile_dense.py (plain XLA there, plain torch
here; it holds no TPU kernel).  `tile_block_adj` scatters the edge weights
into a [T, bn, bn] block-diagonal adjacency; `spmm_tile_dense` applies it
with a batched matmul, trailing dims carried.  Same tile-locality contract as
ops/spmm_tiled.py: edges whose source lies outside the destination's tile
are dropped.  In f32 the matmul runs in full f32 (no TF32).
"""
from __future__ import annotations

import torch


def tile_block_adj(senders, receivers, edge_mask, num_nodes: int, bn: int,
                   dtype=torch.float32):
    """[T, bn, bn]: A[t, i, j] = sum of edge weights with dst = t*bn + i and
    src = t*bn + j."""
    r = receivers.long()
    col = senders.long() - (r // bn) * bn
    ok = ((col >= 0) & (col < bn)).to(edge_mask.dtype)
    w = (edge_mask * ok).to(dtype)
    adj = torch.zeros((num_nodes, bn), dtype=dtype, device=edge_mask.device)
    adj.index_put_((r, torch.clamp(col, 0, bn - 1)), w, accumulate=True)
    return adj.reshape(num_nodes // bn, bn, bn)


def spmm_tile_dense(x, senders, receivers, weights, num_nodes: int, bn: int):
    """out[n] = sum_{e: dst_e = n} w_e * x[src_e] through the block
    adjacency; x: [N, ...] with any trailing dims, returns the same shape."""
    adj = tile_block_adj(senders, receivers, weights, num_nodes, bn,
                         dtype=x.dtype)
    xt = x.reshape(num_nodes // bn, bn, -1)
    out = torch.matmul(adj, xt)
    return out.reshape(x.shape)
