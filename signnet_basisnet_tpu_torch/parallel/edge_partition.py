"""Edge-partitioned message passing: model parallelism for huge graphs.

Port of signnet_basisnet_tpu/parallel/edge_partition.py onto
`torch.distributed`, one process per rank.  Where the JAX functions take
global arrays that `shard_map` splits, each rank here passes its own block
of them, the one shard_map would hand its device:

- `edge_sharded_aggregate`: node features replicated; each rank gathers
  its slice of the edge array (E / size edges; `pad_edges_for` pads E to a
  multiple of the size) and sums its messages into a partial node
  accumulator; one sum over the group (JAX `psum`) combines the partials.
- Destination-partitioned: nodes in [N / size] shards, each rank owning the
  edges whose destination is local (`partition_edges_by_dst` builds the
  per-rank edge shards on the host).  `halo_edge_aggregate` all-gathers
  the node shards (N * D / size values a rank per hop) and sums into the
  owned shard; `tile_aligned_aggregate`, for tile-local layouts whose shard
  boundaries fall on tile boundaries, needs no collective at all.

The aggregates are differentiable: the sum's gradient is the sum of the
ranks' gradients, the all-gather's the rank's block of that sum.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..graph import segment as seg
from .mp_halo import mp_psum


def pad_edges_for(mesh_axis_size: int, arrays: dict) -> dict:
    """Pad senders/receivers/edge_mask to a multiple of the axis size."""
    E = arrays["senders"].shape[0]
    target = -(-E // mesh_axis_size) * mesh_axis_size
    if target == E:
        return arrays
    pad = target - E
    out = dict(arrays)
    for key in ("senders", "receivers"):
        out[key] = np.concatenate(
            [arrays[key], np.full(pad, arrays[key].max(), arrays[key].dtype)])
    for key in ("edge_mask",):
        out[key] = np.concatenate([arrays[key], np.zeros(pad, np.float32)])
    return out


def edge_sharded_aggregate(group: Optional[dist.ProcessGroup] = None):
    """Returns aggregate(x, senders, receivers, edge_mask, num_nodes): x
    [N, D] the same on every rank, the edge arrays this rank's slice; the
    node sums over every rank's edges, on every rank."""
    group = group or dist.group.WORLD

    def aggregate(x, senders, receivers, edge_mask, num_nodes: int):
        msg = x.index_select(0, senders.long()) * edge_mask[:, None]
        return mp_psum(seg.segment_sum(msg, receivers, num_nodes), group)

    return aggregate


def partition_edges_by_dst(arrays: dict, mp: int) -> dict:
    """Split a batch's (dst-sorted) edges into `mp` per-rank shards.

    Returns senders/receivers/edge_mask reshaped to [mp, E_shard] with
    per-shard padding (zero-mask self-edges on the rank's first node), so
    every rank's shard has one static shape.
    """
    N = arrays["node_mask"].shape[0]
    if N % mp != 0:
        raise ValueError(f"num_nodes {N} not divisible by mp={mp}")
    shard_n = N // mp
    senders = np.asarray(arrays["senders"])
    receivers = np.asarray(arrays["receivers"])
    emask = np.asarray(arrays["edge_mask"])
    bounds = np.searchsorted(receivers, np.arange(mp + 1) * shard_n)
    e_shard = int(-(-max((bounds[1:] - bounds[:-1]).max(), 1) // 8) * 8)
    S = np.zeros((mp, e_shard), np.int32)
    R = np.zeros((mp, e_shard), np.int32)
    M = np.zeros((mp, e_shard), np.float32)
    for d in range(mp):
        lo, hi = bounds[d], bounds[d + 1]
        n = hi - lo
        S[d, :n] = senders[lo:hi]
        R[d, :n] = receivers[lo:hi]
        M[d, :n] = emask[lo:hi]
        S[d, n:] = d * shard_n      # padding: in-shard self-edge, zero mask
        R[d, n:] = d * shard_n
    return {"senders": S, "receivers": R, "edge_mask": M}


class _AllGather(torch.autograd.Function):
    """The ranks' blocks concatenated along axis 0; the gradient of a
    rank's block is its block of the gradients summed over the ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g.chunk(dist.get_world_size(ctx.group))[
            dist.get_rank(ctx.group)], None


def halo_edge_aggregate(group: Optional[dist.ProcessGroup] = None):
    """Destination-partitioned aggregation with an all-gather boundary
    exchange: aggregate(x_shard [N/size, D], senders, receivers,
    edge_mask) with this rank's edge shard of `partition_edges_by_dst`
    (global node indices) -> this rank's [N/size, D] rows."""
    group = group or dist.group.WORLD

    def aggregate(x_shard, senders, receivers, edge_mask):
        shard_n = x_shard.shape[0]
        x_full = _AllGather.apply(x_shard, group)
        msg = x_full.index_select(0, senders.long()) * edge_mask[:, None]
        local_dst = receivers - dist.get_rank(group) * shard_n
        return seg.segment_sum(msg, local_dst, shard_n)

    return aggregate


def tile_aligned_aggregate(group: Optional[dist.ProcessGroup] = None):
    """Zero-collective destination-partitioned aggregation for tile-local
    layouts: every edge's endpoints lie in the same node shard (true when
    the batch was packed with batch_np(tile=bn) and N/size is a multiple of
    bn).  Same arguments and result as `halo_edge_aggregate`'s."""
    group = group or dist.group.WORLD

    def aggregate(x_shard, senders, receivers, edge_mask):
        shard_n = x_shard.shape[0]
        base = dist.get_rank(group) * shard_n
        msg = (x_shard.index_select(0, (senders - base).long())
               * edge_mask[:, None])
        return seg.segment_sum(msg, receivers - base, shard_n)

    return aggregate
