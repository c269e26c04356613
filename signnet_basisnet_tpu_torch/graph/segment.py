"""Segment reductions — the message-passing primitives.

Port of signnet_basisnet_tpu/graph/segment.py onto `index_add` and
`scatter_reduce` (`segment_sum`, `segment_mean`, `segment_max`,
`segment_min`, `segment_softmax`), with the JAX module's two switches: the sum backend
(`set_sum_backend`: 'xla', index_add, or 'onehot', a product with a
one-hot matrix built on the device by comparison, never syncing the host:
ops/segment_matmul.py) and the neighbor-aggregation backend
(`set_agg_backend`).  All functions take a static `num_segments` and never
produce NaNs on empty segments: means divide by max(count, 1), max and min
return `empty_value` for a segment with no (unmasked) entries, and the
softmax divides by max(denominator, 1e-16).  A tied max or min shares its
gradient evenly among the tied entries, as the JAX reductions do.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch

# Large-but-finite stand-in for -inf: masked entries never win a max, and a
# segment whose max stays at the sentinel is empty.
_NEG_BIG = -1e30

# Backend for sum reductions (segment_sum): 'xla' (index_add) or 'onehot'
# (onehot(ids)^T @ data as one matmul).  The names are the JAX package's.
_SUM_BACKEND = "xla"


def set_sum_backend(name: str) -> None:
    global _SUM_BACKEND
    if name not in ("xla", "onehot"):
        raise ValueError(name)
    _SUM_BACKEND = name


def get_sum_backend() -> str:
    return _SUM_BACKEND

# Backend for neighbor aggregation (models/conv.neighbor_sum):
# 'xla' (the flat path: gather + index_add_), 'pallas_tile' (the tile-local
# SpMM kernel of ops/spmm_tiled.py; its plain version on CPU tensors) or
# 'tile_dense' (ops/tile_dense.py: block adjacency + batched matmul).
# The names are the JAX package's, so its configs run unchanged.
_AGG_BACKEND = "xla"


def set_agg_backend(name: str) -> None:
    global _AGG_BACKEND
    if name not in ("xla", "pallas_tile", "tile_dense"):
        raise ValueError(name)
    _AGG_BACKEND = name


def get_agg_backend() -> str:
    return _AGG_BACKEND


def _bcast(w: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return w.reshape(w.shape + (1,) * (data.dim() - w.dim()))


def segment_sum(data, segment_ids, num_segments):
    if _SUM_BACKEND == "onehot" and data.dim() >= 2:
        # trailing axes fold into the feature dim, as in the JAX branch
        # (imported here: ops imports this module)
        from ..ops.segment_matmul import segment_sum_onehot
        flat = data.reshape(data.shape[0], -1)
        out = segment_sum_onehot(flat, segment_ids, num_segments)
        return out.reshape((num_segments,) + tuple(data.shape[1:]))
    out = zeros_for(data, (num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids.long(), data)


def is_dtensor(t) -> bool:
    """Whether `t` is a DTensor (parallel/gspmd.py).  Only a process that
    imported torch.distributed.tensor can hold one, so a process that did
    not is spared that import (seconds, in every process it would start)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def zeros_for(data, shape):
    """The zero accumulator of a sum of `data` into `shape`: on a DTensor
    (parallel/gspmd.py) a `Partial` one on `data`'s mesh, each rank's zeros,
    which the out-of-place `index_add` of a sharded source keeps `Partial`
    (an in-place op cannot change its placement)."""
    if is_dtensor(data):
        from torch.distributed.tensor import DTensor, Partial
        local = torch.zeros(shape, dtype=data.dtype, device=data.device)
        return DTensor.from_local(local, data.device_mesh,
                                  [Partial()] * data.device_mesh.ndim,
                                  run_check=False)
    return data.new_zeros(shape)


def segment_mean(data, segment_ids, num_segments,
                 weights: Optional[torch.Tensor] = None):
    """Mean over each segment; `weights` (e.g. a mask) masks entries."""
    if weights is not None:
        w = _bcast(weights, data)
        data = data * w
        ones = w.expand(data.shape[:1] + (1,) * (data.dim() - 1))
    else:
        ones = data.new_ones(data.shape[:1] + (1,) * (data.dim() - 1))
    s = segment_sum(data, segment_ids, num_segments)
    c = segment_sum(ones, segment_ids, num_segments)
    return s / torch.clamp(c, min=1.0)


def segment_max(data, segment_ids, num_segments,
                mask: Optional[torch.Tensor] = None, empty_value=0.0):
    """Max over segments; empty segments yield `empty_value`."""
    if mask is not None:
        data = torch.where(_bcast(mask, data) > 0, data,
                           torch.full_like(data, _NEG_BIG))
    idx = _bcast(segment_ids.long(), data).expand_as(data)
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), _NEG_BIG)
    out = out.scatter_reduce(0, idx, data, reduce="amax", include_self=True)
    return torch.where(out <= _NEG_BIG / 2, torch.full_like(out, empty_value),
                       out)


def segment_min(data, segment_ids, num_segments,
                mask: Optional[torch.Tensor] = None, empty_value=0.0):
    """Min over segments; empty segments yield `empty_value`."""
    if mask is not None:
        data = torch.where(_bcast(mask, data) > 0, data,
                           torch.full_like(data, -_NEG_BIG))
    idx = _bcast(segment_ids.long(), data).expand_as(data)
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), -_NEG_BIG)
    out = out.scatter_reduce(0, idx, data, reduce="amin", include_self=True)
    return torch.where(out >= -_NEG_BIG / 2, torch.full_like(out, empty_value),
                       out)


def segment_softmax(scores, segment_ids, num_segments,
                    mask: Optional[torch.Tensor] = None):
    """Per-segment softmax, stable: the segment's (masked) max is
    subtracted first (0 for an empty segment), masked entries get 0, and
    the denominator is at least 1e-16."""
    ids = segment_ids.long()
    maxes = segment_max(scores, segment_ids, num_segments, mask=mask,
                        empty_value=0.0)
    ex = torch.exp(scores - maxes[ids])
    if mask is not None:
        ex = ex * _bcast(mask, ex)
    denom = segment_sum(ex, segment_ids, num_segments)
    return ex / torch.clamp(denom, min=1e-16)[ids]


def aggregate_edges(edge_msg, receivers, num_nodes, edge_mask=None,
                    reduce="sum"):
    """Reduce edge messages into destination nodes (the SpMM scatter half)."""
    if edge_mask is not None and reduce in ("sum", "mean"):
        edge_msg = edge_msg * _bcast(edge_mask, edge_msg)
    if reduce == "sum":
        return segment_sum(edge_msg, receivers, num_nodes)
    if reduce == "mean":
        return segment_mean(edge_msg, receivers, num_nodes, weights=edge_mask)
    if reduce == "max":
        return segment_max(edge_msg, receivers, num_nodes, mask=edge_mask)
    raise ValueError(f"unknown reduce {reduce!r}")


def pool_nodes(node_feat, graph_id, num_graphs, node_mask=None, reduce="sum"):
    """Pool node features per graph: the readout primitive."""
    return aggregate_edges(node_feat, graph_id, num_graphs, edge_mask=node_mask,
                           reduce=reduce)
