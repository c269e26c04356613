"""Segment ops as one-hot matrix products.

Port of signnet_basisnet_tpu/ops/segment_matmul.py.  There the one-hot
product put a scatter-add on the TPU's matrix unit; here it is plain torch
(`torch.matmul`), kept so that the port's `bench_ops` can time it against
index_add_ and K5 on the card:

    out[n, d] = sum_e [segment_ids[e] == n] * msg[e, d]
              = onehot(segment_ids)^T @ msg

An id outside [0, num_segments) gives an all-zero one-hot row, as
`jax.nn.one_hot` does.
"""
from __future__ import annotations

import torch


def _one_hot(ids, n: int, dtype):
    """[len(ids), n] one-hot of `ids` in `dtype`; out-of-range ids give 0."""
    cols = torch.arange(n, device=ids.device)
    return (ids.long()[:, None] == cols).to(dtype)


def segment_sum_onehot(msg, segment_ids, num_segments):
    """out = onehot(segment_ids)^T @ msg; masked entries must already be 0."""
    return _one_hot(segment_ids, num_segments, msg.dtype).T @ msg


def gather_onehot(x, indices):
    """x[indices] as onehot(indices) @ x."""
    return _one_hot(indices, x.shape[0], x.dtype) @ x


def spmm_onehot(x, senders, receivers, edge_mask, num_nodes,
                edge_weight=None):
    """Fused gather->weight->scatter: sum_{e: dst=n} w_e * x[src_e]."""
    msg = gather_onehot(x, senders)
    w = edge_mask if edge_weight is None else edge_mask * edge_weight
    msg = msg * w[:, None]
    return segment_sum_onehot(msg, receivers, num_nodes)
