"""Dense block-diagonal batched graphs: per-graph blocks instead of a flat
edge list.

Port of signnet_basisnet_tpu/graph/dense.py.  A batch is a stack of padded
per-graph blocks: adjacency [G, M, M] and node features [G, M, ...].
Neighbour aggregation is a batched matmul (`adj @ x`, an einsum) with no
gather or scatter; pooling is a masked sum over the node axis.  ZINC
molecules have at most 38 nodes, so the blocks are small.

`adj[g, i, j] = 1` iff edge j -> i (receiver-major), so `adj @ x` sums
source features into receivers, as `segment.aggregate_edges` does on a
flat batch.  Unlike `batch_np`, `dense_batch_np` reserves no padding
graph: padding rows and columns are masked, and graph slots past the
graphs given are all masked.

The host packer is numpy and gives the same arrays as the JAX package's;
`DenseGraphBatch` is a dataclass of torch tensors.  The layers with a
dense branch are the GIN family (`models/conv.py`); `pool_any` and the
ZINC nets' input embedding read it too.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclass
class DenseGraphBatch:
    adj: torch.Tensor                # [G, M, M] float32, receiver-major
    node_mask: torch.Tensor          # [G, M] float32
    n_node: torch.Tensor             # [G] int32
    graph_mask: torch.Tensor         # [G] float32
    node_feat: Optional[torch.Tensor] = None   # [G, M] or [G, M, F]
    edge_feat: Optional[torch.Tensor] = None   # [G, M, M] int codes
    y: Optional[torch.Tensor] = None           # [G] or [G, T]
    eigvecs: Optional[torch.Tensor] = None     # [G, M, K]
    eigvals: Optional[torch.Tensor] = None     # [G, K]
    eig_mask: Optional[torch.Tensor] = None    # [G, M, K]
    extras: Dict[str, torch.Tensor] = field(default_factory=dict)

    @property
    def num_graphs(self) -> int:
        return self.node_mask.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.node_mask.shape[1]

    def nodes_per_graph(self) -> torch.Tensor:
        """[G, M]: the size of the owning graph at every node slot (at
        least 1)."""
        counts = torch.clamp(self.n_node, min=1).to(torch.float32)
        return counts[:, None].expand(self.node_mask.shape)

    def snorm(self) -> torch.Tensor:
        return ((1.0 / torch.sqrt(self.nodes_per_graph()))[..., None]
                * self.node_mask[..., None])

    def in_degrees(self) -> torch.Tensor:
        return self.adj.sum(dim=-1)                       # [G, M]

    def _map(self, fn) -> "DenseGraphBatch":
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "extras":
                kw[f.name] = {k: fn(t) for k, t in v.items()}
            else:
                kw[f.name] = None if v is None else fn(v)
        return DenseGraphBatch(**kw)

    def to(self, device, non_blocking: bool = False) -> "DenseGraphBatch":
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def cast_floats(self, dtype: torch.dtype) -> "DenseGraphBatch":
        """Every floating tensor cast to `dtype` (integer arrays unchanged)."""
        return self._map(lambda t: t.to(dtype) if t.is_floating_point() else t)


def dense_batch_np(graphs: List[dict], num_graphs: int, max_nodes: int,
                   k: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Pack numpy graph dicts into dense block arrays.  No graph slot is
    reserved for padding; slots past len(graphs) are all masked.  Raises
    if a graph has more than `max_nodes` nodes."""
    if len(graphs) > num_graphs:
        raise ValueError("too many graphs")
    G, M = num_graphs, max_nodes
    adj = np.zeros((G, M, M), np.float32)
    node_mask = np.zeros((G, M), np.float32)
    n_node = np.zeros(G, np.int32)
    graph_mask = np.zeros(G, np.float32)
    out: Dict[str, np.ndarray] = {}

    has = {key: all(key in g for g in graphs) for key in
           ("node_feat", "edge_feat", "y", "eigvecs", "eigvals")}
    if has["node_feat"]:
        nf0 = np.asarray(graphs[0]["node_feat"])
        nf_shape = (G, M) if nf0.ndim == 1 else (G, M, nf0.shape[1])
        node_feat = np.zeros(nf_shape, nf0.dtype)
    if has["edge_feat"]:
        edge_feat = np.zeros((G, M, M),
                             np.asarray(graphs[0]["edge_feat"]).dtype)
    if has["y"]:
        y0 = np.asarray(graphs[0]["y"], np.float32).reshape(-1)
        y = np.zeros((G, y0.shape[0]), np.float32)
    if has["eigvecs"]:
        if k is None:
            k = max(np.asarray(g["eigvecs"]).shape[1] for g in graphs)
        eigvecs = np.zeros((G, M, k), np.float32)
        eigvals = np.zeros((G, k), np.float32)
        eig_mask = np.zeros((G, M, k), np.float32)

    for gi, g in enumerate(graphs):
        n = (int(np.asarray(g["node_feat"]).shape[0]) if has["node_feat"]
             else int(g["n_node"]))
        if n > M:
            raise ValueError(f"graph with {n} nodes exceeds max_nodes={M}")
        s = np.asarray(g["senders"])
        r = np.asarray(g["receivers"])
        adj[gi, r, s] = 1.0                       # receiver-major
        node_mask[gi, :n] = 1.0
        n_node[gi] = n
        graph_mask[gi] = 1.0
        if has["node_feat"]:
            node_feat[gi, :n] = np.asarray(g["node_feat"])
        if has["edge_feat"]:
            edge_feat[gi, r, s] = np.asarray(g["edge_feat"])
        if has["y"]:
            y[gi] = np.asarray(g["y"], np.float32).reshape(-1)
        if has["eigvecs"]:
            v = np.asarray(g["eigvecs"], np.float32)
            kk = min(v.shape[1], k)
            eigvecs[gi, :n, :kk] = v[:n, :kk]
            eig_mask[gi, :n, :kk] = 1.0
            if has["eigvals"]:
                sv = np.asarray(g["eigvals"], np.float32)
                eigvals[gi, :min(len(sv), k)] = sv[:k]

    out.update(adj=adj, node_mask=node_mask, n_node=n_node,
               graph_mask=graph_mask)
    if has["node_feat"]:
        out["node_feat"] = node_feat
    if has["edge_feat"]:
        out["edge_feat"] = edge_feat
    if has["y"]:
        out["y"] = y
    if has["eigvecs"]:
        out.update(eigvecs=eigvecs, eigvals=eigvals, eig_mask=eig_mask)
    return out


def dense_from_arrays(arrays: Dict[str, np.ndarray]) -> DenseGraphBatch:
    """A DenseGraphBatch of CPU tensors from `dense_batch_np`'s dict."""
    known = {f.name for f in dataclasses.fields(DenseGraphBatch)} - {"extras"}
    main = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in arrays.items() if k in known}
    extras = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in arrays.items() if k not in known}
    return DenseGraphBatch(**main, extras=extras)


def dense_neighbor_sum(adj, x):
    """adj [G, M, M] @ x [G, M, D] or [G, M, K, D] -> receiver sums."""
    adj = adj.to(x.dtype)
    if x.dim() == 3:
        return torch.einsum("gmn,gnd->gmd", adj, x)
    if x.dim() == 4:   # an eigenvector-channel axis
        return torch.einsum("gmn,gnkd->gmkd", adj, x)
    raise ValueError(f"unsupported rank {x.dim()}")


def dense_pool(x, node_mask, reduce="sum"):
    """Per-graph pooling over the node axis (1) with the node mask."""
    m = node_mask.reshape(node_mask.shape
                          + (1,) * (x.dim() - node_mask.dim())).to(x.dtype)
    if reduce == "sum":
        return (x * m).sum(dim=1)
    if reduce == "mean":
        return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    if reduce == "max":
        out = torch.where(m > 0, x, torch.full_like(x, -math.inf)).amax(dim=1)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    raise ValueError(reduce)
