"""Fixed-shape padded batched graphs — the core data structure.

Port of signnet_basisnet_tpu/graph/batch.py.  The layout is the same:

- nodes of all graphs are concatenated, then padded to ``num_nodes`` slots;
- edges are concatenated, **sorted by destination node**, then padded to
  ``num_edges`` slots;
- the **last graph slot is a dedicated padding graph**: all padding nodes and
  padding edges belong to it, so pooling real graphs never mixes in padding;
- eigendata rides along in the masked padded layout: ``eigvecs[num_nodes, k]``,
  ``eigvals[num_graphs, k]``, ``eig_mask[num_nodes, k]``.

With ``tile`` set, graphs are placed first-fit into ``tile``-sized node tiles
and ``extras`` gains ``node_offset`` and the per-tile edge ranges
``tile_starts``/``tile_ends`` that the tile-local SpMM kernel reads.

The host packer (`batch_np`, `tile_first_fit`) is numpy and produces the same
arrays, bit for bit, as the JAX package's; `GraphBatch` is a dataclass of
torch tensors.  Index arrays are int32 (int64 where torch indexing wants
them is done at the use site), masks float32.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from .segment import zeros_for


@dataclass
class GraphBatch:
    """A padded block-diagonal batch of graphs (torch tensors).

    Shape vocabulary: N = padded node count, E = padded edge count,
    G = padded graph count (last slot = padding graph), K = padded
    eigen-dimension.
    """

    # --- structure -------------------------------------------------------
    senders: torch.Tensor        # [E] int32, source node of each edge
    receivers: torch.Tensor      # [E] int32, destination node of each edge
    graph_id: torch.Tensor       # [N] int32, graph each node belongs to
    edge_graph_id: torch.Tensor  # [E] int32, graph each edge belongs to
    n_node: torch.Tensor         # [G] int32, real node count per graph
    n_edge: torch.Tensor         # [G] int32, real edge count per graph
    node_mask: torch.Tensor      # [N] float32, 1.0 for real nodes
    edge_mask: torch.Tensor      # [E] float32, 1.0 for real edges
    graph_mask: torch.Tensor     # [G] float32, 1.0 for real graphs

    # --- features --------------------------------------------------------
    node_feat: Optional[torch.Tensor] = None   # [N] or [N, F]
    edge_feat: Optional[torch.Tensor] = None   # [E] or [E, F]
    y: Optional[torch.Tensor] = None           # [G] or [G, T] targets

    # --- spectral data (optional) ---------------------------------------
    eigvecs: Optional[torch.Tensor] = None     # [N, K]
    eigvals: Optional[torch.Tensor] = None     # [G, K]
    eig_mask: Optional[torch.Tensor] = None    # [N, K]

    # --- free-form extras (tile ranges, node offsets, ...) --------------
    extras: Dict[str, torch.Tensor] = field(default_factory=dict)

    @property
    def num_nodes(self) -> int:
        return self.node_mask.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_mask.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[0]

    def nodes_per_graph(self) -> torch.Tensor:
        """[N] float32: the node count of the graph owning each node, at
        least 1 (padding nodes belong to the padding graph slot, whose
        count of 0 becomes 1)."""
        counts = torch.clamp(self.n_node, min=1).to(torch.float32)
        return counts[self.graph_id.long()]

    def snorm(self) -> torch.Tensor:
        """[N, 1] graph-size normalisation 1/sqrt(|V_g|) of each node,
        0 on the padding nodes (the reference's `snorm_n`)."""
        return ((1.0 / torch.sqrt(self.nodes_per_graph()))
                * self.node_mask)[:, None]

    def in_degrees(self) -> torch.Tensor:
        """[N] in-degree of each node over the real edges, in the edge
        mask's type."""
        out = zeros_for(self.edge_mask, (self.num_nodes,))
        return out.index_add(0, self.receivers.long(), self.edge_mask)

    def _map(self, fn) -> "GraphBatch":
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "extras":
                kw[f.name] = {k: fn(t) for k, t in v.items()}
            else:
                kw[f.name] = None if v is None else fn(v)
        return GraphBatch(**kw)

    def to(self, device, non_blocking: bool = False) -> "GraphBatch":
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "GraphBatch":
        """Every tensor in page-locked host memory, so that a copy to the
        card with non_blocking=True runs asynchronously."""
        return self._map(lambda t: t.pin_memory())

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor of the batch by name (extras under their keys)."""
        out = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self) if f.name != "extras"}
        out = {k: v for k, v in out.items() if v is not None}
        out.update(self.extras)
        return out

    def copy_(self, src: "GraphBatch",
              non_blocking: bool = False) -> "GraphBatch":
        """Copy `src`'s tensors into this batch's, in place: the copy-in of
        a captured step's static batch.  Both must hold the same tensors at
        the same shapes (batches packed to one set of budgets do)."""
        mine, theirs = self.tensors(), src.tensors()
        if mine.keys() != theirs.keys():
            raise ValueError(f"batches hold different tensors: "
                             f"{sorted(mine)} vs {sorted(theirs)}")
        for k, t in mine.items():
            if t.shape != theirs[k].shape:
                raise ValueError(f"{k}: shape {tuple(theirs[k].shape)}, the "
                                 f"static batch has {tuple(t.shape)}")
            t.copy_(theirs[k], non_blocking=non_blocking)
        return self

    def cast_floats(self, dtype: torch.dtype) -> "GraphBatch":
        """Every floating tensor cast to `dtype` (integer arrays unchanged)."""
        return self._map(lambda t: t.to(dtype) if t.is_floating_point() else t)


def tile_first_fit(graphs, tile: int, num_nodes: int) -> np.ndarray:
    """First-fit node offsets placing each graph fully inside one `tile`-sized
    node tile (no graph straddles a tile boundary).  Raises if they don't fit."""
    if num_nodes % tile != 0:
        raise ValueError(f"num_nodes {num_nodes} not a multiple of tile {tile}")
    n_tiles = num_nodes // tile
    free = np.full(n_tiles, tile, dtype=np.int64)
    offsets = np.zeros(len(graphs), dtype=np.int64)
    for gi, g in enumerate(graphs):
        n = len_nodes(g)
        if n > tile:
            raise ValueError(f"graph with {n} nodes exceeds tile {tile}")
        t = int(np.argmax(free >= n))
        if free[t] < n:
            raise ValueError("graphs do not fit the tiled node budget")
        offsets[gi] = t * tile + (tile - free[t])
        free[t] -= n
    return offsets


def batch_np(graphs, num_nodes: int, num_edges: int, num_graphs: int,
             k: Optional[int] = None,
             tile: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Pack a list of numpy graph dicts into padded flat arrays (host side).

    Each graph dict has ``senders``, ``receivers`` ([e] ints) and optionally
    ``node_feat`` [n, ...], ``edge_feat`` [e, ...], ``y``, ``eigvecs``
    [n, k_g], ``eigvals`` [k_g].  The final graph slot is the padding graph,
    so ``num_graphs >= len(graphs) + 1``.  With ``tile`` set the output gains
    ``node_offset`` [G] and the per-tile edge ranges ``tile_starts`` /
    ``tile_ends`` [T].
    """
    n_real_graphs = len(graphs)
    if n_real_graphs + 1 > num_graphs:
        raise ValueError(f"need num_graphs >= {n_real_graphs + 1}, got {num_graphs}")
    tot_n = int(sum(len_nodes(g) for g in graphs))
    tot_e = int(sum(len(g["senders"]) for g in graphs))
    if tot_n > num_nodes or tot_e > num_edges:
        raise ValueError(
            f"batch does not fit: {tot_n} nodes > {num_nodes} or {tot_e} edges > {num_edges}"
        )
    offsets = (tile_first_fit(graphs, tile, num_nodes)
               if tile is not None else None)

    pad_gid = num_graphs - 1
    senders = np.full(num_edges, num_nodes - 1, dtype=np.int32)
    receivers = np.full(num_edges, num_nodes - 1, dtype=np.int32)
    graph_id = np.full(num_nodes, pad_gid, dtype=np.int32)
    edge_graph_id = np.full(num_edges, pad_gid, dtype=np.int32)
    n_node = np.zeros(num_graphs, dtype=np.int32)
    n_edge = np.zeros(num_graphs, dtype=np.int32)
    node_mask = np.zeros(num_nodes, dtype=np.float32)
    edge_mask = np.zeros(num_edges, dtype=np.float32)
    graph_mask = np.zeros(num_graphs, dtype=np.float32)

    out: Dict[str, Any] = {}
    node_off = 0
    edge_off = 0
    feats: Dict[str, list] = {"node_feat": [], "edge_feat": [], "y": []}
    eig: Dict[str, list] = {"eigvecs": [], "eigvals": []}
    has = {k_: all(k_ in g for g in graphs) for k_ in
           ("node_feat", "edge_feat", "y", "eigvecs", "eigvals")}

    node_offsets_out = np.zeros(num_graphs, dtype=np.int32)
    for gi, g in enumerate(graphs):
        n = len_nodes(g)
        e = len(g["senders"])
        if offsets is not None:
            node_off = int(offsets[gi])
        senders[edge_off:edge_off + e] = np.asarray(g["senders"], np.int32) + node_off
        receivers[edge_off:edge_off + e] = np.asarray(g["receivers"], np.int32) + node_off
        graph_id[node_off:node_off + n] = gi
        edge_graph_id[edge_off:edge_off + e] = gi
        n_node[gi] = n
        n_edge[gi] = e
        node_mask[node_off:node_off + n] = 1.0
        edge_mask[edge_off:edge_off + e] = 1.0
        graph_mask[gi] = 1.0
        node_offsets_out[gi] = node_off
        node_off += n
        edge_off += e
        for key in ("node_feat", "edge_feat", "y"):
            if has[key]:
                feats[key].append(np.asarray(g[key]))
        for key in ("eigvecs", "eigvals"):
            if has[key]:
                eig[key].append(np.asarray(g[key]))

    # stable sort by receiver: padding edges (receiver = num_nodes-1) land
    # at the end
    order = np.argsort(receivers, kind="stable")
    senders = senders[order]
    receivers = receivers[order]
    edge_graph_id = edge_graph_id[order]
    edge_mask = edge_mask[order]

    out.update(
        senders=senders, receivers=receivers, graph_id=graph_id,
        edge_graph_id=edge_graph_id, n_node=n_node, n_edge=n_edge,
        node_mask=node_mask, edge_mask=edge_mask, graph_mask=graph_mask,
    )

    if has["node_feat"]:
        if offsets is None:
            nf = np.concatenate(feats["node_feat"], axis=0)
            out["node_feat"] = _pad_rows(nf, num_nodes)
        else:
            first = np.asarray(feats["node_feat"][0])
            nf = np.zeros((num_nodes,) + first.shape[1:], first.dtype)
            for gi in range(n_real_graphs):
                a = np.asarray(feats["node_feat"][gi])
                nf[node_offsets_out[gi]:node_offsets_out[gi] + len(a)] = a
            out["node_feat"] = nf
    if has["edge_feat"]:
        ef = np.concatenate(feats["edge_feat"], axis=0)
        out["edge_feat"] = _pad_rows(ef, num_edges)[order]
    if has["y"]:
        ys = np.stack([np.asarray(v, np.float32) for v in feats["y"]], axis=0)
        pad_shape = (num_graphs - ys.shape[0],) + ys.shape[1:]
        out["y"] = np.concatenate([ys, np.zeros(pad_shape, ys.dtype)], axis=0)

    # per-edge extras: the full graph's `edge_real` flags and GraphiT's
    # `k_rw` weights (data/transforms.py), padded and sorted as the edges
    for extra in ("edge_real", "k_rw"):
        if all(extra in g for g in graphs):
            er = np.concatenate([np.asarray(g[extra], np.float32)
                                 for g in graphs])
            out[extra] = _pad_rows(er, num_edges)[order]

    if has["eigvecs"]:
        if k is None:
            k = max(v.shape[1] for v in eig["eigvecs"])
        V = np.zeros((num_nodes, k), dtype=np.float32)
        S = np.zeros((num_graphs, k), dtype=np.float32)
        M = np.zeros((num_nodes, k), dtype=np.float32)
        for gi, g in enumerate(graphs):
            n = len_nodes(g)
            off = int(node_offsets_out[gi])
            vg = np.asarray(eig["eigvecs"][gi], np.float32)
            kg = min(vg.shape[1], k)
            V[off:off + n, :kg] = vg[:n, :kg]
            M[off:off + n, :kg] = 1.0
            if has["eigvals"]:
                sg = np.asarray(eig["eigvals"][gi], np.float32)
                S[gi, :min(len(sg), k)] = sg[:k]
        out["eigvecs"] = V
        out["eigvals"] = S
        out["eig_mask"] = M

    if offsets is not None:
        out["node_offset"] = node_offsets_out
        n_tiles = num_nodes // tile
        # per-tile contiguous edge ranges over the receiver-sorted edge array
        bounds = np.searchsorted(receivers, np.arange(n_tiles + 1) * tile)
        out["tile_starts"] = bounds[:-1].astype(np.int32)
        out["tile_ends"] = bounds[1:].astype(np.int32)

    return out


CSR_KEYS = ("dst_ptr", "src_order", "src_ptr")


def edge_csr(senders: torch.Tensor, receivers: torch.Tensor,
             num_nodes: int):
    """CSR views of a dst-sorted edge list, int32 tensors on the edges'
    device, in CSR_KEYS order: ``dst_ptr`` [N + 1] (pointers over the
    dst-sorted edges), ``src_order`` [E] (the edges stably sorted by
    source) and ``src_ptr`` [N + 1] (pointers over that order).  The
    tile-local SpMM kernel walks each row's edges through them
    (ops/spmm_tiled.py); `from_arrays` makes them once per batch."""
    rows = torch.arange(num_nodes + 1, dtype=torch.int32,
                        device=senders.device)
    dst_ptr = torch.searchsorted(receivers.contiguous(), rows, out_int32=True)
    src_sorted, order = torch.sort(senders, stable=True)
    src_ptr = torch.searchsorted(src_sorted, rows, out_int32=True)
    return dst_ptr, order.to(torch.int32), src_ptr


def from_arrays(arrays: Dict[str, np.ndarray]) -> GraphBatch:
    """Build a GraphBatch of CPU tensors from the dict `batch_np` produces.

    Tiled batches also get the `edge_csr` views in ``extras``
    (CSR_KEYS), which the tile-local SpMM kernel reads.
    """
    known = {f.name for f in dataclasses.fields(GraphBatch)} - {"extras"}
    main = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in arrays.items() if k in known}
    extras = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in arrays.items() if k not in known}
    if "tile_starts" in arrays:
        extras.update(zip(CSR_KEYS, edge_csr(main["senders"],
                                             main["receivers"],
                                             len(arrays["node_mask"]))))
    return GraphBatch(**main, extras=extras)


def dense_node_index(gb: GraphBatch):
    """Each node's (graph, slot in its graph): the slot is the node's
    index less its graph's first node, `extras['node_offset']` on a tiled
    batch, else the cumulative node counts (a flat batch keeps each
    graph's nodes contiguous).  A padding node's slot is past its
    graph's nodes, or below 0 on a tiled batch."""
    if "node_offset" in gb.extras:
        offsets = gb.extras["node_offset"].long()
    else:
        counts = gb.n_node.long()
        offsets = torch.cumsum(counts, 0) - counts
    gid = gb.graph_id.long()
    idx = torch.arange(gb.num_nodes, device=gid.device) - offsets[gid]
    return gid, idx


def _dense_slots(gb: GraphBatch, n_max: int):
    """(graph, slot) of each node, the slot clamped to [0, n_max - 1], and
    which nodes write their slot in `to_dense_nodes`: the real ones, but of
    those clamped to n_max - 1 only their graph's last node."""
    gid, idx = dense_node_index(gb)
    slot = torch.clamp(idx, 0, n_max - 1)
    last = idx == gb.n_node.long()[gid] - 1
    writes = (gb.node_mask > 0) & ((idx < n_max - 1) | last)
    return gid, slot, writes


def to_dense_nodes(gb: GraphBatch, x: torch.Tensor, n_max: int):
    """Flat node rows x [N, ...] scattered to [G, n_max, ...], and the
    mask [G, n_max] of the slots that real nodes fill (the dense layout of
    per-graph attention).  A graph of more than n_max nodes keeps its
    first n_max - 1 nodes and its last one in the last slot, as the JAX
    scatter's last write leaves it.  Every other node (padding nodes, a
    large graph's clamped ones) writes to a spare slot n_max that is then
    cut off, so each kept slot has one writer and the result is the same
    in any order of the writes, with static shapes (no host sync)."""
    gid, slot, writes = _dense_slots(gb, n_max)
    slot = torch.where(writes, slot, n_max)
    dense = x.new_zeros((gb.num_graphs, n_max + 1) + tuple(x.shape[1:]))
    dense = dense.index_put((gid, slot), x)
    mask = gb.node_mask.new_zeros((gb.num_graphs, n_max + 1))
    mask = mask.index_put((gid, slot), gb.node_mask)
    return dense[:, :n_max], mask[:, :n_max]


def from_dense_nodes(gb: GraphBatch, dense: torch.Tensor):
    """The inverse of to_dense_nodes: each node's slot gathered back to
    the flat [N, ...] layout, padding nodes zero."""
    gid, slot, _ = _dense_slots(gb, dense.shape[1])
    out = dense[gid, slot]
    return out * gb.node_mask.reshape(
        (-1,) + (1,) * (out.dim() - 1)).to(out.dtype)


def len_nodes(g) -> int:
    if "n_node" in g:
        return int(g["n_node"])
    return int(np.asarray(g["node_feat"]).shape[0])


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)
