"""Model-parallel net execution: node- and edge-partitioned layers with a
neighbor-only halo exchange.

Port of signnet_basisnet_tpu/parallel/mp_halo.py onto `torch.distributed`,
one process per shard.  Nodes are split into `mp` contiguous [N/mp]
shards; each rank owns the edges whose destination is local (a contiguous
slice of the destination-sorted edge array).  Per layer only the boundary
rows (nodes that another rank's edges read) move, as one
`all_to_all_single` of [mp * H, ...] send blocks, H the largest boundary
of any pair of ranks (static, computed on the host).

The host partitioner (`partition_batch_mp`, `mp_budgets`,
`device_arrays_mp`) is the JAX package's numpy, bit for bit.  On the
device, a layer sees the shard through `"mp_send_idx" in gb.extras`
(models/conv.py: `neighbor_sum`, `src_features`, `pool_any`, the GatedGCN
and Transformer halo branches; models/pe.py: `canonical`), and
nn/norm.py: `MaskedBatchNorm` sums its moments over the group that
`mp_axis_ctx` sets.

The exchange's gradient goes back to the owners through the same
exchange, and a sum over the group (`mp_psum`) gets the sum of the ranks'
gradients, as JAX transposes `all_to_all` and `psum`.  Each rank
backpropagates its own copy of the replicated loss, so every gradient that
crosses a sum over the group comes out `mp` times its share while the
replicated readout's does not: the steps average the ranks' gradients,
which gives JAX's gradients for both.  The max over the group has no such
rule (its backward would take the max of the gradients), so
`mp_pool_nodes(reduce="max")` runs forward only.

`mp_neighbor_sum` issues the exchange before the local sum and waits for
it after, as JAX leaves XLA to overlap the two.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..graph import segment as seg

# ---------------------------------------------------------------------------
# mp context: the process group of the shards.  Layers read it (with the
# presence of 'mp_send_idx' in gb.extras) to route aggregations through the
# halo path; build_mp_steps sets it around each forward.
# ---------------------------------------------------------------------------

_MP_AXIS: Optional[dist.ProcessGroup] = None


def set_mp_axis(group: Optional[dist.ProcessGroup]) -> None:
    global _MP_AXIS
    _MP_AXIS = group


def get_mp_axis() -> Optional[dist.ProcessGroup]:
    return _MP_AXIS


@contextmanager
def mp_axis_ctx(group: dist.ProcessGroup):
    prev = get_mp_axis()
    set_mp_axis(group)
    try:
        yield
    finally:
        set_mp_axis(prev)


# ---------------------------------------------------------------------------
# Host-side partitioner (numpy, as the JAX package's)
# ---------------------------------------------------------------------------

_NODE_KEYS = ("node_feat", "node_mask", "graph_id", "eigvecs", "eig_mask")
_EDGE_KEYS = ("edge_feat", "edge_graph_id", "edge_real", "k_rw")
_REPL_KEYS = ("n_node", "n_edge", "graph_mask", "y", "eigvals")


def partition_batch_mp(arrays: Dict[str, np.ndarray], mp: int,
                       e_shard: Optional[int] = None,
                       halo: Optional[int] = None) -> Dict:
    """Split one packed batch (dst-sorted edges, from `batch_np`/
    `pack_batches`) into `mp` shards with halo-exchange metadata.

    Returns a dict of:
      nodes:    {key: [mp, N/mp, ...]} node-axis leaves
      edges:    {senders, receivers, edge_mask, edge_feat, edge_graph_id}
                as [mp, E_sh, ...]; `senders` are remapped *augmented*
                indices: s < shard_n is a local row, s >= shard_n indexes
                the halo buffer at (owner * H + slot)
      send_idx: [mp, mp, H] int32: send_idx[o, d] = owner-local rows
                rank o must send to rank d each layer
      repl:     graph-level leaves, replicated
      shard_n, halo, mp: layout ints

    `e_shard`/`halo` force static shapes across batches (pass dataset-wide
    maxima so every batch has one shape).
    """
    N = int(np.asarray(arrays["node_mask"]).shape[0])
    if N % mp != 0:
        raise ValueError(f"num_nodes {N} not divisible by mp={mp}")
    shard_n = N // mp
    send_np = np.asarray(arrays["senders"]).astype(np.int64)
    recv_np = np.asarray(arrays["receivers"]).astype(np.int64)
    emask = np.asarray(arrays["edge_mask"]).astype(np.float32)

    bounds = np.searchsorted(recv_np, np.arange(mp + 1) * shard_n)
    need_e = int(max((bounds[1:] - bounds[:-1]).max(), 1))
    e_sh = e_shard if e_shard is not None else -(-need_e // 8) * 8
    if need_e > e_sh:
        raise ValueError(f"edge shard {need_e} exceeds budget {e_sh}")

    # boundary rows each owner must ship to each destination rank
    needed = [[np.zeros(0, np.int64) for _ in range(mp)] for _ in range(mp)]
    for d in range(mp):
        lo, hi = bounds[d], bounds[d + 1]
        src, m = send_np[lo:hi], emask[lo:hi]
        owner = src // shard_n
        for o in np.unique(owner[(m > 0) & (owner != d)]):
            sel = (owner == o) & (m > 0)
            needed[int(o)][d] = np.unique(src[sel] - o * shard_n)
    need_h = max([len(q) for row in needed for q in row] + [1])
    H = halo if halo is not None else -(-need_h // 8) * 8
    if need_h > H:
        raise ValueError(f"halo {need_h} exceeds budget {H}")
    send_idx = np.zeros((mp, mp, H), np.int32)
    for o in range(mp):
        for d in range(mp):
            q = needed[o][d]
            send_idx[o, d, :len(q)] = q

    S = np.zeros((mp, e_sh), np.int32)
    R = np.zeros((mp, e_sh), np.int32)
    M = np.zeros((mp, e_sh), np.float32)
    edges = {"senders": S, "receivers": R, "edge_mask": M}
    for key in _EDGE_KEYS:
        if key in arrays and arrays[key] is not None:
            a = np.asarray(arrays[key])
            edges[key] = np.zeros((mp, e_sh) + a.shape[1:], a.dtype)
    for d in range(mp):
        lo, hi = bounds[d], bounds[d + 1]
        n = hi - lo
        src, dst, m = send_np[lo:hi], recv_np[lo:hi], emask[lo:hi]
        owner = src // shard_n
        aug = src - d * shard_n
        for o in range(mp):
            if o == d or not len(needed[o][d]):
                continue
            sel = (owner == o) & (m > 0)
            if not sel.any():
                continue
            pos = np.searchsorted(needed[o][d], src[sel] - o * shard_n)
            aug[sel] = shard_n + o * H + pos
        aug[m == 0] = 0          # padding edges: any in-range index
        S[d, :n] = aug
        R[d, :n] = dst - d * shard_n
        M[d, :n] = m
        for key in _EDGE_KEYS:
            if key in edges:
                edges[key][d, :n] = np.asarray(arrays[key])[lo:hi]

    nodes = {}
    for key in _NODE_KEYS:
        if key in arrays and arrays[key] is not None:
            a = np.asarray(arrays[key])
            nodes[key] = a.reshape((mp, shard_n) + a.shape[1:])
    repl = {key: np.asarray(arrays[key]) for key in _REPL_KEYS
            if key in arrays and arrays[key] is not None}
    return dict(nodes=nodes, edges=edges, send_idx=send_idx, repl=repl,
                shard_n=shard_n, halo=H, mp=mp)


def mp_budgets(batches, mp: int):
    """Dataset-wide (e_shard, halo) maxima so every batch shares one
    shape."""
    e_sh, H = 8, 8
    for arrays in batches:
        p = partition_batch_mp(arrays, mp)
        e_sh = max(e_sh, p["edges"]["senders"].shape[1])
        H = max(H, p["halo"])
    return e_sh, H


def device_arrays_mp(parts: Dict) -> Dict:
    """The arrays of `partition_batch_mp` output that the steps read,
    every shard's (numpy)."""
    return {"nodes": parts["nodes"], "edges": parts["edges"],
            "send_idx": parts["send_idx"], "repl": parts["repl"]}


def shard_arrays_mp(arrs: Dict, rank: int, device) -> Dict:
    """Rank `rank`'s shard of `device_arrays_mp` output as tensors on
    `device`: its node and edge rows, its row [mp, H] of the send table and
    the replicated leaves; what `build_mp_steps`' steps take."""
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {"nodes": {k: put(v[rank]) for k, v in arrs["nodes"].items()},
            "edges": {k: put(v[rank]) for k, v in arrs["edges"].items()},
            "send_idx": put(arrs["send_idx"][rank]),
            "repl": {k: put(v) for k, v in arrs["repl"].items()}}


# ---------------------------------------------------------------------------
# Device-side ops (group from get_mp_axis())
# ---------------------------------------------------------------------------


class _AllToAll(torch.autograd.Function):
    """`all_to_all_single` of equal blocks along axis 0; the gradient
    blocks go back to their senders by the same exchange.  With `pending`
    a list, the exchange is left running and its work appended there: the
    caller waits on it before reading the output."""

    @staticmethod
    def forward(ctx, x, group, pending):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        work = dist.all_to_all_single(out, x, group=group, async_op=True)
        if pending is None:
            work.wait()
        else:
            pending.append(work)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty(g.shape, dtype=g.dtype, device=g.device)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None, None


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group (JAX `psum`); its gradient is the sum of
    the ranks' gradients (psum's transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def mp_psum(x, group: Optional[dist.ProcessGroup] = None):
    """`x` summed over the mp group (default: the one `mp_axis_ctx`
    set), differentiable."""
    return _AllReduceSum.apply(x, group or get_mp_axis())


def mp_exchange(x, send_idx, axis: Optional[dist.ProcessGroup] = None,
                pending: Optional[List] = None):
    """Ship this rank's boundary rows to every peer; returns the received
    halo buffer [mp * H, ...] (block o = rows owned by rank o).

    x: [shard_n, ...] local features; send_idx: [mp, H] (this rank's row
    of the global [mp, mp, H] table).  One `all_to_all_single`; with
    `pending` a list it is left running (see `_AllToAll`).
    """
    group = axis or get_mp_axis()
    buf = x.index_select(0, send_idx.reshape(-1).long())
    return _AllToAll.apply(buf, group, pending)


def mp_neighbor_sum(x, gb):
    """sum_{j in N(i)} x_j under the mp partition: the local-edge segment
    sum (no communication) plus the remote-edge one fed by the halo
    exchange, which runs while the local sum is computed."""
    send_idx = gb.extras["mp_send_idx"]
    shard_n = x.shape[0]
    s = gb.senders.long()
    local = (s < shard_n).to(gb.edge_mask.dtype)
    pending = []
    halo = mp_exchange(x, send_idx, pending=pending)
    msg_l = x.index_select(0, torch.clamp(s, 0, shard_n - 1))
    out = seg.aggregate_edges(msg_l, gb.receivers, shard_n,
                              edge_mask=gb.edge_mask * local)
    for work in pending:
        work.wait()
    msg_r = halo.index_select(0, torch.clamp(s - shard_n, 0,
                                             halo.shape[0] - 1))
    return out + seg.aggregate_edges(msg_r, gb.receivers, shard_n,
                                     edge_mask=gb.edge_mask * (1.0 - local))


def mp_pool_nodes(x, gb, reduce: str = "sum"):
    """Per-graph pooling when nodes are mp-sharded: graphs may straddle
    shard boundaries, so partial per-graph reductions are combined over the
    group (sums for sum and mean; the max, forward only)."""
    G = gb.num_graphs
    if reduce == "sum":
        part = seg.pool_nodes(x, gb.graph_id, G, node_mask=gb.node_mask,
                              reduce="sum")
        return mp_psum(part)
    if reduce == "mean":
        m = gb.node_mask.reshape(gb.node_mask.shape
                                 + (1,) * (x.dim() - 1)).to(x.dtype)
        s = mp_psum(seg.pool_nodes(x * m, gb.graph_id, G, reduce="sum"))
        c = mp_psum(seg.pool_nodes(
            m.expand(x.shape[:1] + (1,) * (x.dim() - 1)), gb.graph_id, G,
            reduce="sum"))
        return s / torch.clamp(c, min=1.0)
    if reduce == "max":
        if torch.is_grad_enabled() and x.requires_grad:
            raise NotImplementedError(
                "mp_pool_nodes(reduce='max') runs forward only: the max "
                "over the group has no gradient rule here (ROADMAP.md "
                "queue 3)")
        part = seg.segment_max(x, gb.graph_id, G, mask=gb.node_mask,
                               empty_value=-1e30)
        out = part.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=get_mp_axis())
        return torch.where(out <= -1e29, torch.zeros_like(out), out)
    raise ValueError(f"unsupported mp reduce {reduce!r}")


# ---------------------------------------------------------------------------
# Train and eval steps: each rank runs the net on its shard inside
# mp_axis_ctx; the ranks' gradients are averaged (see the module docstring)
# before one optimizer step, the same on every rank.
# ---------------------------------------------------------------------------


def _gb_of(shard, repl):
    from ..graph.batch import GraphBatch
    nodes, edges, send_idx = shard["nodes"], shard["edges"], shard["send_idx"]
    extras = {"mp_send_idx": send_idx}
    for key in ("edge_real", "k_rw"):
        if key in edges:
            extras[key] = edges[key]
    return GraphBatch(
        senders=edges["senders"], receivers=edges["receivers"],
        graph_id=nodes["graph_id"], edge_graph_id=edges.get("edge_graph_id"),
        n_node=repl["n_node"], n_edge=repl["n_edge"],
        node_mask=nodes["node_mask"], edge_mask=edges["edge_mask"],
        graph_mask=repl["graph_mask"], node_feat=nodes.get("node_feat"),
        edge_feat=edges.get("edge_feat"), y=repl.get("y"),
        eigvecs=nodes.get("eigvecs"), eigvals=repl.get("eigvals"),
        eig_mask=nodes.get("eig_mask"),
        extras=extras,
    )


def build_mp_steps(model: torch.nn.Module, predict, optimizer,
                   group: Optional[dist.ProcessGroup] = None, loss_fn=None):
    """(train_step(arrs, lr) -> metrics, eval_step(arrs, flip_rng=None) ->
    sums) for a net running model-parallel over `group` (default: every
    rank), with `arrs` this rank's `shard_arrays_mp`.  The model, its
    parameters and the optimizer are replicated: each rank builds them
    from the same seed.  The contract is `training.build_steps`', so `fit`
    runs them as it runs the single-device steps; the eval step returns
    loss_sum = loss * n."""
    from ..training.metrics import masked_l1
    from ..training.optim import set_lr
    from ..training.train import _score, _target, l1_graph_loss
    from .data_parallel import average_over
    loss_fn = loss_fn or l1_graph_loss
    group = group or dist.group.WORLD

    def forward(arrs, flip_rng):
        gb = _gb_of(arrs, arrs["repl"])
        pred = predict(gb, flip_rng)
        loss = loss_fn(pred, gb)
        score = _score(pred).detach()
        mae = masked_l1(score, _target(score, gb), gb.graph_mask)
        return loss, mae, gb

    def train_step(arrs, lr):
        set_lr(optimizer, lr)
        model.train()
        # the backward too: a remat'd layer's forward runs again there
        with mp_axis_ctx(group):
            loss, mae, _ = forward(arrs, getattr(model, "flip_rng", None))
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        params = list(model.parameters())
        grads = average_over([torch.zeros_like(p) if p.grad is None
                              else p.grad for p in params], group)
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        return {"loss": loss.detach(), "mae": mae}

    @torch.no_grad()
    def eval_step(arrs, flip_rng=None):
        model.eval()
        with mp_axis_ctx(group):
            loss, mae, gb = forward(arrs, flip_rng)
        n = gb.graph_mask.sum()
        return {"loss_sum": loss * n, "mae_sum": mae * n, "n": n}

    return train_step, eval_step
