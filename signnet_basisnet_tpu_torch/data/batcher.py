"""Pad-and-bucket batching: the host-side input pipeline (numpy).

Port of signnet_basisnet_tpu/data/batcher.py.  Graphs are packed greedily
into fixed (node, edge, graph) budgets and padded, so every batch has the same
shapes; a background thread packs the next batches while the device computes.
As the JAX iterator yields device arrays, `iterate_graphbatches` with a
CUDA `device` yields batches on the card: the thread packs each batch and
pins it in page-locked memory, and the consumer copies it with
non_blocking=True on the current stream, so the copy overlaps the host's
work and is ordered before the step that reads it.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..graph.batch import batch_np, from_arrays, len_nodes
from ..utils import profiling


def choose_budgets(graphs: Sequence[dict], batch_graphs: int,
                   slack: float = 1.10, align: int = 8,
                   tile: Optional[int] = None):
    """Pick (num_nodes, num_edges, num_graphs) budgets from dataset stats.

    Budgets cover `batch_graphs` average-sized graphs with `slack` headroom,
    rounded up to `align`.  With `tile` set the node budget rounds up to a
    whole number of tiles (+1 tile of first-fit headroom) and the edge budget
    to a multiple of 1024, the JAX kernels' load granularity (kept so both
    packages pack the same batches).
    """
    ns = np.array([len_nodes(g) for g in graphs])
    es = np.array([len(g["senders"]) for g in graphs])
    num_nodes = int(np.ceil(max(ns.mean() * batch_graphs * slack, ns.max() + 1)))
    num_edges = int(np.ceil(max(es.mean() * batch_graphs * slack, es.max() + 1)))
    rnd = lambda v, a: int(-(-v // a) * a)
    if tile is not None:
        return (rnd(num_nodes, tile) + tile, rnd(num_edges, 1024),
                batch_graphs + 1)
    return rnd(num_nodes, align), rnd(num_edges, align), batch_graphs + 1


def code_columns(graphs: Sequence[dict], key: str) -> int:
    """The code columns of `key` in the graphs (F of [n, F] codes, 1 for
    1-D ones): what a net's DiscreteEncoders are built for."""
    a = np.asarray(graphs[0][key])
    return int(a.shape[1]) if a.ndim == 2 else 1


def plan_batches(graphs: Sequence[dict], num_nodes: int, num_edges: int,
                 num_graphs: int, shuffle: bool = False, seed: int = 0,
                 drop_overflow: bool = True,
                 tile: Optional[int] = None) -> List[List[int]]:
    """The greedy first-fit plan of `pack_batches`: the graphs' indices of
    each batch, in order.

    With `tile` set, a graph joins the current batch only if some tile still
    has room for all of its nodes.
    """
    order = np.arange(len(graphs))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    groups: List[List[int]] = []
    cur: List[int] = []
    cur_n = cur_e = 0
    free = (np.full(num_nodes // tile, tile, dtype=np.int64)
            if tile is not None else None)
    max_n = tile if tile is not None else num_nodes

    for i in order:
        g = graphs[i]
        n, e = len_nodes(g), len(g["senders"])
        if n > max_n or e > num_edges:
            if drop_overflow:
                continue
            raise ValueError("graph larger than batch budget")
        tile_full = free is not None and not (free >= n).any()
        if (cur_n + n > num_nodes or cur_e + e > num_edges
                or len(cur) + 1 >= num_graphs or tile_full):
            groups.append(cur)
            cur, cur_n, cur_e = [], 0, 0
            if free is not None:
                free[:] = tile
        cur.append(int(i))
        cur_n += n
        cur_e += e
        if free is not None:
            t = int(np.argmax(free >= n))
            free[t] -= n
    if cur:
        groups.append(cur)
    return groups


def pack_batches(graphs: Sequence[dict], num_nodes: int, num_edges: int,
                 num_graphs: int, shuffle: bool = False,
                 seed: int = 0, drop_overflow: bool = True,
                 k: Optional[int] = None,
                 tile: Optional[int] = None) -> List[Dict[str, np.ndarray]]:
    """Greedy packing into fixed budgets (`plan_batches`); returns padded
    array dicts."""
    return [batch_np([graphs[i] for i in group], num_nodes, num_edges,
                     num_graphs, k=k, tile=tile)
            for group in plan_batches(graphs, num_nodes, num_edges,
                                      num_graphs, shuffle=shuffle, seed=seed,
                                      drop_overflow=drop_overflow, tile=tile)]


def iterate_graphbatches(graphs, num_nodes, num_edges, num_graphs,
                         shuffle=False, seed=0, k=None, tile=None,
                         prefetch: int = 2, device=None) -> Iterator:
    """Yield GraphBatch objects packed by a background thread: on `device`
    (pinned, then copied without blocking, where it is a card), else CPU
    tensors.

    The thread packs the whole epoch as `pack_batches` does, then makes each
    batch a GraphBatch and pins it.  Each iterator takes a feed ordinal
    (`profiling.COUNTERS.new_feed`) when it starts and records, on the host
    clock, under that ordinal: `pipeline.plan_ms` (the shuffle and the
    greedy plan), `pipeline.first_batch_ms` (from its start to its first
    batch in the queue: the epoch-start stall as the producer sees it), a
    `pipeline.pack_ms` a batch (its `batch_np`, `from_arrays` and pinning,
    no wait on a full queue), and at each of the consumer's `get()`s the
    queue's depth (`pipeline.queue_depth`) and the time blocked
    (`pipeline.get_ms`, also a host span `pipeline.get` while a profiler
    runs).  `fit`'s log line reads them (`profiling.counters_line`).
    """
    device = None if device is None else torch.device(device)
    pin = device is not None and device.type == "cuda"
    counters = profiling.COUNTERS
    feed = counters.new_feed()
    clock = time.perf_counter
    t_start = clock()

    def producer(q):
        try:
            t = clock()
            groups = plan_batches(graphs, num_nodes, num_edges, num_graphs,
                                  shuffle=shuffle, seed=seed, tile=tile)
            counters.record("pipeline.plan_ms", (clock() - t) * 1e3, feed)
            packed = []
            for group in groups:
                t = clock()
                arrays = batch_np([graphs[i] for i in group], num_nodes,
                                  num_edges, num_graphs, k=k, tile=tile)
                packed.append((arrays, clock() - t))
            for i, (arrays, pack_s) in enumerate(packed):
                t = clock()
                gb = from_arrays(arrays)
                gb = gb.pin_memory() if pin else gb
                counters.record("pipeline.pack_ms",
                                (pack_s + clock() - t) * 1e3, feed)
                packed[i] = None
                q.put(gb)
                if i == 0:
                    counters.record("pipeline.first_batch_ms",
                                    (clock() - t_start) * 1e3, feed)
        finally:
            q.put(None)

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    t = threading.Thread(target=producer, args=(q,), daemon=True)
    t.start()
    while True:
        depth = q.qsize()
        with profiling.span("pipeline.get"):
            t0 = clock()
            item = q.get()
            waited = clock() - t0
        if item is None:
            break
        counters.record("pipeline.queue_depth", depth, feed)
        counters.record("pipeline.get_ms", waited * 1e3, feed)
        yield item if device is None else item.to(device, non_blocking=pin)


def stack_microbatches(batches: Sequence[Dict[str, np.ndarray]]):
    """Stack D padded batches along a new leading axis for data parallelism
    (rank r of a dp group takes its microbatches from that axis)."""
    out = {}
    for key in batches[0]:
        out[key] = np.stack([b[key] for b in batches], axis=0)
    return out
