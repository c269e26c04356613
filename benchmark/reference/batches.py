"""Which graphs a training epoch puts in each batch, worked out apart from
the program.

The reference's own statement of the batching policy that the
configuration states (the ZINC trainer's: budgets from the dataset's mean
sizes, a shuffle by the epoch's seed, greedy packing into those budgets,
each graph whole inside one node tile), so that it can follow the
program's first steps on the same graphs without reading the program's
packed batches.  It gives each batch's graphs and its padding node slots,
which the SignNet rho's BatchNorm counts.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def budgets(graphs: Sequence[dict], batch_graphs: int, slack: float,
            align: int, tile) -> Tuple[int, int, int]:
    """(node slots, edge slots, graph slots) of every batch: `slack`
    times `batch_graphs` mean-sized graphs; with tiles, the nodes rounded
    up to whole tiles plus one, the edges to a multiple of 1024."""
    ns = np.array([len(g["node_feat"]) for g in graphs])
    es = np.array([len(g["senders"]) for g in graphs])
    nodes = int(np.ceil(max(ns.mean() * batch_graphs * slack, ns.max() + 1)))
    edges = int(np.ceil(max(es.mean() * batch_graphs * slack, es.max() + 1)))
    up = lambda v, a: int(-(-v // a) * a)
    if tile:
        return up(nodes, tile) + tile, up(edges, 1024), batch_graphs + 1
    return up(nodes, align), up(edges, align), batch_graphs + 1


def epoch_batches(graphs: Sequence[dict], slots: Tuple[int, int, int],
                  seed: int, tile, count: int) -> List[List[int]]:
    """The graph indices of the first `count` batches of the epoch
    shuffled by `seed`: graphs join a batch in shuffled order until one
    would overflow the node, edge or graph slots, or find no tile with
    room for all its nodes (tiles filled first-fit); the last graph slot
    is the padding graph's."""
    nodes, edges, graph_slots = slots
    order = np.arange(len(graphs))
    np.random.default_rng(seed).shuffle(order)
    limit = tile if tile else nodes
    out: List[List[int]] = []
    cur: List[int] = []
    cur_n = cur_e = 0
    free = np.full(nodes // tile, tile) if tile else None
    for i in order:
        n, e = len(graphs[i]["node_feat"]), len(graphs[i]["senders"])
        if n > limit or e > edges:
            continue
        no_tile = free is not None and not (free >= n).any()
        if (cur_n + n > nodes or cur_e + e > edges
                or len(cur) + 1 >= graph_slots or no_tile):
            out.append(cur)
            if len(out) == count:
                return out
            cur, cur_n, cur_e = [], 0, 0
            if free is not None:
                free[:] = tile
        cur.append(int(i))
        cur_n += n
        cur_e += e
        if free is not None:
            free[int(np.argmax(free >= n))] -= n
    if cur:
        out.append(cur)
    return out[:count]
