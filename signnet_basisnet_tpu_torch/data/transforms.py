"""Graph-level transforms.

Port of signnet_basisnet_tpu/data/transforms.py (numpy, host side).
`make_full_graph` replaces each graph's edge set with the complete graph
(no self-loops), keeps the original edge features on the real edges and
flags them in `edge_real`: the input of the full-graph Transformer
(`TransformerNet(full_graph=True)`).  With `adaptive_weighting` it also
adds GraphiT's random-walk kernel weight k_RW = (I - gamma L)^p_steps of
each full-graph edge as `k_rw`.  `graph.batch_np` carries both extras.
"""
from __future__ import annotations

from typing import List

import numpy as np


def make_full_graph(g: dict, adaptive_weighting=None) -> dict:
    """The complete-graph copy of `g`; `adaptive_weighting=(p_steps,
    gamma)` adds `k_rw`, p_steps an int or one of qtr_num_nodes,
    half_num_nodes, num_nodes and twice_num_nodes."""
    n = int(np.asarray(g["node_feat"]).shape[0])
    s, r = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    keep = s != r
    senders = s[keep].astype(np.int32)
    receivers = r[keep].astype(np.int32)

    has_ef = g.get("edge_feat") is not None
    ef_src = np.asarray(g["edge_feat"]) if has_ef else None
    edge_feat = np.zeros(len(senders),
                         ef_src.dtype if has_ef else np.int32)
    edge_real = np.zeros(len(senders), np.float32)

    pos = {(int(a), int(b)): i
           for i, (a, b) in enumerate(zip(senders, receivers))}
    for idx, (a, b) in enumerate(zip(np.asarray(g["senders"]),
                                     np.asarray(g["receivers"]))):
        key = (int(a), int(b))
        if key in pos:
            edge_real[pos[key]] = 1.0
            if has_ef:
                edge_feat[pos[key]] = ef_src[idx]

    out = dict(g)
    out.update(senders=senders, receivers=receivers, edge_feat=edge_feat,
               edge_real=edge_real)

    if adaptive_weighting is not None:
        p_steps, gamma = adaptive_weighting
        if isinstance(p_steps, str):
            p_steps = int(n * {"qtr_num_nodes": 0.25, "half_num_nodes": 0.5,
                               "num_nodes": 1.0,
                               "twice_num_nodes": 2.0}[p_steps])
        A = np.zeros((n, n), np.float64)
        A[np.asarray(g["senders"]), np.asarray(g["receivers"])] = 1.0
        deg = np.clip(A.sum(0), 1.0, None)          # in-degrees, clipped at 1
        Dm = deg ** -0.5
        L = np.eye(n) - (Dm[:, None] * A * Dm[None, :])
        k_rw_power = np.linalg.matrix_power(np.eye(n) - gamma * L,
                                            max(int(p_steps), 1))
        out["k_rw"] = k_rw_power[senders, receivers].astype(np.float32)
    return out


def make_full_graphs(graphs: List[dict], adaptive_weighting=None) -> List[dict]:
    return [make_full_graph(g, adaptive_weighting) for g in graphs]
