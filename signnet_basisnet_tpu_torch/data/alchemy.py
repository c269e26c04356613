"""Alchemy 12-target graph regression dataset: TUDataset files, or the
synthetic stand-in.

Port of signnet_basisnet_tpu/data/alchemy.py (numpy, the same arrays bit
for bit).  `load_tudataset` parses the TUDataset format (`_A.txt`,
`_graph_indicator.txt`, `_node_labels.txt`, `_edge_labels.txt`,
`_graph_attributes.txt`); `load_alchemy` reads `alchemy_full` under `root`
with the reference's `{train,val,test}_al_10.index` splits where they
exist, else draws `synthetic_alchemy` (molecule-like graphs with [n, 6]
node codes, 1-D edge codes in 0-3 and 12 structure-dependent targets, the
same graphs as the JAX package's from the same seed);
`standardize_targets` standardises y with the train split's statistics.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

ALCHEMY_NUM_TARGETS = 12


def load_tudataset(root: str, name: str = "alchemy_full") -> List[dict]:
    pre = os.path.join(root, name, name)
    edges = np.loadtxt(pre + "_A.txt", delimiter=",", dtype=np.int64) - 1
    gid = np.loadtxt(pre + "_graph_indicator.txt", dtype=np.int64) - 1
    node_feat = np.loadtxt(pre + "_node_labels.txt", delimiter=",",
                           dtype=np.int64)
    if node_feat.ndim == 1:
        node_feat = node_feat[:, None]
    edge_lab = np.loadtxt(pre + "_edge_labels.txt", delimiter=",",
                          dtype=np.int64)
    ys = np.loadtxt(pre + "_graph_attributes.txt", delimiter=",",
                    dtype=np.float32)

    graphs = []
    n_graphs = gid.max() + 1
    node_offsets = np.zeros(n_graphs + 1, np.int64)
    np.add.at(node_offsets, gid + 1, 1)
    node_offsets = np.cumsum(node_offsets)
    edge_gid = gid[edges[:, 0]]
    for g in range(n_graphs):
        nodes = slice(node_offsets[g], node_offsets[g + 1])
        esel = edge_gid == g
        e = edges[esel] - node_offsets[g]
        graphs.append(dict(
            senders=e[:, 0].astype(np.int32),
            receivers=e[:, 1].astype(np.int32),
            node_feat=node_feat[nodes].astype(np.int32),
            edge_feat=edge_lab[esel].astype(np.int32),
            y=ys[g].astype(np.float32),
        ))
    return graphs


def synthetic_alchemy(num_train=10000, num_val=1000, num_test=1000, seed=0
                      ) -> Dict[str, List[dict]]:
    rng = np.random.default_rng(seed)

    def one(_):
        n = int(rng.integers(8, 24))
        parents = [int(rng.integers(0, i)) for i in range(1, n)]
        edges = {(i + 1, p) for i, p in enumerate(parents)}
        for _ in range(int(rng.integers(0, 4))):
            a, b = rng.integers(0, n, size=2)
            if a != b:
                edges.add((max(a, b), min(a, b)))
        s_l, r_l = [], []
        for a, b in sorted(edges):
            s_l += [a, b]
            r_l += [b, a]
        s = np.array(s_l, np.int32)
        r = np.array(r_l, np.int32)
        nf = rng.integers(0, 6, size=(n, 6)).astype(np.int32)
        ef = rng.integers(0, 4, size=(len(s),)).astype(np.int32)
        deg = np.bincount(r, minlength=n).astype(np.float32)
        base = np.array([nf.mean(), nf.std(), n / 20.0, deg.mean(),
                         deg.std(), len(edges) / n, ef.mean(),
                         np.sin(nf.sum() % 7), (nf[:, 0] % 3).mean(),
                         deg.max() / 4.0, (ef % 2).mean(),
                         np.cos(n)], np.float32)
        return dict(senders=s, receivers=r, node_feat=nf, edge_feat=ef,
                    y=base + 0.01 * rng.normal(size=12).astype(np.float32))

    return {"train": [one(i) for i in range(num_train)],
            "val": [one(i) for i in range(num_val)],
            "test": [one(i) for i in range(num_test)]}


def standardize_targets(splits: Dict[str, List[dict]]
                        ) -> Dict[str, np.ndarray]:
    """y <- (y - mean_train) / std_train in place (a zero std counts as
    1); returns the statistics."""
    ys = np.stack([g["y"] for g in splits["train"]])
    mean, std = ys.mean(0), ys.std(0)
    std = np.where(std > 0, std, 1.0)
    for graphs in splits.values():
        for g in graphs:
            g["y"] = ((g["y"] - mean) / std).astype(np.float32)
    return {"mean": mean, "std": std}


def load_alchemy(root: str = "data/alchemy", synthetic_fallback: bool = True,
                 seed: int = 0, synth_sizes=(10000, 1000, 1000)):
    """(splits, is_real)."""
    try:
        graphs = load_tudataset(root)
        idx = {}
        for split in ("train", "val", "test"):
            with open(os.path.join(root, f"{split}_al_10.index")) as f:
                idx[split] = [int(v) for line in f for v in line.split(",")
                              if v.strip()]
        return {s: [graphs[i] for i in idx[s]] for s in idx}, True
    except (FileNotFoundError, OSError):
        if not synthetic_fallback:
            raise
        return synthetic_alchemy(*synth_sizes, seed=seed), False
