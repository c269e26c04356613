"""The molecules a cell trains on, made from a seed.

A frozen copy of the port's synthetic ZINC generator
(`signnet_basisnet_tpu_torch/data/zinc.py: _synthetic_molecule`) and of its
Laplacian PE (`spectral/eigh.py: lap_pe_np` over `spectral/laplacian.py:
sym_laplacian_np`, tau = 0, degrees clipped at 1), kept here so that a
change to the program cannot change what the benchmark feeds it.  The same
seed gives the same graph dicts as the port's `synthetic_zinc(n, 0, 0,
seed)["train"]` followed by `add_lap_pe(graphs, k)`.

The eigendecompositions run batched, one `np.linalg.eigh` call per node
count: numpy's stacked eigh calls the same LAPACK routine on each matrix,
so the vectors are those of one call per graph, and set-up is shorter.
The eigenvectors are inputs, handed alike to the program and the plain
reference: a repeated eigenvalue's basis is arbitrary and SignNet is not
basis-invariant, so both sides must see one basis.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np

NUM_ATOM_TYPE = 28
NUM_BOND_TYPE = 4


def _molecule(rng: np.random.Generator) -> dict:
    n = int(rng.integers(9, 38))
    # random tree backbone (molecule-like connectivity)
    parents = [int(rng.integers(0, i)) for i in range(1, n)]
    edges = {(i + 1, p) for i, p in enumerate(parents)}
    # a few ring-closing extra edges
    n_extra = int(rng.integers(0, max(2, n // 8) + 1))
    for _ in range(n_extra):
        a, b = rng.integers(0, n, size=2)
        if a != b:
            edges.add((max(a, b), min(a, b)))
    s_list, r_list = [], []
    for a, b in sorted(edges):
        s_list += [a, b]
        r_list += [b, a]
    s = np.array(s_list, np.int32)
    r = np.array(r_list, np.int32)
    atom = rng.integers(0, NUM_ATOM_TYPE, size=n).astype(np.int32)
    bond = rng.integers(1, NUM_BOND_TYPE, size=len(s) // 2).astype(np.int32)
    bond = np.repeat(bond, 2)

    deg = np.bincount(r, minlength=n).astype(np.float32)
    cycles = len(edges) - (n - 1)
    y = (0.1 * (atom % 7).mean() - 0.05 * n + 0.3 * cycles
         + 0.2 * deg.std() + 0.15 * np.sin(atom.sum() % 10)
         + 0.1 * bond.mean())
    return dict(senders=s, receivers=r, node_feat=atom, edge_feat=bond,
                y=np.array([y], np.float32))


def _laplacians(graphs: List[dict], n: int) -> np.ndarray:
    """[m, n, n] sym-normalised Laplacians I - D^-1/2 A D^-1/2 (float64,
    degrees clipped at 1) of graphs that all have n nodes."""
    A = np.zeros((len(graphs), n, n))
    for i, g in enumerate(graphs):
        np.add.at(A[i], (g["senders"], g["receivers"]), 1.0)
    d = np.clip(A.sum(axis=2), 1.0, None) ** -0.5
    return np.eye(n)[None] - (d[:, :, None] * A) * d[:, None, :]


def add_lap_pe(graphs: List[dict], k: int) -> None:
    """Attach `eigvals` [k] and `eigvecs` [n, k] in place: the k eigenpairs
    after the trivial first one, each vector's first entry of largest
    magnitude made positive, zero-padded where n < k + 1."""
    by_n: Dict[int, List[int]] = defaultdict(list)
    for i, g in enumerate(graphs):
        by_n[len(g["node_feat"])].append(i)
    for n, idx in by_n.items():
        vals, vecs = np.linalg.eigh(_laplacians([graphs[i] for i in idx], n))
        top = np.argmax(np.abs(vecs), axis=1)                    # [m, n]
        signs = np.sign(np.take_along_axis(vecs, top[:, None, :], axis=1))
        signs[signs == 0] = 1.0
        vecs = (vecs * signs).astype(np.float32)
        vals = vals.astype(np.float32)
        kk = min(k, n - 1)
        for j, i in enumerate(idx):
            out_vals = np.zeros(k, np.float32)
            out_vecs = np.zeros((n, k), np.float32)
            out_vals[:kk] = vals[j, 1:1 + kk]
            out_vecs[:, :kk] = vecs[j, :, 1:1 + kk]
            graphs[i]["eigvals"] = out_vals
            graphs[i]["eigvecs"] = out_vecs


def make_molecules(count: int, seed: int, k: int) -> List[dict]:
    """`count` molecules drawn from `seed`, with their k-eigenvector PE."""
    rng = np.random.default_rng(seed)
    graphs = [_molecule(rng) for _ in range(count)]
    add_lap_pe(graphs, k)
    return graphs
