"""ZINC molecular graph regression dataset: the synthetic stand-in.

Port of signnet_basisnet_tpu/data/zinc.py (synthetic path and Laplacian PE).
`synthetic_zinc` draws molecule-like graphs with ZINC's statistics (n in
[9, 37], ~2.2 average degree, 28 atom / 4 bond types) and a graph-computable
regression target; from the same seed it yields the same graphs as the JAX
package.  Reading the reference's real ZINC pickles is not ported yet
(ROADMAP.md, queue 1 item 9): `load_zinc` raises when they are present.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from .. import spectral

ZINC_NUM_ATOM_TYPE = 28
ZINC_NUM_BOND_TYPE = 4


def _synthetic_molecule(rng: np.random.Generator) -> dict:
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
    atom = rng.integers(0, ZINC_NUM_ATOM_TYPE, size=n).astype(np.int32)
    bond = rng.integers(1, ZINC_NUM_BOND_TYPE, size=len(s) // 2).astype(np.int32)
    bond = np.repeat(bond, 2)

    deg = np.bincount(r, minlength=n).astype(np.float32)
    cycles = len(edges) - (n - 1)
    # smooth structure-dependent target (plays the role of logP-SA-cycle)
    y = (0.1 * (atom % 7).mean() - 0.05 * n + 0.3 * cycles
         + 0.2 * deg.std() + 0.15 * np.sin(atom.sum() % 10)
         + 0.1 * bond.mean())
    return dict(senders=s, receivers=r, node_feat=atom, edge_feat=bond,
                y=np.array([y], np.float32))


def synthetic_zinc(num_train=10000, num_val=1000, num_test=1000, seed=0
                   ) -> Dict[str, List[dict]]:
    rng = np.random.default_rng(seed)
    return {
        "train": [_synthetic_molecule(rng) for _ in range(num_train)],
        "val": [_synthetic_molecule(rng) for _ in range(num_val)],
        "test": [_synthetic_molecule(rng) for _ in range(num_test)],
    }


def add_lap_pe(graphs: List[dict], k: int, tau: float = 0.0) -> None:
    """Attach fixed-k Laplacian PE in place (drop the trivial eigvec,
    zero-pad)."""
    for g in graphs:
        n = int(np.asarray(g["node_feat"]).shape[0])
        vals, vecs = spectral.lap_pe_np(g["senders"], g["receivers"], n, k,
                                        tau=tau)
        g["eigvals"] = vals
        g["eigvecs"] = vecs


def _has_real_zinc(data_dir: str) -> bool:
    if os.path.exists(os.path.join(data_dir, "ZINC.pkl")):
        return True
    return all(os.path.exists(os.path.join(data_dir, f"{s}.pickle"))
               for s in ("train", "val", "test"))


def load_zinc(data_dir: str = "data/zinc", synthetic_fallback: bool = True,
              seed: int = 0,
              synth_sizes: Tuple[int, int, int] = (10000, 1000, 1000)):
    """(splits, is_real): the synthetic stand-in where the real pickles are
    missing, as the JAX loader falls back."""
    if _has_real_zinc(data_dir):
        raise NotImplementedError(
            "reading the real ZINC pickles is not ported yet "
            "(ROADMAP.md queue 1 item 9)")
    if not synthetic_fallback:
        raise FileNotFoundError(f"no ZINC pickles under {data_dir}")
    return synthetic_zinc(*synth_sizes, seed=seed), False
