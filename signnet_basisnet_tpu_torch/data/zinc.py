"""ZINC molecular graph regression dataset: the reference's pickles, or
the synthetic stand-in.

Port of signnet_basisnet_tpu/data/zinc.py (real-data path, synthetic path
and Laplacian PE).  `load_zinc_pickle` reads the reference's two formats:
the bundled `ZINC.pkl` tuple (train, val, test, num_atom_type,
num_bond_type), whose splits are the reference's `MoleculeDGL` objects, or
per-split `<split>.pickle` molecule dicts with `<split>.index` subset
files (read with `subset`).  Neither dgl nor the reference's modules are
needed: any class the unpickler cannot import becomes an inert stub, and
only the raw molecule dicts (atom types, the dense bond matrix, the
target) are read.  `synthetic_zinc` draws molecule-like graphs with ZINC's
statistics (n in [9, 37], ~2.2 average degree, 28 atom / 4 bond types) and
a graph-computable regression target; from the same seed it yields the
same graphs as the JAX package.  The positional encodings are attached in
place: `add_lap_pe` (k eigenvectors), `add_full_evd` (all n) and
`add_rwpe` (the random-walk PE); `avg_degree_stats` gives the PNA scalers
their train-split degree statistics.  `load_zinc` reads the pickles where they
exist and falls back to the synthetic stand-in, as the JAX loader does.
"""
from __future__ import annotations

import csv
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import spectral

ZINC_NUM_ATOM_TYPE = 28
ZINC_NUM_BOND_TYPE = 4


def _mol_to_graph(atom_type: np.ndarray, bond_type: np.ndarray,
                  y: float) -> dict:
    s, r = np.nonzero(bond_type)
    return dict(
        senders=s.astype(np.int32), receivers=r.astype(np.int32),
        node_feat=np.asarray(atom_type, np.int32),
        edge_feat=np.asarray(bond_type[s, r], np.int32),
        y=np.array([y], np.float32),
    )


class _Stub:
    """Stand-in for a class whose module is missing (dgl, the reference's
    `data.molecules`): takes any construction and state and keeps the
    state in its __dict__."""

    def __init__(self, *a, **k):
        pass

    def __call__(self, *a, **k):
        return _Stub()

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


class _ReferenceUnpickler(pickle.Unpickler):
    """Unpickles the reference's ZINC files without dgl or the reference's
    modules: a class that cannot be imported becomes a `_Stub` subclass.
    The molecule dicts (`MoleculeDGL.data`) are plain torch and Python data
    and survive; the DGLGraphs become stubs that are never read."""

    _stub_cache: Dict[tuple, type] = {}

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            key = (module, name)
            if key not in self._stub_cache:
                self._stub_cache[key] = type(f"Stub_{name}", (_Stub,),
                                             {"__module__": module})
            return self._stub_cache[key]


def _mol_dicts_to_graphs(mols) -> List[dict]:
    """Reference molecule dicts -> graph dicts: the edges are the nonzeros
    of the dense bond matrix, their features the bond codes there."""
    out = []
    for m in mols:
        atom = np.asarray(m["atom_type"]).reshape(-1).astype(np.int32)
        bond = np.asarray(m["bond_type"])
        y = float(np.asarray(m["logP_SA_cycle_normalized"]).reshape(()))
        out.append(_mol_to_graph(atom, bond, y))
    return out


def load_zinc_pickle(data_dir: str, subset: bool = True
                     ) -> Dict[str, List[dict]]:
    """The splits of the reference-format ZINC pickles under `data_dir`
    (FileNotFoundError where there are none)."""
    pkl = os.path.join(data_dir, "ZINC.pkl")
    out: Dict[str, List[dict]] = {}
    if os.path.exists(pkl):
        with open(pkl, "rb") as f:
            loaded = _ReferenceUnpickler(f).load()
        for name, ds in zip(("train", "val", "test"), loaded[:3]):
            mols = ds["data"] if isinstance(ds, dict) else getattr(
                ds, "data", None)
            if mols is None:
                raise ValueError(
                    f"ZINC.pkl split {name!r} has no raw molecule list "
                    f"(fields: {sorted(getattr(ds, '__dict__', {}))}); "
                    "cannot rebuild graphs without dgl")
            out[name] = _mol_dicts_to_graphs(mols)
        return out
    for split in ("train", "val", "test"):
        p = os.path.join(data_dir, f"{split}.pickle")
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        with open(p, "rb") as f:
            mols = _ReferenceUnpickler(f).load()
        idx_file = os.path.join(data_dir, f"{split}.index")
        if subset and os.path.exists(idx_file):
            with open(idx_file) as f:
                idx = [int(v) for row in csv.reader(f) for v in row]
            mols = [mols[i] for i in idx]
        out[split] = _mol_dicts_to_graphs(mols)
    return out


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


def add_full_evd(graphs: List[dict], normalization: Optional[str] = None
                 ) -> None:
    """Attach all n eigenpairs in place (PyG EVDTransform semantics,
    computed once per graph)."""
    for g in graphs:
        n = int(np.asarray(g["node_feat"]).shape[0])
        vals, vecs = spectral.full_evd_np(g["senders"], g["receivers"], n,
                                          normalization=normalization)
        g["eigvals"] = vals
        g["eigvecs"] = vecs


def add_rwpe(graphs: List[dict], k: int) -> None:
    """Attach the k-step random-walk PE in place, as `eigvecs` (with zero
    `eigvals`), where the packer carries it."""
    for g in graphs:
        n = int(np.asarray(g["node_feat"]).shape[0])
        g["eigvecs"] = spectral.rwpe_np(g["senders"], g["receivers"], n, k)
        g["eigvals"] = np.zeros(k, np.float32)


def load_zinc(data_dir: str = "data/zinc", subset: bool = True,
              synthetic_fallback: bool = True, seed: int = 0,
              synth_sizes: Tuple[int, int, int] = (10000, 1000, 1000)):
    """(splits, is_real): the real pickles where they exist, else the
    synthetic stand-in (unless `synthetic_fallback` is off)."""
    try:
        return load_zinc_pickle(data_dir, subset=subset), True
    except (FileNotFoundError, OSError):
        if not synthetic_fallback:
            raise
        return synthetic_zinc(*synth_sizes, seed=seed), False


def avg_degree_stats(graphs: List[dict]) -> dict:
    """The train split's degree statistics for the PNA scalers: the mean of
    log(d + 1) over every node ('log') and the mean of d ('exp'), d the
    in-degree counted over the receivers."""
    logs = []
    for g in graphs:
        n = int(np.asarray(g["node_feat"]).shape[0])
        deg = np.bincount(np.asarray(g["receivers"]), minlength=n)
        logs.append(np.log(deg + 1))
    cat = np.concatenate(logs)
    return {"log": float(cat.mean()), "exp": float(np.exp(cat).mean() - 1)}
