"""ctypes bindings for the native C++ batch packer (native/batcher.cpp).

Port of signnet_basisnet_tpu/data/native.py.  The packer writes one padded,
destination-sorted batch straight into preallocated buffers (one copy pass
and a counting sort), the same arrays as `graph.batch_np` without tiles.

The library is built from `native/batcher.cpp` as it stands, at first use
(never when this module is imported), with `g++ -O3 -std=c++17 -fPIC
-shared`, into `data/_build/` of this package (gitignored), once per hash of
source and flags; the build writes a temporary file and renames it into
place, so a build that dies leaves nothing a later one would load.  Nothing
is written into `native/`.  Unlike the JAX wrapper there is no fallback to
the numpy packer: if no compiler is found, the build fails or the library
does not load, `pack_batch_native` raises.  `native_available()` reports
whether the library builds and loads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native",
                      "batcher.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_LIB: Optional[ctypes.CDLL] = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.c_int32
# pack_batch's C signature (native/batcher.cpp), parameter by parameter
PACK_ARGTYPES = [
    _I32P, _I32,                      # graph_sel, n_sel
    _I64P, _I64P,                     # node_off, edge_off
    _I32P, _I32P,                     # senders_all, receivers_all
    _I32P, _I32,                      # node_feat_all, nf_dim
    _I32P, _I32,                      # edge_feat_all, ef_dim
    _F32P, _I32, _I32P,               # eigvec_all, k_src, eig_counts
    _F32P, _I32,                      # eigval_all, k_val_src
    _F32P, _I32,                      # y_all, y_dim
    _I32, _I32, _I32, _I32,           # num_nodes, num_edges, num_graphs, k
    _I32P, _I32P, _F32P,              # senders, receivers, edge_mask
    _I32P, _I32P, _F32P,              # graph_id, edge_graph_id, node_mask
    _I32P, _I32P, _F32P,              # n_node, n_edge, graph_mask
    _I32P, _I32P,                     # node_feat, edge_feat
    _F32P, _F32P, _F32P, _F32P,       # eigvec, eigval, eig_mask, y
]


def _find_cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        path = name and shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C++ compiler (g++) found: the native packer is "
                       "built from native/batcher.cpp at first use")


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    tag = hashlib.sha1(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libsbt_native_{tag}.so")


def load() -> ctypes.CDLL:
    """Build the library (once per source and flags) and load it; raises
    if either fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([_find_cxx(), *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE} failed:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    lib.pack_batch.restype = ctypes.c_int
    lib.pack_batch.argtypes = PACK_ARGTYPES
    _LIB = lib
    return lib


def native_available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        load()
    except (OSError, RuntimeError):
        return False
    return True


class GraphStore:
    """Concatenated column store of a graph dataset for the native packer."""

    def __init__(self, graphs: List[dict], k: Optional[int] = None):
        n_off = [0]
        e_off = [0]
        for g in graphs:
            n_off.append(n_off[-1] + int(np.asarray(g["node_feat"]).shape[0]))
            e_off.append(e_off[-1] + len(g["senders"]))
        self.node_off = np.asarray(n_off, np.int64)
        self.edge_off = np.asarray(e_off, np.int64)
        self.senders = np.concatenate(
            [np.asarray(g["senders"], np.int32) for g in graphs])
        self.receivers = np.concatenate(
            [np.asarray(g["receivers"], np.int32) for g in graphs])

        nf = [np.asarray(g["node_feat"], np.int32) for g in graphs]
        nf = [a[:, None] if a.ndim == 1 else a for a in nf]
        self.node_feat = np.ascontiguousarray(np.concatenate(nf, axis=0))
        self.nf_dim = self.node_feat.shape[1]

        if "edge_feat" in graphs[0]:
            ef = [np.asarray(g["edge_feat"], np.int32) for g in graphs]
            ef = [a[:, None] if a.ndim == 1 else a for a in ef]
            self.edge_feat = np.ascontiguousarray(np.concatenate(ef, axis=0))
            self.ef_dim = self.edge_feat.shape[1]
        else:
            self.edge_feat = None
            self.ef_dim = 0

        if "eigvecs" in graphs[0]:
            ks = max(np.asarray(g["eigvecs"]).shape[1] for g in graphs)
            self.k = k or ks
            evs = []
            counts = []
            for g in graphs:
                v = np.asarray(g["eigvecs"], np.float32)
                out = np.zeros((v.shape[0], self.k), np.float32)
                kk = min(v.shape[1], self.k)
                out[:, :kk] = v[:, :kk]
                evs.append(out)
                counts.append(kk)
            self.eig_counts = np.asarray(counts, np.int32)
            self.eigvecs = np.ascontiguousarray(np.concatenate(evs, axis=0))
            evals = np.zeros((len(graphs), self.k), np.float32)
            for i, g in enumerate(graphs):
                sv = np.asarray(g["eigvals"], np.float32)
                evals[i, :min(len(sv), self.k)] = sv[:self.k]
            self.eigvals = evals
        else:
            self.eigvecs = None
            self.eigvals = None
            self.eig_counts = None
            self.k = 0

        if "y" in graphs[0]:
            ys = [np.asarray(g["y"], np.float32).reshape(-1) for g in graphs]
            self.y = np.ascontiguousarray(np.stack(ys, axis=0))
            self.y_dim = self.y.shape[1]
        else:
            self.y = None
            self.y_dim = 0

        self.num_graphs = len(graphs)
        self.node_counts = np.diff(self.node_off)
        self.edge_counts = np.diff(self.edge_off)


def pack_batch_native(store: GraphStore, graph_sel: np.ndarray,
                      num_nodes: int, num_edges: int, num_graphs: int,
                      out: Optional[Dict[str, np.ndarray]] = None
                      ) -> Dict[str, np.ndarray]:
    """Pack the graphs `graph_sel` of `store` into one padded batch (the
    arrays of `batch_np(..., k=store.k)`), into the buffers `out` where
    given (feature columns 2-d, as allocated below).  Raises ValueError if
    the batch does not fit."""
    lib = load()
    k = store.k
    if out is None:
        out = dict(
            senders=np.empty(num_edges, np.int32),
            receivers=np.empty(num_edges, np.int32),
            edge_mask=np.empty(num_edges, np.float32),
            graph_id=np.empty(num_nodes, np.int32),
            edge_graph_id=np.empty(num_edges, np.int32),
            node_mask=np.empty(num_nodes, np.float32),
            n_node=np.empty(num_graphs, np.int32),
            n_edge=np.empty(num_graphs, np.int32),
            graph_mask=np.empty(num_graphs, np.float32),
        )
        out["node_feat"] = np.empty((num_nodes, store.nf_dim), np.int32)
        if store.edge_feat is not None:
            out["edge_feat"] = np.empty((num_edges, store.ef_dim), np.int32)
        if store.eigvecs is not None:
            out["eigvecs"] = np.empty((num_nodes, k), np.float32)
            out["eigvals"] = np.empty((num_graphs, k), np.float32)
            out["eig_mask"] = np.empty((num_nodes, k), np.float32)
        if store.y is not None:
            out["y"] = np.empty((num_graphs, store.y_dim), np.float32)

    sel = np.ascontiguousarray(graph_sel, np.int32)
    P = lambda a, t: (a.ctypes.data_as(ctypes.POINTER(t))
                      if a is not None else None)
    i32, i64, f32 = ctypes.c_int32, ctypes.c_int64, ctypes.c_float
    rc = lib.pack_batch(
        P(sel, i32), i32(len(sel)),
        P(store.node_off, i64), P(store.edge_off, i64),
        P(store.senders, i32), P(store.receivers, i32),
        P(store.node_feat, i32), i32(store.nf_dim),
        P(store.edge_feat, i32), i32(store.ef_dim),
        P(store.eigvecs, f32), i32(k), P(store.eig_counts, i32),
        P(store.eigvals, f32), i32(k),
        P(store.y, f32), i32(store.y_dim),
        i32(num_nodes), i32(num_edges), i32(num_graphs), i32(k),
        P(out["senders"], i32), P(out["receivers"], i32),
        P(out["edge_mask"], f32), P(out["graph_id"], i32),
        P(out["edge_graph_id"], i32), P(out["node_mask"], f32),
        P(out["n_node"], i32), P(out["n_edge"], i32),
        P(out["graph_mask"], f32),
        P(out.get("node_feat"), i32), P(out.get("edge_feat"), i32),
        P(out.get("eigvecs"), f32), P(out.get("eigvals"), f32),
        P(out.get("eig_mask"), f32), P(out.get("y"), f32),
    )
    if rc != 0:
        raise ValueError("batch does not fit in budgets")
    res = dict(out)
    # squeeze 1-d feature columns back to vectors (graph/batch.py contract)
    if store.nf_dim == 1 and "node_feat" in res:
        res["node_feat"] = res["node_feat"][:, 0]
    if store.ef_dim == 1 and "edge_feat" in res:
        res["edge_feat"] = res["edge_feat"][:, 0]
    return res
