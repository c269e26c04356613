"""Host-side eigendecomposition for Laplacian PE (numpy).

Port of the numpy half of signnet_basisnet_tpu/spectral/eigh.py.  Eigenvector
signs are fixed deterministically (the entry of largest magnitude is made
positive) so preprocessing is reproducible; SignNet is sign invariant anyway.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .laplacian import adjacency_dense_np, sym_laplacian_np


def canonical_sign_np(V: np.ndarray) -> np.ndarray:
    """Flip each column so its first entry of max magnitude is positive."""
    idx = np.argmax(np.abs(V), axis=0)
    signs = np.sign(V[idx, np.arange(V.shape[1])])
    signs[signs == 0] = 1.0
    return V * signs[None, :]


def eigh_np(L: np.ndarray, fix_sign: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Full eigh with ascending eigenvalues, as float32."""
    vals, vecs = np.linalg.eigh(L)
    if fix_sign:
        vecs = canonical_sign_np(vecs)
    return vals.astype(np.float32), vecs.astype(np.float32)


def lap_pe_np(senders, receivers, n, k, tau: float = 0.0,
              skip_first: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Laplacian-eigenvector PE for one graph, DGL-path semantics.

    Returns (eigvals[k], eigvecs[n, k]): the k eigenpairs after dropping the
    trivial first one, zero-padded when the graph has fewer than k+1 nodes.
    """
    A = adjacency_dense_np(senders, receivers, n)
    L = sym_laplacian_np(A, tau=tau)
    vals, vecs = eigh_np(L)
    lo = 1 if skip_first else 0
    vals, vecs = vals[lo:lo + k], vecs[:, lo:lo + k]
    out_vals = np.zeros(k, np.float32)
    out_vecs = np.zeros((n, k), np.float32)
    out_vals[:len(vals)] = vals
    out_vecs[:, :vecs.shape[1]] = vecs
    return out_vals, out_vecs
