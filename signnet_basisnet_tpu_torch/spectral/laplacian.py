"""Graph Laplacians (host-side numpy).

Port of the numpy half of signnet_basisnet_tpu/spectral/laplacian.py:
- DGL path: ``L = I - D^{-1/2} (A + tau/n) D_tau^{-1/2}`` with degrees clipped
  at 1 (reference: GraphPrediction/data/molecules.py:148-161);
- PyG path: ``L = D - A`` (normalization None).
"""
from __future__ import annotations

import numpy as np


def adjacency_dense_np(senders, receivers, n, weights=None):
    A = np.zeros((n, n), dtype=np.float64)
    w = np.ones(len(senders)) if weights is None else np.asarray(weights)
    np.add.at(A, (np.asarray(senders), np.asarray(receivers)), w)
    return A


def sym_laplacian_np(A: np.ndarray, tau: float = 0.0, clip_degree: bool = True):
    """Symmetric-normalized Laplacian from a dense adjacency; with ``tau > 0``
    the regularized Laplacian of the DGL path."""
    n = A.shape[0]
    deg = A.sum(axis=1)
    if clip_degree:
        deg = np.clip(deg, 1.0, None)
    A_t = A + tau / max(n, 1)
    d_inv_sqrt = (deg + tau) ** -0.5
    return np.eye(n) - (d_inv_sqrt[:, None] * A_t) * d_inv_sqrt[None, :]


def unnormalized_laplacian_np(A: np.ndarray):
    """L = D - A (PyG get_laplacian with normalization=None)."""
    return np.diag(A.sum(axis=1)) - A
