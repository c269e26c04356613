"""Graph Laplacians: numpy on the host, torch on padded dense batches.

Port of signnet_basisnet_tpu/spectral/laplacian.py:
- DGL path: ``L = I - D^{-1/2} (A + tau/n) D_tau^{-1/2}`` with degrees clipped
  at 1 (reference: GraphPrediction/data/molecules.py:148-161);
- PyG path: ``L = D - A`` (normalization None);
- the dense torch versions over [..., n, n] adjacencies with zero padding
  rows and columns (`sym_laplacian_dense`, `unnormalized_laplacian_dense`),
  whose spectra `spectral.eigh.masked_eigh` takes in one batched call, and
  `dense_adjacency_from_graph`, a padded edge list scattered to [N, N].
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


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


def sym_laplacian_dense(A: torch.Tensor,
                        node_mask: Optional[torch.Tensor] = None,
                        clip_degree: bool = True) -> torch.Tensor:
    """The sym-normalised Laplacian of padded dense adjacencies
    [..., n, n]; with `node_mask` [..., n] the identity is masked too, so
    padding rows and columns are all zero (`masked_eigh` then lifts their
    eigenvalues above the real spectrum)."""
    deg = A.sum(dim=-1)
    if clip_degree:
        deg = torch.clamp(deg, min=1.0)
    d_inv_sqrt = deg ** -0.5
    L = -(d_inv_sqrt[..., :, None] * A) * d_inv_sqrt[..., None, :]
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    if node_mask is not None:
        eye = eye * node_mask[..., None, :].to(A.dtype)
    return L + eye


def unnormalized_laplacian_dense(A: torch.Tensor) -> torch.Tensor:
    """L = D - A over [..., n, n]."""
    return torch.diag_embed(A.sum(dim=-1)) - A


def dense_adjacency_from_graph(senders, receivers, num_nodes: int,
                               edge_mask=None) -> torch.Tensor:
    """A padded edge list summed into a dense [N, N] adjacency, A[s, r]
    += the edge's weight (its mask, or 1)."""
    w = (torch.ones(senders.shape[0], dtype=torch.float32,
                    device=senders.device)
         if edge_mask is None else edge_mask.to(torch.float32))
    A = torch.zeros((num_nodes, num_nodes), dtype=torch.float32,
                    device=senders.device)
    return A.index_put_((senders.long(), receivers.long()), w,
                        accumulate=True)
