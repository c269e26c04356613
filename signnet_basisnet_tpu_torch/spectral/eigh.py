"""Eigendecomposition for Laplacian PE: numpy on the host, batched torch
on the device.

Port of signnet_basisnet_tpu/spectral/eigh.py: the fixed-k Laplacian PE
(`lap_pe_np`), all n eigenpairs (`full_evd_np`) and the random-walk PE
(`rwpe_np`) on the host; and on padded dense Laplacians, one batched
`torch.linalg.eigh` (`masked_eigh`, for the JAX `jax.vmap` of it too) and
the device-side sign fix (`canonical_sign`).  Eigenvector signs are fixed
deterministically (the entry of largest magnitude is made positive) so
preprocessing is reproducible; SignNet is sign invariant anyway.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .laplacian import (adjacency_dense_np, sym_laplacian_np,
                        unnormalized_laplacian_np)

# padded diagonal entries get eigenvalues from this up, far above the
# sym-Laplacian spectrum's bound of 2
PAD_EIGVAL = 256.0


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


def full_evd_np(senders, receivers, n, normalization: Optional[str] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """All n eigenpairs (PyG EVDTransform semantics): of L = D - A with
    `normalization` None, of I - D^-1/2 A D^-1/2 (degrees not clipped)
    with 'sym'."""
    A = adjacency_dense_np(senders, receivers, n)
    if normalization == "sym":
        L = sym_laplacian_np(A, clip_degree=False)
    else:
        L = unnormalized_laplacian_np(A)
    return eigh_np(L)


def rwpe_np(senders, receivers, n, k) -> np.ndarray:
    """Random-walk PE [n, k]: the diagonals of (A D^-1)^p for p = 1..k,
    degrees clipped at 1."""
    A = adjacency_dense_np(senders, receivers, n)
    d_inv = 1.0 / np.clip(A.sum(axis=1), 1.0, None)
    RW = A * d_inv[None, :]
    out = np.zeros((n, k), np.float32)
    M = RW.copy()
    for p in range(k):
        out[:, p] = np.diag(M)
        if p + 1 < k:
            M = M @ RW
    return out


def masked_eigh(L: torch.Tensor, node_mask: torch.Tensor):
    """Batched eigh of padded dense Laplacians L [..., n, n], whose padding
    rows and columns (node_mask [..., n] 0) are zero.  Padding diagonal
    slot i gets PAD_EIGVAL * (1 + i / n): simple eigenvalues above the
    real spectrum.  Returns ascending (vals [..., n], vecs [..., n, n],
    valid [..., n]): a graph with n_g real nodes keeps its first n_g
    pairs, the rest are zeroed (valid 0), and the vectors are zero at the
    padding rows."""
    n = L.shape[-1]
    slot = torch.arange(n, dtype=L.dtype, device=L.device)
    mask = node_mask.to(L.dtype)
    pad_diag = (1.0 - mask) * (PAD_EIGVAL * (1.0 + slot / n))
    vals, vecs = torch.linalg.eigh(L + torch.diag_embed(pad_diag))
    n_real = mask.sum(dim=-1, keepdim=True)
    valid = (slot < n_real).to(L.dtype)
    vals = vals * valid
    vecs = vecs * valid[..., None, :] * mask[..., :, None]
    return vals, vecs, valid


# torch.linalg.eigh batches over the leading axes itself: the JAX
# package's jit(vmap(masked_eigh)) is the same call here
batched_masked_eigh = masked_eigh


def canonical_sign(V: torch.Tensor) -> torch.Tensor:
    """Each column of V [..., n, k] flipped so that its first entry of
    largest magnitude is >= 0."""
    idx = V.abs().argmax(dim=-2)
    picked = torch.gather(V, -2, idx[..., None, :])[..., 0, :]
    signs = torch.where(picked >= 0, 1.0, -1.0).to(V.dtype)
    return V * signs[..., None, :]
