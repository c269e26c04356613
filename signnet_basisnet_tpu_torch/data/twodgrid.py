"""The 2D-grid spectral-filter dataset (the LearningFilters workload).

Port of signnet_basisnet_tpu/data/twodgrid.py: the grid graph and its
images from `2Dgrid.mat` (keys A, F, mask), every eigenpair of the
symmetric-normalised Laplacian (cached as `eigenvalues.npy` and
`eigenvectors.npy` beside the .mat, or in `cache_dir`), and the
filter-regression labels y = V f(Lambda) V^T x of the six analytic filters
(cached as `y_<filter>.npy` in `cache_dir`).  The caches keep the JAX
package's names and float32, so either package can fill them.  numpy and
scipy only.
"""
from __future__ import annotations

import os

import numpy as np

from ..spectral import eigh_np, sym_laplacian_np

FILTERS = ("low", "high", "band", "rejection", "comb", "low_band")


def filter_response(filter_type: str, lam: np.ndarray) -> np.ndarray:
    """The analytic spectral response f(lambda) of each filter."""
    if filter_type == "low":
        return np.exp(-10.0 * lam ** 2)
    if filter_type == "high":
        return 1.0 - np.exp(-10.0 * lam ** 2)
    if filter_type == "band":
        return np.exp(-10.0 * (lam - 1.0) ** 2)
    if filter_type == "rejection":
        return 1.0 - np.exp(-10.0 * (lam - 1.0) ** 2)
    if filter_type == "comb":
        return np.abs(np.sin(lam * np.pi))
    if filter_type == "low_band":
        return np.where(lam < 0.5, 1.0,
                        np.where(lam < 1.0, np.exp(-100.0 * (lam - 0.5) ** 2),
                                 np.exp(-50.0 * (lam - 1.5) ** 2)))
    raise ValueError(f"unknown filter {filter_type!r}")


def _save(path: str, arr: np.ndarray) -> None:
    try:
        np.save(path, arr)
    except OSError:
        pass


def load_twodgrid(mat_path: str = "data/2dgrid/2Dgrid.mat",
                  cache_dir: str | None = None) -> dict:
    """senders/receivers, the images x [n, num_images], the mask, n, and
    the eigenvalues and eigenvectors (float32; cached)."""
    import scipy.io as sio
    a = sio.loadmat(mat_path)
    A = np.asarray(a["A"], dtype=np.float64)
    F = np.asarray(a["F"], dtype=np.float32)
    mask = np.asarray(a["mask"], dtype=np.float32)
    s, r = np.nonzero(A > 0)

    cache_dir = cache_dir or os.path.dirname(mat_path)
    vals_p = os.path.join(cache_dir, "eigenvalues.npy")
    vecs_p = os.path.join(cache_dir, "eigenvectors.npy")
    if os.path.exists(vals_p) and os.path.exists(vecs_p):
        vals, vecs = np.load(vals_p), np.load(vecs_p)
    else:
        vals, vecs = eigh_np(sym_laplacian_np(A), fix_sign=False)
        _save(vals_p, vals)
        _save(vecs_p, vecs)
    return dict(senders=s.astype(np.int32), receivers=r.astype(np.int32),
                x=F, mask=mask.reshape(-1), n=A.shape[0],
                eigvals=vals.astype(np.float32),
                eigvecs=vecs.astype(np.float32))


def filter_labels(data: dict, filter_type: str,
                  cache_dir: str | None = None) -> np.ndarray:
    """y = V diag(f(lambda)) V^T x for every image, float32."""
    path = (os.path.join(cache_dir, f"y_{filter_type}.npy") if cache_dir
            else None)
    if path and os.path.exists(path):
        return np.load(path).astype(np.float32)
    V, lam = data["eigvecs"], data["eigvals"]
    resp = filter_response(filter_type, lam).astype(np.float32)
    y = V @ (resp[:, None] * (V.T @ data["x"]))
    if path:
        _save(path, y)
    return y.astype(np.float32)
