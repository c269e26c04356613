"""Eigenvalue rounding (port of signnet_basisnet_tpu/spectral/projectors.py:
`round_eigvals`; the eigenspace projectors of that file belong to
BasisNet, ROADMAP.md queue 1 item 18)."""
from __future__ import annotations

import numpy as np


def round_eigvals(vals: np.ndarray, decimals: int = 5) -> np.ndarray:
    """round(x * 10^d) / 10^d, the reference's `around`."""
    scale = 10.0 ** decimals
    return np.round(vals * scale) / scale
