"""Positional-encoding sign handling.

Port of signnet_basisnet_tpu/models/pe.py:apply_lap_method for the methods on
the ported path: `sign_inv` (the model's own SignNet handles signs) and
`none` leave the PE unchanged.  The sign-handling baselines (sign_flip,
abs_val, canonical, canonical_ref) are ROADMAP.md queue 1 item 15.
"""
from __future__ import annotations


def apply_lap_method(method: str, pos_enc):
    if method in ("none", "sign_inv"):
        return pos_enc
    if method in ("sign_flip", "abs_val", "canonical", "canonical_ref"):
        raise NotImplementedError(
            f"lap_method {method!r} is not ported yet (ROADMAP.md queue 1 "
            "item 15)")
    raise ValueError(f"invalid laplacian method {method!r}")
