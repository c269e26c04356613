"""Positional-encoding sign handling: the paper's sign baselines.

Port of signnet_basisnet_tpu/models/pe.py: `apply_lap_method` over
lap_method in {none, sign_inv, sign_flip, abs_val, canonical,
canonical_ref}.  `sign_inv` is applied by the model itself (it owns the
SignNet parameters) and `none` leaves the PE unchanged.

`sign_flip` draws its +-1 per eigenvector column from a seeded generator
(a `nn.dropout.DropoutRNG`) on the PE's device, never through the host;
the two packages draw different bits from the same seed.  On a DTensor
(parallel/gspmd.py) every rank draws the single-device flips, replicated.
"""
from __future__ import annotations

import torch

from ..graph import segment as seg


def sign_flip(pos_enc, rng):
    """A random +-1 per eigenvector column, shared by every graph of the
    batch: one draw of `rng` per call."""
    u = torch.rand(pos_enc.shape[1], generator=rng.on(pos_enc.device),
                   device=pos_enc.device)
    rng.draws += 1
    flips = torch.where(u >= 0.5, 1.0, -1.0).to(pos_enc.dtype)
    if seg.is_dtensor(pos_enc):
        # parallel/gspmd.py: every rank draws the single-device flips
        from torch.distributed.tensor import DTensor, Replicate
        mesh = pos_enc.device_mesh
        flips = DTensor.from_local(flips, mesh, [Replicate()] * mesh.ndim)
    return pos_enc * flips[None, :]


def abs_val(pos_enc):
    return torch.abs(pos_enc)


def canonical(gb, pos_enc, exact: bool = False):
    """Per-graph sign fix: flip column j of graph g iff it has fewer
    nonnegative entries than negative ones, OR less nonnegative mass than
    negative mass.

    `exact=True` (lap_method canonical_ref) keeps the published quirk:
    where both criteria fire the multiplier is -2, not -1 (PARITY.md
    deviation 1); the default is a pure +-1 sign choice.  On a
    model-parallel shard the per-graph counts and masses are summed over
    the mp group, as graphs may straddle shards."""
    nm = gb.node_mask[:, None].to(pos_enc.dtype)

    def pool(v):
        part = seg.pool_nodes(v, gb.graph_id, gb.num_graphs)
        if "mp_send_idx" in gb.extras:
            from ..parallel.mp_halo import mp_psum
            part = mp_psum(part)
        return part

    zero = torch.zeros_like(pos_enc)
    nonneg = pos_enc >= 0
    pos_count = pool(nonneg.to(pos_enc.dtype) * nm)
    neg_count = pool((~nonneg).to(pos_enc.dtype) * nm)
    nonneg_mass = pool(torch.where(nonneg, pos_enc, zero) * nm)
    neg_mass = pool(torch.where(nonneg, zero, -pos_enc) * nm)
    flip = ((pos_count < neg_count).to(pos_enc.dtype)
            + (nonneg_mass < neg_mass).to(pos_enc.dtype))
    one = torch.ones_like(flip)
    signs = torch.where(flip > 0, -flip if exact else -one, one)   # G K
    return pos_enc * signs[gb.graph_id.long()]


def apply_lap_method(method: str, gb, pos_enc, rng=None):
    if method in ("none", "sign_inv"):
        return pos_enc
    if method == "sign_flip":
        if rng is None:
            raise ValueError("sign_flip needs a generator")
        return sign_flip(pos_enc, rng)
    if method == "abs_val":
        return abs_val(pos_enc)
    if method == "canonical":
        return canonical(gb, pos_enc)
    if method == "canonical_ref":
        return canonical(gb, pos_enc, exact=True)
    raise ValueError(f"invalid laplacian method {method!r}")
