"""BasisNet: basis-invariant encoders over eigenspace projectors.

Port of signnet_basisnet_tpu/models/basisnet.py.  One IGN 2->1 encoder per
eigenvalue multiplicity, each run on the fixed-shape [S_m, 1, n, n] stack
of that multiplicity's projectors (built on the host by
spectral/projectors.py), so every encoder is one batched IGN.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ..nn.ign import IGN2to1
from ..nn.init import Linear


class IGNBasisInv(nn.Module):
    """One `IGN2to1(hidden, m)` per multiplicity m, named `enc_m{m}`:
    {m: [S_m, 1, n, n]} -> {m: [S_m, m, n]}."""

    def __init__(self, mult_list: Sequence[int], hidden: int = 32):
        super().__init__()
        self.mult_list = tuple(mult_list)
        for m in self.mult_list:
            self.add_module(f"enc_m{m}", IGN2to1(hidden, m))

    def forward(self, projs: Dict[int, torch.Tensor]):
        return {m: getattr(self, f"enc_m{m}")(projs[m])
                for m in self.mult_list if m in projs}


class IGNShared(nn.Module):
    """Weight-shared variant: one IGN `enc` with one output channel, then
    a Linear `fc_m{m}` to m channels for each multiplicity."""

    def __init__(self, mult_list: Sequence[int], hidden: int = 16):
        super().__init__()
        self.mult_list = tuple(mult_list)
        self.enc = IGN2to1(hidden, 1)
        for m in self.mult_list:
            self.add_module(f"fc_m{m}", Linear(1, m))

    def forward(self, projs: Dict[int, torch.Tensor]):
        out = {}
        for m in self.mult_list:
            if m in projs:
                x = self.enc(projs[m]).transpose(1, 2)          # S n 1
                out[m] = getattr(self, f"fc_m{m}")(x).transpose(1, 2)
        return out


def basis_features(phi_outs: Dict[int, torch.Tensor], n: int,
                   layout: str = "reference") -> torch.Tensor:
    """The per-multiplicity IGN outputs {m: [S_m, m, n]} as per-node
    features [n, sum_m S_m * m], buckets in sorted order.

    layout="aligned": [S, m, n] -> [n, S*m], so column j of node i is that
    node's own IGN output: the per-node feature map the reference's
    comment ("b x d x n -> n x bd") describes.

    layout="reference" (the default): the raw ``reshape(n, -1)`` of each
    [S, m, n] output that the reference code does.  It does not align
    features to nodes: node i receives a contiguous chunk of the flattened
    tensor (other nodes' values from a few eigenspaces).  On a fixed graph
    this acts as a unique node-signature code, and the published BasisNet
    numbers rest on it: the aligned features are invariant under the
    grid's automorphisms and cannot separate symmetry-equivalent nodes
    (per-image memorisation caps at the within-orbit variance, r2 ~ 0.36
    on band_50), while the scrambled layout memorises to ~1e-2 MSE.
    `reshape`, not `view`: the IGN output is a transposed view."""
    outs = [v for _, v in sorted(phi_outs.items())]
    if layout == "aligned":
        feats = [v.permute(2, 0, 1).reshape(n, -1) for v in outs]
    else:
        feats = [v.reshape(n, -1) for v in outs]
    return torch.cat(feats, dim=-1)
