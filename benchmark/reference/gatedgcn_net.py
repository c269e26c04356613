"""GatedGCNNet with the fixed-k GIN SignNet (the reference's ZINC GatedGCN
+ SignNet, configs/gatedgcn_zinc_signinv_gin.json), in plain PyTorch.

h and e embedded (the SignNet PE merged into h by concat), then n_layers
residual gated graph convs (Bresson and Laurent), each

    e_ij' = D h_j + E h_i + C e_ij          (edge j -> i)
    h_i'  = A h_i + sum_j s_ij B h_j / (sum_j s_ij + 1e-6),  s = sigmoid(e')
    h <- h + ReLU(BN(h')),  e <- e + ReLU(BN(e'))

with BN over the real nodes and the real edges and no graph norm, as the
ZINC net sets it; mean readout, MLPReadout and the L1 loss.
"""
from __future__ import annotations

import torch

from . import common


def spec(cfg: dict):
    """(parameters, buffers) in the program's names."""
    m = cfg["model"]
    H, k = m["hidden_dim"], m["pos_enc_dim"]
    if m["out_dim"] != H:
        raise NotImplementedError("the residual layers need out_dim == "
                                  "hidden_dim")
    params, bufs = common.deep_signs_spec(
        "sign_inv_net", H, m["phi_out_dim"], m["sign_inv_layers"], k)
    params = ([("embedding_h.weight", (cfg["atom_types"], H), "normal", 0)]
              + params + common.linear_spec("embedding_p", k, H)
              + common.linear_spec("embedding_hp", 2 * H, H)
              + [("embedding_e.weight", (cfg["bond_types"], H), "normal", 0)]
              + common.readout_spec(H))
    for i in range(m["n_layers"]):
        for name in "ABCDE":
            params += common.linear_spec(f"layer_{i}.{name}", H, H)
        for bn in ("bn_h", "bn_e"):
            params += common.bn_spec(f"layer_{i}.{bn}", H)
            bufs += common.bn_buffers(f"layer_{i}.{bn}", H)
    return params, bufs


def loss(P, B, batch, cfg):
    h = common.embed(P, B, batch, cfg)
    e = P["embedding_e.weight"][batch.edge_feat]
    s, r = batch.senders, batch.receivers
    for i in range(cfg["model"]["n_layers"]):
        lin = lambda name, x: common.linear(P, f"layer_{i}.{name}", x)
        e_new = (lin("D", h)[s] + lin("E", h)[r]) + lin("C", e)
        sig = torch.sigmoid(e_new)
        num = torch.zeros_like(h).index_add_(0, r, sig * lin("B", h)[s])
        den = torch.zeros_like(h).index_add_(0, r, sig)
        h_new = lin("A", h) + num / (den + 1e-6)
        h_new = common.batch_norm(P, B, f"layer_{i}.bn_h", h_new)
        e_new = common.batch_norm(P, B, f"layer_{i}.bn_e", e_new)
        h = h + torch.relu(h_new)
        e = e + torch.relu(e_new)
    return common.readout_loss(P, batch, h)
