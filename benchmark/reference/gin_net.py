"""GINNet with the fixed-k GIN SignNet (the reference's ZINC GIN +
SignNet, configs/gin_zinc_signinv_gin.json), in plain PyTorch.

h = embedding_hp([embedding_h(atom) || embedding_p(SignNet(v))]); then
n_layers GIN layers h <- MLP(h + sum of the neighbours' h), each MLP
Linear, ReLU, BN (over the real nodes), Linear, with no residual and no
activation between layers, as the port's and the JAX package's GINNet
have it; mean readout, MLPReadout and the L1 loss.
"""
from __future__ import annotations

from . import common


def spec(cfg: dict):
    """(parameters, buffers): [(name, shape, init, fan_in)] in the
    program's names.  `embedding_e` is made and never used, as the
    program's GINNet makes it."""
    m = cfg["model"]
    H, out, k = m["hidden_dim"], m["out_dim"], m["pos_enc_dim"]
    params, bufs = common.deep_signs_spec(
        "sign_inv_net", H, m["phi_out_dim"], m["sign_inv_layers"], k)
    params = ([("embedding_h.weight", (cfg["atom_types"], H), "normal", 0)]
              + params + common.linear_spec("embedding_p", k, H)
              + common.linear_spec("embedding_hp", 2 * H, H)
              + [("embedding_e.weight", (cfg["bond_types"], H), "normal", 0)]
              + common.readout_spec(out))
    for i in range(m["n_layers"]):
        d_out = H if i < m["n_layers"] - 1 else out
        p, b = common.mlp_spec(f"layer_{i}.mlp", H, H, d_out, 2)
        params, bufs = params + p, bufs + b
    return params, bufs


def loss(P, B, batch, cfg):
    h = common.embed(P, B, batch, cfg)
    for i in range(cfg["model"]["n_layers"]):
        h = common.mlp(P, B, f"layer_{i}.mlp",
                       h + common.neighbor_sum(h, batch), 2)
    return common.readout_loss(P, batch, h)
