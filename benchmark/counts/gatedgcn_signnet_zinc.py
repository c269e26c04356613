"""Analytic counts of GatedGCNNet with the fixed-k GIN SignNet, per train
step, at a batch's real counts (harness/costs.py says what is counted).

A layer of width H: A, B, D, E on the nodes and C on the edges (2 m H H
each); the gate's forward, per edge and feature, 2 adds for e', 3 for the
sigmoid, a product and an add into the weighted sum and an add into the
sum of weights, per node and feature a division and an add; its backward
(the exact VJP: dB, dsig, de, dD, dE) 11 per edge and feature and 3 per
node and feature."""
from harness import costs


def step_flops(cfg: dict, real: dict, params: int) -> float:
    m = cfg["model"]
    H, k, L = m["hidden_dim"], m["pos_enc_dim"], m["sign_inv_layers"]
    n, e = real["nodes"], real["edges"]
    mm, agg = costs.signnet(real, k, H, m["phi_out_dim"], L)
    mm2, agg2 = costs.embed_and_readout(real, k, H, m["out_dim"])
    mm, agg = mm + mm2, agg + agg2
    gate_fwd = gate_bwd = 0.0
    for _ in range(m["n_layers"]):
        mm += 4 * 2 * n * H * H + 2 * e * H * H
        gate_fwd += 8 * e * H + 2 * n * H
        gate_bwd += 11 * e * H + 3 * n * H
    # train_flops counts a second aggregation pass as the backward's; the
    # gate's backward is counted here instead
    return costs.train_flops(mm, agg, params) + gate_fwd + gate_bwd


def k1_launches(cfg: dict):
    """(features, transposed) of each K1 launch of a train step: the
    phi's only (the GatedGCN layers aggregate through K4)."""
    m = cfg["model"]
    H, k, L = m["hidden_dim"], m["pos_enc_dim"], m["sign_inv_layers"]
    return [(2 * k, False)] + [(2 * k * H, t) for t in (False, True)
                               for _ in range(L - 1)]


def k4_launches(cfg: dict):
    """Features of each K4 launch of a train step: one forward a layer
    (the gate's backward is plain torch)."""
    return [cfg["model"]["hidden_dim"]] * cfg["model"]["n_layers"]
