"""Analytic counts of GINNet with the fixed-k GIN SignNet, per train step,
at a batch's real counts (harness/costs.py says what is counted)."""
from harness import costs


def step_flops(cfg: dict, real: dict, params: int) -> float:
    m = cfg["model"]
    H, k, L = m["hidden_dim"], m["pos_enc_dim"], m["sign_inv_layers"]
    mm, agg = costs.signnet(real, k, H, m["phi_out_dim"], L)
    mm2, agg2 = costs.embed_and_readout(real, k, H, m["out_dim"])
    mm, agg = mm + mm2, agg + agg2
    for i in range(m["n_layers"]):
        out = H if i < m["n_layers"] - 1 else m["out_dim"]
        agg += real["edges"] * H
        mm += 2 * real["nodes"] * H * H + 2 * real["nodes"] * H * out
    return costs.train_flops(mm, agg, params)


def k1_launches(cfg: dict):
    """(features, transposed) of each K1 launch of a train step: the phi's
    first layer forward on the 2k eigenvector channels, its other layers
    forward and transposed at 2k * hidden, each GIN layer forward and
    transposed at hidden."""
    m = cfg["model"]
    H, k, L = m["hidden_dim"], m["pos_enc_dim"], m["sign_inv_layers"]
    phi = [(2 * k, False)] + [(2 * k * H, t) for t in (False, True)
                              for _ in range(L - 1)]
    return phi + [(H, t) for t in (False, True) for _ in range(m["n_layers"])]


def k4_launches(cfg: dict):
    """Features of each K4 launch of a train step: none in GIN."""
    return []
