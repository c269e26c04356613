"""The plain reference's shared parts: a batch of whole graphs, the layer
equations, the seeded parameter layout, Adam and the three-step run.

Plain PyTorch (gather and `index_add_`), float32 with TF32 off unless a
caller turns it on for the control.  It imports torch and numpy and
nothing of the program: the equations are written here from the layers'
definitions, and only the parameter names follow the program's, so that
one set of seeded weights can be loaded into both.

Semantics held to, each as the configuration states it:
- masked BatchNorm: batch statistics over the rows where the mask is 1,
  biased variance to normalise, unbiased into the running variance,
  momentum 0.1, eps 1e-5, masked rows zero on output;
- the SignNet rho's BatchNorm runs over every node slot of the padded
  batch, padding included, as the JAX package and the port state it: so
  the phi and rho run here over the batch's real nodes plus its
  `num_pad` padding slots (eigenvector 0, no edge, masked out of every
  other statistic), and `num_pad` is the packed node budget less the real
  nodes, which the reference works out itself (`batches.py`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

MOMENTUM = 0.1
BN_EPS = 1e-5
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclass
class Batch:
    """Whole graphs side by side, then `num_pad` padding slots."""
    senders: torch.Tensor      # [e] long, real edges only
    receivers: torch.Tensor    # [e] long
    graph_id: torch.Tensor     # [n] long, real nodes
    node_feat: torch.Tensor    # [n] long
    edge_feat: torch.Tensor    # [e] long
    eigvecs: torch.Tensor      # [n + num_pad, k]
    node_mask: torch.Tensor    # [n + num_pad] float, 1 on the real nodes
    y: torch.Tensor            # [g]
    num_real: int
    num_graphs: int


def make_batch(graphs: Sequence[dict], num_pad: int, device) -> Batch:
    n_off = np.cumsum([0] + [len(g["node_feat"]) for g in graphs])
    cat = lambda key, off=False: np.concatenate(
        [np.asarray(g[key]) + (n_off[i] if off else 0)
         for i, g in enumerate(graphs)])
    n = int(n_off[-1])
    k = graphs[0]["eigvecs"].shape[1]
    eig = np.zeros((n + num_pad, k), np.float32)
    eig[:n] = cat("eigvecs")
    mask = np.zeros(n + num_pad, np.float32)
    mask[:n] = 1.0
    gid = np.concatenate([np.full(len(g["node_feat"]), i)
                          for i, g in enumerate(graphs)])
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    return Batch(senders=t(cat("senders", True), torch.long),
                 receivers=t(cat("receivers", True), torch.long),
                 graph_id=t(gid, torch.long),
                 node_feat=t(cat("node_feat"), torch.long),
                 edge_feat=t(cat("edge_feat"), torch.long),
                 eigvecs=t(eig, torch.float32),
                 node_mask=t(mask, torch.float32),
                 y=t(np.stack([g["y"][0] for g in graphs]), torch.float32),
                 num_real=n, num_graphs=len(graphs))


# ------------------------------------------------------------ layout

def linear_spec(name: str, d_in: int, d_out: int) -> list:
    """A Linear's weight [d_out, d_in] and bias, uniform(+-1/sqrt(d_in))."""
    return [(f"{name}.weight", (d_out, d_in), "uniform", d_in),
            (f"{name}.bias", (d_out,), "uniform", d_in)]


def bn_spec(name: str, d: int) -> list:
    return [(f"{name}.weight", (d,), "ones", 0),
            (f"{name}.bias", (d,), "zeros", 0)]


def bn_buffers(name: str, d: int) -> list:
    return [(f"{name}.running_mean", (d,), "zeros", 0),
            (f"{name}.running_var", (d,), "ones", 0)]


def mlp_spec(name: str, d_in: int, hidden: int, d_out: int, layers: int):
    """(params, buffers) of an MLP: Linear, ReLU, BN per hidden layer."""
    dims = [d_in] + [hidden] * (layers - 1) + [d_out]
    params, bufs = [], []
    for i in range(layers):
        params += linear_spec(f"{name}.lin_{i}", dims[i], dims[i + 1])
        if i < layers - 1:
            params += bn_spec(f"{name}.bn_{i}", hidden)
            bufs += bn_buffers(f"{name}.bn_{i}", hidden)
    return params, bufs


def deep_signs_spec(name: str, hidden: int, phi_out: int, layers: int,
                    k: int):
    """The fixed-k SignNet: a GIN phi of `layers` layers, BN between
    them, and a `layers`-layer rho MLP over the k * phi_out features."""
    params, bufs = [], []
    d_in = 1
    for i in range(layers):
        if i:
            params += bn_spec(f"{name}.enc.bn_{i - 1}", d_in)
            bufs += bn_buffers(f"{name}.enc.bn_{i - 1}", d_in)
        out = phi_out if i == layers - 1 else hidden
        p, b = mlp_spec(f"{name}.enc.conv_{i}.mlp", d_in, hidden, out, 2)
        params, bufs = params + p, bufs + b
        d_in = out
    p, b = mlp_spec(f"{name}.rho", k * phi_out, hidden, k, layers)
    return params + p, bufs + b


def readout_spec(d: int) -> list:
    dims = [d, d // 2, d // 4]
    out = []
    for i in range(2):
        out += linear_spec(f"mlp_readout.fc_{i}", dims[i], dims[i + 1])
    return out + linear_spec("mlp_readout.fc_2", dims[2], 1)


# ---------------------------------------------------------- equations

def linear(P, name, x):
    return x @ P[f"{name}.weight"].t() + P[f"{name}.bias"]


def batch_norm(P, B, name, x, mask=None):
    """Masked BatchNorm in training mode over x [..., d]; updates the
    running statistics in B."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    if mask is None:
        cnt = x2.new_tensor(float(x2.shape[0]))
        mean = x2.mean(dim=0)
        var = ((x2 - mean) ** 2).mean(dim=0)
    else:
        m = mask.reshape(-1, 1).to(x2.dtype)
        cnt = torch.clamp(m.sum(), min=1.0)
        mean = (x2 * m).sum(dim=0) / cnt
        var = (((x2 - mean) ** 2) * m).sum(dim=0) / cnt
    with torch.no_grad():
        unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
        rm, rv = f"{name}.running_mean", f"{name}.running_var"
        B[rm] = (1 - MOMENTUM) * B[rm] + MOMENTUM * mean
        B[rv] = (1 - MOMENTUM) * B[rv] + MOMENTUM * unbiased
    y = (x2 - mean) / torch.sqrt(var + BN_EPS) * P[f"{name}.weight"] \
        + P[f"{name}.bias"]
    if mask is not None:
        y = y * m
    return y.reshape(x.shape)


def neighbor_sum(x, batch: Batch):
    """out[i] = sum over the edges j -> i of x[j]."""
    out = torch.zeros_like(x)
    return out.index_add_(0, batch.receivers, x[batch.senders])


def mlp(P, B, name, x, layers, mask=None):
    for i in range(layers - 1):
        x = batch_norm(P, B, f"{name}.bn_{i}",
                       torch.relu(linear(P, f"{name}.lin_{i}", x)), mask)
    return linear(P, f"{name}.lin_{layers - 1}", x)


def deep_signs(P, B, name, batch: Batch, layers: int):
    """rho([phi(v_i) + phi(-v_i)]_i) -> [n + num_pad, k]: each phi layer
    a GIN conv (x + sum of the neighbours through a 2-layer MLP), BN
    between layers, over the real nodes' (node, eigenvector) slots."""
    v = batch.eigvecs[..., None]                        # N k 1
    k = v.shape[1]
    x = torch.cat([v, -v], dim=1)                       # N 2k 1
    mask = batch.node_mask[:, None].expand(x.shape[:-1])
    for i in range(layers):
        if i:
            x = batch_norm(P, B, f"{name}.enc.bn_{i - 1}", x, mask)
        x = mlp(P, B, f"{name}.enc.conv_{i}.mlp", x + neighbor_sum(x, batch),
                2, mask)
    x = (x[:, :k] + x[:, k:]).reshape(x.shape[0], -1)   # N (k phi_out)
    return mlp(P, B, f"{name}.rho", x, layers)          # every slot


def embed(P, B, batch: Batch, cfg: dict):
    """The atom embedding and the embedded SignNet PE, concatenated and
    mixed by `embedding_hp` (pe_aggregate concat), at the real nodes."""
    m = cfg["model"]
    if not (m["pe_init"] == "lap_pe" and m["lap_method"] == "sign_inv"
            and m["sign_inv_net"] == "gin" and m["pe_aggregate"] == "concat"):
        raise NotImplementedError("the reference holds the fixed-k GIN "
                                  "SignNet merged by concat only")
    pe = deep_signs(P, B, "sign_inv_net", batch, m["sign_inv_layers"])
    p = linear(P, "embedding_p", pe[:batch.num_real])
    h = P["embedding_h.weight"][batch.node_feat]
    return linear(P, "embedding_hp", torch.cat([h, p], dim=-1))


def readout_loss(P, batch: Batch, h):
    """Mean readout, the halving MLP head and the L1 loss over graphs."""
    sums = h.new_zeros((batch.num_graphs, h.shape[1]))
    sums = sums.index_add_(0, batch.graph_id, h)
    counts = torch.bincount(batch.graph_id, minlength=batch.num_graphs)
    hg = sums / counts[:, None].to(h.dtype)
    for i in range(2):
        hg = torch.relu(linear(P, f"mlp_readout.fc_{i}", hg))
    pred = linear(P, "mlp_readout.fc_2", hg)[:, 0]
    return (pred - batch.y).abs().mean()


# ---------------------------------------------------------- training

def three_steps(net, cfg: dict, params0: Dict[str, torch.Tensor],
                buffers0: Dict[str, torch.Tensor], batches: List[Batch],
                lr: float) -> dict:
    """Train `net` (a reference module: `loss(P, B, batch, cfg)`) from the
    given weights, one Adam step a batch (torch's Adam: bias-corrected
    moments, eps outside the square root).  Returns each step's loss, the
    first step's gradient of every leaf, and the weights and running
    statistics after the last step."""
    P = {n: t.detach().clone().requires_grad_(True)
         for n, t in params0.items()}
    B = {n: t.detach().clone() for n, t in buffers0.items()}
    m = {n: torch.zeros_like(t) for n, t in P.items()}
    v = {n: torch.zeros_like(t) for n, t in P.items()}
    b1, b2 = BETAS
    losses, grad1 = [], {}
    for step, batch in enumerate(batches, start=1):
        loss = net.loss(P, B, batch, cfg)
        names = list(P)
        grads = torch.autograd.grad(loss, [P[n] for n in names],
                                    allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for n, g in zip(names, grads):
                if g is None:      # a leaf the net does not use
                    continue
                if step == 1:
                    grad1[n] = g.clone()
                m[n] = b1 * m[n] + (1 - b1) * g
                v[n] = b2 * v[n] + (1 - b2) * g * g
                m_hat = m[n] / (1 - b1 ** step)
                denom = torch.sqrt(v[n]) / (1 - b2 ** step) ** 0.5 + ADAM_EPS
                P[n] -= lr * m_hat / denom
    return {"losses": losses, "grad1": grad1,
            "params": {n: t.detach() for n, t in P.items()}, "buffers": B}
