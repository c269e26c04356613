"""Set2Set pooling and the recurrent cells.

Port of signnet_basisnet_tpu/nn/set2set.py: `Set2Set` (over flax's
`OptimizedLSTMCell`), `GRUStep` (over flax's `GRUCell`) and `S2SReadout`.
Set2Set: an LSTM emits a query per graph, a masked per-graph softmax over
the graph's nodes weighs their features into a readout, and [query,
readout] is the next LSTM input; after `processing_steps` steps that pair
is the graph embedding [G, 2d].  The carry and the first input start at
zero.
"""
from __future__ import annotations

import torch
from torch import nn

from ..graph import segment as seg
from .init import Linear


class LSTMCell(nn.Module):
    """flax's OptimizedLSTMCell: i = sigmoid(ii x + hi h), f = sigmoid(if x
    + hf h), g = tanh(ig x + hg h), o = sigmoid(io x + ho h), c' = f c + i g,
    h' = o tanh(c').  Eight Linears with flax's names: the input kernels
    `ii`, `if`, `ig`, `io` without bias, the hidden ones `hi`, `hf`, `hg`,
    `ho` with bias."""

    GATES = ("i", "f", "g", "o")

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.features = features
        for gate in self.GATES:
            self.add_module(f"i{gate}", Linear(in_features, features,
                                               use_bias=False))
            self.add_module(f"h{gate}", Linear(features, features))

    def forward(self, carry, x):
        c, h = carry
        z = {g: getattr(self, f"i{g}")(x) + getattr(self, f"h{g}")(h)
             for g in self.GATES}
        c = (torch.sigmoid(z["f"]) * c
             + torch.sigmoid(z["i"]) * torch.tanh(z["g"]))
        h = torch.sigmoid(z["o"]) * torch.tanh(c)
        return (c, h), h


class Set2Set(nn.Module):
    """[N, d] node features -> [G, 2d]; `num_layers` stacked LSTM cells
    `lstm_i` (the first takes the 2d-wide [q, r], the others d)."""

    def __init__(self, features: int, processing_steps: int = 6,
                 num_layers: int = 1):
        super().__init__()
        self.features = features
        self.processing_steps = processing_steps
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"lstm_{i}", LSTMCell(
                2 * features if i == 0 else features, features))

    def forward(self, x, graph_id, num_graphs, node_mask=None):
        d = self.features
        cells = [getattr(self, f"lstm_{i}") for i in range(self.num_layers)]
        zeros = x.new_zeros(num_graphs, d)
        carries = [(zeros, zeros) for _ in cells]
        q_star = x.new_zeros(num_graphs, 2 * d)
        nm = node_mask if node_mask is not None else x.new_ones(x.shape[0])
        nm = nm.to(x.dtype)
        gid = graph_id.long()
        for _ in range(self.processing_steps):
            inp = q_star
            for i, cell in enumerate(cells):
                carries[i], inp = cell(carries[i], inp)
            q = inp
            e = (x * q[gid]).sum(-1, keepdim=True)
            alpha = seg.segment_softmax(e, graph_id, num_graphs, mask=nm)
            r = seg.segment_sum(alpha * x * nm[:, None], graph_id,
                                num_graphs)
            q_star = torch.cat([q, r], dim=-1)
        return q_star


class GRUCell(nn.Module):
    """flax's GRUCell: r = sigmoid(ir x + hr h), z = sigmoid(iz x + hz h),
    n = tanh(in x + r * hn h), h' = (1 - z) n + z h.  Six Linears with
    flax's names; `hr` and `hz` have no bias (torch.nn.GRUCell's b_hr and
    b_hz have no counterpart)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, Linear(in_features, features))
        for name in ("hr", "hz"):
            self.add_module(name, Linear(features, features, use_bias=False))
        self.hn = Linear(features, features)

    def forward(self, h, x):
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class GRUStep(nn.Module):
    """h' = GRU(x, h) with h the carry: `GRUStep(x, h)` runs `cell(h, x)`,
    as the JAX module does.  The cell is `cell`."""

    def __init__(self, features: int):
        super().__init__()
        self.cell = GRUCell(features, features)

    def forward(self, x, h):
        return self.cell(h, x)


class S2SReadout(nn.Module):
    """Set2Set + a two-Linear head: relu(fc1 [q, r]) -> fc2."""

    def __init__(self, features: int, out: int, processing_steps: int = 6):
        super().__init__()
        self.set2set = Set2Set(features, processing_steps)
        self.fc1 = Linear(2 * features, features)
        self.fc2 = Linear(features, out)

    def forward(self, x, graph_id, num_graphs, node_mask=None):
        hg = self.set2set(x, graph_id, num_graphs, node_mask)
        return self.fc2(torch.relu(self.fc1(hg)))
