"""Input feature encoders.

Port of signnet_basisnet_tpu/nn/encoders.py: `DiscreteEncoder`, the sum of
per-column embedding lookups of an integer code matrix.  Codes of any rank
other than 2 (1-D node or edge codes) take one embedding, `emb_0`; a
[N, F] matrix sums `emb_0 .. emb_{min(F, max_num_features) - 1}`.  flax
makes the embeddings at the first call from the codes' shape; here
`num_features` (F, or 1 for codes of another rank) fixes them when the
module is built.
"""
from __future__ import annotations

from torch import nn

from .init import Embedding


class DiscreteEncoder(nn.Module):
    def __init__(self, hidden: int, max_num_features: int = 10,
                 max_num_values: int = 6, num_features: int = 1):
        super().__init__()
        self.max_num_features = max_num_features
        self.n_emb = max(1, min(num_features, max_num_features))
        for i in range(self.n_emb):
            self.add_module(f"emb_{i}", Embedding(max_num_values, hidden))

    def forward(self, x):
        if x.dim() != 2:
            return self.emb_0(x)
        if min(x.shape[1], self.max_num_features) != self.n_emb:
            raise ValueError(f"{x.shape[1]} code columns, the encoder was "
                             f"built for {self.n_emb}")
        out = 0.0
        for i in range(self.n_emb):
            out = out + getattr(self, f"emb_{i}")(x[:, i])
        return out
