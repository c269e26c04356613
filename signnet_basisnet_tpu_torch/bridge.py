"""Weight bridge: flax variables of the JAX package -> the port's modules.

`load_flax_variables(model, variables)` takes the flax ``variables`` as
nested dicts of numpy arrays ({'params': ..., 'batch_stats': ...}) and copies
them into the port's parameters and buffers:

- `Linear` kernels [in, out] -> weights [out, in]; biases as they are;
- BatchNorm `scale`/`bias` -> `weight`/`bias`, `batch_stats/{mean,var}` ->
  `running_mean`/`running_var`;
- `Embedding` tables -> `weight`;
- GAT's attention vectors `attn_src`/`attn_dst` (1, H, F) as they are, and
  the bare `bias` of GAT and GCN (beside their `weight/{kernel,bias}`
  Linear) -> the layer's `bias`;
- the GIN-family convs' learnt scalar `eps` and the full-graph
  attention's learnt scalar `gamma` (a leaf of a module named
  `attention` only) as they are (its `Q_2`, `K_2` and `E_2` are Linears
  like `Q`, `K` and `E`);
- the leaves with no Linear rule as they are: IGN's `coeffs`, `diag_bias`
  and [1, S, 1(, 1)] `bias`, GPRNet's `temp`, BernNet's `coe`, the bare
  `bias_i` of GcnNet and ChebNet;
- flax `MultiHeadDotProductAttention`'s `DenseGeneral` kernels, `query`,
  `key` and `value` [in, H, hd] -> [H*hd, in] and `out` [H, hd, out] ->
  [out, H*hd], their [H, hd] biases flattened; `nn.LayerNorm`'s `scale`
  -> `weight`.

Module paths map one to one (the transformer SignNet phi's `embed`,
`sab_i` and `rho`; `MLPReadout2`'s `fc_i`; flax's OptimizedLSTMCell's
eight Linears `ii`, `if`, `ig`, `io`, `hi`, `hf`, `hg`, `ho` are the
port's LSTMCell's),
except where flax makes a GIN layer's update net beside the layer: the ZINC
nets' `mlp_i` (top level, or under the DeepSigns phi `enc`) is the port's
`layer_i.mlp` (`conv_i.mlp` inside the phi), the PyG GNN's `conv_i_nn`
is `conv_i.mlp`, and a GIN layer built alone names it `update_net`, the
port `mlp`.  Every flax leaf must land on a tensor of the same size and
every port tensor must be set, or it raises.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias", "mean": "running_mean", "var": "running_var",
         "attn_src": "attn_src", "attn_dst": "attn_dst", "eps": "eps"}
# leaves that keep their flax name in the port
_BARE = re.compile(r"coeffs|diag_bias|temp|coe|bias_\d+")
_HEADS_IN = ("query", "key", "value")


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def torch_name(path: tuple) -> str:
    """Port tensor name for a flax leaf path (without the collection)."""
    parts = list(path[:-1])
    for i, p in enumerate(parts):
        m = re.fullmatch(r"mlp_(\d+)", p)
        if m and (i == 0 or parts[i - 1] == "enc"):
            conv = "layer" if i == 0 else "conv"
            parts[i] = f"{conv}_{m.group(1)}.mlp"
        m = re.fullmatch(r"conv_(\d+)_nn", p)
        if m:
            parts[i] = f"conv_{m.group(1)}.mlp"
        if p == "update_net":
            parts[i] = "mlp"
    leaf = path[-1]
    # the full-graph attention's gamma, and no other leaf of that name
    gamma = leaf == "gamma" and parts[-1:] == ["attention"]
    if leaf not in _LEAF and not _BARE.fullmatch(leaf) and not gamma:
        raise KeyError(f"flax leaf {'/'.join(path)}: no rule in the bridge")
    return ".".join(parts + [_LEAF.get(leaf, leaf)])


def port_value(path: tuple, arr: np.ndarray) -> np.ndarray:
    """The flax leaf `arr` at `path` in the port's layout."""
    if path[-1] == "kernel":
        if arr.ndim == 3:   # attention DenseGeneral, heads flattened
            arr = (arr.reshape(-1, arr.shape[-1]) if path[-2] == "out"
                   else arr.reshape(arr.shape[0], -1))
        return arr.T
    if path[-1] == "bias" and arr.ndim == 2 and path[-2] in _HEADS_IN:
        return arr.reshape(-1)
    return arr


def load_flax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    seen = set()
    for coll in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(coll, {})).items():
            name = torch_name(path)
            if name not in targets:
                raise KeyError(f"flax {coll}/{'/'.join(path)} -> {name}: no "
                               "such tensor in the port")
            t = targets[name]
            val = port_value(path, arr)
            if tuple(val.shape) != tuple(t.shape):
                raise ValueError(f"{name}: flax shape {arr.shape} does not "
                                 f"fit {tuple(t.shape)}")
            with torch.no_grad():
                t.copy_(torch.from_numpy(np.array(val)))
            seen.add(name)
    missing = sorted(set(targets) - seen)
    if missing:
        raise KeyError(f"port tensors the flax variables do not set: {missing}")
