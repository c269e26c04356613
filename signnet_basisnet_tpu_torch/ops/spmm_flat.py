"""Flat destination-sorted SpMM (kernel K5):
out[n] = sum_{e: dst_e = n} w_e * x[src_e] over the whole node axis.

Port of the flat half of signnet_basisnet_tpu/ops/pallas_spmm.py: the
Pallas kernel `spmm_pallas` (body `_spmm_kernel`), its XLA reference
`spmm_reference`, and the host helpers `pad_edges_to` and
`tile_edge_ranges` (numpy copies, the same arrays bit for bit).  The
contract is the JAX one: edges sorted by destination, padded to a multiple
of 1024 with `pad_edges_to`, and per-tile edge ranges `starts`/`ends` from
`tile_edge_ranges(receivers, num_nodes, bn)`; an edge counts for its
destination only inside the range of the destination's tile, as the TPU
kernel masks it.  Sources may lie anywhere and num_nodes need not be a
multiple of bn.  No model path of either package runs it; the port's
`bench_ops` does.

- On CUDA tensors `spmm_flat` launches the hand-written kernel
  `csrc/spmm_flat.cu` (sm_90a, built with nvcc at first use by
  `_nvcc.load`, bound with ctypes): one launch per call, which finds each
  row's edges in the receivers itself (no CSR pointers are made).
  `kernel_variant` picks, from the shape, the features per load (16 bytes
  where D and the pointers allow it, else one element) and the lanes per
  row.  There is no fallback: a failed build or launch raises.  The
  kernel's design and bound are noted in its source.
- On CPU tensors it runs `spmm_flat_plain`, the same function in plain torch.
- Forward only, as `spmm_pallas` has no VJP: with grad mode on and x or the
  weights requiring grad it raises on either device.

Edges of weight 0 (the padding) are skipped and only the rows that counted
edges name are read, so a non-finite row of x reaches only the rows whose
counted edges read it.  The TPU kernel spreads it to every row (its one-hot
gather multiplies all of x by 0), and `spmm_reference` to every row whose
edges read it, weight 0 or not; on finite inputs the three agree
(ROADMAP.md queue 3).  In bf16 the kernel rounds each row's f32 sum once;
the TPU kernel rounds at every 256-edge chunk.

`spmm_flat.launches` counts kernel launches; nothing else touches it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _nvcc
from .spmm_tiled import edge_in_range

# spmm_flat_launch(x, out, senders, receivers, w, starts, ends, num_nodes,
#                  num_feat, bn, is_bf16, vec, group, stream)
LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])

# the kernel's vectors per lane per edge in one pass (`vecs_per_lane` in the
# source), by features per load
_VECS_PER_LANE = {1: 4, 4: 1, 8: 1}
# lanes per row the kernel takes
_GROUPS = (16, 32)


def build() -> ctypes.CDLL:
    """Compile csrc/spmm_flat.cu (once per source content) and load it."""
    return _nvcc.load("spmm_flat", {"spmm_flat_launch": LAUNCH_ARGTYPES})


def kernel_variant(num_feat: int, dtype, aligned: bool):
    """(vec, group) of the kernel for rows of `num_feat` features of `dtype`:
    vec features per load, 16 bytes (4 f32, 8 bf16) when num_feat is a
    multiple of it and x and out are 16-byte `aligned`, else 1; group lanes
    per row, 16 where 16 lanes' loads cover the row in one pass (a bf16 row
    of 128 in 16-byte loads), else 32 (wider rows take several passes)."""
    wide = 16 // torch.tensor([], dtype=dtype).element_size()
    vec = wide if aligned and num_feat % wide == 0 else 1
    need = -(-num_feat // vec) / _VECS_PER_LANE[vec]
    return vec, next((g for g in _GROUPS if g >= need), _GROUPS[-1])


def spmm_reference(x, senders, receivers, weights, num_nodes: int):
    """Gather, weight, index_add_ over every edge (the JAX `spmm_reference`:
    weight-0 edges are multiplied in), in the type of x * weights."""
    msg = x[senders.long()] * weights[:, None]
    out = msg.new_zeros((num_nodes,) + tuple(msg.shape[1:]))
    return out.index_add_(0, receivers.long(), msg)


def pad_edges_to(senders, receivers, weights, be: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad edge arrays to a multiple of `be` with zero-weight self-edges."""
    e = len(senders)
    target = -(-e // be) * be
    if target == e:
        return senders, receivers, weights
    pad = target - e
    senders = np.concatenate([senders, np.zeros(pad, senders.dtype)])
    receivers = np.concatenate(
        [receivers, np.full(pad, receivers[-1] if e else 0, receivers.dtype)])
    weights = np.concatenate([weights, np.zeros(pad, weights.dtype)])
    return senders, receivers, weights


def tile_edge_ranges(receivers: np.ndarray, num_nodes: int, bn: int):
    """Host-side: for each destination tile, the [start, end) range of the
    (destination-sorted) edge array touching it."""
    n_tiles = -(-num_nodes // bn)
    bounds = np.searchsorted(receivers, np.arange(0, n_tiles + 1) * bn)
    return (bounds[:-1].astype(np.int32), bounds[1:].astype(np.int32))


def spmm_flat_plain(x, senders, receivers, weights, starts, ends,
                    num_nodes: int, bn: int = 256):
    """The plain-torch version of the kernel: the edges inside their
    destination tile's range and of weight != 0, f32 accumulation (f64 for
    f64 input), output [num_nodes, D] in x's type."""
    acc = torch.promote_types(x.dtype, torch.float32)
    keep = edge_in_range(receivers, starts, ends, bn) & (weights != 0)
    idx = torch.nonzero(keep)[:, 0]
    msg = (x.index_select(0, senders.long()[idx]).to(acc)
           * weights[idx].to(acc)[:, None])
    out = torch.zeros((num_nodes, x.shape[1]), dtype=acc, device=x.device)
    return out.index_add_(0, receivers.long()[idx], msg).to(x.dtype)


def _launch(x, senders, receivers, weights, starts, ends, bn: int):
    """K5 on CUDA tensors: out [N, D] in x's type, one launch."""
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2:
        raise TypeError(f"spmm_flat kernel takes f32 or bf16 x [N, D], got "
                        f"{x.dtype} {tuple(x.shape)}")
    num_nodes, num_feat = x.shape
    if starts.shape[0] != -(-num_nodes // bn) or ends.shape != starts.shape:
        raise ValueError(f"{num_nodes} nodes need {-(-num_nodes // bn)} tile "
                         f"ranges of {bn}, got {starts.shape[0]}")
    if not (weights.shape[0] == senders.shape[0] == receivers.shape[0]):
        raise ValueError("senders, receivers and weights differ in length")
    ints = [a.contiguous() for a in (senders, receivers, starts, ends)]
    for a in ints:
        if a.device != x.device or a.dtype != torch.int32:
            raise TypeError("spmm_flat kernel takes int32 index arrays on "
                            "the features' device")
    x = x.contiguous()
    w = weights.to(torch.float32).contiguous()
    lib = build()
    out = torch.empty_like(x)
    vec, group = kernel_variant(num_feat, x.dtype, x.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    senders, receivers, starts, ends = ints
    err = lib.spmm_flat_launch(
        *(t.data_ptr() for t in (x, out, senders, receivers, w, starts, ends)),
        num_nodes, num_feat, bn, int(x.dtype == torch.bfloat16), vec, group,
        stream)
    if err != 0:
        raise RuntimeError(f"spmm_flat kernel launch failed: CUDA error {err}")
    spmm_flat.launches += 1
    return out


def spmm_flat(x, senders, receivers, weights, starts, ends, num_nodes: int,
              bn: int = 256):
    """Flat dst-sorted SpMM, forward only (x: [num_nodes, D]).

    `senders`/`receivers`/`weights` padded with `pad_edges_to`, `starts`/
    `ends` from `tile_edge_ranges(receivers, num_nodes, bn)`.  Returns
    [num_nodes, D] in x's type, every row written (zeros where no edge
    counts).
    """
    _nvcc.refuse_dtensor("spmm_flat", x, senders, receivers, weights, starts,
                         ends)
    if x.shape[0] != num_nodes:
        raise ValueError(f"x has {x.shape[0]} rows, expected {num_nodes}")
    if torch.is_grad_enabled() and (x.requires_grad or weights.requires_grad):
        raise NotImplementedError(
            "spmm_flat is forward only, as spmm_pallas has no VJP")
    if x.device.type == "cuda":
        return _launch(x, senders, receivers, weights, starts, ends, bn)
    if x.device.type == "cpu":
        return spmm_flat_plain(x, senders, receivers, weights, starts, ends,
                               num_nodes, bn)
    raise RuntimeError(f"spmm_flat has no path for device {x.device}")


spmm_flat.launches = 0
