"""Fused GatedGCN gate and aggregation (kernel K4).

Port of signnet_basisnet_tpu/ops/pallas_gatedgcn.py.  For Bh, Dh, Eh [N, F]
and Ce [E, F], per destination node n and edge e = (s -> n):

    e_new_e = Dh[s] + Eh[n] + Ce_e
    sig_e   = sigmoid(e_new_e) * edge_mask_e
    agg_n   = sum_e sig_e * Bh[s] / (sum_e sig_e + 1e-6)

- `gatedgcn_gate_reference` is the JAX reference of the same name: every
  edge counts, in the inputs' own type.
- `gatedgcn_gate_plain` is the function K4 computes, in plain torch: e_new
  at every edge slot inside its destination tile's range [starts[t],
  ends[t]) (weight-0 padding edges included) and zero elsewhere; agg over
  the in-range edges of weight != 0.  e_new, sig and the sums are f32 (f64
  for f64 input), rounded to the input type once.  It is the only path for
  CPU tensors.
- `gatedgcn_gate_bwd_plain` is the JAX backward `_gate_bwd`: the exact VJP
  of the reference over every edge, in the inputs' type.
- `gatedgcn_gate_tiled` is the differentiable wrapper, a
  `torch.autograd.Function`: on CUDA tensors its forward launches the
  hand-written kernel `csrc/gatedgcn_gate.cu` (sm_90a, built by nvcc at
  first use through `_nvcc.load`, bound with ctypes) or raises; on CPU
  tensors it runs the plain version.  Its backward is
  `gatedgcn_gate_bwd_plain` on either device, as the JAX backward is XLA,
  not Pallas.  It saves what the JAX `_gate_fwd` saves: the four inputs
  and the edge arrays.

An in-range edge whose source lies outside its tile counts fully in the
plain version and in K4, as in the reference and in the backward.  The TPU
kernel reads such a source as a zero row (ROADMAP.md queue 3).  The packer
makes no such edge.

`gatedgcn_gate_tiled.launches` counts K4's launches; nothing else touches it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..graph.segment import segment_sum
from . import _nvcc
from .edge_attention import _common_dtype
from .spmm_tiled import edge_in_range

# gatedgcn_gate_fwd(bh, dh, eh, ce, agg, e_new, senders, receivers, w, starts,
#                   ends, dst_ptr, num_nodes, num_edges, num_feat, bn,
#                   is_bf16, stream)
FWD_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def build() -> ctypes.CDLL:
    """Compile csrc/gatedgcn_gate.cu (once per source content) and load it."""
    return _nvcc.load("gatedgcn_gate", {"gatedgcn_gate_fwd": FWD_ARGTYPES})


def gatedgcn_gate_reference(Bh, Dh, Eh, Ce, senders, receivers, edge_mask,
                            num_nodes: int):
    """Every edge counts, weighted by edge_mask: (agg [N, F], e_new [E, F])."""
    s, r = senders.long(), receivers.long()
    e_new = Dh[s] + Eh[r] + Ce
    sigma = torch.sigmoid(e_new) * edge_mask[:, None]
    num = segment_sum(sigma * Bh[s], r, num_nodes)
    den = segment_sum(sigma, r, num_nodes)
    return num / (den + 1e-6), e_new


def gatedgcn_gate_plain(Bh, Dh, Eh, Ce, senders, receivers, edge_mask,
                        starts, ends, bn: int):
    """The plain-torch version of K4: (agg [N, F], e_new [E, F]) in the
    inputs' common type."""
    dt = _common_dtype(Bh, Dh, Eh, Ce)
    acc = torch.promote_types(dt, torch.float32)
    s, r = senders.long(), receivers.long()
    in_range = edge_in_range(receivers, starts, ends, bn)
    e_new = (Dh.to(acc)[s] + Eh.to(acc)[r]) + Ce.to(acc)
    e_new = torch.where(in_range[:, None], e_new, torch.zeros_like(e_new))
    idx = torch.nonzero(in_range & (edge_mask != 0))[:, 0]
    sig = torch.sigmoid(e_new[idx]) * edge_mask.to(acc)[idx][:, None]
    num = segment_sum(sig * Bh.to(acc)[s[idx]], r[idx], Bh.shape[0])
    den = segment_sum(sig, r[idx], Bh.shape[0])
    return (num / (den + 1e-6)).to(dt), e_new.to(dt)


def gatedgcn_gate_bwd_plain(Bh, Dh, Eh, Ce, senders, receivers, edge_mask,
                            g_agg, g_e, num_nodes: int):
    """(dBh, dDh, dEh, dCe): the exact VJP of `gatedgcn_gate_reference`
    for the cotangents (g_agg, g_e), by the formulas of the JAX `_gate_bwd`,
    each in the type of the input it belongs to."""
    s, r = senders.long(), receivers.long()
    em = edge_mask[:, None]
    Bs = Bh[s]
    e_new = Dh[s] + Eh[r] + Ce
    sig0 = torch.sigmoid(e_new)
    sig = sig0 * em
    num = segment_sum(sig * Bs, r, num_nodes)
    den = segment_sum(sig, r, num_nodes)
    inv = 1.0 / (den + 1e-6)
    ghat = g_agg * inv
    c = (num * inv) * ghat
    dBh = segment_sum(sig * ghat[r], s, num_nodes)
    dsig = em * (Bs * ghat[r] - c[r])
    de = dsig * sig0 * (1.0 - sig0) + g_e
    dDh = segment_sum(de, s, num_nodes)
    dEh = segment_sum(de, r, num_nodes)
    return (dBh.to(Bh.dtype), dDh.to(Dh.dtype), dEh.to(Eh.dtype),
            de.to(Ce.dtype))


def _launch(Bh, Dh, Eh, Ce, senders, receivers, w, starts, ends, dst_ptr,
            bn: int):
    """K4: (agg [N, F], e_new [E, F]) in the inputs' type."""
    Bh, Dh, Eh, Ce, senders, receivers, starts, ends, dst_ptr = (
        a.contiguous() for a in (Bh, Dh, Eh, Ce, senders, receivers, starts,
                                 ends, dst_ptr))
    if Bh.dtype not in (torch.float32, torch.bfloat16) or Bh.dim() != 2:
        raise TypeError(f"gatedgcn gate kernel takes f32 or bf16 Bh [N, F], "
                        f"got {Bh.dtype} {tuple(Bh.shape)}")
    for name, t in (("Dh", Dh), ("Eh", Eh)):
        if t.shape != Bh.shape or t.dtype != Bh.dtype:
            raise TypeError(f"{name} must match Bh's shape and type")
    N, F = Bh.shape
    E = senders.shape[0]
    if Ce.dtype != Bh.dtype or Ce.shape != (E, F):
        raise TypeError("Ce must be [E, F] in Bh's type")
    if N % bn or starts.shape[0] != N // bn:
        raise ValueError(f"{N} nodes do not make {starts.shape[0]} tiles of "
                         f"{bn}")
    for a in (senders, receivers, starts, ends, dst_ptr):
        if a.device != Bh.device or a.dtype != torch.int32:
            raise TypeError("gatedgcn gate kernel takes int32 index arrays "
                            "on the features' device")
    if receivers.shape[0] != E or dst_ptr.shape[0] != N + 1:
        raise ValueError("receivers must have E entries and CSR pointers "
                         "num_nodes + 1")
    w = w.to(torch.float32).contiguous()
    lib = build()
    agg = torch.empty_like(Bh)  # K4 writes every row and slot
    e_new = torch.empty_like(Ce)
    stream = torch.cuda.current_stream(Bh.device).cuda_stream
    err = lib.gatedgcn_gate_fwd(
        *(t.data_ptr() for t in (Bh, Dh, Eh, Ce, agg, e_new, senders,
                                 receivers, w, starts, ends, dst_ptr)),
        N, E, F, bn, int(Bh.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"gatedgcn gate kernel launch failed: CUDA error "
                           f"{err}")
    gatedgcn_gate_tiled.launches += 1
    return agg, e_new


class _GatedGCNGate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Bh, Dh, Eh, Ce, senders, receivers, edge_mask, starts,
                ends, bn, dst_ptr):
        if Bh.device.type == "cuda":
            out = _launch(Bh, Dh, Eh, Ce, senders, receivers, edge_mask,
                          starts, ends, dst_ptr, bn)
        else:
            out = gatedgcn_gate_plain(Bh, Dh, Eh, Ce, senders, receivers,
                                      edge_mask, starts, ends, bn)
        ctx.save_for_backward(Bh, Dh, Eh, Ce, senders, receivers, edge_mask)
        return out

    @staticmethod
    def backward(ctx, g_agg, g_e):
        Bh, Dh, Eh, Ce, senders, receivers, edge_mask = ctx.saved_tensors
        return gatedgcn_gate_bwd_plain(
            Bh, Dh, Eh, Ce, senders, receivers, edge_mask, g_agg, g_e,
            Bh.shape[0]) + (None,) * 7


def gatedgcn_gate_tiled(Bh, Dh, Eh, Ce, senders, receivers, edge_mask,
                        starts, ends, num_nodes: int, bn: int,
                        csr: Tuple[torch.Tensor, ...]):
    """Fused gate + aggregation, differentiable in Bh, Dh, Eh and Ce.

    Bh/Dh/Eh [N, F], Ce [E, F]; a batch packed in tiles of `bn` with
    dst-sorted edges, `starts`/`ends` = its tile_starts/tile_ends and `csr`
    = its (dst_ptr, src_order, src_ptr) from `graph.batch.edge_csr` (K4
    reads dst_ptr).  Returns (agg [N, F], e_new [E, F]) in the inputs'
    common type.
    """
    _nvcc.refuse_dtensor("gatedgcn_gate_tiled", Bh, Dh, Eh, Ce, senders,
                         receivers, edge_mask, starts, ends, *csr)
    if Bh.shape[0] != num_nodes:
        raise ValueError(f"Bh has {Bh.shape[0]} rows, expected {num_nodes}")
    if Bh.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"gatedgcn_gate_tiled has no path for device "
                           f"{Bh.device}")
    dt = _common_dtype(Bh, Dh, Eh, Ce)
    Bh, Dh, Eh, Ce = (t.to(dt) for t in (Bh, Dh, Eh, Ce))
    return _GatedGCNGate.apply(Bh, Dh, Eh, Ce, senders, receivers, edge_mask,
                               starts, ends, bn, csr[0])


gatedgcn_gate_tiled.launches = 0
