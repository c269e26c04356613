"""Fused edge-softmax attention (kernels K2 forward, K3 backward).

Port of signnet_basisnet_tpu/ops/pallas_attention.py.  Q/K/V [N, H, D] and
the edge modulation E1 [E, H, D]; per destination node n and head h:

    score_e = sum_d K[src_e] * (Q[n] / sqrt(D)) * E1_e
    s_e     = exp(clip(score_e, -5, 5)) * edge_mask_e
    out_n   = sum_e s_e V[src_e] / (sum_e s_e + 1e-6)

- `edge_softmax_attention_reference` is the JAX reference of the same name
  (every edge counts, weighted by its mask): what the graph transformer
  layer computes on a batch without tiles.
- `edge_softmax_attention_plain` adds the tile-locality rule of the
  tile-local SpMM (ops/spmm_tiled.py): an edge counts only inside its tile's
  range [starts[t], ends[t]) with both endpoints in the tile, and edges of
  weight 0 (a batch's padding edges) are skipped.  Its gradients come from
  autograd.  It is the only path for CPU tensors.
- `edge_softmax_den_plain` is K2's second output, the per-head
  denominator den [N, H] f32, in plain torch.
- `edge_attention_bwd_plain` is K3's function as launched (gradients from
  ghat and c) in plain torch: the tests' and the smoke run's direct
  reference for K3.
- `edge_softmax_attention_tiled` launches the hand-written kernels
  `csrc/edge_attention.cu` (sm_90a, built by nvcc at first use through
  `_nvcc.load`, bound with ctypes) on CUDA tensors, through a
  `torch.autograd.Function`: the forward is K2 and keeps the per-head
  denominator den [N, H] f32; the backward forms ghat = g / (den + 1e-6) and
  c = sum_d out * ghat in plain torch, as the JAX glue `_attn_bwd` does, then
  runs K3 (one launch, two passes) for dQ, dK, dV and dE1.  K3 writes every
  dE1 slot (zeros where no edge counts), so its output is allocated, not
  zero-filled; K2 writes out and den at every row, so neither is filled
  either.  `bwd_variant` picks the layout of both kernels from the shape: a
  row in registers, D/4 lanes per head (D a multiple of 4, H*D/4 dividing
  32: the shipped H = D = 8), or the general one (D = 7, 10).  On a CUDA
  tensor it launches or raises; on CPU tensors it runs the plain version.

Q is pre-scaled by 1/sqrt(D) in its own type (the scale itself rounded to
that type), as the JAX wrapper scales it before its kernel, so in bf16 the
port rounds where the JAX kernel rounds.  Q, K, V and E1 of mixed types are
first cast to their common type.  The TPU kernel differs from both versions
here on an edge whose source lies outside its tile: it counts exp(0) * mask
in the denominator and nothing in the numerator.  The packer makes no such
edges (ROADMAP.md queue 3).

`edge_softmax_attention_tiled.launches_fwd` and `.launches_bwd` count the
kernels' launches; nothing else touches them.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _nvcc
from .spmm_tiled import _tile_mask

# edge_attention_fwd(q, k, v, e1, out, den, senders, w, starts, ends, dst_ptr,
#                    num_nodes, num_heads, head_dim, bn, is_bf16, vec, inv,
#                    stream)
FWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                + [ctypes.c_float, ctypes.c_void_p])
# edge_attention_bwd(q, k, v, e1, ghat, c, dq, dk, dv, de1, senders,
#                    receivers, w, starts, ends, dst_ptr, src_order, src_ptr,
#                    num_nodes, num_edges, num_heads, head_dim, bn, is_bf16,
#                    vec, inv, stream)
BWD_ARGTYPES = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 7
                + [ctypes.c_float, ctypes.c_void_p])


def build() -> ctypes.CDLL:
    """Compile csrc/edge_attention.cu (once per source content) and load it."""
    return _nvcc.load("edge_attention", {"edge_attention_fwd": FWD_ARGTYPES,
                                         "edge_attention_bwd": BWD_ARGTYPES})


def _common_dtype(*ts):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def _inv_sqrt(D: int, dtype) -> float:
    """1/sqrt(D) rounded to `dtype`, as JAX's `Q * (1/sqrt(D))` applies it."""
    return float(torch.tensor(1.0 / math.sqrt(D), dtype=dtype))


def edge_softmax_attention_reference(Q, K, V, E1, senders, receivers,
                                     edge_mask, num_nodes: int):
    """Every edge counts, weighted by edge_mask.  f32 accumulation (f64 for
    f64 input); returns the inputs' common type."""
    dt = _common_dtype(Q, K, V, E1)
    acc = torch.promote_types(dt, torch.float32)
    N, H, D = Q.shape
    s, r = senders.long(), receivers.long()
    qs = Q.to(dt) * torch.tensor(_inv_sqrt(D, dt), dtype=dt)
    score = (K.to(acc)[s] * qs.to(acc)[r] * E1.to(acc)).sum(-1, keepdim=True)
    ex = (torch.exp(torch.clamp(score, -5.0, 5.0))
          * edge_mask.to(acc)[:, None, None])
    wv = torch.zeros((num_nodes, H, D), dtype=acc, device=Q.device)
    wv = wv.index_add_(0, r, ex * V.to(acc)[s])
    z = torch.zeros((num_nodes, H, 1), dtype=acc, device=Q.device)
    z = z.index_add_(0, r, ex)
    return (wv / (z + 1e-6)).to(dt)


def edge_softmax_attention_plain(Q, K, V, E1, senders, receivers, edge_mask,
                                 starts, ends, bn: int):
    """The plain-torch version of K2 (and, through autograd, of K3): the
    reference over the edges that count under the tile-locality rule."""
    keep = _tile_mask(senders, receivers, starts, ends, bn) & (edge_mask != 0)
    idx = torch.nonzero(keep)[:, 0]
    return edge_softmax_attention_reference(
        Q, K, V, E1[idx], senders[idx], receivers[idx], edge_mask[idx],
        Q.shape[0])


def edge_softmax_den_plain(Q, K, E1, senders, receivers, edge_mask, starts,
                           ends, bn: int):
    """K2's second output in plain torch: den [N, H] f32, the sum over the
    edges that count of exp(clamp(score, -5, 5)) * w, from Q scaled as K2
    scales it."""
    keep = _tile_mask(senders, receivers, starts, ends, bn) & (edge_mask != 0)
    idx = torch.nonzero(keep)[:, 0]
    s, r = senders.long()[idx], receivers.long()[idx]
    f32 = torch.float32
    inv = torch.tensor(_inv_sqrt(Q.shape[2], Q.dtype), dtype=Q.dtype,
                       device=Q.device)
    score = (K.to(f32)[s] * (Q * inv).to(f32)[r] * E1.to(f32)[idx]).sum(-1)
    ex = torch.exp(torch.clamp(score, -5.0, 5.0)) * edge_mask.to(f32)[idx][:, None]
    return torch.zeros(Q.shape[:2], dtype=f32, device=Q.device).index_add_(
        0, r, ex)


def edge_attention_bwd_plain(Q, K, V, E1, ghat, c, senders, receivers,
                             edge_mask, starts, ends, bn: int):
    """The plain-torch version of K3 as launched: (dQ, dK, dV, dE1) in f32
    from ghat [N, H, D] and c [N, H] f32, by the formulas of the JAX
    backward (`_attn_bwd_kernel`), over the edges that count.  Autograd
    through `edge_softmax_attention_plain` gives the same gradients, except
    that it forms c from the unrounded output where K3's caller rounds it
    to the input type first, as the JAX glue does."""
    N, H, D = Q.shape
    inv = _inv_sqrt(D, Q.dtype)
    keep = _tile_mask(senders, receivers, starts, ends, bn) & (edge_mask != 0)
    idx = torch.nonzero(keep)[:, 0]
    s, r = senders.long()[idx], receivers.long()[idx]
    f32 = torch.float32
    qd = (Q * torch.tensor(inv, dtype=Q.dtype)).to(f32)[r]
    k, v, e1 = K.to(f32)[s], V.to(f32)[s], E1.to(f32)[idx]
    gd = ghat.to(f32)[r]
    score = (k * qd * e1).sum(-1, keepdim=True)
    ex = (torch.exp(torch.clamp(score, -5.0, 5.0))
          * edge_mask.to(f32)[idx][:, None, None])
    ok = (score > -5.0) & (score < 5.0)
    dscore = ((v * gd).sum(-1, keepdim=True) - c.to(f32)[r][..., None]) \
        * ex * ok
    zeros = lambda: torch.zeros((N, H, D), dtype=f32, device=Q.device)
    dq = zeros().index_add_(0, r, k * e1 * dscore) * inv
    dk = zeros().index_add_(0, s, qd * e1 * dscore)
    dv = zeros().index_add_(0, s, ex * gd)
    de1 = torch.zeros(E1.shape, dtype=f32, device=Q.device)
    de1[idx] = k * qd * dscore
    return dq, dk, dv, de1


def bwd_variant(H: int, D: int, aligned: bool) -> int:
    """The layout of K3 and of K2 (both C entries take the same condition):
    1, the vector one (a row's H*D features in H*D/4 lanes, 4 a lane, D/4
    lanes a head), where D is a multiple of 4, H*D/4 divides 32 and the
    feature rows are `aligned` to 4 elements; else 0, the general one."""
    lanes = H * D // 4
    return int(D % 4 == 0 and 0 < lanes <= 32 and 32 % lanes == 0
               and aligned)


def _check(Q, K, V, E1, ints, num_ptr: int, bn: int, n_tiles: int):
    if Q.dtype not in (torch.float32, torch.bfloat16) or Q.dim() != 3:
        raise TypeError(f"edge attention kernel takes f32 or bf16 Q [N, H, D],"
                        f" got {Q.dtype} {tuple(Q.shape)}")
    for name, t in (("K", K), ("V", V)):
        if t.shape != Q.shape or t.dtype != Q.dtype:
            raise TypeError(f"{name} must match Q's shape and type")
    if E1.dtype != Q.dtype or E1.dim() != 3 or E1.shape[1:] != Q.shape[1:]:
        raise TypeError("E1 must be [E, H, D] in Q's type")
    N = Q.shape[0]
    if N % bn or n_tiles != N // bn:
        raise ValueError(f"{N} nodes do not make {n_tiles} tiles of {bn}")
    for a in ints:
        if a.device != Q.device or a.dtype != torch.int32:
            raise TypeError("edge attention kernel takes int32 index arrays "
                            "on the features' device")
    if num_ptr != N + 1:
        raise ValueError("CSR pointers must have num_nodes + 1 entries")


def _addr(t):
    return t.data_ptr()


def _launch_fwd(Q, K, V, E1, senders, w, starts, ends, dst_ptr, bn: int):
    """K2: (out [N, H, D] in Q's type, den [N, H] f32)."""
    Q, K, V, E1, senders, starts, ends, dst_ptr = (
        a.contiguous() for a in (Q, K, V, E1, senders, starts, ends, dst_ptr))
    _check(Q, K, V, E1, (senders, starts, ends, dst_ptr), dst_ptr.shape[0],
           bn, starts.shape[0])
    w = w.to(torch.float32).contiguous()
    N, H, D = Q.shape
    lib = build()
    out = torch.empty_like(Q)  # K2 writes every row of out and den
    den = torch.empty((N, H), dtype=torch.float32, device=Q.device)
    row_bytes = 4 * Q.element_size()
    aligned = all(t.data_ptr() % row_bytes == 0 for t in (Q, K, V, E1, out))
    stream = torch.cuda.current_stream(Q.device).cuda_stream
    err = lib.edge_attention_fwd(
        *map(_addr, (Q, K, V, E1, out, den, senders, w, starts, ends,
                     dst_ptr)),
        N, H, D, bn, int(Q.dtype == torch.bfloat16),
        bwd_variant(H, D, aligned), _inv_sqrt(D, Q.dtype), stream)
    if err != 0:
        raise RuntimeError(f"edge attention forward kernel launch failed: "
                           f"CUDA error {err}")
    edge_softmax_attention_tiled.launches_fwd += 1
    return out, den


def _launch_bwd(Q, K, V, E1, ghat, c, senders, receivers, w, starts, ends,
                csr, bn: int):
    """K3: (dQ, dK, dV, dE1), f32, from ghat [N, H, D] and c [N, H] f32."""
    Q, K, V, E1, senders, receivers, starts, ends = (
        a.contiguous() for a in (Q, K, V, E1, senders, receivers, starts,
                                 ends))
    dst_ptr, src_order, src_ptr = (a.contiguous() for a in csr)
    _check(Q, K, V, E1, (senders, receivers, starts, ends, dst_ptr,
                         src_order, src_ptr),
           dst_ptr.shape[0], bn, starts.shape[0])
    if src_ptr.shape[0] != Q.shape[0] + 1:
        raise ValueError("CSR pointers must have num_nodes + 1 entries")
    ghat = ghat.to(torch.float32).contiguous()
    c = c.to(torch.float32).contiguous()
    if ghat.shape != Q.shape or c.shape != Q.shape[:2]:
        raise ValueError("ghat must be [N, H, D] and c [N, H]")
    w = w.to(torch.float32).contiguous()
    N, H, D = Q.shape
    if (N + E1.shape[0]) * H * D >= 2 ** 31:
        raise ValueError("edge attention backward kernel takes (N + E) * H "
                         "* D < 2**31 (32-bit offsets)")
    lib = build()
    f32 = dict(dtype=torch.float32, device=Q.device)
    dq, dk, dv = (torch.empty(Q.shape, **f32) for _ in range(3))
    de1 = torch.empty(E1.shape, **f32)  # K3 writes every slot
    row_bytes = 4 * Q.element_size()
    aligned = (all(t.data_ptr() % row_bytes == 0 for t in (Q, K, V, E1))
               and ghat.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(Q.device).cuda_stream
    err = lib.edge_attention_bwd(
        *map(_addr, (Q, K, V, E1, ghat, c, dq, dk, dv, de1, senders,
                     receivers, w, starts, ends, dst_ptr, src_order,
                     src_ptr)),
        N, E1.shape[0], H, D, bn, int(Q.dtype == torch.bfloat16),
        bwd_variant(H, D, aligned), _inv_sqrt(D, Q.dtype), stream)
    if err != 0:
        raise RuntimeError(f"edge attention backward kernel launch failed: "
                           f"CUDA error {err}")
    edge_softmax_attention_tiled.launches_bwd += 1
    return dq, dk, dv, de1


class _EdgeAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Q, K, V, E1, senders, receivers, w, starts, ends, bn,
                csr):
        out, den = _launch_fwd(Q, K, V, E1, senders, w, starts, ends, csr[0],
                               bn)
        ctx.save_for_backward(Q, K, V, E1, senders, receivers, w, starts,
                              ends, out, den)
        ctx.bn, ctx.csr = bn, csr
        return out

    @staticmethod
    def backward(ctx, g):
        Q, K, V, E1, senders, receivers, w, starts, ends, out, den = (
            ctx.saved_tensors)
        ghat = g.to(torch.float32) / (den[:, :, None] + 1e-6)
        c = (out.to(torch.float32) * ghat).sum(-1)
        dq, dk, dv, de1 = _launch_bwd(Q, K, V, E1, ghat, c, senders,
                                      receivers, w, starts, ends, ctx.csr,
                                      ctx.bn)
        return (dq.to(Q.dtype), dk.to(K.dtype), dv.to(V.dtype),
                de1.to(E1.dtype)) + (None,) * 7


def edge_softmax_attention_tiled(Q, K, V, E1, senders, receivers, edge_mask,
                                 starts, ends, bn: int,
                                 csr: Tuple[torch.Tensor, ...]):
    """Tile-local fused attention, differentiable in Q, K, V and E1.

    Q/K/V [N, H, D], E1 [E, H, D] (ones for the unmodulated variant), a
    batch packed in tiles of `bn` with dst-sorted edges, `starts`/`ends` =
    its tile_starts/tile_ends and `csr` = its (dst_ptr, src_order, src_ptr)
    from `graph.batch.edge_csr`.  Returns [N, H, D] in the inputs' common
    type.
    """
    _nvcc.refuse_dtensor("edge_softmax_attention_tiled", Q, K, V, E1,
                         senders, receivers, edge_mask, starts, ends, *csr)
    dt = _common_dtype(Q, K, V, E1)
    Q, K, V, E1 = (t.to(dt) for t in (Q, K, V, E1))
    if Q.device.type == "cuda":
        return _EdgeAttention.apply(Q, K, V, E1, senders, receivers,
                                    edge_mask, starts, ends, bn, csr)
    if Q.device.type == "cpu":
        return edge_softmax_attention_plain(Q, K, V, E1, senders, receivers,
                                            edge_mask, starts, ends, bn)
    raise RuntimeError(f"edge_softmax_attention_tiled has no path for device "
                       f"{Q.device}")


edge_softmax_attention_tiled.launches_fwd = 0
edge_softmax_attention_tiled.launches_bwd = 0
