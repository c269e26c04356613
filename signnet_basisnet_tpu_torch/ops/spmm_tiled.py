"""Tile-local SpMM (kernel K1): out[n] = sum_{e: dst_e = n} w_e * x[src_e].

Port of signnet_basisnet_tpu/ops/pallas_spmm.py:spmm_tiled (the Pallas
kernel `_spmm_tiled_raw`, body `_spmm_tile_kernel` + `_tile_adj`).  The
contract is the JAX one: a batch packed with `batch_np(tile=bn)`, edges sorted
by destination, per-tile edge ranges `starts`/`ends` =
extras['tile_starts'/'tile_ends'], num_nodes % bn == 0.  An edge counts for
tile t only inside [starts[t], ends[t]) and only if both endpoints lie in
tile t; other edges are dropped, as the TPU kernel drops them.  Edges of
weight 0 (a batch's padding edges) are skipped, so a non-finite x row
reached only through them does not leak into the output.

- On CUDA tensors `spmm_tiled` launches the hand-written kernel
  `csrc/spmm_tiled.cu` (sm_90a, built with nvcc at first use by
  `_nvcc.load`, bound with ctypes) for the forward and, with
  `transpose=1`, for dx = A^T g in the backward.  There is no fallback: a
  failed build or launch raises.
  The kernel's design and its bound are noted in its source: memory-bound,
  about 12 us at N=3584, F=1520 (f32) on an H100 at 3.35 TB/s.  Each
  row's edges are walked once; `kernel_variant` picks, from the shape, the
  features per load (16 bytes where F and the pointers allow it, else one
  element) and the lanes per row (several rows a warp for narrow F, up to
  4 warps a row for wide F).  Every variant is a kernel of the same
  source.
- On CPU tensors it runs `spmm_tiled_plain`, the same function in plain
  torch (index_select + index_add_ with the tile-locality mask).
- dw_e = g[dst_e] . x[src_e], only when the weights need a gradient, is plain
  torch on either device, as the JAX backward leaves it to XLA (and, as
  there, it is not masked by tile locality).

`spmm_tiled.launches` counts kernel launches (both directions); nothing else
touches it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _nvcc

# spmm_tiled_launch(x, out, senders, receivers, w, starts, ends, ptr, order,
#                   num_nodes, num_feat, bn, is_bf16, transpose, vec, group,
#                   stream)
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

# the kernel's vectors per lane per edge (`vecs_per_edge` in the source), by
# features per load
_VECS_PER_EDGE = {1: 8, 4: 2, 8: 2}
# lanes per row the kernel takes
_GROUPS = (4, 8, 16, 32, 64, 128)


def build() -> ctypes.CDLL:
    """Compile csrc/spmm_tiled.cu (once per source content) and load it."""
    return _nvcc.load("spmm_tiled", {"spmm_tiled_launch": LAUNCH_ARGTYPES})


def edge_in_range(receivers, starts, ends, bn: int):
    """[E] bool: edge slot e lies inside its destination tile's range."""
    r = receivers.long()
    n_tiles = starts.shape[0]
    t = torch.clamp(r // bn, max=n_tiles - 1)
    e = torch.arange(r.shape[0], device=r.device)
    return (r // bn < n_tiles) & (e >= starts.long()[t]) & (e < ends.long()[t])


def kernel_variant(num_feat: int, dtype, aligned: bool, bn: int):
    """(vec, group) of the kernel for rows of `num_feat` features of `dtype`
    in tiles of `bn`: vec features per load, 16 bytes (4 f32, 8 bf16) when
    num_feat is a multiple of it and x and out are 16-byte `aligned`, else
    1; group lanes per row, the fewest of 4, 8, 16, 32, 64, 128 whose
    loads cover the row in one pass (a row above 32 lanes takes group / 32
    warps), widened until the 32 / group rows of a warp divide bn (so that
    they share a tile)."""
    wide = 16 // torch.tensor([], dtype=dtype).element_size()
    vec = wide if aligned and num_feat % wide == 0 else 1
    need = -(-num_feat // vec) / _VECS_PER_EDGE[vec]
    group = next((g for g in _GROUPS if g >= need), _GROUPS[-1])
    while group < 32 and bn % (32 // group):
        group *= 2
    return vec, group


def _tile_mask(senders, receivers, starts, ends, bn: int):
    """[E] bool: edge e counts (inside its destination tile's range, both
    endpoints in that tile)."""
    return ((senders.long() // bn == receivers.long() // bn)
            & edge_in_range(receivers, starts, ends, bn))


def spmm_tiled_plain(x, senders, receivers, weights, starts, ends, bn: int,
                     transpose: bool = False):
    """The plain-torch version of the kernel: x [N, F] -> [N, F], f32
    accumulation (f64 for f64 input), output in x's type."""
    acc = torch.promote_types(x.dtype, torch.float32)
    keep = _tile_mask(senders, receivers, starts, ends, bn) & (weights != 0)
    idx = torch.nonzero(keep)[:, 0]
    s, r = senders.long()[idx], receivers.long()[idx]
    src, dst = (r, s) if transpose else (s, r)
    msg = x.index_select(0, src).to(acc) * weights[idx].to(acc)[:, None]
    out = torch.zeros(x.shape, dtype=acc, device=x.device)
    return out.index_add_(0, dst, msg).to(x.dtype)


def _launch(x, senders, receivers, weights, starts, ends, csr, bn: int,
            transpose: bool):
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2:
        raise TypeError(f"spmm_tiled kernel takes f32 or bf16 x [N, F], got "
                        f"{x.dtype} {tuple(x.shape)}")
    num_nodes, num_feat = x.shape
    if num_nodes % bn or starts.shape[0] != num_nodes // bn:
        raise ValueError(f"{num_nodes} nodes do not make {starts.shape[0]} "
                         f"tiles of {bn}")
    ptr, order = (csr[2], csr[1]) if transpose else (csr[0], None)
    senders, receivers, starts, ends, ptr = (
        a.contiguous() for a in (senders, receivers, starts, ends, ptr))
    ints = [senders, receivers, starts, ends, ptr]
    if order is not None:
        order = order.contiguous()
        ints.append(order)
    for a in ints:
        if a.device != x.device or a.dtype != torch.int32:
            raise TypeError("spmm_tiled kernel takes int32 index arrays on "
                            "the features' device")
    if ptr.shape[0] != num_nodes + 1:
        raise ValueError("CSR pointers must have num_nodes + 1 entries")
    x = x.contiguous()
    w = weights.to(torch.float32).contiguous()
    lib = build()
    out = torch.empty_like(x)
    vec, group = kernel_variant(num_feat, x.dtype, x.data_ptr() % 16 == 0,
                                bn)
    addr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.spmm_tiled_launch(
        addr(x), addr(out), addr(senders), addr(receivers), addr(w),
        addr(starts), addr(ends), addr(ptr), addr(order), num_nodes,
        num_feat, bn, int(x.dtype == torch.bfloat16), int(transpose), vec,
        group, stream)
    if err != 0:
        raise RuntimeError(f"spmm_tiled kernel launch failed: CUDA error {err}")
    spmm_tiled.launches += 1
    return out


def _apply(x, senders, receivers, weights, starts, ends, csr, bn: int,
           transpose: bool):
    if x.device.type == "cuda":
        return _launch(x, senders, receivers, weights, starts, ends, csr, bn,
                       transpose)
    if x.device.type == "cpu":
        return spmm_tiled_plain(x, senders, receivers, weights, starts, ends,
                                bn, transpose)
    raise RuntimeError(f"spmm_tiled has no path for device {x.device}")


class _SpmmTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, senders, receivers, weights, starts, ends, csr, bn):
        ctx.bn = bn
        ctx.csr = csr
        ctx.save_for_backward(x if ctx.needs_input_grad[3] else None,
                              senders, receivers, weights, starts, ends)
        return _apply(x, senders, receivers, weights, starts, ends, csr, bn,
                      False)

    @staticmethod
    def backward(ctx, g):
        x, senders, receivers, weights, starts, ends = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _apply(g.contiguous(), senders, receivers, weights, starts,
                        ends, ctx.csr, ctx.bn, True)
        if ctx.needs_input_grad[3]:
            dw = ((g[receivers.long()] * x[senders.long()]).sum(-1)
                  .to(weights.dtype))
        return dx, None, None, dw, None, None, None, None


def spmm_tiled(x, senders, receivers, weights, starts, ends, num_nodes: int,
               bn: int, csr: Tuple[torch.Tensor, ...]):
    """Tile-local SpMM, differentiable in x and weights (x: [N, F]).

    `csr` = (dst_ptr, src_order, src_ptr) of the batch, from
    `graph.batch.edge_csr` (a tiled GraphBatch carries them in extras).
    The kernel walks the rows' edges through them; the plain version on
    CPU tensors does not read them.
    """
    _nvcc.refuse_dtensor("spmm_tiled", x, senders, receivers, weights, starts,
                         ends, *csr)
    if x.shape[0] != num_nodes:
        raise ValueError(f"x has {x.shape[0]} rows, expected {num_nodes}")
    return _SpmmTiled.apply(x, senders, receivers, weights, starts, ends, csr,
                            bn)


spmm_tiled.launches = 0
