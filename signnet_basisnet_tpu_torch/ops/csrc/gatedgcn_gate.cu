// Fused GatedGCN gate and aggregation for Hopper (sm_90a): kernel K4.
//
// Replaces the Pallas TPU kernel signnet_basisnet_tpu/ops/pallas_gatedgcn.py:
// _gate_pallas_raw (body _gate_kernel).  For Bh, Dh, Eh [N, F] and Ce [E, F],
// per edge slot e = (s -> n) and feature f:
//
//   e_new[e]  = Dh[s] + Eh[n] + Ce[e]                   (every in-range slot)
//   sig_e     = sigmoid(e_new[e]) * w_e
//   agg[n]    = sum_e sig_e * Bh[s] / (sum_e sig_e + 1e-6)
//
// Which slots: nodes come in tiles of `bn`; edges are sorted by destination;
// slot e is in range if it lies in [starts[t], ends[t]) of its destination's
// tile t.  e_new is written at every in-range slot, the weight-0 padding
// edges included (they reach the edge BatchNorm, which masks them, and the
// next layer's C(e)), and is zero at the slots outside every range, as the
// TPU kernel leaves them.  agg counts the in-range edges of weight != 0.
// An edge whose source lies outside its tile counts fully: Dh[s] and Bh[s]
// are read wherever s lies, as gatedgcn_gate_reference and the backward
// (_gate_bwd, the exact VJP of the reference) count it.  (The TPU kernel's
// one-hot gather reads such a source as a zero row.  The packer makes no
// such edge.)
//
// Types: Bh, Dh, Eh, Ce f32 or bf16 (one type for all four), w f32.  e_new,
// sig and the sums are f32, in the order (Dh[s] + Eh[n]) + Ce; sig comes
// from the unrounded f32 e_new; agg and e_new are rounded to the input type
// once, on store, as the TPU kernel's f32 accumulation does.
//
// What bounds it on the card.  On a 128-graph synthetic ZINC batch (N = 3584
// slots, E = 7168 slots of which 5996 real, F = 68, f32) it reads Bh and Dh
// at the ~3000 rows that counted edges reach, Eh at the destination rows,
// Ce at every slot, and writes e_new at every slot and agg at every row:
// about 7.4 MB, 2.2 us at an H100's 3.35 TB/s, against about 5 MFLOP.  It
// is bound by memory, and at this size by launch latency.  The TPU form
// gathered rows with one-hot [be, bn] MXU products and padded F to 128
// lanes; this kernel gathers rows with index loads instead.
//
// Design (simple; later work makes it fast).  One launch, two kinds of
// block:
// - row blocks: one warp per (destination row, chunk of 128 features),
//   8 rows per 256-thread block; lanes take the features at stride 32, so a
//   gathered row is one coalesced read.  The warp loads 32 of its row's edges
//   (dst_ptr within the tile's range) at once, a ballot marks those of
//   weight != 0, and the counted ones are taken one by one, each lane
//   summing num and den for its own features in registers: no cross-lane
//   reduction, no atomics, a fixed order.  The batch's 1172 padding edges
//   all sit on its last node; the ballot skips them 32 at a time, so that
//   row is no tail;
// - edge blocks: one thread per (slot, feature) element, 4 elements each at
//   a stride of the block size, writing e_new.  This part is edge-parallel,
//   so the padding row's e_new costs what any other slots' cost.
// Both recompute e_new with the same f32 additions in the same order.  Any
// F is taken (68, 77, 70 in the shipped configs and tests; F = 68 is not a
// multiple of 32, and bf16 rows of 136 B are only 8-byte aligned, so the
// loads are scalar).  No tensor cores.
//
// Plain C interface, loaded with ctypes: the entry returns cudaGetLastError()
// after the launch and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // rows per row block
constexpr int kPerLane = 4;            // features per lane
constexpr int kChunk = 32 * kPerLane;  // features per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kEdgeItems = 4;          // e_new elements per thread
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// agg[n] for the features f0 + 32 i of one warp
template <typename T>
__device__ __forceinline__ void gate_row(
    int n, int f0, int lane, const T* __restrict__ bh, const T* __restrict__ dh,
    const T* __restrict__ eh, const T* __restrict__ ce, T* __restrict__ agg,
    const int* __restrict__ senders, const float* __restrict__ w,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ dst_ptr, int F, int bn) {
  const int t = n / bn;
  const int j0 = max(__ldg(dst_ptr + n), __ldg(starts + t));
  const int j1 = min(__ldg(dst_ptr + n + 1), __ldg(ends + t));
  float en[kPerLane], num[kPerLane], den[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int f = f0 + 32 * i;
    en[i] = f < F ? to_f32(eh[(size_t)n * F + f]) : 0.f;
    num[i] = den[i] = 0.f;
  }
  for (int jb = j0; jb < j1; jb += 32) {
    const int j = jb + lane;
    int src = 0;
    float we = 0.f;
    if (j < j1) {
      src = __ldg(senders + j);
      we = __ldg(w + j);
    }
    unsigned bits = __ballot_sync(kAll, we != 0.f);
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      const int o = __shfl_sync(kAll, src, b);
      const float wo = __shfl_sync(kAll, we, b);
      const T* dr = dh + (size_t)o * F;
      const T* br = bh + (size_t)o * F;
      const T* cr = ce + (size_t)(jb + b) * F;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int f = f0 + 32 * i;
        if (f < F) {
          const float x = (to_f32(dr[f]) + en[i]) + to_f32(cr[f]);
          const float s = (1.f / (1.f + expf(-x))) * wo;
          num[i] += s * to_f32(br[f]);
          den[i] += s;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int f = f0 + 32 * i;
    if (f < F) agg[(size_t)n * F + f] = from_f32<T>(num[i] / (den[i] + 1e-6f));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gate_kernel(
    const T* __restrict__ bh, const T* __restrict__ dh, const T* __restrict__ eh,
    const T* __restrict__ ce, T* __restrict__ agg, T* __restrict__ e_new,
    const int* __restrict__ senders, const int* __restrict__ receivers,
    const float* __restrict__ w, const int* __restrict__ starts,
    const int* __restrict__ ends, const int* __restrict__ dst_ptr, int num_nodes,
    int num_edges, int F, int bn, int row_blocks, int chunks) {
  if ((int)blockIdx.x < row_blocks) {
    const int lane = threadIdx.x & 31;
    const int n = (blockIdx.x / chunks) * kWarps + (threadIdx.x >> 5);
    if (n >= num_nodes) return;  // whole warps leave together
    gate_row(n, (blockIdx.x % chunks) * kChunk + lane, lane, bh, dh, eh, ce, agg,
             senders, w, starts, ends, dst_ptr, F, bn);
    return;
  }
  const size_t total = (size_t)num_edges * F;
  const size_t base = (size_t)(blockIdx.x - row_blocks) * kThreads * kEdgeItems;
#pragma unroll
  for (int k = 0; k < kEdgeItems; ++k) {
    const size_t idx = base + (size_t)k * kThreads + threadIdx.x;
    if (idx >= total) return;
    const int e = (int)(idx / F);
    const int f = (int)(idx - (size_t)e * F);
    const int r = __ldg(receivers + e);
    const int t = r / bn;
    float v = 0.f;
    if (e >= __ldg(starts + t) && e < __ldg(ends + t)) {
      const int s = __ldg(senders + e);
      v = (to_f32(dh[(size_t)s * F + f]) + to_f32(eh[(size_t)r * F + f])) +
          to_f32(ce[idx]);
    }
    e_new[idx] = from_f32<T>(v);
  }
}

template <typename T>
void launch(const void* bh, const void* dh, const void* eh, const void* ce, void* agg,
            void* e_new, const void* senders, const void* receivers, const void* w,
            const void* starts, const void* ends, const void* dst_ptr, int num_nodes,
            int num_edges, int F, int bn, cudaStream_t stream) {
  const int chunks = (F + kChunk - 1) / kChunk;
  const int row_blocks = (num_nodes + kWarps - 1) / kWarps * chunks;
  const long long elems = (long long)num_edges * F;
  const int edge_blocks = (int)((elems + kThreads * kEdgeItems - 1) / (kThreads * kEdgeItems));
  gate_kernel<T><<<row_blocks + edge_blocks, kThreads, 0, stream>>>(
      (const T*)bh, (const T*)dh, (const T*)eh, (const T*)ce, (T*)agg, (T*)e_new,
      (const int*)senders, (const int*)receivers, (const float*)w, (const int*)starts,
      (const int*)ends, (const int*)dst_ptr, num_nodes, num_edges, F, bn, row_blocks,
      chunks);
}

}  // namespace

// bh, dh, eh, agg: [num_nodes, num_feat]; ce, e_new: [num_edges, num_feat];
// all f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).  senders, receivers: [E]
// int32, dst-sorted; w: [E] f32; starts, ends: [num_nodes / bn] int32, the
// tiles' edge ranges; dst_ptr: [num_nodes + 1] int32, the CSR pointers over
// the dst-sorted edges.
extern "C" int gatedgcn_gate_fwd(const void* bh, const void* dh, const void* eh,
                                 const void* ce, void* agg, void* e_new,
                                 const void* senders, const void* receivers, const void* w,
                                 const void* starts, const void* ends, const void* dst_ptr,
                                 int num_nodes, int num_edges, int num_feat, int bn,
                                 int is_bf16, void* stream) {
  if (num_nodes > 0 && num_feat > 0) {
    if (is_bf16) {
      launch<__nv_bfloat16>(bh, dh, eh, ce, agg, e_new, senders, receivers, w, starts,
                            ends, dst_ptr, num_nodes, num_edges, num_feat, bn,
                            (cudaStream_t)stream);
    } else {
      launch<float>(bh, dh, eh, ce, agg, e_new, senders, receivers, w, starts, ends,
                    dst_ptr, num_nodes, num_edges, num_feat, bn, (cudaStream_t)stream);
    }
  }
  return (int)cudaGetLastError();
}
