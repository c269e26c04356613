// Tile-local SpMM for Hopper (sm_90a): out[n] = sum_{e: dst_e = n} w_e * x[src_e].
//
// Replaces the Pallas TPU kernel signnet_basisnet_tpu/ops/pallas_spmm.py:
// _spmm_tiled_raw (body _spmm_tile_kernel + _tile_adj).  Same contract:
// nodes come in tiles of `bn`; edges are sorted by destination; edge e counts
// for destination tile t only if it lies in [starts[t], ends[t]) and its
// source lies in tile t too (edges that break tile locality are dropped, as
// _tile_adj drops them).  `transpose` = 1 gives dx = A^T g for the backward:
// dx[s] = sum over the counted edges with src_e = s of w_e * g[dst_e].
//
// What bounds it on the card.  The main path has about 2 edges per node, so
// the work is 2*E*F flops against reading x at the rows that counted edges
// reach and writing every output row once: on a 128-graph synthetic ZINC
// batch (N = 3584 slots, 2985 real nodes, E = 7168, F = 1520, f32) that is
// 18 MFLOP against 40 MB, about 12 us at an H100's 3.35 TB/s.  It is bound
// by memory, never by arithmetic.  The TPU
// form built a dense f32 [256, 256] tile adjacency from one-hot MXU products
// (a VMEM workaround, 128x the needed arithmetic, and 256 KB, more than the
// 227 KB of shared memory a block can use); this kernel walks the sparse
// edges instead.
//
// Design (simple; later work makes it fast):
// - one warp per (row, chunk of 128 features), 8 rows per 256-thread block,
//   grid.y over the feature chunks; lanes hold 4 features each at stride 32,
//   so every edge reads a coalesced 512 B slice of an f32 row;
// - a row's edges come from a CSR pointer array made once per batch on the
//   host: forward, `ptr` over the dst-sorted edges (intersected with the
//   tile's range [starts[t], ends[t])); transposed, `ptr` over a src-sorted
//   permutation `order` of the edges;
// - the warp loads up to 128 of its row's edges at once (4 per lane),
//   checks tile locality there, skips edges of weight 0 (the padding edges,
//   which all sit on the batch's last node), and broadcasts each counted
//   edge with __shfl_sync, two at a time so their row loads overlap;
// - each row sums its edges in a fixed order in f32 registers and writes its
//   output once: no atomics, so the result does not depend on scheduling;
// - features f32 or bf16, weights f32, accumulation f32, output in the
//   feature type.  No tensor cores, so no TF32 anywhere.
//
// Plain C interface, loaded with ctypes: the entry returns cudaGetLastError()
// after the launch and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // rows per block
constexpr int kPerLane = 4;            // features per lane
constexpr int kChunk = 32 * kPerLane;  // features per warp (grid.y)
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// acc[i] += w * x[o*F + f0 + 32 i], for the lane's 4 features
template <typename T>
__device__ __forceinline__ void fma_row(float* acc, const T* __restrict__ x, int o,
                                        float w, int f0, int num_feat) {
  const T* xr = x + (size_t)o * num_feat;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int f = f0 + 32 * i;
    if (f < num_feat) acc[i] += w * to_f32(xr[f]);
  }
}

template <typename T, bool kTranspose>
__global__ void __launch_bounds__(32 * kWarps) spmm_tiled_kernel(
    const T* __restrict__ x, T* __restrict__ out,
    const int* __restrict__ senders, const int* __restrict__ receivers,
    const float* __restrict__ w,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ ptr, const int* __restrict__ order,
    int num_nodes, int num_feat, int bn) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= num_nodes) return;  // whole warps leave together
  const int t = n / bn;
  const int n_lo = t * bn;
  const int e_lo = __ldg(starts + t), e_hi = __ldg(ends + t);
  int j0 = __ldg(ptr + n), j1 = __ldg(ptr + n + 1);
  if (!kTranspose) {  // the forward walks the dst-sorted edges in range
    j0 = max(j0, e_lo);
    j1 = min(j1, e_hi);
  }
  const int f0 = blockIdx.y * kChunk + lane;

  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;

  // The row's edges, 128 at a time: lane k fetches edges jb + 32 q + k
  // (q < 4, four independent loads in flight) with their other endpoint
  // (the source forward, the destination transposed) and weight, and a
  // ballot marks the ones that count.  Edges of weight 0 count for nothing
  // and are skipped: the padding edges of a batch all sit on its last node,
  // and walking them one by one would make that row the kernel's tail.
  for (int jb = j0; jb < j1; jb += 4 * 32) {
    int other[4];
    float we[4];
    unsigned counted[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = jb + 32 * q + lane;
      bool ok = false;
      other[q] = 0;
      we[q] = 0.f;
      if (j < j1) {
        const int e = kTranspose ? __ldg(order + j) : j;
        other[q] = kTranspose ? __ldg(receivers + e) : __ldg(senders + e);
        we[q] = __ldg(w + e);
        ok = we[q] != 0.f && other[q] >= n_lo && other[q] < n_lo + bn;
        // transposed: the edge must also lie in its destination tile's range
        if (kTranspose) ok = ok && e >= e_lo && e < e_hi;
      }
      counted[q] = __ballot_sync(kAll, ok);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned bits = counted[q];  // the same in every lane
      while (bits) {  // two edges per trip, so their row loads overlap
        const int k0 = __ffs(bits) - 1;
        bits &= bits - 1;
        const int o0 = __shfl_sync(kAll, other[q], k0);
        const float w0 = __shfl_sync(kAll, we[q], k0);
        if (bits) {
          const int k1 = __ffs(bits) - 1;
          bits &= bits - 1;
          const int o1 = __shfl_sync(kAll, other[q], k1);
          const float w1 = __shfl_sync(kAll, we[q], k1);
          float a0[kPerLane], a1[kPerLane];
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) a0[i] = a1[i] = 0.f;
          fma_row(a0, x, o0, w0, f0, num_feat);
          fma_row(a1, x, o1, w1, f0, num_feat);
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) acc[i] += a0[i] + a1[i];
        } else {
          fma_row(acc, x, o0, w0, f0, num_feat);
        }
      }
    }
  }

  T* orow = out + (size_t)n * num_feat;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int f = f0 + 32 * i;
    if (f < num_feat) orow[f] = from_f32<T>(acc[i]);
  }
}

template <typename T>
void launch(const void* x, void* out, const void* senders, const void* receivers,
            const void* w, const void* starts, const void* ends, const void* ptr,
            const void* order, int num_nodes, int num_feat, int bn, int transpose,
            cudaStream_t stream) {
  const dim3 block(32 * kWarps);
  const dim3 grid((num_nodes + kWarps - 1) / kWarps, (num_feat + kChunk - 1) / kChunk);
  if (transpose) {
    spmm_tiled_kernel<T, true><<<grid, block, 0, stream>>>(
        (const T*)x, (T*)out, (const int*)senders, (const int*)receivers, (const float*)w,
        (const int*)starts, (const int*)ends, (const int*)ptr, (const int*)order,
        num_nodes, num_feat, bn);
  } else {
    spmm_tiled_kernel<T, false><<<grid, block, 0, stream>>>(
        (const T*)x, (T*)out, (const int*)senders, (const int*)receivers, (const float*)w,
        (const int*)starts, (const int*)ends, (const int*)ptr, (const int*)order,
        num_nodes, num_feat, bn);
  }
}

}  // namespace

// x, out: [num_nodes, num_feat] f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// senders, receivers: [E] int32, dst-sorted; w: [E] f32; starts, ends: [T]
// int32; ptr: [num_nodes + 1] int32, the CSR pointers over the dst-sorted
// edges (transpose = 0) or over `order`, the src-sorted permutation of the
// edges (transpose = 1; `order` is unused and may be null otherwise).
extern "C" int spmm_tiled_launch(const void* x, void* out, const void* senders,
                                 const void* receivers, const void* w, const void* starts,
                                 const void* ends, const void* ptr, const void* order,
                                 int num_nodes, int num_feat, int bn, int is_bf16,
                                 int transpose, void* stream) {
  if (num_nodes > 0 && num_feat > 0) {
    if (is_bf16) {
      launch<__nv_bfloat16>(x, out, senders, receivers, w, starts, ends, ptr, order,
                            num_nodes, num_feat, bn, transpose, (cudaStream_t)stream);
    } else {
      launch<float>(x, out, senders, receivers, w, starts, ends, ptr, order, num_nodes,
                    num_feat, bn, transpose, (cudaStream_t)stream);
    }
  }
  return (int)cudaGetLastError();
}
