// Flat destination-sorted SpMM for Hopper (sm_90a):
//     out[n] = sum over the counted edges e with dst_e = n of w_e * x[src_e]
//
// Replaces the Pallas TPU kernel signnet_basisnet_tpu/ops/pallas_spmm.py:
// spmm_pallas (body _spmm_kernel).  Same contract: edges sorted by
// destination; edge e counts for its destination row n only if it lies in
// the range [starts[t], ends[t]) of n's tile t = n / bn (the TPU kernel masks
// by the same ranges); sources may lie anywhere on the node axis, which has
// any length (no multiple of bn needed).  Unlike the TPU kernel, edges of
// weight 0 (the padding pad_edges_to appends) are skipped, and only the rows
// the counted edges name are read: the TPU kernel gathers through a one-hot
// product over the whole of x, so one non-finite row of x reaches every
// output row there (0 * inf = NaN); here it reaches only the rows whose
// counted edges read it.
//
// What bounds it on the card.  At the shape of the port's bench_ops
// (N = 3072, D = 128, 6912 edges padded to 7168, f32) the work is about
// 6200 counted edges, 2 * 6200 * 128 = 1.6 MFLOP, against reading x at the
// ~2650 source rows they name, writing all 3072 output rows, and reading the
// index arrays: about 3 MB, 0.9 us at an H100's 3.35 TB/s.  It is bound by
// memory, and at this size by launch latency.  The TPU form (one-hot [256, N]
// gather and [bn, 256] scatter products on the MXU, N * D * 2 flops per edge)
// was a workaround for a machine without a fast gather; this kernel gathers.
//
// Design (K1's forward row walk without its tile-locality test; simple,
// later work makes it fast):
// - one warp per (row, chunk of 128 features), 8 rows per 256-thread block,
//   grid.y over the feature chunks; lanes hold 4 features each at stride 32
//   with a tail check, so any D runs and every edge reads a coalesced slice;
// - a row's edges are [dst_ptr[n], dst_ptr[n + 1]) intersected with its
//   tile's range; the wrapper makes dst_ptr from the receivers on the device;
// - the warp loads up to 128 of its row's edges at once (4 per lane), a
//   ballot marks the ones of weight != 0, and each counted edge's source and
//   weight are broadcast with __shfl_sync, two at a time so their row loads
//   overlap;
// - each row sums its edges in a fixed order in f32 registers and writes its
//   output once, zeros for a row with no counted edge: no atomics, no
//   clearing pass, and the result does not depend on scheduling;
// - features f32 or bf16, weights f32, accumulation f32, one rounding into
//   the feature type.  No tensor cores, so no TF32 anywhere.
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

// acc[i] += w * x[s*F + f0 + 32 i], for the lane's 4 features
template <typename T>
__device__ __forceinline__ void fma_row(float* acc, const T* __restrict__ x, int s,
                                        float w, int f0, int num_feat) {
  const T* xr = x + (size_t)s * num_feat;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int f = f0 + 32 * i;
    if (f < num_feat) acc[i] += w * to_f32(xr[f]);
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps) spmm_flat_kernel(
    const T* __restrict__ x, T* __restrict__ out, const int* __restrict__ senders,
    const float* __restrict__ w, const int* __restrict__ starts,
    const int* __restrict__ ends, const int* __restrict__ dst_ptr, int num_nodes,
    int num_feat, int bn) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= num_nodes) return;  // whole warps leave together
  const int t = n / bn;
  const int j0 = max(__ldg(dst_ptr + n), __ldg(starts + t));
  const int j1 = min(__ldg(dst_ptr + n + 1), __ldg(ends + t));
  const int f0 = blockIdx.y * kChunk + lane;

  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;

  // The row's edges, 128 at a time: lane k fetches edges jb + 32 q + k
  // (q < 4, four independent loads in flight) with their source and weight,
  // and a ballot marks the ones of weight != 0.
  for (int jb = j0; jb < j1; jb += 4 * 32) {
    int src[4];
    float we[4];
    unsigned counted[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = jb + 32 * q + lane;
      src[q] = 0;
      we[q] = 0.f;
      if (j < j1) {
        src[q] = __ldg(senders + j);
        we[q] = __ldg(w + j);
      }
      counted[q] = __ballot_sync(kAll, we[q] != 0.f);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned bits = counted[q];  // the same in every lane
      while (bits) {  // two edges per trip, so their row loads overlap
        const int k0 = __ffs(bits) - 1;
        bits &= bits - 1;
        const int s0 = __shfl_sync(kAll, src[q], k0);
        const float w0 = __shfl_sync(kAll, we[q], k0);
        if (bits) {
          const int k1 = __ffs(bits) - 1;
          bits &= bits - 1;
          const int s1 = __shfl_sync(kAll, src[q], k1);
          const float w1 = __shfl_sync(kAll, we[q], k1);
          float a0[kPerLane], a1[kPerLane];
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) a0[i] = a1[i] = 0.f;
          fma_row(a0, x, s0, w0, f0, num_feat);
          fma_row(a1, x, s1, w1, f0, num_feat);
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) acc[i] += a0[i] + a1[i];
        } else {
          fma_row(acc, x, s0, w0, f0, num_feat);
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
void launch(const void* x, void* out, const void* senders, const void* w,
            const void* starts, const void* ends, const void* dst_ptr, int num_nodes,
            int num_feat, int bn, cudaStream_t stream) {
  const dim3 block(32 * kWarps);
  const dim3 grid((num_nodes + kWarps - 1) / kWarps, (num_feat + kChunk - 1) / kChunk);
  spmm_flat_kernel<T><<<grid, block, 0, stream>>>(
      (const T*)x, (T*)out, (const int*)senders, (const float*)w, (const int*)starts,
      (const int*)ends, (const int*)dst_ptr, num_nodes, num_feat, bn);
}

}  // namespace

// x, out: [num_nodes, num_feat] f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// senders: [E] int32 in destination order; w: [E] f32; starts, ends:
// [ceil(num_nodes / bn)] int32; dst_ptr: [num_nodes + 1] int32, the CSR
// pointers of the destination-sorted receivers.
extern "C" int spmm_flat_launch(const void* x, void* out, const void* senders,
                                const void* w, const void* starts, const void* ends,
                                const void* dst_ptr, int num_nodes, int num_feat, int bn,
                                int is_bf16, void* stream) {
  if (num_nodes > 0 && num_feat > 0) {
    if (is_bf16) {
      launch<__nv_bfloat16>(x, out, senders, w, starts, ends, dst_ptr, num_nodes,
                            num_feat, bn, (cudaStream_t)stream);
    } else {
      launch<float>(x, out, senders, w, starts, ends, dst_ptr, num_nodes, num_feat, bn,
                    (cudaStream_t)stream);
    }
  }
  return (int)cudaGetLastError();
}
