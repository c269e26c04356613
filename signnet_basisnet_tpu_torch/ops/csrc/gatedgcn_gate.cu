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
// (_gate_bwd, the exact VJP of the reference) count it.  There is no
// tile-local test here, unlike K1-K3.  (The TPU kernel's one-hot gather
// reads such a source as a zero row.  The packer makes no such edge.)
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
// about 7.4 MB, 2.2 us at an H100's 3.35 TB/s, against about 5 MFLOP.  At
// about 2 edges a row the bytes do not set the time: a row waits on a chain
// of dependent loads (dst_ptr and the tile range, then the senders and
// weights, then Dh, Bh and Ce), and the launch and that chain set it.  The
// TPU form gathered rows with one-hot [be, bn] MXU products and padded F to
// 128 lanes; this kernel gathers rows with index loads instead.
//
// Design: each slot's e_new is computed once, by the one warp that writes
// it, and every load a warp can start at once is in flight together.  One
// launch, two kinds of warp:
// - row warps, one per destination row, from the last row down (the
//   padding row, whose 1172 weight-0 edges are all skipped, starts first).
//   Eh[n] is loaded with the CSR pointers.  A trip loads 256 candidates
//   (unconditional index loads: a lane past the end reloads the last
//   candidate and drops it) and lists the counted ones (in range, weight
//   != 0) in shared memory.  The warp's 32 lanes share out the row, 3
//   features a lane, one element a load (96 features a pass; wider rows
//   take several passes).  Each lane takes kEdges counted edges at once:
//   their Dh, Bh and Ce loads are all in flight before the sums.  From
//   x = (Dh[s] + Eh[n]) + Ce[e] the lane writes e_new[e] and adds
//   sigmoid(x) * w to num and den in registers, in list order, and agg[n]
//   is written once: no atomics, results independent of scheduling;
// - rest warps, one per kRestSlots edge slots, write every slot the row
//   walks do not, testing each slot by the same rule: e_new of an
//   in-range slot of weight 0 (the padding edges), 0 at a slot outside
//   every range, kEdges slots at once.
// Registers and lanes set the layout: every warp of the grid (3584 rows
// and 896 rest warps on the main-path batch) should be resident at once,
// so that the card waits on each chain of loads once, not once per wave.
// In throwaway same-call A/B runs on the card at F = 68, lane groups of 8
// with 3 float4 vectors a lane (4 edges at once) needed about twice the
// registers and were slower; whole-warp rows of float4 vectors leave 15 of
// 32 lanes idle and were slower than one element a load, which keeps every
// lane busy at F = 68, 70 and 77; 4 edges a lane were no faster than 2.
// Rest warps of 8 slots keep the padding edges' 1172 slots off the
// critical path (chip_smoke.py times the kernel with and without them).
// No tensor cores.
//
// Plain C interface, loaded with ctypes: the entry returns cudaGetLastError()
// after the launch and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;          // warps per block
constexpr int kCand = 8;           // candidate edges per lane per trip
constexpr int kCap = 32 * kCand;   // counted edges a warp lists per trip
constexpr int kEdges = 2;          // edges (or rest slots) a lane takes at once
constexpr int kPerLane = 3;        // features a lane takes per pass over a row
constexpr int kRestSlots = 8;      // edge slots per rest warp
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The lane's features c + 32 u (u < kPerLane) of row `row` of x, as f32
// (those below F; the others 0)
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ x, size_t row, int F, int c,
                                         float (&v)[kPerLane]) {
#pragma unroll
  for (int u = 0; u < kPerLane; ++u)
    v[u] = c + 32 * u < F ? to_f32(x[row * F + c + 32 * u]) : 0.f;
}

// A warp's list of counted edges, filled from one trip of candidates: the
// edge slot, its source and its weight.
struct EdgeList {
  int e[kCap];
  int src[kCap];
  float w[kCap];
};

// Row n: agg[n], and e_new at its counted edges.  The warp's lane l takes
// features c0 + l + 32 u (u < kPerLane) of the row, kEdges counted edges
// at once, in list order; rows wider than 32 kPerLane features take
// several passes.
template <typename T>
__device__ __forceinline__ void gate_row(
    EdgeList& list, int n, int lane, const T* __restrict__ bh, const T* __restrict__ dh,
    const T* __restrict__ eh, const T* __restrict__ ce, T* __restrict__ agg,
    T* __restrict__ e_new, const int* __restrict__ senders, const float* __restrict__ w,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ dst_ptr, int F, int bn) {
  const int t = n / bn;
  // every load that needs no index first, all in flight together
  const int e_lo = __ldg(starts + t), e_hi = __ldg(ends + t);
  const int p0 = max(__ldg(dst_ptr + n), e_lo), p1 = min(__ldg(dst_ptr + n + 1), e_hi);
  for (int c = lane; c - lane < F; c += 32 * kPerLane) {  // the same trips in every lane
    float en[kPerLane], num[kPerLane], den[kPerLane];
    load_row<T>(eh, n, F, c, en);
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) num[u] = den[u] = 0.f;
    for (int jb = p0; jb < p1; jb += kCap) {
      int src[kCand];
      float we[kCand];
#pragma unroll
      for (int i = 0; i < kCand; ++i) {  // past the end, the last one again
        const int j = min(jb + 32 * i + lane, p1 - 1);
        src[i] = __ldg(senders + j);
        we[i] = __ldg(w + j);
      }
      int count = 0;
#pragma unroll
      for (int i = 0; i < kCand; ++i) {
        const int j = jb + 32 * i + lane;
        const bool ok = j < p1 && we[i] != 0.f;  // no tile-local test (see the head)
        const unsigned bits = __ballot_sync(kAll, ok);
        if (ok) {
          const int pos = count + __popc(bits & ((1u << lane) - 1u));
          list.e[pos] = j;
          list.src[pos] = src[i];
          list.w[pos] = we[i];
        }
        count += __popc(bits);
      }
      __syncwarp();
      // the counted edges, kEdges at once: every load first, then the sums
      // in list order
      for (int m = 0; m < count; m += kEdges) {
        float d[kEdges][kPerLane], b[kEdges][kPerLane], x[kEdges][kPerLane], wo[kEdges];
        size_t e[kEdges];
#pragma unroll
        for (int q = 0; q < kEdges; ++q) {
          e[q] = (size_t)list.e[min(m + q, count - 1)];
          wo[q] = list.w[min(m + q, count - 1)];
          if (m + q < count) {
            const size_t o = (size_t)list.src[m + q];
            load_row<T>(dh, o, F, c, d[q]);
            load_row<T>(bh, o, F, c, b[q]);
            load_row<T>(ce, e[q], F, c, x[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < kEdges; ++q) {
          if (m + q >= count) break;  // the same in every lane
#pragma unroll
          for (int u = 0; u < kPerLane; ++u) {
            const int f = c + 32 * u;
            if (f < F) {
              const float xv = (d[q][u] + en[u]) + x[q][u];
              const float sg = (1.f / (1.f + expf(-xv))) * wo[q];
              num[u] += sg * b[q][u];
              den[u] += sg;
              e_new[e[q] * F + f] = from_f32<T>(xv);
            }
          }
        }
      }
      __syncwarp();  // the list is refilled by the next trip
    }
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int f = c + 32 * u;
      if (f < F) agg[(size_t)n * F + f] = from_f32<T>(num[u] / (den[u] + 1e-6f));
    }
  }
}

// Slots kRestSlots z ... kRestSlots (z + 1) - 1: e_new at every slot the
// row walks do not write, each slot tested by their rule (in range and
// weight != 0 is theirs): the in-range slots of weight 0 get
// Dh[s] + Eh[n] + Ce, the slots outside every range 0.  kEdges slots at
// once, the lanes over the row as in gate_row.
template <typename T>
__device__ __forceinline__ void gate_rest(
    int z, int lane, const T* __restrict__ dh, const T* __restrict__ eh,
    const T* __restrict__ ce, T* __restrict__ e_new, const int* __restrict__ senders,
    const int* __restrict__ receivers, const float* __restrict__ w,
    const int* __restrict__ starts, const int* __restrict__ ends, int num_nodes,
    int num_edges, int F, int bn) {
  const int j0 = kRestSlots * z;
  const int j = min(j0 + min(lane, kRestSlots - 1), num_edges - 1);
  const int r = __ldg(receivers + j), s = __ldg(senders + j);
  const float we = __ldg(w + j);
  bool in_range = false;
  if (r >= 0 && r < num_nodes) {
    const int t = r / bn;
    in_range = j >= __ldg(starts + t) && j < __ldg(ends + t);
  }
  const bool mine = lane < kRestSlots && j0 + lane < num_edges && !(in_range && we != 0.f);
  const unsigned bits = __ballot_sync(kAll, mine);
  const int rr = in_range ? r : -1;  // -1: outside every range, e_new = 0
  for (int c = lane; c - lane < F; c += 32 * kPerLane) {
    unsigned left = bits;
    while (left) {  // the same in every lane
      float d[kEdges][kPerLane], h[kEdges][kPerLane], x[kEdges][kPerLane];
      int a[kEdges];
#pragma unroll
      for (int q = 0; q < kEdges; ++q) {
        a[q] = left ? __ffs(left) - 1 : -1;
        left &= left - 1;
        const size_t sq = (size_t)__shfl_sync(kAll, s, max(a[q], 0));
        const int rq = __shfl_sync(kAll, rr, max(a[q], 0));
        if (a[q] >= 0 && rq >= 0) {
          load_row<T>(dh, sq, F, c, d[q]);
          load_row<T>(eh, (size_t)rq, F, c, h[q]);
          load_row<T>(ce, (size_t)(j0 + a[q]), F, c, x[q]);
        } else {
#pragma unroll
          for (int u = 0; u < kPerLane; ++u) d[q][u] = h[q][u] = x[q][u] = 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < kEdges; ++q) {
        if (a[q] < 0) break;  // the same in every lane
#pragma unroll
        for (int u = 0; u < kPerLane; ++u) {
          const int f = c + 32 * u;
          if (f < F)
            e_new[(size_t)(j0 + a[q]) * F + f] = from_f32<T>((d[q][u] + h[q][u]) + x[q][u]);
        }
      }
    }
  }
}

// The first rest_blocks blocks hold the rest warps; then row blocks, from
// the last rows down.  No __launch_bounds__: given the block size, ptxas
// squeezes registers to fit one more block an SM and spills (K1, K3).
template <typename T>
__global__ void gate_kernel(
    const T* __restrict__ bh, const T* __restrict__ dh, const T* __restrict__ eh,
    const T* __restrict__ ce, T* __restrict__ agg, T* __restrict__ e_new,
    const int* __restrict__ senders, const int* __restrict__ receivers,
    const float* __restrict__ w, const int* __restrict__ starts,
    const int* __restrict__ ends, const int* __restrict__ dst_ptr, int num_nodes,
    int num_edges, int F, int bn, int row_blocks, int rest_blocks) {
  __shared__ EdgeList lists[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if ((int)blockIdx.x < rest_blocks) {
    const int z = blockIdx.x * kWarps + warp;
    if (kRestSlots * z < num_edges)  // whole warps leave together
      gate_rest<T>(z, lane, dh, eh, ce, e_new, senders, receivers, w, starts, ends,
                   num_nodes, num_edges, F, bn);
    return;
  }
  const int n = (row_blocks - 1 - ((int)blockIdx.x - rest_blocks)) * kWarps + warp;
  if (n >= num_nodes) return;  // whole warps leave together
  gate_row<T>(lists[warp], n, lane, bh, dh, eh, ce, agg, e_new, senders, w, starts, ends,
              dst_ptr, F, bn);
}

template <typename T>
cudaError_t launch(const void* bh, const void* dh, const void* eh, const void* ce, void* agg,
                   void* e_new, const void* senders, const void* receivers, const void* w,
                   const void* starts, const void* ends, const void* dst_ptr, int num_nodes,
                   int num_edges, int F, int bn, cudaStream_t stream) {
  const int row_blocks = (num_nodes + kWarps - 1) / kWarps;
  const int rest_warps = (num_edges + kRestSlots - 1) / kRestSlots;
  const int rest_blocks = (rest_warps + kWarps - 1) / kWarps;
  gate_kernel<T><<<rest_blocks + row_blocks, 32 * kWarps, 0, stream>>>(
      (const T*)bh, (const T*)dh, (const T*)eh, (const T*)ce, (T*)agg, (T*)e_new,
      (const int*)senders, (const int*)receivers, (const float*)w, (const int*)starts,
      (const int*)ends, (const int*)dst_ptr, num_nodes, num_edges, F, bn, row_blocks,
      rest_blocks);
  return cudaGetLastError();
}

}  // namespace

// bh, dh, eh, agg: [num_nodes, num_feat]; ce, e_new: [num_edges, num_feat];
// all f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); agg and e_new written at
// every row and slot.  senders, receivers: [E] int32, dst-sorted; w: [E]
// f32; starts, ends: [num_nodes / bn] int32, the tiles' edge ranges;
// dst_ptr: [num_nodes + 1] int32, the CSR pointers over the dst-sorted
// edges.
extern "C" int gatedgcn_gate_fwd(const void* bh, const void* dh, const void* eh,
                                 const void* ce, void* agg, void* e_new,
                                 const void* senders, const void* receivers, const void* w,
                                 const void* starts, const void* ends, const void* dst_ptr,
                                 int num_nodes, int num_edges, int num_feat, int bn,
                                 int is_bf16, void* stream) {
  if (num_nodes <= 0 || num_feat <= 0) return (int)cudaGetLastError();
  if (bn <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? (int)launch<__nv_bfloat16>(bh, dh, eh, ce, agg, e_new, senders, receivers,
                                              w, starts, ends, dst_ptr, num_nodes, num_edges,
                                              num_feat, bn, s)
                 : (int)launch<float>(bh, dh, eh, ce, agg, e_new, senders, receivers, w,
                                      starts, ends, dst_ptr, num_nodes, num_edges, num_feat,
                                      bn, s);
}
