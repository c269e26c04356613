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
// (N = 3072, D = 128, 6912 edges padded to 7168, f32) the work is 6194
// counted edges, 2 * 6194 * 128 = 1.6 MFLOP, against reading x at the 2652
// source rows they name, writing all 3072 output rows, and reading the
// senders, receivers and weights of every slot and the tile ranges once:
// about 3 MB, 0.9 us at an H100's 3.35 TB/s.  It is bound by memory, and at
// this size by the launch and the chain of dependent loads before the rows
// of x move.  The TPU form (one-hot [256, N] gather and [bn, 256] scatter
// products on the MXU, N * D * 2 flops per edge) was a workaround for a
// machine without a fast gather; this kernel gathers.
//
// Design: one launch per call, no CSR pointers made beforehand; the kernel
// finds each row's edges in the receivers itself.  Blocks share the search:
// a search by each row's lane group (4 * G probes an end a round, then the
// row's slots from global memory; no shared memory, no barrier) took as
// long at D = 95 but 1.0-3.1 us more cold at D = 128 and 2.3-3.6 more at
// N = 300, on an NVIDIA H100 80GB HBM3 at 700 W.
// - a block of 8 warps owns R consecutive destination rows of one tile (the
//   tile's last block fewer); its G-lane groups take one row each (R = 8 *
//   32 / G); the host picks G and the load width (spmm_flat.py:
//   kernel_variant mirrors it);
// - window: the block's edges lie in the tile's range [starts[t], ends[t]).
//   A range wider than one chunk (1024 slots) is narrowed by probe rounds:
//   the 256 threads read the receivers at 256 evenly spaced slots, and two
//   __syncthreads_count give the probes below the block's first row and
//   below its row past the last; the window shrinks to the slots between.
//   At bench_ops' shape a tile's range (about 600 slots) is staged whole,
//   with no probe: a probe round before staging (one dependent load more)
//   took 0.65 us more cold in f32 on an NVIDIA H100 80GB HBM3 at 700 W.  A
//   window wider than one chunk is walked chunk by chunk;
// - stage: each thread loads the receiver, sender and weight of 4 slots of
//   the chunk (all in flight together); a ballot keeps the slots that count
//   for the block (weight != 0, receiver among its rows), one warp scans the
//   32 per-warp counts, and the kept slots go to shared memory compacted in
//   slot order, each row's [beg, end) by shared atomicMin/atomicMax (the
//   same result in any order).  The padding edges cost one pass of loads;
// - walk: a row's G lanes read its staged edges 4 at a time and issue the
//   4 rows of x together, 16 bytes a lane (4 f32 or 8 bf16) where D and the
//   pointers allow it, else one element a load (4 a lane, D = 95 takes this
//   path); wide rows take several passes over the staged edges.  The rows
//   are loaded raw and turned into f32 only where they are added (bf16
//   converted at the load took 11.7 us cold at D = 95, 8.9 converted late,
//   on the same card);
// - each row sums its edges in slot order in f32 registers and writes its
//   output once, zeros for a row with no counted edge: no atomics on x or
//   out, no clearing pass, and the result does not depend on scheduling;
// - features f32 or bf16, weights f32, accumulation f32, one rounding into
//   the feature type.  No tensor cores, so no TF32 anywhere.  No
//   __launch_bounds__ (it made ptxas spill in K1).
//
// Plain C interface, loaded with ctypes: the entry returns cudaGetLastError()
// after the launch (or cudaErrorInvalidValue for a shape it does not take)
// and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                // warps per block
constexpr int kThreads = 32 * kWarps;    // threads per block, probes per round
constexpr int kSlots = 4;                // edge slots a thread stages per chunk
constexpr int kCap = kSlots * kThreads;  // edge slots per chunk
constexpr int kRounds = 4;               // probe rounds at most
constexpr int kInFlight = 4;             // edges whose rows of x a group loads at once
constexpr unsigned kAll = 0xffffffffu;
static_assert(kSlots * kWarps == 32, "one warp scans the per-warp counts");

__device__ __forceinline__ float2 unpack_bf16x2(unsigned u) {
  // bf16 is the top half of an f32; the lower address holds the low half
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16(b)) << 16);
}

// V consecutive features of type T: loaded raw (one 16-byte access for
// (float, 4) and (bf16, 8), one element for V = 1), added into f32 sums only
// later, so that every load of a walk step is issued before the first is
// waited on; written back rounded once
template <typename T, int V> struct Feat;

template <> struct Feat<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void fma(float* acc, float w, Raw r) {
    acc[0] += w * r.x; acc[1] += w * r.y; acc[2] += w * r.z; acc[3] += w * r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Feat<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void fma(float* acc, float w, Raw r) { acc[0] += w * r; }
  static __device__ __forceinline__ void store(float* p, const float* v) { *p = v[0]; }
};

template <> struct Feat<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void fma(float* acc, float w, Raw r) {
    const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack_bf16x2(u[i]);
      acc[2 * i] += w * f.x;
      acc[2 * i + 1] += w * f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint4 t;
    t.x = pack_bf16x2(v[0], v[1]);
    t.y = pack_bf16x2(v[2], v[3]);
    t.z = pack_bf16x2(v[4], v[5]);
    t.w = pack_bf16x2(v[6], v[7]);
    *reinterpret_cast<uint4*>(p) = t;
  }
};

template <> struct Feat<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ void fma(float* acc, float w, Raw r) {
    acc[0] += w * __uint_as_float((unsigned)r << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    *p = __float2bfloat16(v[0]);
  }
};

// vectors a lane loads per edge in one pass: one of 16 bytes, or 4
// elements on the one-element path (ops/spmm_flat.py mirrors this to pick G)
template <int V> __host__ __device__ constexpr int vecs_per_lane() { return V == 1 ? 4 : 1; }

// rows per block for G lanes a row
template <int G> __host__ __device__ constexpr int rows_per_block() { return kWarps * (32 / G); }

template <typename T, int V, int G>
__global__ void spmm_flat_kernel(
    const T* __restrict__ x, T* __restrict__ out, const int* __restrict__ senders,
    const int* __restrict__ receivers, const float* __restrict__ w,
    const int* __restrict__ starts, const int* __restrict__ ends, int num_nodes,
    int num_feat, int bn, int blocks_per_tile) {
  constexpr int R = rows_per_block<G>();
  constexpr int U = vecs_per_lane<V>();
  __shared__ int s_src[kCap];
  __shared__ float s_w[kCap];
  __shared__ int s_beg[R], s_end[R];
  __shared__ int s_cnt[32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = blockIdx.x / blocks_per_tile;
  const int n0 = t * bn + (blockIdx.x % blocks_per_tile) * R;
  const int n1 = min(min(n0 + R, (t + 1) * bn), num_nodes);
  if (n0 >= n1) return;  // the whole block
  if (tid < R) {
    s_beg[tid] = kCap;
    s_end[tid] = 0;
  }

  // The window [lo, hi) of the tile's range that holds the block's edges:
  // probe rounds while it is wider than a chunk.  Probe k reads slot
  // lo + k * step; the receivers are sorted, so the probes below n0 (ca)
  // and below n1 (cb) are prefixes, and the block's edges lie after probe
  // ca - 1 and up to probe cb.  The counts are the same in every thread.
  int lo = __ldg(starts + t);
  int hi = max(lo, __ldg(ends + t));
  for (int round = 0; round < kRounds && hi - lo > kCap; ++round) {
    const int step = (hi - lo + kThreads - 1) / kThreads;
    const int q = lo + tid * step;
    const int rq = q < hi ? __ldg(receivers + q) : INT_MAX;
    const int ca = __syncthreads_count(rq < n0);
    const int cb = __syncthreads_count(rq < n1);
    hi = min(hi, lo + cb * step);
    lo = ca ? lo + (ca - 1) * step + 1 : lo;
  }

  const int ri = warp * (32 / G) + lane / G;  // the group's row in the block
  const int n = n0 + ri, lg = lane % G;
  const bool has_row = n < n1;
  const int nv = num_feat / V;
  const int passes = (nv + G * U - 1) / (G * U);
  const bool one_chunk = hi - lo <= kCap;
  const unsigned below = (1u << lane) - 1u;
  for (int pass = 0; pass < passes; ++pass) {
    const int k0 = pass * G * U + lg;
    float acc[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < V; ++c) acc[u][c] = 0.f;
    for (int c0 = lo; c0 < hi; c0 += kCap) {
      if (pass == 0 || !one_chunk) {  // the same in every thread
        if (c0 != lo || pass != 0) {  // shared memory holds the last chunk
          __syncthreads();
          if (tid < R) {
            s_beg[tid] = kCap;
            s_end[tid] = 0;
          }
        }
        // Stage: slot c0 + i * kThreads + tid, every load in flight at once
        int src[kSlots], rcv[kSlots];
        float we[kSlots];
        unsigned bal[kSlots];
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          const int j = c0 + i * kThreads + tid;
          const bool in = j < hi;
          rcv[i] = in ? __ldg(receivers + j) : -1;
          src[i] = in ? __ldg(senders + j) : 0;
          we[i] = in ? __ldg(w + j) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kSlots; ++i)
          bal[i] = __ballot_sync(kAll, we[i] != 0.f && rcv[i] >= n0 && rcv[i] < n1);
        if (lane == 0) {
#pragma unroll
          for (int i = 0; i < kSlots; ++i) s_cnt[i * kWarps + warp] = __popc(bal[i]);
        }
        __syncthreads();
        // the kept slots before (i, warp), in slot order: a scan of the 32
        // counts, one a lane
        const int cnt = s_cnt[lane];
        int incl = cnt;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kAll, incl, d);
          if (lane >= d) incl += y;
        }
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          const int base = __shfl_sync(kAll, incl - cnt, i * kWarps + warp);
          if (bal[i] >> lane & 1u) {
            const int p = base + __popc(bal[i] & below);
            s_src[p] = src[i];
            s_w[p] = we[i];
            atomicMin(&s_beg[rcv[i] - n0], p);
            atomicMax(&s_end[rcv[i] - n0], p + 1);
          }
        }
        __syncthreads();
      }
      if (!has_row) continue;
      // Walk: the row's staged edges kInFlight at a time, their rows of x
      // loaded together, summed in slot order
      const int b = s_beg[ri], e = s_end[ri];
      for (int k = b; k < e; k += kInFlight) {
        float wq[kInFlight];
        typename Feat<T, V>::Raw v[kInFlight][U];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          const int kk = min(k + q, e - 1);
          wq[q] = s_w[kk];
          const T* xr = x + (size_t)s_src[kk] * num_feat;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int kv = k0 + u * G;
            v[q][u] = k + q < e && kv < nv ? Feat<T, V>::load(xr + (size_t)kv * V)
                              : typename Feat<T, V>::Raw{};
          }
        }
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          if (k + q < e) {
#pragma unroll
            for (int u = 0; u < U; ++u) Feat<T, V>::fma(acc[u], wq[q], v[q][u]);
          }
        }
      }
    }
    if (has_row) {
      T* orow = out + (size_t)n * num_feat;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kv = k0 + u * G;
        if (kv < nv) Feat<T, V>::store(orow + (size_t)kv * V, acc[u]);
      }
    }
  }
}

template <typename T, int V, int G>
void launch_rows(const void* x, void* out, const void* senders, const void* receivers,
                 const void* w, const void* starts, const void* ends, int num_nodes,
                 int num_feat, int bn, cudaStream_t stream) {
  constexpr int R = rows_per_block<G>();
  const int per_tile = ((bn < num_nodes ? bn : num_nodes) + R - 1) / R;
  const int n_tiles = (num_nodes + bn - 1) / bn;
  spmm_flat_kernel<T, V, G><<<n_tiles * per_tile, kThreads, 0, stream>>>(
      (const T*)x, (T*)out, (const int*)senders, (const int*)receivers, (const float*)w,
      (const int*)starts, (const int*)ends, num_nodes, num_feat, bn, per_tile);
}

template <typename T, int V>
bool launch_vec(int group, const void* x, void* out, const void* senders,
                const void* receivers, const void* w, const void* starts, const void* ends,
                int num_nodes, int num_feat, int bn, cudaStream_t stream) {
#define SPMM_FLAT_ROWS(G)                                                              \
  launch_rows<T, V, G>(x, out, senders, receivers, w, starts, ends, num_nodes, num_feat, \
                       bn, stream)
  switch (group) {
    case 16: SPMM_FLAT_ROWS(16); return true;
    case 32: SPMM_FLAT_ROWS(32); return true;
    default: return false;
  }
#undef SPMM_FLAT_ROWS
}

}  // namespace

// x, out: [num_nodes, num_feat] f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// senders, receivers: [E] int32 in destination order; w: [E] f32; starts,
// ends: [ceil(num_nodes / bn)] int32.  vec: features per load, 1 or 16
// bytes' worth (4 f32, 8 bf16; num_feat a multiple of it, x and out 16-byte
// aligned); group: lanes per row, 16 or 32.
extern "C" int spmm_flat_launch(const void* x, void* out, const void* senders,
                                const void* receivers, const void* w, const void* starts,
                                const void* ends, int num_nodes, int num_feat, int bn,
                                int is_bf16, int vec, int group, void* stream) {
  if (num_nodes <= 0 || num_feat <= 0) return (int)cudaGetLastError();
  if (bn <= 0 || vec <= 0 || num_feat % vec) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  bool ok;
  if (is_bf16) {
    ok = vec == 8   ? launch_vec<__nv_bfloat16, 8>(group, x, out, senders, receivers, w,
                                                   starts, ends, num_nodes, num_feat, bn, s)
         : vec == 1 ? launch_vec<__nv_bfloat16, 1>(group, x, out, senders, receivers, w,
                                                   starts, ends, num_nodes, num_feat, bn, s)
                    : false;
  } else {
    ok = vec == 4   ? launch_vec<float, 4>(group, x, out, senders, receivers, w, starts,
                                           ends, num_nodes, num_feat, bn, s)
         : vec == 1 ? launch_vec<float, 1>(group, x, out, senders, receivers, w, starts,
                                           ends, num_nodes, num_feat, bn, s)
                    : false;
  }
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}
