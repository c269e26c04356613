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
// by memory, never by arithmetic.  Before any feature byte moves, a row
// waits on a chain of dependent index loads (forward: ptr, then the senders
// and weights; transposed: ptr, then the src-sorted order, then the
// receivers and weights), so the card sees latency unless many rows' loads
// are in flight at once.  The TPU form built a dense f32 [256, 256] tile
// adjacency from one-hot MXU products (a VMEM workaround, 128x the needed
// arithmetic); this kernel walks the sparse edges instead.
//
// Design: a row's index chain is walked once, not once per feature chunk,
// and its features move 16 bytes a lane:
// - rows are taken whole by G lanes: the host picks G (4 to 128) as the
//   fewest lanes whose loads cover the row in one pass, so narrow rows
//   (F = 16, 95, 128) share a warp (R = 32 / G rows, all in one tile) and a
//   wide one (F = 1088, 1520) takes S = G / 32 warps, each walking the
//   row's edges itself (the S walks hit the same lines) and summing its
//   share of the features, so no warp waits on another;
// - stage 1: a warp walks its rows' edges once, as one range (consecutive
//   rows' CSR segments are adjacent), 256 candidates a trip, all of a
//   trip's index loads in flight (transposed, the next trip's order entries
//   too); a ballot keeps the edges that count (tile-local, in range,
//   weight != 0, tested at run time: the padding edges, weight 0 and all on
//   the batch's last node, are skipped 256 at a time) and puts their other
//   endpoint and weight in shared memory in walk order, each row's start
//   from popcounts.  Blocks take rows from the last one down, so the
//   padding row's walk starts first;
// - stage 2: a row's lanes loop over its features, V per load (16 bytes: 4
//   f32 or 8 bf16, where F and the pointers allow it, else one element: F =
//   95 and 74 * 67 = 4958 take that path), two vectors (8 elements) a lane
//   for each of two edges in flight before they are summed;
// - each row sums its edges in walk order in f32 registers and writes its
//   output once: no atomics, so the result does not depend on scheduling.
//   A warp whose rows hold more than 256 counted edges (none on the ZINC
//   paths) has each lane walk its row's edges itself: slower, same sums in
//   the same order;
// - features f32 or bf16, weights f32, accumulation f32, output in the
//   feature type, rounded once.  No tensor cores, so no TF32 anywhere.
// What still bounds it: at F = 1520 it moves its 40 MB within about 1.2x
// of the time a plain copy of x takes (x.clone(), 43.6 MB, chip_smoke.py
// phase 1, NVIDIA H100 80GB HBM3 at 700 W); at F <= 128 the launch and two
// or three dependent loads set its time.
//
// Plain C interface, loaded with ctypes: the entry returns cudaGetLastError()
// after the launch (or cudaErrorInvalidValue for a shape it does not take)
// and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;         // warps per block
constexpr int kCand = 8;          // candidate edges per lane per trip
constexpr int kCap = 32 * kCand;  // counted edges a warp keeps in shared memory
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float2 unpack_bf16x2(unsigned u) {
  // bf16 is the top half of an f32; the lower address holds the low half
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16(b)) << 16);
}

// V consecutive features of type T, read as f32 and written back rounded:
// one 16-byte access for (float, 4) and (bf16, 8), one element for V = 1
template <typename T, int V> struct Feat;

template <> struct Feat<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Feat<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) { v[0] = __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const float* v) { *p = v[0]; }
};

template <> struct Feat<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack_bf16x2(u[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
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
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    *p = __float2bfloat16(v[0]);
  }
};

// vectors a lane loads per edge before it sums: 2 of 16 bytes, or 8
// elements on the one-element path (ops/spmm_tiled.py mirrors this to pick
// G)
template <int V> __host__ __device__ constexpr int vecs_per_edge() { return V == 1 ? 8 : 2; }

// Whether edge e, with the other endpoint (the source forward, the
// destination transposed) and weight loaded for it, counts for tile
// [n_lo, n_lo + bn) with range [e_lo, e_hi).  The forward's walk is already
// cut to the range.
template <bool kTranspose>
__device__ __forceinline__ bool counts(int e, int other, float we, int n_lo, int bn,
                                      int e_lo, int e_hi) {
  const bool ok = we != 0.f && (unsigned)(other - n_lo) < (unsigned)bn;
  return kTranspose ? ok && e >= e_lo && e < e_hi : ok;
}

// acc[u] += w * x[o, (k0 + u G) V ...] for the lane's vectors below nv
template <typename T, int V, int G, int U>
__device__ __forceinline__ void add_edge(float (&acc)[U][V], const T* __restrict__ x,
                                         int o, float w, int k0, int nv, int num_feat) {
  const T* xr = x + (size_t)o * num_feat;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int k = k0 + u * G;
    if (k < nv) {
      float v[V];
      Feat<T, V>::load(xr + (size_t)k * V, v);
#pragma unroll
      for (int c = 0; c < V; ++c) acc[u][c] += w * v[c];
    }
  }
}

// G lanes per row: below 32, a warp takes R = 32 / G rows; above, a row
// takes S = G / 32 warps.  No __launch_bounds__: given the block size,
// ptxas squeezes registers to fit one more block an SM and spills, and a
// fixed ceiling of 64 spills too.
template <typename T, int V, int G, bool kTranspose>
__global__ void spmm_tiled_kernel(
    const T* __restrict__ x, T* __restrict__ out,
    const int* __restrict__ senders, const int* __restrict__ receivers,
    const float* __restrict__ w,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ ptr, const int* __restrict__ order,
    int num_nodes, int num_feat, int bn) {
  constexpr int R = G < 32 ? 32 / G : 1;       // rows per warp
  constexpr int S = G < 32 ? 1 : G / 32;       // warps per row
  constexpr int GW = G < 32 ? G : 32;          // a row's lanes in one warp
  constexpr int U = vecs_per_edge<V>();        // vectors per lane per edge
  __shared__ int s_other[kWarps][kCap];
  __shared__ float s_w[kWarps][kCap];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the last rows first: a batch's padding edges all sit on its last node,
  // and that row's long walk should start at once, not in the last wave
  const int gw = (gridDim.x - 1 - blockIdx.x) * kWarps + warp;
  const int n0 = gw / S * R, slice = gw % S;
  if (n0 >= num_nodes) return;  // whole warps leave together
  const int t = n0 / bn, n_lo = t * bn;        // R divides bn: one tile
  const int e_lo = __ldg(starts + t), e_hi = __ldg(ends + t);
  // the rows' CSR segments are adjacent: row n0 + r walks [p[r], p[r + 1])
  const int my_p = __ldg(ptr + n0 + min(lane, R));
  int p[R + 1];
#pragma unroll
  for (int r = 0; r <= R; ++r) {
    p[r] = __shfl_sync(kAll, my_p, r);
    if (!kTranspose) p[r] = min(max(p[r], e_lo), e_hi);  // the tile's range
  }

  // Stage 1: one walk over the rows' candidates, 256 a trip, every index
  // load of a trip in flight at once (past the end a lane reloads the last
  // candidate and drops it); the counted edges go to shared memory in walk
  // order (so grouped by row), and beg[r] counts those of the rows below r.
  int count = 0;
  int beg[R + 1];
#pragma unroll
  for (int r = 0; r <= R; ++r) beg[r] = 0;
  const unsigned below = (1u << lane) - 1u;
  // the edge ids of trip jb: transposed, from the src-sorted order, loaded
  // a trip ahead so that a long walk waits on one level a trip, not two
  int eid[kCand];
#pragma unroll
  for (int q = 0; q < kCand; ++q) {
    const int j = min(p[0] + 32 * q + lane, p[R] - 1);
    eid[q] = kTranspose && p[0] < p[R] ? __ldg(order + j) : j;
  }
  for (int jb = p[0]; jb < p[R]; jb += kCap) {
    const int groups = min(kCand, (p[R] - jb + 31) >> 5);  // with a candidate
    int oth[kCand], next[kCand];
    float we[kCand];
    bool ok[kCand];
#pragma unroll
    for (int q = 0; q < kCand; ++q) {
      const int j = min(jb + kCap + 32 * q + lane, p[R] - 1);
      next[q] = kTranspose ? __ldg(order + j) : j;
    }
#pragma unroll
    for (int q = 0; q < kCand; ++q) {
      oth[q] = kTranspose ? __ldg(receivers + eid[q]) : __ldg(senders + eid[q]);
      we[q] = __ldg(w + eid[q]);
    }
#pragma unroll
    for (int q = 0; q < kCand; ++q)
      ok[q] = jb + 32 * q + lane < p[R] &&
              counts<kTranspose>(eid[q], oth[q], we[q], n_lo, bn, e_lo, e_hi);
#pragma unroll
    for (int q = 0; q < kCand; ++q) {
      if (q >= groups) break;  // the same in every lane
      const unsigned bal = __ballot_sync(kAll, ok[q]);
      if (ok[q]) {
        const int pos = count + __popc(bal & below);
        if (pos < kCap) {
          s_other[warp][pos] = oth[q];
          s_w[warp][pos] = we[q];
        }
      }
      const int jq = jb + 32 * q;  // lane 0's candidate
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const int m = p[r] - jq;   // lanes below m are rows below r
        beg[r] += __popc(bal & (m <= 0 ? 0u : m >= 32 ? kAll : (1u << m) - 1u));
      }
      count += __popc(bal);
    }
#pragma unroll
    for (int q = 0; q < kCand; ++q) eid[q] = next[q];
  }
  beg[R] = count;
  __syncwarp();

  // Stage 2: the G lanes of row r (lane lg of them) sum its edges over its
  // features
  const int r = lane / GW, lg = slice * 32 + lane % GW;
  int b0 = 0, b1 = 0, ja = 0, jz = 0;
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    if (rr == r) {
      b0 = beg[rr];
      b1 = beg[rr + 1];
      ja = p[rr];
      jz = p[rr + 1];
    }
  }
  const int nv = num_feat / V;
  T* orow = out + (size_t)(n0 + r) * num_feat;
  for (int k0 = lg; k0 < nv; k0 += G * U) {
    float acc[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < V; ++c) acc[u][c] = 0.f;
    if (count <= kCap) {
#pragma unroll 2
      for (int i = b0; i < b1; ++i)
        add_edge<T, V, G, U>(acc, x, s_other[warp][i], s_w[warp][i], k0, nv, num_feat);
    } else {  // too many for shared memory: the lane walks the row itself
      for (int j = ja; j < jz; ++j) {
        const int e = kTranspose ? __ldg(order + j) : j;
        const int o = kTranspose ? __ldg(receivers + e) : __ldg(senders + e);
        const float wj = __ldg(w + e);
        if (counts<kTranspose>(e, o, wj, n_lo, bn, e_lo, e_hi))
          add_edge<T, V, G, U>(acc, x, o, wj, k0, nv, num_feat);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * G;
      if (k < nv) Feat<T, V>::store(orow + (size_t)k * V, acc[u]);
    }
  }
}

template <typename T, int V, int G>
void launch_rows(const void* x, void* out, const void* senders, const void* receivers,
                 const void* w, const void* starts, const void* ends, const void* ptr,
                 const void* order, int num_nodes, int num_feat, int bn, int transpose,
                 cudaStream_t stream) {
  // warps: one per R rows, or S per row
  const int warps = G < 32 ? num_nodes / (32 / G) : num_nodes * (G / 32);
  const dim3 grid((warps + kWarps - 1) / kWarps);
  if (transpose) {
    spmm_tiled_kernel<T, V, G, true><<<grid, 32 * kWarps, 0, stream>>>(
        (const T*)x, (T*)out, (const int*)senders, (const int*)receivers, (const float*)w,
        (const int*)starts, (const int*)ends, (const int*)ptr, (const int*)order,
        num_nodes, num_feat, bn);
  } else {
    spmm_tiled_kernel<T, V, G, false><<<grid, 32 * kWarps, 0, stream>>>(
        (const T*)x, (T*)out, (const int*)senders, (const int*)receivers, (const float*)w,
        (const int*)starts, (const int*)ends, (const int*)ptr, (const int*)order,
        num_nodes, num_feat, bn);
  }
}

template <typename T, int V>
bool launch_vec(int group, const void* x, void* out, const void* senders,
                const void* receivers, const void* w, const void* starts, const void* ends,
                const void* ptr, const void* order, int num_nodes, int num_feat, int bn,
                int transpose, cudaStream_t stream) {
#define SPMM_TILED_ROWS(G)                                                               \
  launch_rows<T, V, G>(x, out, senders, receivers, w, starts, ends, ptr, order, num_nodes, \
                       num_feat, bn, transpose, stream)
  switch (group) {
    case 4: SPMM_TILED_ROWS(4); return true;
    case 8: SPMM_TILED_ROWS(8); return true;
    case 16: SPMM_TILED_ROWS(16); return true;
    case 32: SPMM_TILED_ROWS(32); return true;
    case 64: SPMM_TILED_ROWS(64); return true;
    case 128: SPMM_TILED_ROWS(128); return true;
    default: return false;
  }
#undef SPMM_TILED_ROWS
}

}  // namespace

// x, out: [num_nodes, num_feat] f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// senders, receivers: [E] int32, dst-sorted; w: [E] f32; starts, ends: [T]
// int32; ptr: [num_nodes + 1] int32, the CSR pointers over the dst-sorted
// edges (transpose = 0) or over `order`, the src-sorted permutation of the
// edges (transpose = 1; `order` is unused and may be null otherwise).
// vec: features per load, 1 or 16 bytes' worth (4 f32, 8 bf16; num_feat a
// multiple of it, x and out 16-byte aligned); group: lanes per row, 4, 8,
// 16, 32, 64 or 128, with 32 / group dividing bn below 32.
extern "C" int spmm_tiled_launch(const void* x, void* out, const void* senders,
                                 const void* receivers, const void* w, const void* starts,
                                 const void* ends, const void* ptr, const void* order,
                                 int num_nodes, int num_feat, int bn, int is_bf16,
                                 int transpose, int vec, int group, void* stream) {
  if (num_nodes <= 0 || num_feat <= 0) return (int)cudaGetLastError();
  if (bn <= 0 || num_nodes % bn || group <= 0 || bn % (group < 32 ? 32 / group : 1) ||
      vec <= 0 || num_feat % vec)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  bool ok;
  if (is_bf16) {
    ok = vec == 8   ? launch_vec<__nv_bfloat16, 8>(group, x, out, senders, receivers, w,
                                                   starts, ends, ptr, order, num_nodes,
                                                   num_feat, bn, transpose, s)
         : vec == 1 ? launch_vec<__nv_bfloat16, 1>(group, x, out, senders, receivers, w,
                                                   starts, ends, ptr, order, num_nodes,
                                                   num_feat, bn, transpose, s)
                    : false;
  } else {
    ok = vec == 4   ? launch_vec<float, 4>(group, x, out, senders, receivers, w, starts,
                                           ends, ptr, order, num_nodes, num_feat, bn,
                                           transpose, s)
         : vec == 1 ? launch_vec<float, 1>(group, x, out, senders, receivers, w, starts,
                                           ends, ptr, order, num_nodes, num_feat, bn,
                                           transpose, s)
                    : false;
  }
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}
