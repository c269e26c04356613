// Fused edge-softmax attention for Hopper (sm_90a): forward (K2) and
// backward (K3) of the sparse graph-transformer attention.
//
// Replaces the Pallas TPU kernels signnet_basisnet_tpu/ops/pallas_attention.py:
// _attn_pallas_raw (body _attn_kernel) and _attn_bwd_pallas_raw (body
// _attn_bwd_kernel).  Per destination node n and head h, over the edges e
// that count for n (below):
//
//   score_e = sum_d K[src_e, h, d] * Qs[n, h, d] * E1[e, h, d]
//   s_e     = exp(clamp(score_e, -5, 5)) * w_e
//   out[n]  = sum_e s_e V[src_e] / (sum_e s_e + 1e-6),   den[n, h] = sum_e s_e
//
// where Qs = Q * inv is Q pre-scaled by inv = 1/sqrt(D) (rounded to the
// input type by the caller) and rounded to the input type, as the JAX
// wrapper's `Q * (1/sqrt(D))` does before its kernel.  The backward takes
// ghat = g / (den + 1e-6) and c[n, h] = sum_d out * ghat (plain torch in the
// caller, as in the JAX glue) and, with
//   dscore_e = (sum_d V[src_e] ghat[n]  -  c[n, h]) * s_e * 1{|score_e| < 5},
// gives dQ[n] = inv * sum_e K[src_e] E1_e dscore_e, dE1_e = K[src_e] Qs[n]
// dscore_e, dV[m] = sum_{e: src_e = m} s_e ghat[dst_e] and
// dK[m] = sum_{e: src_e = m} Qs[dst_e] E1_e dscore_e.
//
// Edges that count: nodes come in tiles of `bn`; edges are sorted by
// destination; edge e counts for destination tile t only if it lies in
// [starts[t], ends[t]), both its endpoints lie in tile t and its weight is
// not 0 (the rule of the tile-local SpMM, csrc/spmm_tiled.cu).  The batch
// packer makes every real edge tile-local.  (The TPU kernel reads a source
// outside the tile as an all-zero row, so such an edge would add exp(0) * w
// to its den and nothing to its numerator; here it adds nothing.)
//
// What bounds it on the card.  About 2 edges per node and H*D = 64 features:
// on a 128-graph synthetic ZINC batch (N = 3584 slots, 5996 counted edges,
// f32) the forward reads Q, K, V at the ~3000 rows that counted edges reach
// and E1 at the counted edges, and writes out and den: about 5 MB, 1.5 us at
// an H100's 3.35 TB/s, against about 2 MFLOP.  The backward moves about
// 10 MB.  Both are bound by memory, and at this size by launch latency and
// the chains of dependent loads a row waits on.  The TPU form gathered and
// scattered rows with one-hot [256, 256] MXU products and padded features
// to 128 lanes (a workaround for the MXU); these kernels walk each row's
// edges through CSR pointers instead.
//
// K2 (forward), design.  Each row's walk is a chain of dependent loads
// (dst_ptr and the tile range, then the senders and weights, then K, V and
// E1 at the counted edges), and at about 2 edges a row that chain, not the
// bytes, sets the time.  So the walk keeps as many loads in flight as it
// can and takes nothing in turn that it could take at once:
// - blocks take rows from the last one down, so the padding row (the
//   batch's 1172 weight-0 edges, all on its last node) starts first;
// - index loads are unconditional: a lane past the segment's end reloads
//   its last candidate and drops it;
// - the vector layout (D a multiple of 4 and H*D/4 dividing 32; the
//   shipped Transformer's H = D = 8): a lane group of H*D/4 lanes holds a
//   row, 4 features a lane in registers, a head in D/4 adjacent lanes.  The
//   row's Qs (Q * inv, rounded to the input type) is loaded with the CSR
//   pointers; a trip loads 256 candidates (all index loads in flight) and
//   lists the counted ones in shared memory; the warp's 32/(H*D/4) lane
//   groups then take that many counted edges at once, each edge's K, V and
//   E1 loads in flight together, its score a shuffle sum over the head's lanes.
//   Each group keeps its share of sum_e s_e V and of den in registers, and
//   the groups' shares are added by shuffles in a fixed order at the end:
//   no shared-memory phase per edge;
// - the general layout (D = 7, 10): one warp per row, lanes over the H*D
//   features at stride 32, one lane per head summing the products in shared
//   memory (any H and D); a ballot over 32 candidates at a time keeps the
//   counted edges, taken one at a time, each edge's V loads in flight with
//   its K and E1 loads, before its score is known.  (Taking two edges at a
//   time doubled the warp's shared memory and measured slower cold at
//   D = 7 in bf16.)
// - every row writes out and den once (den 0 and out 0 where no edge
//   counts), so the caller allocates both without filling them.

// K3 (backward), one launch with three kinds of warp:
// - destination warps (dQ and the counted edges' dE1) and source warps (dK
//   and dV, walking the src-sorted permutation the transposed SpMM walks)
//   alternate from the last row down, so the padding row's walks start
//   first; zero warps, one per 32 edge slots, write the zeros of every dE1
//   slot no edge counts for, so the caller allocates dE1 without zeroing it
//   (one warp zeroing the 1172 padding slots set the kernel's time);
// - the vector layout (D a multiple of 4 and H*D/4 dividing 32; the shipped
//   Transformer's H = D = 8): a row lives in registers, H*D/4 lanes of 4
//   features, a head in D/4 adjacent lanes, so its score and V.ghat sums
//   are shuffles and an edge needs no shared-memory phase; the row's own data (Q, ghat and c, or K and V) is loaded
//   at once with the CSR pointers; a trip loads 256 candidates (all index
//   loads in flight, the counted ones into a per-warp list in shared
//   memory), then the warp's lane groups take 32/(H*D/4) counted edges at
//   a time;
// - the general layout (D = 7, 10): a warp per row, its products in shared
//   memory and one lane per head summing them, as K2;
// - each row sums its edges in a fixed order in f32 and writes its outputs
//   once: no atomics, so the results do not depend on scheduling;
// - inputs f32 or bf16 (one type for all four), f32 accumulation; out in
//   the input type, den and every gradient in f32.  No tensor cores.
//
// Plain C interface, loaded with ctypes: each entry returns
// cudaGetLastError() after its launch and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // rows per block
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Q * inv, rounded to the input type
template <typename T>
__device__ __forceinline__ float scaled_q(T q, float inv) {
  return to_f32(from_f32<T>(to_f32(q) * inv));
}

__device__ __forceinline__ float clamped_exp(float score) {
  return expf(fminf(fmaxf(score, -5.f), 5.f));
}

// General layout (any H and D): one warp per destination row n, out[n]
// and den[n]; blocks take rows from the last one down (the padding row's
// walk starts first).  A ballot over 32 candidates (unconditional index
// loads) keeps the counted edges; per edge, its K, E1 and V loads are in
// flight together, the products go to shared memory and one lane per head
// sums them.  No __launch_bounds__, as K3.
template <typename T>
__global__ void attn_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ e1, T* __restrict__ out, float* __restrict__ den,
    const int* __restrict__ senders, const float* __restrict__ w,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ dst_ptr, int num_nodes, int H, int D, int bn, float inv) {
  extern __shared__ float smem[];
  const int F = H * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qs = smem + warp * (4 * F + 2 * H);  // the row's Qs
  float* p = qs + F;                          // K * Qs * E1 of one edge
  float* vs = p + F;                          // V of that edge
  float* acc = vs + F;                        // sum_e s_e V[src_e]
  float* sh = acc + F;                        // s_e per head
  float* dh = sh + H;                         // sum_e s_e per head
  const int n = (gridDim.x - 1 - blockIdx.x) * kWarps + warp;
  if (n >= num_nodes) return;  // whole warps leave together
  const int t = n / bn, n_lo = t * bn;
  const int j0 = max(__ldg(dst_ptr + n), __ldg(starts + t));
  const int j1 = min(__ldg(dst_ptr + n + 1), __ldg(ends + t));
  for (int f = lane; f < F; f += 32) {
    qs[f] = scaled_q(q[(size_t)n * F + f], inv);
    acc[f] = 0.f;
  }
  for (int h = lane; h < H; h += 32) dh[h] = 0.f;
  __syncwarp();

  for (int jb = j0; jb < j1; jb += 32) {
    const int j = min(jb + lane, j1 - 1);  // past the end, the last one again
    const int src = __ldg(senders + j);
    const float we = __ldg(w + j);
    const bool ok = jb + lane < j1 && we != 0.f && (unsigned)(src - n_lo) < (unsigned)bn;
    unsigned bits = __ballot_sync(kAll, ok);
    while (bits) {  // the same in every lane
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      const int o = __shfl_sync(kAll, src, b);
      const float wo = __shfl_sync(kAll, we, b);
      const T* kr = k + (size_t)o * F;
      const T* vr = v + (size_t)o * F;
      const T* er = e1 + (size_t)(jb + b) * F;
      for (int f = lane; f < F; f += 32) {  // V's loads in flight with K's and E1's
        p[f] = to_f32(kr[f]) * qs[f] * to_f32(er[f]);
        vs[f] = to_f32(vr[f]);
      }
      __syncwarp();
      for (int h = lane; h < H; h += 32) {
        float score = 0.f;
        for (int d = 0; d < D; ++d) score += p[h * D + d];
        const float s = clamped_exp(score) * wo;
        sh[h] = s;
        dh[h] += s;
      }
      __syncwarp();
      for (int f = lane; f < F; f += 32) acc[f] += sh[f / D] * vs[f];
    }
  }
  __syncwarp();
  for (int f = lane; f < F; f += 32)
    out[(size_t)n * F + f] = from_f32<T>(acc[f] / (dh[f / D] + 1e-6f));
  for (int h = lane; h < H; h += 32) den[(size_t)n * H + h] = dh[h];
}

// ---- K3, the backward ------------------------------------------------------

constexpr int kCand = 8;  // candidate edges per lane per trip (vector kernels)

__device__ __forceinline__ unsigned lanes_below(int m) {
  return m <= 0 ? 0u : m >= 32 ? kAll : (1u << m) - 1u;
}

// `count` floats at p set to 0 by the warp, 16 bytes a store where p and
// count allow it
__device__ __forceinline__ void zero_span(float* p, int count, int lane) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0 && (count & 3) == 0) {
    float4* p4 = reinterpret_cast<float4*>(p);
    for (int i = lane; i < count / 4; i += 32) p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = lane; i < count; i += 32) p[i] = 0.f;
  }
}

// dE1 at edge slots j0 + i, for the set bits i of the warp-uniform `mask`,
// set to 0: each run of adjacent slots is one contiguous stretch
__device__ __forceinline__ void zero_slots(float* de1, int j0, unsigned mask, int F,
                                           int lane) {
  while (mask) {
    const int a = __ffs(mask) - 1;
    const unsigned rest = ~(mask >> a);
    const int len = rest ? __ffs(rest) - 1 : 32 - a;
    zero_span(de1 + (j0 + a) * F, len * F, lane);
    mask &= ~((len >= 32 ? kAll : (1u << len) - 1u) << a);
  }
}

// Every dE1 slot is written once: the destination pass writes the counted
// edges' gradients, and zero warps, one per 32 slots, the zeros of every
// other slot, each slot tested by the same rule.  (Zeroing a row's other
// slots in its own pass left the 1172 padding slots of a batch's last node
// to one warp, whose store loop then set the kernel's time.)
__device__ __forceinline__ void zero_uncounted(float* __restrict__ de1, int z, int lane,
                                               const int* __restrict__ senders,
                                               const int* __restrict__ receivers,
                                               const float* __restrict__ w,
                                               const int* __restrict__ starts,
                                               const int* __restrict__ ends, int num_nodes,
                                               int num_edges, int F, int bn) {
  const int j0 = 32 * z, j = min(j0 + lane, num_edges - 1);
  const int r = __ldg(receivers + j), src = __ldg(senders + j);
  const float we = __ldg(w + j);
  bool ok = false;
  if (r >= 0 && r < num_nodes) {
    const int t = r / bn;
    ok = we != 0.f && j >= __ldg(starts + t) && j < __ldg(ends + t) &&
         (unsigned)(src - t * bn) < (unsigned)bn;
  }
  const unsigned bits = __ballot_sync(kAll, ok);
  zero_slots(de1, j0, lanes_below(num_edges - j0) & ~bits, F, lane);
}

// General layout (any H and D): a warp per row, lanes over the H*D features
// at stride 32, a row's products in shared memory and one lane per head
// summing them.  Destination row n: dQ[n] and dE1 of its segment.
template <typename T>
__device__ __forceinline__ void bwd_dst_row(
    float* buf, int n, int lane, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ e1, const float* __restrict__ ghat,
    const float* __restrict__ c, float* __restrict__ dq, float* __restrict__ de1,
    const int* __restrict__ senders, const float* __restrict__ w, int e_lo, int e_hi,
    const int* __restrict__ dst_ptr, int H, int D, int bn, float inv) {
  const int F = H * D;
  float* qs = buf;        // the row's Qs
  float* gh = qs + F;     // the row's ghat
  float* p = gh + F;      // K * Qs * E1 of one edge
  float* pv = p + F;      // V * ghat of one edge
  float* acc = pv + F;    // sum_e K E1 dscore_e
  float* dsh = acc + F;   // dscore_e per head
  float* ch = dsh + H;    // the row's c per head
  const int n_lo = (n / bn) * bn;
  const int j0 = max(__ldg(dst_ptr + n), e_lo), j1 = min(__ldg(dst_ptr + n + 1), e_hi);
  for (int f = lane; f < F; f += 32) {
    qs[f] = scaled_q(q[n * F + f], inv);
    gh[f] = ghat[n * F + f];
    acc[f] = 0.f;
  }
  for (int h = lane; h < H; h += 32) ch[h] = c[n * H + h];
  __syncwarp();

  for (int jb = j0; jb < j1; jb += 32) {
    const int j = jb + lane;
    int src = 0;
    float we = 0.f;
    bool ok = false;
    if (j < j1) {
      src = __ldg(senders + j);
      we = __ldg(w + j);
      ok = we != 0.f && src >= n_lo && src < n_lo + bn;
    }
    unsigned bits = __ballot_sync(kAll, ok);
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      const int o = __shfl_sync(kAll, src, b);
      const float wo = __shfl_sync(kAll, we, b);
      const int e = jb + b;
      const T* kr = k + o * F;
      const T* vr = v + o * F;
      const T* er = e1 + e * F;
      for (int f = lane; f < F; f += 32) {
        p[f] = to_f32(kr[f]) * qs[f] * to_f32(er[f]);
        pv[f] = to_f32(vr[f]) * gh[f];
      }
      __syncwarp();
      for (int h = lane; h < H; h += 32) {
        float score = 0.f, vg = 0.f;
        for (int d = 0; d < D; ++d) {
          score += p[h * D + d];
          vg += pv[h * D + d];
        }
        const float s = clamped_exp(score) * wo;
        dsh[h] = (score > -5.f && score < 5.f) ? (vg - ch[h]) * s : 0.f;
      }
      __syncwarp();
      for (int f = lane; f < F; f += 32) {
        const float kf = to_f32(kr[f]), ef = to_f32(er[f]), ds = dsh[f / D];
        acc[f] += kf * ef * ds;
        de1[e * F + f] = kf * qs[f] * ds;
      }
    }
  }
  __syncwarp();
  for (int f = lane; f < F; f += 32) dq[n * F + f] = acc[f] * inv;
}

// General layout, source row m: dK[m] and dV[m] over the counted edges
// leaving m
template <typename T>
__device__ __forceinline__ void bwd_src_row(
    float* buf, int m, int lane, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ e1, const float* __restrict__ ghat,
    const float* __restrict__ c, float* __restrict__ dk, float* __restrict__ dv,
    const int* __restrict__ receivers, const float* __restrict__ w, int e_lo, int e_hi,
    const int* __restrict__ src_order, const int* __restrict__ src_ptr, int H, int D,
    int bn, float inv) {
  const int F = H * D;
  float* kk = buf;        // the row's K
  float* vv = kk + F;     // the row's V
  float* p = vv + F;      // K * Qs * E1 of one edge
  float* pv = p + F;      // V * ghat of one edge
  float* adk = pv + F;    // sum_e Qs E1 dscore_e
  float* adv = adk + F;   // sum_e s_e ghat
  float* sh = adv + F;    // s_e per head
  float* dsh = sh + H;    // dscore_e per head
  const int m_lo = (m / bn) * bn;
  const int j0 = __ldg(src_ptr + m), j1 = __ldg(src_ptr + m + 1);
  for (int f = lane; f < F; f += 32) {
    kk[f] = to_f32(k[m * F + f]);
    vv[f] = to_f32(v[m * F + f]);
    adk[f] = 0.f;
    adv[f] = 0.f;
  }
  __syncwarp();

  for (int jb = j0; jb < j1; jb += 32) {
    const int j = jb + lane;
    int e = 0, dst = 0;
    float we = 0.f;
    bool ok = false;
    if (j < j1) {
      e = __ldg(src_order + j);
      dst = __ldg(receivers + e);
      we = __ldg(w + e);
      // the edge must lie in its destination tile (= m's tile) and its range
      ok = we != 0.f && dst >= m_lo && dst < m_lo + bn && e >= e_lo && e < e_hi;
    }
    unsigned bits = __ballot_sync(kAll, ok);
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      const int eb = __shfl_sync(kAll, e, b);
      const int nd = __shfl_sync(kAll, dst, b);
      const float wo = __shfl_sync(kAll, we, b);
      const T* qr = q + nd * F;
      const float* gr = ghat + nd * F;
      const T* er = e1 + eb * F;
      for (int f = lane; f < F; f += 32) {
        p[f] = kk[f] * scaled_q(qr[f], inv) * to_f32(er[f]);
        pv[f] = vv[f] * gr[f];
      }
      __syncwarp();
      for (int h = lane; h < H; h += 32) {
        float score = 0.f, vg = 0.f;
        for (int d = 0; d < D; ++d) {
          score += p[h * D + d];
          vg += pv[h * D + d];
        }
        const float s = clamped_exp(score) * wo;
        sh[h] = s;
        dsh[h] = (score > -5.f && score < 5.f) ? (vg - c[nd * H + h]) * s : 0.f;
      }
      __syncwarp();
      for (int f = lane; f < F; f += 32) {
        const int h = f / D;
        adv[f] += sh[h] * gr[f];
        adk[f] += scaled_q(qr[f], inv) * to_f32(er[f]) * dsh[h];
      }
    }
  }
  __syncwarp();
  for (int f = lane; f < F; f += 32) {
    dk[m * F + f] = adk[f];
    dv[m * F + f] = adv[f];
  }
}

// the first zero_blocks blocks zero the uncounted dE1 slots; then even
// blocks walk destination rows, odd ones source rows, both from the last row
// down: a batch's padding edges all sit on its last node, and that row's
// long walks should start at once, not in the last wave
// No __launch_bounds__ on K3: given the block size, ptxas squeezes
// registers to fit one more block an SM and spills; a fixed ceiling of 64
// spills too
template <typename T>
__global__ void attn_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ e1, const float* __restrict__ ghat, const float* __restrict__ c,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ de1, const int* __restrict__ senders,
    const int* __restrict__ receivers, const float* __restrict__ w,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ dst_ptr, const int* __restrict__ src_order,
    const int* __restrict__ src_ptr, int num_nodes, int num_edges, int H, int D, int bn,
    float inv, int row_blocks, int zero_blocks) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (blockIdx.x < zero_blocks) {
    const int z = blockIdx.x * kWarps + warp;
    if (32 * z < num_edges)
      zero_uncounted(de1, z, lane, senders, receivers, w, starts, ends, num_nodes,
                     num_edges, H * D, bn);
    return;
  }
  float* buf = smem + warp * (6 * H * D + 2 * H);
  const int b = blockIdx.x - zero_blocks;
  const bool src_pass = b & 1;
  const int n = (row_blocks - 1 - (b >> 1)) * kWarps + warp;
  if (n >= num_nodes) return;  // whole warps leave together
  const int t = n / bn;
  const int e_lo = __ldg(starts + t), e_hi = __ldg(ends + t);
  if (src_pass) {
    bwd_src_row<T>(buf, n, lane, q, k, v, e1, ghat, c, dk, dv, receivers, w, e_lo, e_hi,
                   src_order, src_ptr, H, D, bn, inv);
  } else {
    bwd_dst_row<T>(buf, n, lane, q, k, v, e1, ghat, c, dq, de1, senders, w, e_lo, e_hi,
                   dst_ptr, H, D, bn, inv);
  }
}

// Vector layout (D a multiple of 4, H*D/4 dividing 32; the shipped
// Transformer has H = D = 8): lane group g of lpr = H*D/4 lanes holds a
// whole row, 4 features a lane in registers, so a head's D features sit in
// lph = D/4 adjacent lanes and its sums are shuffles; the warp's 32/lpr
// groups take that many counted edges at once.

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // bf16 is the top half of an f32; the lower address holds the low half
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Q * inv rounded to the input type, 4 at a time
template <typename T>
__device__ __forceinline__ float4 scaled4(float4 a, float inv) {
  return make_float4(to_f32(from_f32<T>(a.x * inv)), to_f32(from_f32<T>(a.y * inv)),
                     to_f32(from_f32<T>(a.z * inv)), to_f32(from_f32<T>(a.w * inv)));
}

__device__ __forceinline__ float sum4(float4 a) { return a.x + a.y + a.z + a.w; }

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ void add4(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// the sum over the lph lanes of a head (all 32 lanes call it)
__device__ __forceinline__ float head_sum(float x, int lph) {
  for (int o = 1; o < lph; o <<= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

// the sum over the warp's lane groups of lpr lanes (all 32 lanes call it)
__device__ __forceinline__ float4 group_sum(float4 a, int lpr) {
  for (int o = lpr; o < 32; o <<= 1) {
    a.x += __shfl_xor_sync(kAll, a.x, o);
    a.y += __shfl_xor_sync(kAll, a.y, o);
    a.z += __shfl_xor_sync(kAll, a.z, o);
    a.w += __shfl_xor_sync(kAll, a.w, o);
  }
  return a;
}

// A warp's list of counted edges, filled from one trip of candidates (at
// most 32 * kCand): the edge slot, the other endpoint and the weight.
struct EdgeList {
  int e[32 * kCand];
  int node[32 * kCand];
  float w[32 * kCand];
};

// appends the lanes whose `ok` is set, in lane order, after `count` (all 32
// lanes call it); returns the new count, and the ballot in `bits`
__device__ __forceinline__ int append_counted(EdgeList& list, int count, bool ok, int e,
                                              int node, float w, int lane,
                                              unsigned& bits) {
  bits = __ballot_sync(kAll, ok);
  if (ok) {
    const int pos = count + __popc(bits & ((1u << lane) - 1u));
    list.e[pos] = e;
    list.node[pos] = node;
    list.w[pos] = w;
  }
  return count + __popc(bits);
}

// destination row n: dQ[n] and dE1 of its segment
template <typename T>
__device__ __forceinline__ void bwd_dst_row_vec(
    EdgeList& list, int n, int lane, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ e1, const float* __restrict__ ghat,
    const float* __restrict__ c, float* __restrict__ dq, float* __restrict__ de1,
    const int* __restrict__ senders, const float* __restrict__ w,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ dst_ptr, int H, int D, int bn, float inv) {
  const int F = H * D, lpr = F / 4, lph = D / 4, groups = 32 / lpr;
  const int sub = lane / lpr, f = 4 * (lane % lpr);
  const int t = n / bn, n_lo = t * bn;
  const int row = n * F + f;  // this lane's features of row n
  // every load that needs no index first, all in flight together
  const int e_lo = __ldg(starts + t), e_hi = __ldg(ends + t);
  const int p0 = max(__ldg(dst_ptr + n), e_lo), p1 = min(__ldg(dst_ptr + n + 1), e_hi);
  const float4 qs = scaled4<T>(load4(q + row), inv);
  const float4 gh = __ldg(reinterpret_cast<const float4*>(ghat + row));
  const float cn = __ldg(c + n * H + f / D);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int jb = p0; jb < p1; jb += 32 * kCand) {
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
      const bool ok = j < p1 && we[i] != 0.f && (unsigned)(src[i] - n_lo) < (unsigned)bn;
      unsigned bits;
      count = append_counted(list, count, ok, j, src[i], we[i], lane, bits);
    }
    __syncwarp();
    // the counted edges, `groups` at a time, one per lane group
    for (int m0 = 0; m0 < count; m0 += groups) {
      const int m = m0 + sub;
      const bool has = m < count;
      float4 kf = make_float4(0.f, 0.f, 0.f, 0.f), vf = kf, ef = kf;
      float wo = 0.f;
      int e = 0;
      if (has) {
        const int o = list.node[m];
        e = list.e[m];
        wo = list.w[m];
        kf = load4(k + o * F + f);
        vf = load4(v + o * F + f);
        ef = load4(e1 + e * F + f);
      }
      const float4 kq = mul4(kf, qs);
      const float score = head_sum(sum4(mul4(kq, ef)), lph);
      const float vg = head_sum(sum4(mul4(vf, gh)), lph);
      const float s = clamped_exp(score) * wo;
      const float ds = (score > -5.f && score < 5.f) ? (vg - cn) * s : 0.f;
      if (has) {
        add4(acc, scale4(mul4(kf, ef), ds));
        *reinterpret_cast<float4*>(de1 + e * F + f) = scale4(kq, ds);
      }
    }
    __syncwarp();  // the list is refilled by the next trip
  }
  acc = group_sum(acc, lpr);
  if (sub == 0) *reinterpret_cast<float4*>(dq + row) = scale4(acc, inv);
}

// source row m: dK[m] and dV[m] over the counted edges leaving m
template <typename T>
__device__ __forceinline__ void bwd_src_row_vec(
    EdgeList& list, int m, int lane, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ e1, const float* __restrict__ ghat,
    const float* __restrict__ c, float* __restrict__ dk, float* __restrict__ dv,
    const int* __restrict__ receivers, const float* __restrict__ w,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ src_order, const int* __restrict__ src_ptr, int H, int D,
    int bn, float inv) {
  const int F = H * D, lpr = F / 4, lph = D / 4, groups = 32 / lpr;
  const int sub = lane / lpr, f = 4 * (lane % lpr), h = f / D;
  const int t = m / bn, m_lo = t * bn;
  const int row = m * F + f;
  const int p0 = __ldg(src_ptr + m), p1 = __ldg(src_ptr + m + 1);
  const int e_lo = __ldg(starts + t), e_hi = __ldg(ends + t);
  const float4 kk = load4(k + row), vv = load4(v + row);
  float4 adk = make_float4(0.f, 0.f, 0.f, 0.f), adv = adk;

  for (int jb = p0; jb < p1; jb += 32 * kCand) {
    int eid[kCand], dst[kCand];
    float we[kCand];
#pragma unroll
    for (int i = 0; i < kCand; ++i)  // past the end, the last one again
      eid[i] = __ldg(src_order + min(jb + 32 * i + lane, p1 - 1));
#pragma unroll
    for (int i = 0; i < kCand; ++i) {
      dst[i] = __ldg(receivers + eid[i]);
      we[i] = __ldg(w + eid[i]);
    }
    int count = 0;
#pragma unroll
    for (int i = 0; i < kCand; ++i) {
      // the edge must lie in its destination tile (= m's tile) and its range
      const bool ok = jb + 32 * i + lane < p1 && we[i] != 0.f &&
                      (unsigned)(dst[i] - m_lo) < (unsigned)bn && eid[i] >= e_lo &&
                      eid[i] < e_hi;
      unsigned bits;
      count = append_counted(list, count, ok, eid[i], dst[i], we[i], lane, bits);
    }
    __syncwarp();
    for (int i0 = 0; i0 < count; i0 += groups) {
      const int i = i0 + sub;
      const bool has = i < count;
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), gv = qv, ef = qv;
      float cv = 0.f, wo = 0.f;
      if (has) {
        const int nd = list.node[i];
        wo = list.w[i];
        qv = scaled4<T>(load4(q + nd * F + f), inv);
        gv = __ldg(reinterpret_cast<const float4*>(ghat + nd * F + f));
        cv = __ldg(c + nd * H + h);
        ef = load4(e1 + list.e[i] * F + f);
      }
      const float score = head_sum(sum4(mul4(mul4(kk, qv), ef)), lph);
      const float vg = head_sum(sum4(mul4(vv, gv)), lph);
      const float s = clamped_exp(score) * wo;
      const float ds = (score > -5.f && score < 5.f) ? (vg - cv) * s : 0.f;
      if (has) {
        add4(adv, scale4(gv, s));
        add4(adk, scale4(mul4(qv, ef), ds));
      }
    }
    __syncwarp();  // the list is refilled by the next trip
  }
  adk = group_sum(adk, lpr);
  adv = group_sum(adv, lpr);
  if (sub == 0) {
    *reinterpret_cast<float4*>(dk + row) = adk;
    *reinterpret_cast<float4*>(dv + row) = adv;
  }
}

// the first zero_blocks blocks zero the uncounted dE1 slots; then even
// blocks walk destination rows, odd ones source rows, both from the last row
// down: a batch's padding edges all sit on its last node, and that row's
// long walks should start at once, not in the last wave
template <typename T>  // no __launch_bounds__, as attn_bwd_kernel
__global__ void attn_bwd_vec_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ e1, const float* __restrict__ ghat, const float* __restrict__ c,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ de1, const int* __restrict__ senders,
    const int* __restrict__ receivers, const float* __restrict__ w,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ dst_ptr, const int* __restrict__ src_order,
    const int* __restrict__ src_ptr, int num_nodes, int num_edges, int H, int D, int bn,
    float inv, int row_blocks, int zero_blocks) {
  __shared__ EdgeList lists[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (blockIdx.x < zero_blocks) {
    const int z = blockIdx.x * kWarps + warp;
    if (32 * z < num_edges)
      zero_uncounted(de1, z, lane, senders, receivers, w, starts, ends, num_nodes,
                     num_edges, H * D, bn);
    return;
  }
  const int b = blockIdx.x - zero_blocks;
  const bool src_pass = b & 1;
  const int n = (row_blocks - 1 - (b >> 1)) * kWarps + warp;
  if (n >= num_nodes) return;  // whole warps leave together
  if (src_pass) {
    bwd_src_row_vec<T>(lists[warp], n, lane, q, k, v, e1, ghat, c, dk, dv, receivers, w,
                       starts, ends, src_order, src_ptr, H, D, bn, inv);
  } else {
    bwd_dst_row_vec<T>(lists[warp], n, lane, q, k, v, e1, ghat, c, dq, de1, senders, w,
                       starts, ends, dst_ptr, H, D, bn, inv);
  }
}

// ---- K2, the vector layout --------------------------------------------------

__device__ __forceinline__ void store4(float* p, float4 a) {
  *reinterpret_cast<float4*>(p) = a;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 a) {
  uint2 u;
  u.x = (unsigned)__bfloat16_as_ushort(__float2bfloat16(a.x)) |
        ((unsigned)__bfloat16_as_ushort(__float2bfloat16(a.y)) << 16);
  u.y = (unsigned)__bfloat16_as_ushort(__float2bfloat16(a.z)) |
        ((unsigned)__bfloat16_as_ushort(__float2bfloat16(a.w)) << 16);
  *reinterpret_cast<uint2*>(p) = u;
}

// One warp per destination row n, from the last row down: out[n] and
// den[n].  Lane group `sub` of lpr = H*D/4 lanes takes counted edges sub,
// sub + groups, ... of each trip's list in order; the groups' sums are then
// added by shuffles, so the order is fixed.  No __launch_bounds__, as K3.
template <typename T>
__global__ void attn_fwd_vec_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ e1, T* __restrict__ out, float* __restrict__ den,
    const int* __restrict__ senders, const float* __restrict__ w,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ dst_ptr, int num_nodes, int H, int D, int bn, float inv) {
  __shared__ EdgeList lists[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = (gridDim.x - 1 - blockIdx.x) * kWarps + warp;
  if (n >= num_nodes) return;  // whole warps leave together
  EdgeList& list = lists[warp];
  const int F = H * D, lpr = F / 4, lph = D / 4, groups = 32 / lpr;
  const int sub = lane / lpr, f = 4 * (lane % lpr);
  const int t = n / bn, n_lo = t * bn;
  const size_t row = (size_t)n * F + f;  // this lane's features of row n
  // every load that needs no index first, all in flight together
  const int e_lo = __ldg(starts + t), e_hi = __ldg(ends + t);
  const int p0 = max(__ldg(dst_ptr + n), e_lo), p1 = min(__ldg(dst_ptr + n + 1), e_hi);
  const float4 qs = scaled4<T>(load4(q + row), inv);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float dsum = 0.f;  // this group's share of den for the lane's head

  for (int jb = p0; jb < p1; jb += 32 * kCand) {
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
      const bool ok = j < p1 && we[i] != 0.f && (unsigned)(src[i] - n_lo) < (unsigned)bn;
      unsigned bits;
      count = append_counted(list, count, ok, j, src[i], we[i], lane, bits);
    }
    __syncwarp();
    // the counted edges, `groups` at a time, one per lane group
    for (int m0 = 0; m0 < count; m0 += groups) {
      const int m = m0 + sub;
      const bool has = m < count;
      float4 kf = make_float4(0.f, 0.f, 0.f, 0.f), vf = kf, ef = kf;
      float wo = 0.f;
      if (has) {
        const size_t o = (size_t)list.node[m] * F + f;
        wo = list.w[m];
        kf = load4(k + o);
        vf = load4(v + o);
        ef = load4(e1 + (size_t)list.e[m] * F + f);
      }
      const float score = head_sum(sum4(mul4(mul4(kf, qs), ef)), lph);
      const float s = clamped_exp(score) * wo;  // 0 for a group without an edge
      add4(acc, scale4(vf, s));
      dsum += s;
    }
    __syncwarp();  // the list is refilled by the next trip
  }
  acc = group_sum(acc, lpr);
  for (int o = lpr; o < 32; o <<= 1) dsum += __shfl_xor_sync(kAll, dsum, o);
  if (sub == 0) {
    const float d = dsum + 1e-6f;
    store4(out + row, make_float4(acc.x / d, acc.y / d, acc.z / d, acc.w / d));
    if (f % D == 0) den[(size_t)n * H + f / D] = dsum;
  }
}

template <typename Kernel>
cudaError_t fit_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* e1,
                       void* out, void* den, const void* senders, const void* w,
                       const void* starts, const void* ends, const void* dst_ptr,
                       int num_nodes, int H, int D, int bn, float inv, int vec,
                       cudaStream_t stream) {
  const dim3 grid((num_nodes + kWarps - 1) / kWarps);
  if (vec) {
    attn_fwd_vec_kernel<T><<<grid, 32 * kWarps, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)e1, (T*)out, (float*)den,
        (const int*)senders, (const float*)w, (const int*)starts, (const int*)ends,
        (const int*)dst_ptr, num_nodes, H, D, bn, inv);
    return cudaGetLastError();
  }
  const size_t bytes = (size_t)kWarps * (4 * H * D + 2 * H) * sizeof(float);
  cudaError_t err = fit_smem(attn_fwd_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<T><<<grid, 32 * kWarps, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)e1, (T*)out, (float*)den,
      (const int*)senders, (const float*)w, (const int*)starts, (const int*)ends,
      (const int*)dst_ptr, num_nodes, H, D, bn, inv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* e1,
                       const void* ghat, const void* c, void* dq, void* dk, void* dv,
                       void* de1, const void* senders, const void* receivers,
                       const void* w, const void* starts, const void* ends,
                       const void* dst_ptr, const void* src_order, const void* src_ptr,
                       int num_nodes, int num_edges, int H, int D, int bn, float inv,
                       int vec, cudaStream_t stream) {
  const int row_blocks = (num_nodes + kWarps - 1) / kWarps;
  const int zero_blocks = ((num_edges + 31) / 32 + kWarps - 1) / kWarps;
  const int grid = zero_blocks + 2 * row_blocks;
  if (vec) {
    attn_bwd_vec_kernel<T><<<grid, 32 * kWarps, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)e1, (const float*)ghat,
        (const float*)c, (float*)dq, (float*)dk, (float*)dv, (float*)de1,
        (const int*)senders, (const int*)receivers, (const float*)w, (const int*)starts,
        (const int*)ends, (const int*)dst_ptr, (const int*)src_order, (const int*)src_ptr,
        num_nodes, num_edges, H, D, bn, inv, row_blocks, zero_blocks);
    return cudaGetLastError();
  }
  const size_t bytes = (size_t)kWarps * (6 * H * D + 2 * H) * sizeof(float);
  cudaError_t err = fit_smem(attn_bwd_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  attn_bwd_kernel<T><<<grid, 32 * kWarps, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)e1, (const float*)ghat,
      (const float*)c, (float*)dq, (float*)dk, (float*)dv, (float*)de1,
      (const int*)senders, (const int*)receivers, (const float*)w, (const int*)starts,
      (const int*)ends, (const int*)dst_ptr, (const int*)src_order, (const int*)src_ptr,
      num_nodes, num_edges, H, D, bn, inv, row_blocks, zero_blocks);
  return cudaGetLastError();
}

}  // namespace

// K2.  q, k, v: [num_nodes, H * D], e1: [E, H * D], out: [num_nodes, H * D],
// all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1); den: [num_nodes, H] f32;
// out and den written at every row; senders: [E] int32, dst-sorted; w: [E]
// f32 edge weights; starts, ends: [T] int32 tile edge ranges; dst_ptr:
// [num_nodes + 1] int32 CSR pointers over the dst-sorted edges; inv:
// 1/sqrt(D) rounded to the input type.  vec = 1 takes the vector layout
// (head_dim a multiple of 4, H * D / 4 dividing 32, q, k, v, e1 and out
// aligned to 4 elements), vec = 0 the general one.
extern "C" int edge_attention_fwd(const void* q, const void* k, const void* v,
                                  const void* e1, void* out, void* den, const void* senders,
                                  const void* w, const void* starts, const void* ends,
                                  const void* dst_ptr, int num_nodes, int num_heads,
                                  int head_dim, int bn, int is_bf16, int vec, float inv,
                                  void* stream) {
  if (num_nodes <= 0 || num_heads <= 0 || head_dim <= 0) return (int)cudaGetLastError();
  const int lpr = num_heads * head_dim / 4;
  if (vec && (head_dim % 4 || lpr > 32 || 32 % lpr)) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      is_bf16 ? launch_fwd<__nv_bfloat16>(q, k, v, e1, out, den, senders, w, starts, ends,
                                          dst_ptr, num_nodes, num_heads, head_dim, bn, inv,
                                          vec, (cudaStream_t)stream)
              : launch_fwd<float>(q, k, v, e1, out, den, senders, w, starts, ends, dst_ptr,
                                  num_nodes, num_heads, head_dim, bn, inv, vec,
                                  (cudaStream_t)stream);
  return (int)err;
}

// K3 (offsets in 32 bits: (num_nodes + num_edges) * H * D < 2**31).  q, k,
// v, e1 as for K2; ghat: [num_nodes, H * D] f32; c: [num_nodes, H]
// f32; dq, dk, dv: [num_nodes, H * D] f32, every row written; de1:
// [num_edges, H * D] f32, every slot written (zeros where no edge counts);
// receivers: [E] int32; src_order: [E] int32, the edges stably sorted by
// source; src_ptr: [num_nodes + 1] int32 CSR pointers over src_order.
// vec = 1 takes the vector layout: head_dim a multiple of 4, H * D / 4
// dividing 32, q, k, v, e1 aligned to 4 elements and ghat to 16 bytes;
// vec = 0 the general one.
extern "C" int edge_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* e1, const void* ghat, const void* c, void* dq,
                                  void* dk, void* dv, void* de1, const void* senders,
                                  const void* receivers, const void* w, const void* starts,
                                  const void* ends, const void* dst_ptr,
                                  const void* src_order, const void* src_ptr, int num_nodes,
                                  int num_edges, int num_heads, int head_dim, int bn,
                                  int is_bf16, int vec, float inv, void* stream) {
  if (num_nodes <= 0 || num_heads <= 0 || head_dim <= 0) return (int)cudaGetLastError();
  const int lpr = num_heads * head_dim / 4;
  if (vec && (head_dim % 4 || lpr > 32 || 32 % lpr)) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      is_bf16 ? launch_bwd<__nv_bfloat16>(q, k, v, e1, ghat, c, dq, dk, dv, de1, senders,
                                          receivers, w, starts, ends, dst_ptr, src_order,
                                          src_ptr, num_nodes, num_edges, num_heads,
                                          head_dim, bn, inv, vec, (cudaStream_t)stream)
              : launch_bwd<float>(q, k, v, e1, ghat, c, dq, dk, dv, de1, senders, receivers,
                                  w, starts, ends, dst_ptr, src_order, src_ptr, num_nodes,
                                  num_edges, num_heads, head_dim, bn, inv, vec,
                                  (cudaStream_t)stream);
  return (int)err;
}
