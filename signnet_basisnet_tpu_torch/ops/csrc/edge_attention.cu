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
// 10 MB.  Both are bound by memory, and at this size by launch latency.
// The TPU form gathered and scattered rows with one-hot [256, 256] MXU
// products and padded features to 128 lanes (a workaround for the MXU);
// these kernels walk each row's edges through CSR pointers instead.
//
// Design (simple; later work makes it fast):
// - one warp per row, 4 rows per 128-thread block; lanes take the H*D
//   features at stride 32, so a row or an edge's E1 is one coalesced read;
// - each warp keeps its row's vectors and per-edge products in shared
//   memory: a head's score is summed over its D features by one lane per
//   head, which takes any H and D (the shipped configs have D = 7, 8, 10,
//   so heads need not line up with lanes);
// - the warp loads 32 of its row's edges at once, a ballot marks those that
//   count (padding edges, weight 0, all sit on the batch's last node and are
//   skipped 32 at a time), and the counted ones are taken one by one;
// - each row sums its edges in a fixed order in f32 and writes its outputs
//   once: no atomics, so the results do not depend on scheduling.  The
//   backward runs two passes in one launch: the first half of the blocks
//   walks destination rows (dst_ptr) for dQ and dE1, the second half source
//   rows (src_order / src_ptr, the permutation the transposed SpMM walks)
//   for dK and dV; both recompute s from Q, K and E1;
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

// one warp per destination row n: out[n] and den[n]
template <typename T>
__global__ void __launch_bounds__(32 * kWarps) attn_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ e1, T* __restrict__ out, float* __restrict__ den,
    const int* __restrict__ senders, const float* __restrict__ w,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ dst_ptr, int num_nodes, int H, int D, int bn, float inv) {
  extern __shared__ float smem[];
  const int F = H * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qs = smem + warp * (3 * F + 2 * H);  // the row's Qs
  float* p = qs + F;                          // K * Qs * E1 of one edge
  float* acc = p + F;                         // sum_e s_e V[src_e]
  float* sh = acc + F;                        // s_e per head
  float* dh = sh + H;                         // sum_e s_e per head
  const int n = blockIdx.x * kWarps + warp;
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
      const size_t e = (size_t)(jb + b);
      const T* kr = k + (size_t)o * F;
      const T* vr = v + (size_t)o * F;
      const T* er = e1 + e * F;
      for (int f = lane; f < F; f += 32) p[f] = to_f32(kr[f]) * qs[f] * to_f32(er[f]);
      __syncwarp();
      for (int h = lane; h < H; h += 32) {
        float score = 0.f;
        for (int d = 0; d < D; ++d) score += p[h * D + d];
        const float s = clamped_exp(score) * wo;
        sh[h] = s;
        dh[h] += s;
      }
      __syncwarp();
      for (int f = lane; f < F; f += 32) acc[f] += sh[f / D] * to_f32(vr[f]);
    }
  }
  __syncwarp();
  for (int f = lane; f < F; f += 32)
    out[(size_t)n * F + f] = from_f32<T>(acc[f] / (dh[f / D] + 1e-6f));
  for (int h = lane; h < H; h += 32) den[(size_t)n * H + h] = dh[h];
}

// backward, destination row n: dQ[n] and dE1 of its counted edges
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
  const int n_lo = (n / bn) * bn;
  const int j0 = max(__ldg(dst_ptr + n), e_lo);
  const int j1 = min(__ldg(dst_ptr + n + 1), e_hi);
  for (int f = lane; f < F; f += 32) {
    qs[f] = scaled_q(q[(size_t)n * F + f], inv);
    gh[f] = ghat[(size_t)n * F + f];
    acc[f] = 0.f;
  }
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
      const size_t e = (size_t)(jb + b);
      const T* kr = k + (size_t)o * F;
      const T* vr = v + (size_t)o * F;
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
        dsh[h] = (score > -5.f && score < 5.f) ? (vg - c[(size_t)n * H + h]) * s : 0.f;
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
  for (int f = lane; f < F; f += 32) dq[(size_t)n * F + f] = acc[f] * inv;
}

// backward, source row m: dK[m] and dV[m] over the counted edges leaving m
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
    kk[f] = to_f32(k[(size_t)m * F + f]);
    vv[f] = to_f32(v[(size_t)m * F + f]);
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
      const size_t eb = (size_t)__shfl_sync(kAll, e, b);
      const int nd = __shfl_sync(kAll, dst, b);
      const float wo = __shfl_sync(kAll, we, b);
      const T* qr = q + (size_t)nd * F;
      const float* gr = ghat + (size_t)nd * F;
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
        dsh[h] = (score > -5.f && score < 5.f) ? (vg - c[(size_t)nd * H + h]) * s : 0.f;
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
    dk[(size_t)m * F + f] = adk[f];
    dv[(size_t)m * F + f] = adv[f];
  }
}

// blocks [0, row_blocks) walk destination rows, the rest source rows
template <typename T>
__global__ void __launch_bounds__(32 * kWarps) attn_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ e1, const float* __restrict__ ghat, const float* __restrict__ c,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ de1, const int* __restrict__ senders,
    const int* __restrict__ receivers, const float* __restrict__ w,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ dst_ptr, const int* __restrict__ src_order,
    const int* __restrict__ src_ptr, int num_nodes, int H, int D, int bn, float inv,
    int row_blocks) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* buf = smem + warp * (6 * H * D + 2 * H);
  const bool src_pass = blockIdx.x >= row_blocks;
  const int n = (blockIdx.x - (src_pass ? row_blocks : 0)) * kWarps + warp;
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
                       int num_nodes, int H, int D, int bn, float inv,
                       cudaStream_t stream) {
  const size_t bytes = (size_t)kWarps * (3 * H * D + 2 * H) * sizeof(float);
  cudaError_t err = fit_smem(attn_fwd_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((num_nodes + kWarps - 1) / kWarps);
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
                       int num_nodes, int H, int D, int bn, float inv,
                       cudaStream_t stream) {
  const size_t bytes = (size_t)kWarps * (6 * H * D + 2 * H) * sizeof(float);
  cudaError_t err = fit_smem(attn_bwd_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const int row_blocks = (num_nodes + kWarps - 1) / kWarps;
  attn_bwd_kernel<T><<<2 * row_blocks, 32 * kWarps, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)e1, (const float*)ghat,
      (const float*)c, (float*)dq, (float*)dk, (float*)dv, (float*)de1,
      (const int*)senders, (const int*)receivers, (const float*)w, (const int*)starts,
      (const int*)ends, (const int*)dst_ptr, (const int*)src_order, (const int*)src_ptr,
      num_nodes, H, D, bn, inv, row_blocks);
  return cudaGetLastError();
}

}  // namespace

// K2.  q, k, v: [num_nodes, H * D], e1: [E, H * D], out: [num_nodes, H * D],
// all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1); den: [num_nodes, H] f32;
// senders: [E] int32, dst-sorted; w: [E] f32 edge weights; starts, ends: [T]
// int32 tile edge ranges; dst_ptr: [num_nodes + 1] int32 CSR pointers over
// the dst-sorted edges; inv: 1/sqrt(D) rounded to the input type.
extern "C" int edge_attention_fwd(const void* q, const void* k, const void* v,
                                  const void* e1, void* out, void* den, const void* senders,
                                  const void* w, const void* starts, const void* ends,
                                  const void* dst_ptr, int num_nodes, int num_heads,
                                  int head_dim, int bn, int is_bf16, float inv,
                                  void* stream) {
  if (num_nodes <= 0 || num_heads <= 0 || head_dim <= 0) return (int)cudaGetLastError();
  const cudaError_t err =
      is_bf16 ? launch_fwd<__nv_bfloat16>(q, k, v, e1, out, den, senders, w, starts, ends,
                                          dst_ptr, num_nodes, num_heads, head_dim, bn, inv,
                                          (cudaStream_t)stream)
              : launch_fwd<float>(q, k, v, e1, out, den, senders, w, starts, ends, dst_ptr,
                                  num_nodes, num_heads, head_dim, bn, inv,
                                  (cudaStream_t)stream);
  return (int)err;
}

// K3.  q, k, v, e1 as for K2; ghat: [num_nodes, H * D] f32; c: [num_nodes, H]
// f32; dq, dk, dv: [num_nodes, H * D] f32, every row written; de1: [E, H * D]
// f32, written at the counted edges only (the caller zeroes it);
// receivers: [E] int32; src_order: [E] int32, the edges stably sorted by
// source; src_ptr: [num_nodes + 1] int32 CSR pointers over src_order.
extern "C" int edge_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* e1, const void* ghat, const void* c, void* dq,
                                  void* dk, void* dv, void* de1, const void* senders,
                                  const void* receivers, const void* w, const void* starts,
                                  const void* ends, const void* dst_ptr,
                                  const void* src_order, const void* src_ptr, int num_nodes,
                                  int num_heads, int head_dim, int bn, int is_bf16,
                                  float inv, void* stream) {
  if (num_nodes <= 0 || num_heads <= 0 || head_dim <= 0) return (int)cudaGetLastError();
  const cudaError_t err =
      is_bf16 ? launch_bwd<__nv_bfloat16>(q, k, v, e1, ghat, c, dq, dk, dv, de1, senders,
                                          receivers, w, starts, ends, dst_ptr, src_order,
                                          src_ptr, num_nodes, num_heads, head_dim, bn, inv,
                                          (cudaStream_t)stream)
              : launch_bwd<float>(q, k, v, e1, ghat, c, dq, dk, dv, de1, senders, receivers,
                                  w, starts, ends, dst_ptr, src_order, src_ptr, num_nodes,
                                  num_heads, head_dim, bn, inv, (cudaStream_t)stream);
  return (int)err;
}
