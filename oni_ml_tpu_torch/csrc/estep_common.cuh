// Device helpers shared by the port's E-step kernels: the stop rule, the
// special functions and the reciprocal of oni_ml_tpu/ops/pallas_estep.py:
// 67-120 and ops/stop.py (every kernel), and the per-document core of the
// gamma fixed point over a staged list of cells (dense_estep.cu and
// fixed_point_estep.cu, so the two cannot drift): q, the s contraction,
// the gamma update, the reductions over the warps of a document, the
// token term of the tail, and the cp.async staging copies.  ops/_cuda.py
// hashes this header into every kernel's build key.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace oni {

constexpr float kStallGate = 1e-2f;  // ops/stop.py STALL_GATE
constexpr unsigned kFull = 0xffffffffu;

// The TPU's approximate reciprocal + one Newton step (newton_recip).
__device__ __forceinline__ float newton_recip(float q) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(q));
  return r * (2.0f - q * r);
}

// ops/special.py digamma_pos: recurrence up past 6, then the series.
__device__ __forceinline__ float digamma_pos(float x) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const bool small = x < 6.0f;
    acc -= small ? 1.0f / x : 0.0f;
    x += small ? 1.0f : 0.0f;
  }
  const float inv = 1.0f / x;
  const float inv2 = inv * inv;
  const float series = logf(x) - 0.5f * inv -
                       inv2 * (1.0f / 12.0f - inv2 * (1.0f / 120.0f - inv2 / 252.0f));
  return series + acc;
}

// ops/special.py gammaln_pos: product recurrence, then Stirling.
__device__ __forceinline__ float gammaln_pos(float x) {
  float prod = 1.0f;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const bool small = x < 6.0f;
    prod *= small ? x : 1.0f;
    x += small ? 1.0f : 0.0f;
  }
  const float inv = 1.0f / x;
  const float inv2 = inv * inv;
  const float series = (x - 0.5f) * logf(x) - x + 0.9189385332046727f +
                       inv * (1.0f / 12.0f - inv2 * (1.0f / 360.0f - inv2 / 1260.0f));
  return series - logf(prod);
}

// ops/stop.py fp_continue.
__device__ __forceinline__ bool fp_continue(int it, float delta, float prev,
                                            int var_max_iters, float var_tol) {
  return it < var_max_iters &&
         (it == 0 || (delta > var_tol && (delta >= kStallGate || delta < prev)));
}

// ops/estep.py flush_subnormal: a non-negative float32 below the normal
// range is zero, as XLA computes it on the CPU and the TPU (flush-to-zero).
__device__ __forceinline__ float flush_subnormal(float v) {
  return v < 1.17549435e-38f ? 0.0f : v;  // FLT_MIN
}

// xor butterfly: every lane ends with the same sum, in a fixed order.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The chunk driver's device-resident stop flag (models/fused.py): once
// set, every E-step launch of the dispatch returns at once.
__device__ __forceinline__ bool stopped(const int* stop_flag) {
  return stop_flag != nullptr && *stop_flag != 0;
}

// The wrapper's device count of launches that ran past the stop check
// (one thread of the grid adds one); launches after the stop add nothing.
__device__ __forceinline__ void count_executed(int* executed) {
  if (executed != nullptr && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(executed, 1);
}

// ---------------------------------------------------------------------------
// The per-document core over a list of cells.
//
// A document's cells are n values c[i] and, for each, K values of
// exp(log beta) at b[k * ks + i] (a [K, n]-strided tile in shared memory,
// or the same tile in device memory where it did not fit; the pointers
// are not __restrict__, so a tile that the same launch wrote is never
// read through the non-coherent read-only path).  A cell with c = 0 adds
// exactly zero to every sum below, so the caller lists only the non-zero
// ones (the dense kernel) or the live prefix (the slab).
//
// The `wpd` warps of a document stride over its cells (cell i to warp
// i / 32 % wpd, lane i % 32).  Per-topic state is lane-parallel: lane t
// owns topic t (and t + 32 where K > 32), NS(KT) slots a lane; only
// E[log theta]'s exp is broadcast to every lane, for the contractions.
// Every sum is taken in an order fixed by the launch geometry, so the
// results are the same bits on every run.
// ---------------------------------------------------------------------------

// Topic slots a lane owns: topic lane + 32 * h for h < NS.
template <int KT>
constexpr int NS = (KT + 31) / 32;

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// From the lane's gamma slots: el_mine = E[log theta] = digamma(gamma) -
// digamma(sum_k gamma) and e_mine = its exp, for the lane's topics (zero
// past K); e[k] = exp E[log theta][k] broadcast to every lane.
template <int KT>
__device__ __forceinline__ void e_log_theta(const float (&g)[NS<KT>], int K, int lane,
                                            float (&el_mine)[NS<KT>],
                                            float (&e_mine)[NS<KT>], float (&e)[KT]) {
  float gs = 0.0f;
#pragma unroll
  for (int h = 0; h < NS<KT>; ++h)
    if (lane + 32 * h < K) gs += g[h];
  const float dg_sum = digamma_pos(warp_sum(gs));
#pragma unroll
  for (int h = 0; h < NS<KT>; ++h) {
    const bool mine = lane + 32 * h < K;
    const float l = digamma_pos(mine ? g[h] : 1.0f) - dg_sum;
    el_mine[h] = mine ? l : 0.0f;
    e_mine[h] = mine ? expf(l) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < KT; ++k) e[k] = __shfl_sync(kFull, e_mine[k / 32], k & 31);
}

// One cell: its K values into bk and c * recip(sum_k b e + 1e-30).
template <int KT>
__device__ __forceinline__ float cell_ratio(const float* b, size_t ks, float c,
                                            const float (&e)[KT], int K,
                                            float (&bk)[KT], float& q) {
  float ph = 0.0f;
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    bk[k] = (k < K) ? b[k * ks] : 0.0f;
    ph = fmaf(bk[k], e[k], ph);
  }
  q = ph + 1e-30f;
  return c * newton_recip(q);
}

// acc[k] += sum over this lane's cells of ratio * b[k]  (the s contraction).
template <int KT>
__device__ __forceinline__ void accumulate_cells(const float* b, size_t ks, const float* c,
                                                 int lo, int hi, int step,
                                                 const float (&e)[KT], int K,
                                                 float (&acc)[KT]) {
  for (int i = lo; i < hi; i += step) {
    float bk[KT], q;
    const float r = cell_ratio<KT>(b + i, ks, c[i], e, K, bk, q);
#pragma unroll
    for (int k = 0; k < KT; ++k) acc[k] = fmaf(r, bk[k], acc[k]);
  }
}

// The tail's token term over this lane's cells, sum c log q; where
// `ratio` is given, ratio[i] = c * recip(q) (the suff-stats factor).
template <int KT>
__device__ __forceinline__ float token_term(const float* b, size_t ks, const float* c,
                                            int lo, int hi, int step,
                                            const float (&e)[KT], int K,
                                            float* __restrict__ ratio) {
  float tok = 0.0f;
  for (int i = lo; i < hi; i += step) {
    float bk[KT], q;
    const float r = cell_ratio<KT>(b + i, ks, c[i], e, K, bk, q);
    tok = fmaf(c[i], logf(q), tok);
    if (ratio != nullptr) ratio[i] = r;
  }
  return tok;
}

// The warp's per-topic sums, transposed: s[h] = sum over the 32 lanes of
// v[lane + 32 h] (lane t ends with topic t's total).  Halving exchanges:
// at offset o a lane keeps the half of its o * 2 partial sums that its bit
// o selects and adds its partner's, o shuffles a level, 31 per 32 topics.
template <int KT>
__device__ __forceinline__ void warp_topic_sums(const float (&v)[KT], int lane,
                                                float (&s)[NS<KT>]) {
#pragma unroll
  for (int h = 0; h < NS<KT>; ++h) {
    float a[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) a[i] = (32 * h + i < KT) ? v[32 * h + i] : 0.0f;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) {
      const bool upper = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < o; ++i) {
        const float send = upper ? a[i] : a[i + o];
        const float keep = upper ? a[i + o] : a[i];
        a[i] = keep + __shfl_xor_sync(kFull, send, o);
      }
    }
    s[h] = a[0];
  }
}

// A document's per-topic totals over its wpd warps, added in warp order
// through `red` (nwarps * NS * 32 floats of shared memory that no thread
// touches again until every thread has left this call: double-buffer it
// across iterations).  A no-op when wpd == 1; else one __syncthreads, so
// every thread of the CTA must call it.
template <int KT>
__device__ __forceinline__ void doc_sums(float (&s)[NS<KT>], float* red, int warp, int doc,
                                         int wpd, int lane) {
  if (wpd == 1) return;
#pragma unroll
  for (int h = 0; h < NS<KT>; ++h) red[(warp * NS<KT> + h) * 32 + lane] = s[h];
  __syncthreads();
#pragma unroll
  for (int h = 0; h < NS<KT>; ++h) {
    float t = 0.0f;
    for (int p = 0; p < wpd; ++p) t += red[((doc * wpd + p) * NS<KT> + h) * 32 + lane];
    s[h] = t;
  }
}

// The same for one scalar (every lane of the warp holds its value).
__device__ __forceinline__ float doc_sum1(float v, float* red, int warp, int doc,
                                          int wpd, int lane) {
  if (wpd == 1) return v;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.0f;
  for (int p = 0; p < wpd; ++p) t += red[doc * wpd + p];
  return t;
}

// gamma' = alpha + e * s on the lane's topics; returns sum_k |gamma' -
// gamma| over the warp (every lane holds it).
template <int KT>
__device__ __forceinline__ float gamma_update(float (&g)[NS<KT>], const float (&e_mine)[NS<KT>],
                                              const float (&s)[NS<KT>], float alpha, int K,
                                              int lane) {
  float d = 0.0f;
#pragma unroll
  for (int h = 0; h < NS<KT>; ++h) {
    if (lane + 32 * h < K) {
      const float gn = alpha + e_mine[h] * s[h];
      d += fabsf(gn - g[h]);
      g[h] = gn;
    }
  }
  return warp_sum(d);
}

// ---------------------------------------------------------------------------
// Staging copies, device memory -> shared memory (cp.async, sm_80+).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst_smem, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst_smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst_smem, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst_smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// dst[0..n) = src[0..n) by the 32 lanes of a warp: 16-byte copies where
// both ends are 16-byte aligned, else 4-byte ones.  Completes at
// cp_async_wait_all() and a barrier.
__device__ __forceinline__ void stage_row(float* dst_smem, const float* src, int n,
                                          int lane) {
  const bool al = ((reinterpret_cast<uintptr_t>(src) |
                    reinterpret_cast<uintptr_t>(dst_smem)) & 15) == 0;
  int done = 0;
  if (al) {
    const int n4 = n >> 2;
    for (int i = lane; i < n4; i += 32) cp_async16(dst_smem + 4 * i, src + 4 * i);
    done = n4 << 2;
  }
  for (int i = done + lane; i < n; i += 32) cp_async4(dst_smem + i, src + i);
}

}  // namespace oni

// One definition per library: each library is built from one .cu file.
extern "C" const char* oni_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
