// Dense-corpus variational E-step for LDA, hand-written for Hopper (sm_90a).
//
// Replaces: oni_ml_tpu/ops/dense_estep.py::_dense_kernel (row-major, C [B, W])
// and ::_dense_kernel_w (W-major, C^T [W, B]), the Pallas TPU kernels that
// dense_fixed_point and dense_fixed_point_w launch through pl.pallas_call.
// Same function, one source for both layouts: element (d, w) of the corpus
// sits at C[d * stride_d + w * stride_w].  Per block of documents, the gamma
// fixed point under the shared stop rule (ops/stop.py)
//
//     q[d, w]  = sum_k beta[k, w] * exp_et[d, k] + 1e-30
//     s[d, k]  = sum_w beta[k, w] * C[d, w] / q[d, w]
//     gamma    = alpha + exp_et * s
//
// then the converged tail: gamma, the per-doc ELBO (token term
// sum_w C log q + the Dirichlet terms), sum_k E[log theta], and the
// suff-stats factor T[k, w] = sum_d exp_et[d, k] mask[d] C[d, w] / q[d, w]
// (the caller forms SS = beta * T).
//
// What bounds it on this card.  The function needs 4*K flops per non-zero
// cell of C and fixed-point iteration (q and the s contraction; a zero
// cell adds exactly zero to s, T and the token term), plus 4*K per
// non-zero cell for the tail.  At the flow day's shape (B = 1024,
// W = 5,632, K = 20, ~1.6% of the cells non-zero, ~50 iterations) that is
// ~0.4 GFLOP, ~6 us at the 67 TFLOP/s f32 peak, while the bytes it must
// move (C once, 23 MB, plus beta, gamma and T) take ~7 us at 3.35 TB/s:
// bytes bound the function.  This kernel does not reach that bound: it
// runs the dense formulation of the TPU kernels, 4*K*W flops per document
// and iteration over every cell (25 GFLOP per launch, ~0.37 ms at the f32
// peak), because skipping zero cells inside a warp saves little when
// most warps hold a non-zero cell somewhere.  The sparse engine is the
// path that does only the non-zero work.  C of a 1024-doc batch stays in
// the 50 MB L2 across the iterations of a launch.
//
// Design, against the TPU kernels:
//  * Fixed point: one CTA of 256 threads per block of BB <= 4 documents
//    (the TPU's sequential grid becomes parallel CTAs; the per-block stop
//    rule is kept, so converged documents iterate with their block, as in
//    Pallas).  Threads stride over the W columns; each thread loads
//    beta[:, w] into registers once per column and reuses it for the BB
//    documents, keeping s[BB][K] in registers.  exp_et of the block sits in
//    shared memory and is read as broadcasts.  q and C / q never leave
//    registers -- the TPU kept [BB, W] q and ratio blocks in VMEM; the card
//    has no room for them and no need.
//  * s is reduced over the CTA in a fixed order (xor shuffles within each
//    warp, then the 8 warps in turn), so gamma is the same on every run.
//  * The two layouts share the thread mapping.  Row-major loads are
//    coalesced across a warp.  W-major loads are strided by B across a
//    warp, but each thread reads its BB documents of a column from one
//    32-byte sector, which the L1 serves after the first.
//  * T: the TPU summed T in a revisited output block, in grid order.  Here
//    blocks run in no order, so T is a second kernel without atomics: each
//    CTA owns 32 columns and each of its 8 warps walks a fixed contiguous
//    range of the documents in order; the 8 partial sums are added in
//    warp order.  T is bit-identical from run to run.  Cells with C = 0 or
//    a masked document are skipped: their contributions are exactly zero.
//  * The TPU's approximate reciprocal + one Newton step becomes
//    rcp.approx.ftz.f32 + one Newton step.  TF32 and tensor cores are not
//    used: the products are full f32 FMAs.
//  * Under the chunk driver (models/fused.py) both kernels take a device
//    pointer to the driver's stop flag and return at once once it is set.
//    A fixed-point launch that runs past that check adds one to the
//    wrapper's device counter `executed`.

#include <stdint.h>

#include "estep_common.cuh"

namespace {

using oni::digamma_pos;
using oni::gammaln_pos;
using oni::newton_recip;
using oni::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// v[0..N) summed over the CTA in a fixed order: xor shuffles within each
// warp, then warps 0..7 in turn.  The totals land in out[0..N) (shared
// memory); `red` is kWarps * N floats of shared scratch.
template <int N>
__device__ __forceinline__ void block_sum(const float (&v)[N], float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float x = warp_sum(v[i]);
    if (lane == 0) red[warp * N + i] = x;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += kThreads) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w * N + i];
    out[i] = t;
  }
  __syncthreads();
}

// q = sum_k b[k] * e[k] + 1e-30, e a row of exp_et in shared memory.
template <int KT>
__device__ __forceinline__ float phinorm(const float (&b)[KT], const float* e) {
  float q = 0.0f;
  if constexpr (KT % 4 == 0) {
    const float4* e4 = reinterpret_cast<const float4*>(e);
#pragma unroll
    for (int k4 = 0; k4 < KT / 4; ++k4) {
      const float4 x = e4[k4];
      q = fmaf(b[4 * k4], x.x, q);
      q = fmaf(b[4 * k4 + 1], x.y, q);
      q = fmaf(b[4 * k4 + 2], x.z, q);
      q = fmaf(b[4 * k4 + 3], x.w, q);
    }
  } else {
#pragma unroll
    for (int k = 0; k < KT; ++k) q = fmaf(b[k], e[k], q);
  }
  return q + 1e-30f;
}

// beta[:, w] into registers (zero past K).
template <int KT>
__device__ __forceinline__ void load_column(const float* __restrict__ expb, int W, int K,
                                            int w, float (&b)[KT]) {
#pragma unroll
  for (int k = 0; k < KT; ++k) b[k] = (k < K) ? __ldg(expb + (size_t)k * W + w) : 0.0f;
}

template <int KT, int BB>
__global__ void __launch_bounds__(kThreads, 2)
dense_fixed_point_kernel(const float* __restrict__ expb,       // [K, W]
                         const float* __restrict__ C,          // (d, w) at d*sd + w*sw
                         long long sd, long long sw,
                         const float* __restrict__ doc_mask,   // [B]
                         const float* __restrict__ gamma_in,   // [B, K]
                         const float* __restrict__ alpha_ptr,  // [1]
                         const int* __restrict__ stop_flag,    // [1] or null
                         int* __restrict__ executed,           // [1] or null
                         int warm, int W, int K, int var_max_iters, float var_tol,
                         float* __restrict__ gamma_out,        // [B, K]
                         float* __restrict__ em_out,           // [B, K] exp_et * mask
                         float* __restrict__ docll,            // [B]
                         float* __restrict__ ass,              // [B]
                         int32_t* __restrict__ iters_out) {    // [B / BB]
  if (oni::stopped(stop_flag)) return;
  oni::count_executed(executed);
  constexpr int N = BB * KT;
  __shared__ float s_red[kWarps * N];
  __shared__ __align__(16) float s_e[N];   // exp_et of the block's docs
  __shared__ float s_g[N];                 // gamma
  __shared__ float s_x[N];                 // per-iteration sums, then E[log theta]
  __shared__ float s_doc[BB];              // per-doc scalars
  __shared__ float s_scale[BB];            // 1 / (alpha + N_d / K)
  __shared__ float s_delta;

  const int tid = threadIdx.x;
  const long long d0 = (long long)blockIdx.x * BB;
  const float alpha = __ldg(alpha_ptr);
  const float kf = (float)K;
  const float* __restrict__ Cb = C + d0 * sd;

  // N_d: the doc's counts summed over W (integer counts: exact in any order).
  {
    float nd[BB];
#pragma unroll
    for (int j = 0; j < BB; ++j) nd[j] = 0.0f;
    for (int w = tid; w < W; w += kThreads) {
#pragma unroll
      for (int j = 0; j < BB; ++j) nd[j] += __ldg(Cb + j * sd + w * sw);
    }
    block_sum<BB>(nd, s_red, s_doc);
  }
  if (tid < BB) s_scale[tid] = 1.0f / (alpha + s_doc[tid] / kf);
  for (int i = tid; i < N; i += kThreads) {
    const int j = i / KT, k = i % KT;
    s_g[i] = (k < K) ? (warm ? gamma_in[(d0 + j) * K + k] : alpha + s_doc[j] / kf) : 0.0f;
  }
  __syncthreads();

  int it = 0;
  float delta = INFINITY, prev = INFINITY;
  for (;;) {
    // exp(E[log theta]) of the current gamma, into s_e.
    if (tid < BB) {
      float gsum = 0.0f;
      for (int k = 0; k < K; ++k) gsum += s_g[tid * KT + k];
      s_doc[tid] = digamma_pos(gsum);
    }
    __syncthreads();
    if (!oni::fp_continue(it, delta, prev, var_max_iters, var_tol)) break;
    for (int i = tid; i < N; i += kThreads) {
      const int k = i % KT;
      s_e[i] = (k < K) ? expf(digamma_pos(s_g[i]) - s_doc[i / KT]) : 0.0f;
    }
    __syncthreads();

    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.0f;
    for (int w = tid; w < W; w += kThreads) {
      float b[KT];
      load_column<KT>(expb, W, K, w, b);
#pragma unroll
      for (int j = 0; j < BB; ++j) {
        const float c = __ldg(Cb + j * sd + w * sw);
        const float r = c * newton_recip(phinorm<KT>(b, s_e + j * KT));
#pragma unroll
        for (int k = 0; k < KT; ++k) acc[j * KT + k] = fmaf(r, b[k], acc[j * KT + k]);
      }
    }
    block_sum<N>(acc, s_red, s_x);

    // gamma update; s_x becomes |gamma_new - gamma|.
    for (int i = tid; i < N; i += kThreads) {
      if (i % KT < K) {
        const float gn = alpha + s_e[i] * s_x[i];
        s_x[i] = fabsf(gn - s_g[i]);
        s_g[i] = gn;
      }
    }
    __syncthreads();
    if (tid == 0) {
      float bmax = 0.0f;
      for (int j = 0; j < BB; ++j) {
        float dsum = 0.0f;
        for (int k = 0; k < K; ++k) dsum += s_x[j * KT + k];
        bmax = fmaxf(bmax, (dsum / kf) * s_scale[j] * doc_mask[d0 + j]);
      }
      s_delta = bmax;
    }
    __syncthreads();
    prev = delta;
    delta = s_delta;
    ++it;
  }

  // Converged tail.  s_doc holds digamma(sum gamma) of the final gamma.
  for (int i = tid; i < N; i += kThreads) {
    const int k = i % KT;
    const float el = (k < K) ? digamma_pos(s_g[i]) - s_doc[i / KT] : 0.0f;
    s_x[i] = el;
    s_e[i] = (k < K) ? expf(el) : 0.0f;
  }
  __syncthreads();
  {
    // The token term sum_w C log q (cells with C = 0 add exactly zero).
    float tok[BB];
#pragma unroll
    for (int j = 0; j < BB; ++j) tok[j] = 0.0f;
    for (int w = tid; w < W; w += kThreads) {
      float b[KT];
      bool loaded = false;
#pragma unroll
      for (int j = 0; j < BB; ++j) {
        const float c = __ldg(Cb + j * sd + w * sw);
        if (c != 0.0f) {
          if (!loaded) {
            load_column<KT>(expb, W, K, w, b);
            loaded = true;
          }
          tok[j] = fmaf(c, logf(phinorm<KT>(b, s_e + j * KT)), tok[j]);
        }
      }
    }
    block_sum<BB>(tok, s_red, s_doc);
  }
  if (tid < BB) {
    const long long d = d0 + tid;
    const float m = doc_mask[d];
    float gsum = 0.0f, core = 0.0f, as = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float g = s_g[tid * KT + k], el = s_x[tid * KT + k];
      gsum += g;
      core += (alpha - g) * el + gammaln_pos(g);
      as += el;
    }
    core -= gammaln_pos(gsum);
    docll[d] = (core + s_doc[tid]) * m;
    ass[d] = as * m;
  }
  for (int i = tid; i < N; i += kThreads) {
    const int j = i / KT, k = i % KT;
    if (k < K) {
      gamma_out[(d0 + j) * K + k] = s_g[i];
      em_out[(d0 + j) * K + k] = s_e[i] * doc_mask[d0 + j];
    }
  }
  if (tid == 0) iters_out[blockIdx.x] = it;
}

// T[k, w] = sum_d em[d, k] * C[d, w] / q[d, w] over the unmasked documents,
// with em = exp_et * mask from the fixed-point kernel.  A CTA owns 32
// columns; warp i walks documents [i * per, (i + 1) * per) in order.
template <int KT>
__global__ void __launch_bounds__(kThreads)
dense_suffstats_kernel(const float* __restrict__ expb,       // [K, W]
                       const float* __restrict__ C, long long sd, long long sw,
                       const float* __restrict__ doc_mask,   // [B]
                       const float* __restrict__ em,         // [B, K]
                       const int* __restrict__ stop_flag,    // [1] or null
                       int B, int W, int K,
                       float* __restrict__ T) {              // [K, W]
  if (oni::stopped(stop_flag)) return;
  __shared__ float s_part[kWarps][KT][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w = blockIdx.x * 32 + lane;
  const bool col = w < W;
  float b[KT], acc[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    b[k] = (col && k < K) ? __ldg(expb + (size_t)k * W + w) : 0.0f;
    acc[k] = 0.0f;
  }
  const int per = (B + kWarps - 1) / kWarps;
  const int lo = warp * per, hi = min(B, lo + per);
  for (int d = lo; d < hi; ++d) {
    if (__ldg(doc_mask + d) == 0.0f) continue;  // the same for every lane
    const float c = col ? __ldg(C + d * sd + w * sw) : 0.0f;
    if (c != 0.0f) {
      float e[KT];
#pragma unroll
      for (int k = 0; k < KT; ++k) e[k] = (k < K) ? __ldg(em + (size_t)d * K + k) : 0.0f;
      float q = 0.0f;
#pragma unroll
      for (int k = 0; k < KT; ++k) q = fmaf(b[k], e[k], q);
      const float r = c * newton_recip(q + 1e-30f);
#pragma unroll
      for (int k = 0; k < KT; ++k) acc[k] = fmaf(e[k], r, acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < KT; ++k) s_part[warp][k][lane] = acc[k];
  __syncthreads();
  for (int i = threadIdx.x; i < KT * 32; i += kThreads) {
    const int k = i / 32, l = i % 32;
    const int ww = blockIdx.x * 32 + l;
    if (k < K && ww < W) {
      float t = 0.0f;
#pragma unroll
      for (int p = 0; p < kWarps; ++p) t += s_part[p][k][l];
      T[(size_t)k * W + ww] = t;
    }
  }
}

template <int KT, int BB>
cudaError_t launch(cudaStream_t s, const float* expb, const float* C, long long sd,
                   long long sw, const float* doc_mask, const float* gamma_in,
                   const float* alpha, const int* stop_flag, int* executed, int warm, int B,
                   int W, int K, int var_max_iters, float var_tol, float* gamma_out,
                   float* em, float* docll, float* ass, int32_t* iters, float* T) {
  dense_fixed_point_kernel<KT, BB><<<B / BB, kThreads, 0, s>>>(
      expb, C, sd, sw, doc_mask, gamma_in, alpha, stop_flag, executed, warm, W, K,
      var_max_iters, var_tol, gamma_out, em, docll, ass, iters);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dense_suffstats_kernel<KT><<<(W + 31) / 32, kThreads, 0, s>>>(
      expb, C, sd, sw, doc_mask, em, stop_flag, B, W, K, T);
  return cudaGetLastError();
}

template <int KT>
cudaError_t launch_bb(int bb, cudaStream_t s, const float* expb, const float* C,
                      long long sd, long long sw, const float* doc_mask,
                      const float* gamma_in, const float* alpha, const int* stop_flag,
                      int* executed, int warm, int B, int W, int K, int var_max_iters,
                      float var_tol, float* gamma_out, float* em, float* docll,
                      float* ass, int32_t* iters, float* T) {
#define ONI_LAUNCH(BB)                                                                  \
  return launch<KT, BB>(s, expb, C, sd, sw, doc_mask, gamma_in, alpha, stop_flag,      \
                        executed, warm, B, W, K, var_max_iters, var_tol, gamma_out, em, \
                        docll, ass, iters, T)
  if (bb == 1) ONI_LAUNCH(1);
  if (bb == 2) ONI_LAUNCH(2);
  if constexpr (KT <= 20) {
    if (bb == 4) ONI_LAUNCH(4);
  }
#undef ONI_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int oni_dense_estep(const float* expb, const float* C, long long stride_d,
                               long long stride_w, const float* doc_mask,
                               const float* gamma_in, const float* alpha,
                               const int* stop_flag, int* executed, int warm, int B,
                               int W, int K,
                               int block_docs, int var_max_iters, float var_tol,
                               float* gamma_out, float* em, float* docll, float* ass,
                               int32_t* iters, float* T, void* stream) {
  if (B <= 0 || W <= 0 || K <= 0 || block_docs <= 0 || B % block_docs != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define ONI_LAUNCH(KT)                                                                   \
  return (int)launch_bb<KT>(block_docs, s, expb, C, stride_d, stride_w, doc_mask,       \
                            gamma_in, alpha, stop_flag, executed, warm, B, W, K,        \
                            var_max_iters, var_tol, gamma_out, em, docll, ass, iters, T)
  if (K <= 4) ONI_LAUNCH(4);
  if (K <= 8) ONI_LAUNCH(8);
  if (K <= 16) ONI_LAUNCH(16);
  if (K <= 20) ONI_LAUNCH(20);
  if (K <= 32) ONI_LAUNCH(32);
#undef ONI_LAUNCH
  return (int)cudaErrorInvalidValue;
}
