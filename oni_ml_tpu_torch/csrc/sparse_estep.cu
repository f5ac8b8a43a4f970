// Fused sparse variational E-step for LDA, hand-written for Hopper (sm_90a).
//
// Replaces: oni_ml_tpu/ops/sparse_estep.py::_sparse_kernel, the Pallas TPU
// kernel that fixed_point_full launches through pl.pallas_call.  Same
// function: per block of documents, the gamma fixed point under the shared
// stop rule (ops/stop.py), then the converged tail -- phi-weighted counts
// phi_c, the per-doc ELBO (token term + Dirichlet terms) and
// sum_k E[log theta].
//
// What bounds it on this card.  Per EM iteration the kernel must read the
// corpus tile (word ids + counts, 8*B*L bytes), the beta table (V*K*4) and
// gamma_in, and write phi_c (4*B*L*K -- the dominant term), gamma, docll and
// ass.  It does 4*B*K*L*(vi+1) float32 operations (two K-contractions per
// variational iteration plus the tail, sparse_estep.py:472-480).  At the
// flow day's shape (B=1024, L=128, K=20, vi ~ 10) that is ~11 MB against
// ~0.1 GFLOP: bytes bound it (3.35 TB/s vs 67 TFLOP/s f32), at a few
// microseconds.  In practice the fixed point is a chain of dependent
// iterations per document, each ending in a block-wide stop decision, so
// the kernel is latency-bound well above that floor.
//
// Design, against the TPU kernel:
//  * The TPU kernel gathers a [K, BB, L] slab of exp(log beta) into VMEM.
//    Here no slab is materialised: every token's K beta values are read
//    from an exp(log beta)^T [V, K] table (440 KB at V=5,520, K=20), which
//    stays resident in L2/L1, so device-memory traffic is the corpus tile
//    and phi_c only.  Nothing is sized by L, so any bucket length works
//    (a scanner IP's document can be tens of thousands of tokens).
//  * One warp per document, `block_docs` documents per CTA.  The lanes
//    stride over the document's live tokens (the packed layout puts them
//    first; padding past the last non-zero count is skipped, which is
//    exact because its count is 0).  Each lane keeps one token's K beta
//    values in registers for both contractions of an iteration.
//  * gamma, E[log theta] and the per-topic sums live in registers
//    (K <= 64, a compile-time bound KT).  Per-topic sums are warp
//    all-reduced with xor shuffles; digamma runs lane-parallel (lane k
//    owns topic k) and is broadcast back with shuffles.
//  * The stop rule is the TPU kernel's: every document of a CTA iterates
//    until the CTA's max relative delta says stop (a block reduction
//    through shared memory and one __syncthreads per iteration), so
//    converged documents keep iterating with their block, as in Pallas.
//  * The TPU's approximate reciprocal + one Newton step becomes
//    rcp.approx.ftz.f32 + one Newton step.
//  * phi_c is written in [B, L, K] order (token-major), the layout the
//    [V, K] index_add_ scatter wants; the wrapper returns the JAX [K, B, L]
//    view of it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kStallGate = 1e-2f;  // ops/stop.py STALL_GATE
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBlockDocs = 8;     // 256 threads per CTA

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// el[k] = digamma(gam[k]) - digamma(sum gam), lane-parallel over topics.
template <int KT>
__device__ __forceinline__ void e_log_theta(const float (&gam)[KT], int K, int lane,
                                            float (&el)[KT]) {
  float gsum = 0.0f;
#pragma unroll
  for (int k = 0; k < KT; ++k)
    if (k < K) gsum += gam[k];
  const float dg_sum = digamma_pos(gsum);
#pragma unroll
  for (int base = 0; base < KT; base += 32) {
    float mine = 1.0f;
#pragma unroll
    for (int k = base; k < KT && k < base + 32; ++k)
      if (k < K && lane == k - base) mine = gam[k];
    const float v = digamma_pos(mine) - dg_sum;
#pragma unroll
    for (int k = base; k < KT && k < base + 32; ++k)
      el[k] = (k < K) ? __shfl_sync(kFull, v, k - base) : 0.0f;
  }
}

// One token's K beta values from the [V, K] table; 16-byte loads when the
// row is exactly KT wide and KT is a multiple of 4.
template <int KT>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int K,
                                         float (&b)[KT]) {
  if constexpr (KT % 4 == 0) {
    if (K == KT) {
      const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
      for (int q = 0; q < KT / 4; ++q) {
        const float4 v = __ldg(r4 + q);
        b[4 * q] = v.x;
        b[4 * q + 1] = v.y;
        b[4 * q + 2] = v.z;
        b[4 * q + 3] = v.w;
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < KT; ++k) b[k] = (k < K) ? __ldg(row + k) : 0.0f;
}

template <int KT>
__global__ void __launch_bounds__(32 * kMaxBlockDocs)
sparse_estep_kernel(const float* __restrict__ expb_vk,    // [V, K]
                    const int32_t* __restrict__ word_idx, // [B, L]
                    const float* __restrict__ counts,     // [B, L]
                    const float* __restrict__ doc_mask,   // [B]
                    const float* __restrict__ gamma_in,   // [B, K]
                    const float* __restrict__ alpha_ptr,  // [1]
                    int warm, int L, int K, int var_max_iters, float var_tol,
                    float* __restrict__ gamma_out,        // [B, K]
                    float* __restrict__ phic,             // [B, L, K]
                    float* __restrict__ docll,            // [B]
                    float* __restrict__ ass,              // [B]
                    int32_t* __restrict__ iters_out) {    // [B / block_docs]
  __shared__ float s_delta[2][kMaxBlockDocs];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long doc = (long long)blockIdx.x * nwarps + warp;
  const int32_t* __restrict__ w = word_idx + doc * L;
  const float* __restrict__ c = counts + doc * L;
  const float alpha = __ldg(alpha_ptr);
  const float m = doc_mask[doc];
  const float kf = (float)K;

  // N_d and the live-token bound (1 + last non-zero count).
  float nd = 0.0f;
  int last = -1;
  for (int l = lane; l < L; l += 32) {
    const float cv = c[l];
    nd += cv;
    if (cv != 0.0f) last = l;
  }
  nd = warp_sum(nd);
  const int n_live = warp_max(last) + 1;
  const float mean0 = alpha + nd / kf;  // the fresh init and the delta scale
  const float inv_scale = 1.0f / mean0;

  float gam[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k)
    gam[k] = (k < K) ? (warm ? gamma_in[doc * K + k] : mean0) : 0.0f;

  float e[KT], b[KT], acc[KT];
  float delta = INFINITY, prev = INFINITY;
  int it = 0;
  while (it < var_max_iters &&
         (it == 0 || (delta > var_tol && (delta >= kStallGate || delta < prev)))) {
    e_log_theta<KT>(gam, K, lane, e);
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      e[k] = (k < K) ? expf(e[k]) : 0.0f;
      acc[k] = 0.0f;
    }
    for (int l = lane; l < n_live; l += 32) {
      load_row<KT>(expb_vk + (size_t)w[l] * K, K, b);
      float ph = 0.0f;
#pragma unroll
      for (int k = 0; k < KT; ++k) ph = fmaf(b[k], e[k], ph);
      const float r = c[l] * newton_recip(ph + 1e-30f);
#pragma unroll
      for (int k = 0; k < KT; ++k) acc[k] = fmaf(r, b[k], acc[k]);
    }
    float dsum = 0.0f;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      if (k < K) {
        const float gn = alpha + e[k] * warp_sum(acc[k]);
        dsum += fabsf(gn - gam[k]);
        gam[k] = gn;
      }
    }
    if (lane == 0) s_delta[it & 1][warp] = (dsum / kf) * inv_scale * m;
    __syncthreads();
    float bmax = s_delta[it & 1][0];
    for (int j = 1; j < nwarps; ++j) bmax = fmaxf(bmax, s_delta[it & 1][j]);
    prev = delta;
    delta = bmax;
    ++it;
  }

  // Converged tail: phi_c, the ELBO terms and sum_k E[log theta].
  float el[KT];
  e_log_theta<KT>(gam, K, lane, el);
#pragma unroll
  for (int k = 0; k < KT; ++k) e[k] = (k < K) ? expf(el[k]) : 0.0f;
  float* __restrict__ out = phic + (size_t)doc * L * K;
  float tok = 0.0f;
  for (int l = lane; l < n_live; l += 32) {
    const float cv = c[l];
    load_row<KT>(expb_vk + (size_t)w[l] * K, K, b);
    float ph = 0.0f;
#pragma unroll
    for (int k = 0; k < KT; ++k) ph = fmaf(b[k], e[k], ph);
    ph += 1e-30f;
    const float r = cv * newton_recip(ph) * m;
    tok += cv * logf(ph);
    float* __restrict__ o = out + (size_t)l * K;
#pragma unroll
    for (int k = 0; k < KT; ++k)
      if (k < K) o[k] = b[k] * (r * e[k]);
  }
  for (size_t i = (size_t)n_live * K + lane; i < (size_t)L * K; i += 32) out[i] = 0.0f;
  tok = warp_sum(tok);

  float gsum = 0.0f, as = 0.0f;
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    if (k < K) {
      gsum += gam[k];
      as += el[k];
    }
  }
  float core = 0.0f;
#pragma unroll
  for (int base = 0; base < KT; base += 32) {
    float gk = 1.0f, ek = 0.0f;
    bool own = false;
#pragma unroll
    for (int k = base; k < KT && k < base + 32; ++k) {
      if (k < K && lane == k - base) {
        gk = gam[k];
        ek = el[k];
        own = true;
      }
    }
    const float term = (alpha - gk) * ek + gammaln_pos(gk);
    core += warp_sum(own ? term : 0.0f);
  }
  core -= gammaln_pos(gsum);
  if (lane == 0) {
    docll[doc] = (core + tok) * m;
    ass[doc] = as * m;
  }
#pragma unroll
  for (int k = 0; k < KT; ++k)
    if (k < K && lane == (k & 31)) gamma_out[doc * K + k] = gam[k];
  if (threadIdx.x == 0) iters_out[blockIdx.x] = it;
}

template <int KT>
cudaError_t launch(dim3 grid, dim3 block, cudaStream_t stream, const float* expb_vk,
                   const int32_t* word_idx, const float* counts, const float* doc_mask,
                   const float* gamma_in, const float* alpha, int warm, int L, int K,
                   int var_max_iters, float var_tol, float* gamma_out, float* phic,
                   float* docll, float* ass, int32_t* iters) {
  sparse_estep_kernel<KT><<<grid, block, 0, stream>>>(
      expb_vk, word_idx, counts, doc_mask, gamma_in, alpha, warm, L, K, var_max_iters,
      var_tol, gamma_out, phic, docll, ass, iters);
  return cudaGetLastError();
}

}  // namespace

extern "C" int oni_sparse_estep(const float* expb_vk, const int32_t* word_idx,
                                const float* counts, const float* doc_mask,
                                const float* gamma_in, const float* alpha, int warm, int B,
                                int L, int K, int block_docs, int var_max_iters,
                                float var_tol, float* gamma_out, float* phic, float* docll,
                                float* ass, int32_t* iters, void* stream) {
  if (B <= 0 || L <= 0 || K <= 0 || block_docs <= 0 || block_docs > kMaxBlockDocs ||
      B % block_docs != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B / block_docs), block(32 * block_docs);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define ONI_LAUNCH(KT)                                                                   \
  return (int)launch<KT>(grid, block, s, expb_vk, word_idx, counts, doc_mask, gamma_in, \
                         alpha, warm, L, K, var_max_iters, var_tol, gamma_out, phic,   \
                         docll, ass, iters)
  if (K <= 4) ONI_LAUNCH(4);
  if (K <= 8) ONI_LAUNCH(8);
  if (K <= 16) ONI_LAUNCH(16);
  if (K <= 20) ONI_LAUNCH(20);
  if (K <= 32) ONI_LAUNCH(32);
  if (K <= 64) ONI_LAUNCH(64);
#undef ONI_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* oni_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
