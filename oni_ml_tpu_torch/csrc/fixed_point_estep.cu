// Variational gamma fixed point for LDA over a gathered beta slab,
// hand-written for Hopper (sm_90a).
//
// Replaces: oni_ml_tpu/ops/pallas_estep.py::_fixed_point_kernel, the Pallas
// TPU kernel that pallas_estep.fixed_point launches through pl.pallas_call.
// Same function: per block of documents, from the fresh start
// alpha + N_d/K or from gamma_in,
//
//     exp_et   = exp(digamma(gamma) - digamma(sum_k gamma))
//     phinorm  = sum_k slab[k, d, l] * exp_et[k]
//     ratio    = c[d, l] * recip(phinorm + 1e-30)
//     gamma'   = alpha + exp_et * sum_l ratio * slab[k, d, l]
//
// iterated until the block's max over documents of
// mean_k |gamma' - gamma| / (alpha + N_d/K) * mask says stop under the
// shared rule (ops/stop.py).  Only gamma and the iteration count per block
// come out: phi, the [V, K] scatter and the ELBO are the caller's
// (ops/pallas_estep.py e_step).
//
// What bounds it on this card.  Per launch the function must read the slab
// once (4*K*B*L bytes, 10.5 MB at the flow day's B = 1024, L = 128,
// K = 20), the counts, the mask and gamma_in, and write gamma and the
// counts of iterations.  It needs 4*K flops per live token and fixed-point
// iteration (the two K-contractions) plus K + 1 digammas per document and
// iteration.  At ~50 iterations of ~95 live tokens per document that is
// ~0.4 GFLOP, ~6 us at the 67 TFLOP/s f32 peak, against ~3 us for the
// bytes: operations bound it.  As in the sparse kernel, each iteration is
// a chain of dependent steps that ends in a block-wide stop decision, so
// the kernel is latency-bound well above that floor.
//
// Design, against the TPU kernel:
//  * The TPU kernel holds a [K, BB, L] slab block in VMEM for the whole
//    loop (the doc block sized by a VMEM model, up to 128 documents).  Here
//    nothing is sized by L: the slab stays in device memory and, at the
//    flow day's shapes, in the 50 MB L2 across the iterations, so any
//    bucket length runs (a scanner IP's document of thousands of tokens
//    takes a block of one).  The launch fails only where K exceeds the
//    compiled bound (64) or the grid's size limits.
//  * One warp per document, `block_docs` <= 8 documents per CTA (the doc
//    block is the wrapper's pick for the card's 132 SMs).  The lanes
//    stride over the document's live tokens (padding past the last
//    non-zero count is skipped, exact since its count is 0); for topic k a
//    warp reads 32 neighbouring tokens of slab row (k, d), one coalesced
//    load.  Each lane keeps one token's K slab values in registers for both
//    contractions of an iteration.
//  * gamma and the per-topic sums live in registers (K <= 64, compile-time
//    bound KT); sums are warp all-reduced with xor shuffles, digamma runs
//    lane-parallel (lane k owns topic k) and is broadcast with shuffles.
//  * The stop rule is the TPU kernel's: the documents of a CTA iterate
//    until the CTA's max relative delta says stop (a reduction through
//    shared memory and one __syncthreads per iteration).
//  * The TPU's approximate reciprocal + one Newton step becomes
//    rcp.approx.ftz.f32 + one Newton step (estep_common.cuh).
//  * Under the chunk driver (models/fused.py) the launch reads the driver's
//    device stop flag and returns at once once it is set (gamma and iters
//    then hold no values; the driver discards them); a launch that runs
//    past the check adds one to the wrapper's device counter `executed`.

#include <stdint.h>

#include "estep_common.cuh"

namespace {

using oni::digamma_pos;
using oni::kFull;
using oni::newton_recip;
using oni::warp_sum;

constexpr int kMaxBlockDocs = 8;  // 256 threads per CTA

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// e[k] = exp(digamma(gam[k]) - digamma(sum gam)), lane-parallel over topics.
template <int KT>
__device__ __forceinline__ void exp_e_log_theta(const float (&gam)[KT], int K, int lane,
                                                float (&e)[KT]) {
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
    const float v = expf(digamma_pos(mine) - dg_sum);
#pragma unroll
    for (int k = base; k < KT && k < base + 32; ++k)
      e[k] = (k < K) ? __shfl_sync(kFull, v, k - base) : 0.0f;
  }
}

template <int KT>
__global__ void __launch_bounds__(32 * kMaxBlockDocs)
fixed_point_kernel(const float* __restrict__ slab,      // [K, B, L]
                   const float* __restrict__ counts,    // [B, L]
                   const float* __restrict__ doc_mask,  // [B]
                   const float* __restrict__ gamma_in,  // [B, K]
                   const float* __restrict__ alpha_ptr, // [1]
                   const int* __restrict__ stop_flag,   // [1] or null
                   int* __restrict__ executed,          // [1] or null
                   int warm, int B, int L, int K, int var_max_iters, float var_tol,
                   float* __restrict__ gamma_out,       // [B, K]
                   int32_t* __restrict__ iters_out) {   // [B / block_docs]
  if (oni::stopped(stop_flag)) return;
  oni::count_executed(executed);
  __shared__ float s_delta[2][kMaxBlockDocs];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long doc = (long long)blockIdx.x * nwarps + warp;
  const float* __restrict__ c = counts + doc * L;
  // Slab row (k, doc) starts at (k * B + doc) * L.
  const float* __restrict__ s = slab + doc * L;
  const size_t ks = (size_t)B * L;
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
  const float mean0 = alpha + nd / kf;  // the fresh start and the delta scale
  const float inv_scale = 1.0f / mean0;

  float gam[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k)
    gam[k] = (k < K) ? (warm ? gamma_in[doc * K + k] : mean0) : 0.0f;

  float e[KT], b[KT], acc[KT];
  float delta = INFINITY, prev = INFINITY;
  int it = 0;
  while (oni::fp_continue(it, delta, prev, var_max_iters, var_tol)) {
    exp_e_log_theta<KT>(gam, K, lane, e);
#pragma unroll
    for (int k = 0; k < KT; ++k) acc[k] = 0.0f;
    for (int l = lane; l < n_live; l += 32) {
      float ph = 0.0f;
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        b[k] = (k < K) ? __ldg(s + k * ks + l) : 0.0f;
        ph = fmaf(b[k], e[k], ph);
      }
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

#pragma unroll
  for (int k = 0; k < KT; ++k)
    if (k < K && lane == (k & 31)) gamma_out[doc * K + k] = gam[k];
  if (threadIdx.x == 0) iters_out[blockIdx.x] = it;
}

template <int KT>
cudaError_t launch(dim3 grid, dim3 block, cudaStream_t stream, const float* slab,
                   const float* counts, const float* doc_mask, const float* gamma_in,
                   const float* alpha, const int* stop_flag, int* executed, int warm,
                   int B, int L, int K, int var_max_iters, float var_tol,
                   float* gamma_out, int32_t* iters) {
  fixed_point_kernel<KT><<<grid, block, 0, stream>>>(
      slab, counts, doc_mask, gamma_in, alpha, stop_flag, executed, warm, B, L, K,
      var_max_iters, var_tol, gamma_out, iters);
  return cudaGetLastError();
}

}  // namespace

extern "C" int oni_fixed_point_estep(const float* slab, const float* counts,
                                     const float* doc_mask, const float* gamma_in,
                                     const float* alpha, const int* stop_flag,
                                     int* executed, int warm, int B, int L, int K,
                                     int block_docs, int var_max_iters, float var_tol,
                                     float* gamma_out, int32_t* iters, void* stream) {
  if (B <= 0 || L <= 0 || K <= 0 || block_docs <= 0 || block_docs > kMaxBlockDocs ||
      B % block_docs != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B / block_docs), block(32 * block_docs);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define ONI_LAUNCH(KT)                                                                 \
  return (int)launch<KT>(grid, block, s, slab, counts, doc_mask, gamma_in, alpha,    \
                         stop_flag, executed, warm, B, L, K, var_max_iters, var_tol, \
                         gamma_out, iters)
  if (K <= 4) ONI_LAUNCH(4);
  if (K <= 8) ONI_LAUNCH(8);
  if (K <= 16) ONI_LAUNCH(16);
  if (K <= 20) ONI_LAUNCH(20);
  if (K <= 32) ONI_LAUNCH(32);
  if (K <= 64) ONI_LAUNCH(64);
#undef ONI_LAUNCH
  return (int)cudaErrorInvalidValue;
}
