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
// ~0.46 GFLOP, ~7 us at the 67 TFLOP/s f32 peak, against ~3 us for the
// bytes: operations bound it.  Each iteration is a chain of dependent
// steps that ends in a block-wide stop decision, so the kernel is
// latency-bound above that floor: what it can do is keep every step's
// loads in shared memory and spread a document over enough lanes.
//
// Design, against the TPU kernel:
//  * Staging.  The TPU kernel holds a [K, BB, L] slab block in VMEM for
//    the whole loop.  Here each CTA copies its documents' live slab tile
//    (K rows of its live tokens) and counts into shared memory once, with
//    cp.async, and every iteration reads shared memory only (in device
//    memory a token's K values sit in K rows B*L*4 bytes apart, a chain
//    of scattered L2 loads per iteration).  At B = 1024, L = 128, K = 20 a CTA of 4
//    documents stages 43 KB.  Where a tile cannot fit (a document longer
//    than 8 CTAs' shared memory) the launch reads the slab from device
//    memory as before (`staged` = 0); nothing is sized by L.
//  * Long documents.  A document's live tokens are split over `wpd` warps
//    of its CTA (token i to warp i / 32 % wpd); the per-topic sums are
//    all-reduced in each warp and then summed over the warps in warp order
//    through shared memory (estep_common.cuh doc_sums).  Where one SM's
//    shared memory cannot hold a document's slab, or a batch has too few
//    documents to fill the SMs, a thread-block cluster of `cluster` CTAs
//    (2-8) takes one document: CTA rank r stages its share of the live
//    tokens, and the CTAs' partial sums are added through distributed
//    shared memory, in rank order, after one cluster barrier per
//    iteration.  Every CTA of the cluster then holds the same sums and
//    gamma, so all make the same stop decision.  B = 8, L = 4,096 runs on
//    64 SMs instead of 8.
//  * The launch geometry (docs per CTA, warps per doc, cluster, tile and
//    shared memory) comes from ops/pallas_estep.py launch_geometry; the doc
//    block, which defines the stop groups, is the wrapper's pick_block.
//  * The per-document loop (q, the s contraction, the gamma update, the
//    reductions) is estep_common.cuh's, shared with dense_estep.cu.
//  * gamma is lane-parallel in registers (lane k owns topic k; K <= 64,
//    compile-time bound KT); a warp's per-topic sums are transposed onto
//    the lanes by halving exchanges, and only exp E[log theta] is
//    broadcast for the contractions.  Sums are taken in an order fixed by
//    the geometry, so gamma is the same bits on every run.
//  * The TPU's approximate reciprocal + one Newton step becomes
//    rcp.approx.ftz.f32 + one Newton step (estep_common.cuh).
//  * Under the chunk driver (models/fused.py) the launch reads the driver's
//    device stop flag and returns at once once it is set (gamma and iters
//    then hold no values; the driver discards them); a launch that runs
//    past the check adds one to the wrapper's device counter `executed`.

#include <cooperative_groups.h>
#include <stdint.h>

#include "estep_common.cuh"

namespace cg = cooperative_groups;

namespace {

using oni::kFull;

// The most threads a CTA has: ops/pallas_estep.py MAX_THREADS, the same
// number (tests/test_torch_pallas_estep.py holds them equal).  It sizes
// the static per-warp arrays, which ops/pallas_estep.py SMEM_STATIC
// reserves out of the slab tile's shared memory.
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 8;
// Preferred share of the SM's 228 KB for shared memory, the rest staying
// L1 (a hint: the driver rounds it up to a split the card supports, and
// takes a larger one where a CTA needs it).  With no preference the flow
// day's main shape (43 KB tiles, up to 5 CTAs an SM) ran 0.31-0.33 ms,
// at 86% the same, at 58% 0.245-0.251 ms, in turns on one H100 at 700 W
// (torch_kernel_sweep.py); the long and cluster cases did not move.  The
// likely reason: the driver otherwise takes the largest split, and the
// kernel's 128-byte stack frame per thread no longer fits in L1.
constexpr int kSharedCarveoutPercent = 58;

// The compiler's register cap, apart from the CTA size: __launch_bounds__
// as if for 512 threads where K <= 20 (the kernel never runs more than
// kMaxThreads).  On an H100 at 700 W, in turns on one card
// (torch_kernel_sweep.py), the flow day's main shape ran 0.245-0.255 ms
// under this bound against 0.31 ms under (256, 2).
template <int KT, bool STAGED>
__global__ void __launch_bounds__(KT <= 20 ? 512 : 256)
fixed_point_kernel(const float* __restrict__ slab,      // [K, B, L]
                   const float* __restrict__ counts,    // [B, L]
                   const float* __restrict__ doc_mask,  // [B]
                   const float* __restrict__ gamma_in,  // [B, K]
                   const float* __restrict__ alpha_ptr, // [1]
                   const int* __restrict__ stop_flag,   // [1] or null
                   int* __restrict__ executed,          // [1] or null
                   int warm, int B, int L, int K, int wpd, int csize, int tile_len,
                   int var_max_iters, float var_tol,
                   float* __restrict__ gamma_out,       // [B, K]
                   int32_t* __restrict__ iters_out) {   // [B / block_docs]
  if (oni::stopped(stop_flag)) return;
  oni::count_executed(executed);
  extern __shared__ __align__(16) float s_tile[];      // [docs][K + 1][tile_len]
  constexpr int NS = oni::NS<KT>;
  __shared__ float s_red[2][kMaxWarps * NS * 32];      // warps' per-topic sums
  __shared__ float s_cta[2][NS * 32];                  // the CTA's sums (cluster)
  __shared__ float s_delta[2][kMaxWarps];
  __shared__ float s_nd[kMaxWarps];
  __shared__ int s_last[kMaxWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int docs = (blockDim.x >> 5) / wpd;
  const int j = warp / wpd, p = warp % wpd;
  const int rank = blockIdx.x % csize;            // clusters run along x
  const int blk = blockIdx.x / csize;
  const long long doc = (long long)blk * docs + j;
  const float* __restrict__ c_row = counts + doc * L;
  const float alpha = __ldg(alpha_ptr);
  const float m = doc_mask[doc];
  const float kf = (float)K;

  // N_d and the live-token bound (1 + last non-zero count), over the
  // document's warps; integer counts sum exactly in any order.
  {
    float nd = 0.0f;
    int last = -1;
    for (int l = p * 32 + lane; l < L; l += 32 * wpd) {
      const float cv = c_row[l];
      nd += cv;
      if (cv != 0.0f) last = l;
    }
    nd = oni::warp_sum(nd);
    last = oni::warp_max(last);
    if (lane == 0) {
      s_nd[warp] = nd;
      s_last[warp] = last;
    }
  }
  __syncthreads();
  float nd = 0.0f;
  int n_live = 0;
  for (int q = 0; q < wpd; ++q) {
    nd += s_nd[j * wpd + q];
    n_live = max(n_live, s_last[j * wpd + q] + 1);
  }
  const float mean0 = alpha + nd / kf;  // the fresh start and the delta scale
  const float inv_scale = 1.0f / mean0;

  // This CTA's share of the live tokens: [lo, lo + n) (a multiple of 4
  // per rank, so rows stay 16-byte aligned where L allows).
  const int per = (((n_live + csize - 1) / csize) + 3) & ~3;
  const int lo = min(n_live, rank * per);
  const int n = min(n_live, lo + per) - lo;

  const float* b;
  const float* c;
  size_t ks;
  if constexpr (STAGED) {
    float* t = s_tile + (size_t)j * (K + 1) * tile_len;
    for (int row = p; row <= K; row += wpd) {
      const float* src = row < K ? slab + ((size_t)row * B + doc) * L + lo : c_row + lo;
      oni::stage_row(t + (size_t)row * tile_len, src, n, lane);
    }
    oni::cp_async_wait_all();
    __syncthreads();
    b = t;
    c = t + (size_t)K * tile_len;
    ks = tile_len;
  } else {
    b = slab + doc * L + lo;
    c = c_row + lo;
    ks = (size_t)B * L;
  }

  float gam[NS];  // lane-parallel: topic lane + 32 h
#pragma unroll
  for (int h = 0; h < NS; ++h) {
    const int k = lane + 32 * h;
    gam[h] = (k < K) ? (warm ? gamma_in[doc * K + k] : mean0) : 0.0f;
  }

  float e[KT], acc[KT], s[NS], el_mine[NS], e_mine[NS];
  float delta = INFINITY, prev = INFINITY;
  int it = 0;
  while (oni::fp_continue(it, delta, prev, var_max_iters, var_tol)) {
    const int buf = it & 1;
    oni::e_log_theta<KT>(gam, K, lane, el_mine, e_mine, e);
#pragma unroll
    for (int k = 0; k < KT; ++k) acc[k] = 0.0f;
    oni::accumulate_cells<KT>(b, ks, c, p * 32 + lane, n, 32 * wpd, e, K, acc);
    oni::warp_topic_sums<KT>(acc, lane, s);
    oni::doc_sums<KT>(s, s_red[buf], warp, j, wpd, lane);
    if (csize > 1) {
      // One document per cluster: add the CTAs' sums in rank order.
      cg::cluster_group cluster = cg::this_cluster();
      if (warp == 0) {
#pragma unroll
        for (int h = 0; h < NS; ++h) s_cta[buf][h * 32 + lane] = s[h];
      }
      cluster.sync();
#pragma unroll
      for (int h = 0; h < NS; ++h) {
        float t = 0.0f;
        for (int r = 0; r < csize; ++r)
          t += cluster.map_shared_rank(s_cta[buf], r)[h * 32 + lane];
        s[h] = t;
      }
    }
    const float dsum = oni::gamma_update<KT>(gam, e_mine, s, alpha, K, lane);
    const float d_doc = (dsum / kf) * inv_scale * m;
    float bmax = d_doc;
    if (docs > 1) {
      if (p == 0 && lane == 0) s_delta[buf][j] = d_doc;
      __syncthreads();
      bmax = s_delta[buf][0];
      for (int q = 1; q < docs; ++q) bmax = fmaxf(bmax, s_delta[buf][q]);
    }
    prev = delta;
    delta = bmax;
    ++it;
  }
  // No CTA leaves while another may still read its shared memory.
  if (csize > 1) cg::this_cluster().sync();

  if (rank == 0 && p == 0) {
#pragma unroll
    for (int h = 0; h < NS; ++h)
      if (lane + 32 * h < K) gamma_out[doc * K + lane + 32 * h] = gam[h];
  }
  if (rank == 0 && threadIdx.x == 0) iters_out[blk] = it;
}

template <int KT, bool STAGED>
cudaError_t launch(int nb, int docs, int wpd, int csize, int tile_len, size_t smem,
                   cudaStream_t stream, const float* slab, const float* counts,
                   const float* doc_mask, const float* gamma_in, const float* alpha,
                   const int* stop_flag, int* executed, int warm, int B, int L, int K,
                   int var_max_iters, float var_tol, float* gamma_out,
                   int32_t* iters) {
  auto kernel = fixed_point_kernel<KT, STAGED>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, kSharedCarveoutPercent);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nb * csize);
  cfg.blockDim = dim3(32 * docs * wpd);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (csize > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = csize;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, slab, counts, doc_mask, gamma_in, alpha,
                           stop_flag, executed, warm, B, L, K, wpd, csize, tile_len,
                           var_max_iters, var_tol, gamma_out, iters);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The launch geometry is the caller's (ops/pallas_estep.py
// launch_geometry): `block_docs` documents per CTA (the stop block),
// `warps_per_doc` warps each, `cluster` CTAs per document (then
// block_docs must be 1), and with `staged` a shared-memory tile of
// tile_len tokens per document and CTA.
extern "C" int oni_fixed_point_estep(const float* slab, const float* counts,
                                     const float* doc_mask, const float* gamma_in,
                                     const float* alpha, const int* stop_flag,
                                     int* executed, int warm, int B, int L, int K,
                                     int block_docs, int warps_per_doc, int cluster,
                                     int tile_len, int staged, int var_max_iters,
                                     float var_tol, float* gamma_out, int32_t* iters,
                                     void* stream) {
  const int threads = 32 * block_docs * warps_per_doc;
  if (B <= 0 || L <= 0 || K <= 0 || K > 64 || block_docs <= 0 || warps_per_doc <= 0 ||
      B % block_docs != 0 || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) || (cluster > 1 && block_docs != 1) ||
      threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      staged ? (size_t)block_docs * (K + 1) * (size_t)tile_len * sizeof(float) : 0;
  if (staged && (tile_len % 4 != 0 ||
                 (size_t)tile_len < (size_t)((((L + cluster - 1) / cluster) + 3) & ~3)))
    return (int)cudaErrorInvalidValue;
  const int nb = B / block_docs;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define ONI_LAUNCH(KT)                                                                \
  return (int)(staged ? launch<KT, true>(nb, block_docs, warps_per_doc, cluster,     \
                                         tile_len, smem, s, slab, counts, doc_mask,  \
                                         gamma_in, alpha, stop_flag, executed, warm, \
                                         B, L, K, var_max_iters, var_tol, gamma_out, \
                                         iters)                                      \
                      : launch<KT, false>(nb, block_docs, warps_per_doc, cluster,    \
                                          tile_len, 0, s, slab, counts, doc_mask,    \
                                          gamma_in, alpha, stop_flag, executed,      \
                                          warm, B, L, K, var_max_iters, var_tol,     \
                                          gamma_out, iters))
  if (K <= 4) ONI_LAUNCH(4);
  if (K <= 8) ONI_LAUNCH(8);
  if (K <= 16) ONI_LAUNCH(16);
  if (K <= 20) ONI_LAUNCH(20);
  if (K <= 32) ONI_LAUNCH(32);
  ONI_LAUNCH(64);
#undef ONI_LAUNCH
}
