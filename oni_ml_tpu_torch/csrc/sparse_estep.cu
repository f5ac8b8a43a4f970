// Fused sparse variational E-step for LDA, hand-written for Hopper (sm_90a).
//
// Replaces: oni_ml_tpu/ops/sparse_estep.py::_sparse_kernel, the Pallas TPU
// kernel that fixed_point_full launches through pl.pallas_call.  Same
// function: per block of documents, the gamma fixed point under the shared
// stop rule (ops/stop.py), then the converged tail -- phi-weighted counts
// phi_c, the per-doc ELBO (token term + Dirichlet terms) and
// sum_k E[log theta].
//
// What bounds it on this card.  Per launch the function must read the
// corpus tile (word ids + counts, 8*B*L bytes), the beta table (V*K*4) and
// gamma_in, and write phi_c (4*B*L*K -- the dominant term), gamma, docll and
// ass: ~11 MB at the flow day's B = 1024, L = 128, K = 20, ~3 us at
// 3.35 TB/s.  It needs 4*K flops per live token and fixed-point iteration
// (the two K-contractions) plus the tail: at ~50 iterations of ~95 live
// tokens per document ~0.43 GFLOP, 6.4 us at the 67 TFLOP/s f32 peak, so
// operations bound it (0.0064 ms, chip_smoke.py).  Each iteration is a
// chain of dependent steps that ends in a block-wide stop decision, so the
// kernel is latency-bound above that floor: what it can do is keep every
// step's loads in shared memory and spread a document over enough lanes.
//
// Design, against the TPU kernel and this kernel's first port:
//  * Staging.  The TPU kernel gathers a [K, BB, L] slab of exp(log beta)
//    into VMEM and keeps it for the whole loop.  The first port read each
//    live token's K values from the exp(log beta)^T [V, K] table (440 KB
//    at V = 5,520, K = 20: L2, not L1) on every iteration.  Here each CTA
//    gathers its documents' live tokens' rows of the table into a
//    shared-memory tile with cp.async, once per launch, beside their
//    counts; every fixed-point iteration and the tail then read shared
//    memory only.  The tile is [tile, K] rows (b[i * K + k]): where K is
//    a multiple of 4, 16-byte copies and 16-byte reads in the loop, which
//    are free of bank conflicts at K = 20; else 4-byte ones.  The fixed
//    point's [K, tile] layout (a transposing gather, a 4-byte copy per
//    value) ran the flow day's main shape slower, in turns on an H100 at
//    700 W: 0.281-0.289 ms against 0.263-0.269 for rows (PERF.md).
//    Where a tile cannot fit even over 8 CTAs (`staged` = 0) the rows are
//    read from the table in device memory, as the first port did, so any
//    L runs.
//  * Long documents.  As in fixed_point_estep.cu: a document's live tokens
//    over `wpd` warps of its CTA, and where one SM cannot hold its tile or
//    the batch leaves SMs idle, over a thread-block cluster of 2-8 CTAs,
//    rank r staging its share; sums over warps and ranks in a fixed order
//    (estep_common.cuh doc_sums, cluster_sums), so every CTA of a cluster
//    holds the same gamma and makes the same stop decision.  The launch
//    geometry is ops/pallas_estep.py's rule (ops/sparse_estep.py
//    launch_geometry): a token stages 4 * (K + 1) bytes in both kernels.
//  * The per-document loop is estep_common.cuh's core (e_log_theta,
//    accumulate_cells, warp_topic_sums, doc_sums, cluster_sums,
//    gamma_update): gamma lane-parallel in registers (K <= 64, compile-time
//    bound KT), the Pallas per-block stop (the block's max delta).
//  * The tail reads the tile too: token_term leaves each token's
//    c / q in the tile's count row; the cluster adds its token terms in
//    rank order; then phi_c, in [B, L, K] order (token-major, the layout
//    the [V, K] scatter wants; the wrapper returns the JAX [K, B, L] view),
//    is written coalesced, the lanes over the flattened (token, topic)
//    range of each CTA's tokens, and each CTA zeroes its share of the
//    padding.  An entry below the normal range is written as zero: XLA
//    flushes each per-token contribution before its segment-sum.
//  * The TPU's approximate reciprocal + one Newton step becomes
//    rcp.approx.ftz.f32 + one Newton step (estep_common.cuh).
//  * Under the chunk driver (models/fused.py) the launch reads the
//    driver's device stop flag and returns at once once it is set; a
//    launch that runs past that check adds one to the wrapper's device
//    counter `executed`.
//  * The bf16 storage mode (precision "bf16": the TPU kernel's bf16 slab)
//    is the instantiation TB = __nv_bfloat16: the wrapper rounds the
//    [V, K] table to bf16 once per EM iteration (ops/sparse_estep.py
//    exp_beta_table), which halves its bytes, and every read upcasts it
//    exactly, so the fixed point, phi_c and the token term all see the
//    rounded values while every product, sum and the gamma carry stay
//    f32.  The tile stays f32: a bf16 row of K = 20 is 40 bytes, no
//    multiple of cp.async's 16, so the rows are read with plain loads (8
//    bytes, four values, where K % 4 == 0 and the table is 8-byte
//    aligned; else 2 bytes) and stored upcast; the geometry is the f32
//    one.  TB = float is the code above, unchanged.  One library holds
//    one table type, chosen by ONI_TABLE_BF16 when this source is
//    compiled (ops/_cuda.py builds both libraries in parallel).
//
// The second kernel of this file, sparse_scatter_kernel, sums phi_c into
// [V, K] in a fixed order (see its note).

#include <cuda_bf16.h>
#include <stdint.h>

#include "estep_common.cuh"

namespace {

using oni::kFull;

// The most threads a CTA has and the largest cluster: ops/sparse_estep.py
// MAX_THREADS and MAX_CLUSTER (tests/test_torch_kernels.py reads them here).
// kMaxThreads sizes the static per-warp arrays, which
// ops/pallas_estep.py SMEM_STATIC reserves out of the tile's shared memory.
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 8;

// Word w's row of the table into bk and c * recip(q): f32 rows through
// the shared cell_ratio (rows `align` floats apart for the alignment test
// of the 16-byte reads: K where the table is 16-byte aligned, else 1);
// bf16 rows upcast value by value.
template <int KT>
__device__ __forceinline__ float table_ratio(const float* expb_vk, int32_t w, size_t align,
                                             float c, const float (&e)[KT], int K,
                                             float (&bk)[KT], float& q) {
  return oni::cell_ratio<KT, true>(expb_vk + (size_t)w * K, align, c, e, K, bk, q);
}

template <int KT>
__device__ __forceinline__ float table_ratio(const __nv_bfloat16* expb_vk, int32_t w,
                                             size_t, float c, const float (&e)[KT], int K,
                                             float (&bk)[KT], float& q) {
  const __nv_bfloat16* row = expb_vk + (size_t)w * K;
#pragma unroll
  for (int k = 0; k < KT; ++k) bk[k] = (k < K) ? __bfloat162float(row[k]) : 0.0f;
  return oni::ratio_of<KT>(bk, c, e, q);
}

// acc[k] += sum over this lane's tokens of ratio * b[k], each token's row
// read from the table.
template <int KT, typename TB>
__device__ __forceinline__ void accumulate_table(const TB* __restrict__ expb_vk,
                                                 size_t align, const int32_t* w,
                                                 const float* c, int lo, int hi, int step,
                                                 const float (&e)[KT], int K,
                                                 float (&acc)[KT]) {
  for (int i = lo; i < hi; i += step) {
    float bk[KT], q;
    const float r = table_ratio<KT>(expb_vk, w[i], align, c[i], e, K, bk, q);
#pragma unroll
    for (int k = 0; k < KT; ++k) acc[k] = fmaf(r, bk[k], acc[k]);
  }
}

// The compiler's register cap as for the fixed point (fixed_point_estep.cu):
// __launch_bounds__ as if for 512 threads where K <= 20.  In
// torch_kernel_sweep.py, in turns on an H100 at 700 W, (256, 2) ran the
// same and (256) up to 25% slower on long documents.  STAGED: the tokens'
// rows in a shared-memory tile, else read from the table on every pass.
// TB: the table's storage type (float, or __nv_bfloat16 in bf16 mode).
template <int KT, bool STAGED, typename TB>
__global__ void __launch_bounds__(KT <= 20 ? 512 : 256)
sparse_estep_kernel(const TB* __restrict__ expb_vk,       // [V, K]
                    const int32_t* __restrict__ word_idx, // [B, L]
                    const float* __restrict__ counts,     // [B, L]
                    const float* __restrict__ doc_mask,   // [B]
                    const float* __restrict__ gamma_in,   // [B, K]
                    const float* __restrict__ alpha_ptr,  // [1]
                    const int* __restrict__ stop_flag,    // [1] or null
                    int* __restrict__ executed,           // [1] or null
                    int warm, int L, int K, int wpd, int csize, int tile_len,
                    int var_max_iters, float var_tol,
                    float* __restrict__ gamma_out,        // [B, K]
                    float* __restrict__ phic,             // [B, L, K]
                    float* __restrict__ docll,            // [B]
                    float* __restrict__ ass,              // [B]
                    int32_t* __restrict__ iters_out) {    // [B / block_docs]
  if (oni::stopped(stop_flag)) return;
  oni::count_executed(executed);
  constexpr int NS = oni::NS<KT>;
  extern __shared__ __align__(16) float s_tile[];      // [docs][tile_len * (K + 1)]
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
  const int32_t* __restrict__ w_row = word_idx + doc * L;
  const float* __restrict__ c_row = counts + doc * L;
  const float alpha = __ldg(alpha_ptr);
  const float m = doc_mask[doc];
  const float kf = (float)K;
  const int first = p * 32 + lane, step = 32 * wpd;  // this lane's tokens

  // N_d and the live-token bound (1 + last non-zero count), over the
  // document's warps; integer counts sum exactly in any order.  The
  // packed layout puts the live tokens first: padding past the last
  // non-zero count adds nothing (its count is 0).
  {
    float nd = 0.0f;
    int last = -1;
    for (int l = first; l < L; l += step) {
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

  // The table's rows are K floats apart; 16-byte reads need it aligned.
  const size_t align = (reinterpret_cast<uintptr_t>(expb_vk) & 15) ? 1 : (size_t)K;
  float* b = nullptr;   // the tile's rows of beta values, K floats apart
  float* c = nullptr;   // its counts, then the tail's ratios
  if constexpr (STAGED) {
    b = s_tile + (size_t)j * (K + 1) * tile_len;
    c = b + (size_t)K * tile_len;
    if (p == 0) oni::stage_row(c, c_row + lo, n, lane);
    if constexpr (sizeof(TB) != sizeof(float)) {
      // bf16 rows, upcast into the f32 tile with plain loads.
      if ((reinterpret_cast<uintptr_t>(expb_vk) & 7) == 0 && (K & 3) == 0) {
        const int nq = K >> 2;
        for (int f = first; f < n * nq; f += step) {
          const int i = f / nq, h = f - i * nq;
          const uint2 raw = __ldg(reinterpret_cast<const uint2*>(
              expb_vk + (size_t)w_row[lo + i] * K + 4 * h));
          const float2 v01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
          const float2 v23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
          *reinterpret_cast<float4*>(b + (size_t)i * K + 4 * h) =
              make_float4(v01.x, v01.y, v23.x, v23.y);
        }
      } else {
        for (int f = first; f < n * K; f += step) {
          const int i = f / K, k = f - i * K;
          b[f] = __bfloat162float(expb_vk[(size_t)w_row[lo + i] * K + k]);
        }
      }
    } else if (align != 1 && (K & 3) == 0) {
      const int nq = K >> 2;
      for (int f = first; f < n * nq; f += step) {
        const int i = f / nq, h = f - i * nq;
        oni::cp_async16(b + (size_t)i * K + 4 * h,
                        expb_vk + (size_t)w_row[lo + i] * K + 4 * h);
      }
    } else {
      for (int f = first; f < n * K; f += step) {
        const int i = f / K, k = f - i * K;
        oni::cp_async4(b + f, expb_vk + (size_t)w_row[lo + i] * K + k);
      }
    }
    oni::cp_async_wait_all();
    __syncthreads();
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
    if constexpr (STAGED)
      oni::accumulate_cells<KT, true>(b, K, c, first, n, step, e, K, acc);
    else
      accumulate_table<KT, TB>(expb_vk, align, w_row + lo, c_row + lo, first, n, step, e, K,
                               acc);
    oni::warp_topic_sums<KT>(acc, lane, s);
    oni::doc_sums<KT>(s, s_red[buf], warp, j, wpd, lane);
    // One document per cluster: add the CTAs' sums in rank order.
    if (csize > 1) oni::cluster_sums<KT>(s, s_cta[buf], csize, warp, lane);
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

  // Converged tail: E[log theta], the token term sum c log q, phi_c, the
  // ELBO's Dirichlet terms and sum_k E[log theta].
  oni::e_log_theta<KT>(gam, K, lane, el_mine, e_mine, e);
  float* __restrict__ out = phic + (size_t)doc * L * K;
  float tok;
  if constexpr (!STAGED) {
    // Rows from the table: each lane writes its tokens' phi_c rows.
    tok = 0.0f;
    for (int i = first; i < n; i += step) {
      float bk[KT], q;
      const float cv = c_row[lo + i];
      const float r = table_ratio<KT>(expb_vk, w_row[lo + i], align, cv, e, K, bk, q);
      tok = fmaf(cv, logf(q), tok);
      const float rm = r * m;
      float* __restrict__ o = out + (size_t)(lo + i) * K;
#pragma unroll
      for (int k = 0; k < KT; ++k)
        if (k < K) o[k] = oni::flush_subnormal(bk[k] * (rm * e[k]));
    }
  } else {
    // The ratios c / q replace the counts in the tile.
    tok = oni::token_term<KT, true>(b, K, c, first, n, step, e, K, c);
  }
  tok = oni::doc_sum1(oni::warp_sum(tok), s_red[it & 1], warp, j, wpd, lane);
  if (csize > 1) tok = oni::cluster_sum1(tok, s_cta[it & 1], csize);
  if constexpr (STAGED) {
    __syncthreads();  // every ratio of the tile written
    // phi_c of this CTA's tokens, coalesced: lane f of the flattened
    // (token, topic) range writes element f; topic k's exp E[log theta]
    // comes from lane k % 32, slot k / 32.
    const int nf = n * K;
    float* __restrict__ o = out + (size_t)lo * K;
    for (int f0 = p * 32; f0 < nf; f0 += step) {
      const int f = f0 + lane;
      const int i = f / K, k = f - i * K;
      float ek = 0.0f;
#pragma unroll
      for (int h = 0; h < NS; ++h) {
        const float v = __shfl_sync(kFull, e_mine[h], k & 31);
        if ((k >> 5) == h) ek = v;
      }
      if (f < nf) o[f] = oni::flush_subnormal(b[f] * ((c[i] * m) * ek));
    }
  }
  {
    // This rank's share of the padding [n_live, L).
    const size_t pad0 = (size_t)n_live * K, pad = (size_t)L * K - pad0;
    const size_t share = (pad + csize - 1) / csize;
    const size_t a0 = (size_t)rank * share, a1 = a0 + share;
    const size_t z0 = pad0 + (a0 < pad ? a0 : pad), z1 = pad0 + (a1 < pad ? a1 : pad);
    for (size_t f = z0 + first; f < z1; f += step) out[f] = 0.0f;
  }
  if (p == 0) {
    float gsum = 0.0f, core = 0.0f, as = 0.0f;
#pragma unroll
    for (int h = 0; h < NS; ++h) {
      const int k = lane + 32 * h;
      if (k < K) {
        gsum += gam[h];
        core += (alpha - gam[h]) * el_mine[h] + oni::gammaln_pos(gam[h]);
        as += el_mine[h];
        if (rank == 0) gamma_out[doc * K + k] = gam[h];
      }
    }
    gsum = oni::warp_sum(gsum);
    core = oni::warp_sum(core) - oni::gammaln_pos(gsum);
    as = oni::warp_sum(as);
    if (rank == 0 && lane == 0) {
      docll[doc] = (core + tok) * m;
      ass[doc] = as * m;
    }
  }
  if (rank == 0 && threadIdx.x == 0) iters_out[blk] = it;
  oni::cluster_exit(csize);
}

// The [V, K] scatter of a batch's live tokens, without atomics: the
// tokens were sorted by (word, position) once at set-up
// (ops/sparse_estep.py live_tokens), so one warp per distinct word sums
// that word's phi_c rows in position order -- the order of a sequential
// index_add_, so the sums equal the CPU's bit for bit and do not vary
// from run to run.  Replaces the JAX package's segment-sum
// (oni_ml_tpu/ops/sparse_estep.py:424), which XLA runs outside the
// Pallas kernel.
//
// Bytes bound it (the live rows of phi_c, their positions, the [V, K]
// output), and the longest word's chain of dependent adds.  This design
// (the first port's) was measured against six others on an H100 at
// 700 W (torch_kernel_sweep.py, each batch's scatter right after its
// E-step, as in EM, in turns): a thread per (word, topic), so no lane
// idles at K = 20, loading 4-32 tokens ahead (double-buffered, chunked,
// and with the CTA's word ids in shared memory); the same with the CTA's
// rows staged in shared memory by cp.async; and one warp per word with
// the zero fill folded into the kernel, with and without loads ahead.
// Each ran the flow day's batches slower (9.0-11.8 us a launch against
// 7.7 for this kernel and the wrapper's fill), though the flattened ones
// ran chains of 1,024 adds up to 1.4x faster.  A warp's load here is one
// phi_c row; a flattened warp's straddles two words.
__global__ void __launch_bounds__(256)
sparse_scatter_kernel(const float* __restrict__ phic,          // [B * L, K]
                      const int32_t* __restrict__ sorted_pos,  // [n]
                      const int32_t* __restrict__ seg_ptr,     // [U + 1]
                      const int32_t* __restrict__ seg_word,    // [U]
                      const int* __restrict__ stop_flag,
                      int* __restrict__ executed, int U, int K,
                      float* __restrict__ out) {               // [V, K]
  if (oni::stopped(stop_flag)) return;
  oni::count_executed(executed);
  const int u = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (u >= U) return;
  const int lo = seg_ptr[u], hi = seg_ptr[u + 1];
  float* __restrict__ row = out + (size_t)seg_word[u] * K;
  for (int k = threadIdx.x & 31; k < K; k += 32) {
    float acc = 0.0f;
#pragma unroll 4
    for (int i = lo; i < hi; ++i) acc += __ldg(phic + (size_t)sorted_pos[i] * K + k);
    row[k] = acc;
  }
}

template <int KT, bool STAGED, typename TB>
cudaError_t launch(int nb, int docs, int wpd, int csize, int tile_len, size_t smem,
                   cudaStream_t stream, const TB* expb_vk,
                   const int32_t* word_idx, const float* counts, const float* doc_mask,
                   const float* gamma_in, const float* alpha, const int* stop_flag,
                   int* executed, int warm, int L, int K, int var_max_iters,
                   float var_tol, float* gamma_out, float* phic, float* docll, float* ass,
                   int32_t* iters) {
  return oni::launch_clustered(sparse_estep_kernel<KT, STAGED, TB>, nb, csize, 32 * docs * wpd,
                               smem, stream, expb_vk, word_idx, counts, doc_mask, gamma_in,
                               alpha, stop_flag, executed, warm, L, K, wpd, csize, tile_len,
                               var_max_iters, var_tol, gamma_out, phic, docll, ass, iters);
}

}  // namespace

// The launch geometry is the caller's (ops/sparse_estep.py
// launch_geometry): `block_docs` documents per CTA (the stop block),
// `warps_per_doc` warps each, `cluster` CTAs per document (then
// block_docs must be 1), and with `staged` a shared-memory tile of
// tile_len tokens per document and CTA.  `expb_vk` holds the library's
// table type (float, or bf16 with ONI_TABLE_BF16: see the header).
#ifdef ONI_TABLE_BF16
using Table = __nv_bfloat16;
#else
using Table = float;
#endif

extern "C" int oni_sparse_estep(const void* expb_vk, const int32_t* word_idx,
                                const float* counts, const float* doc_mask,
                                const float* gamma_in, const float* alpha,
                                const int* stop_flag, int* executed, int warm, int B,
                                int L, int K, int block_docs, int warps_per_doc,
                                int cluster, int tile_len, int staged,
                                int var_max_iters, float var_tol,
                                float* gamma_out, float* phic, float* docll, float* ass,
                                int32_t* iters, void* stream) {
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
#define ONI_LAUNCH_MODE(KT, STAGED, TB)                                                      \
  launch<KT, STAGED, TB>(nb, block_docs, warps_per_doc, cluster, tile_len, smem, s,          \
                         static_cast<const TB*>(expb_vk), word_idx, counts, doc_mask,         \
                         gamma_in, alpha, stop_flag, executed, warm, L, K, var_max_iters,     \
                         var_tol, gamma_out, phic, docll, ass, iters)
#define ONI_LAUNCH(KT) \
  return (int)(staged ? ONI_LAUNCH_MODE(KT, true, Table) : ONI_LAUNCH_MODE(KT, false, Table))
  if (K <= 4) ONI_LAUNCH(4);
  if (K <= 8) ONI_LAUNCH(8);
  if (K <= 16) ONI_LAUNCH(16);
  if (K <= 20) ONI_LAUNCH(20);
  if (K <= 32) ONI_LAUNCH(32);
  ONI_LAUNCH(64);
#undef ONI_LAUNCH
#undef ONI_LAUNCH_MODE
}

extern "C" int oni_sparse_scatter(const float* phic, const int32_t* sorted_pos,
                                  const int32_t* seg_ptr, const int32_t* seg_word,
                                  const int* stop_flag, int* executed, int U, int K,
                                  float* out, void* stream) {
  if (U < 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (U == 0) return 0;
  constexpr int kWarps = 8;
  sparse_scatter_kernel<<<(U + kWarps - 1) / kWarps, 32 * kWarps, 0,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      phic, sorted_pos, seg_ptr, seg_word, stop_flag, executed, U, K, out);
  return (int)cudaGetLastError();
}
