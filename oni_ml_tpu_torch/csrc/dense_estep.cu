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
// What bounds it on this card.  A cell with C = 0 adds exactly zero to s,
// T and the token term, so the function needs 4*K flops per non-zero cell
// and fixed-point iteration (q and the s contraction) plus 4*K per
// non-zero cell for the tail.  At the flow day's shape (B = 1024,
// W = 5,632, K = 20, ~1.7% of the cells non-zero, ~50 iterations) that is
// ~0.4 GFLOP, ~6 us at the 67 TFLOP/s f32 peak, while the bytes it must
// move (C once, 23 MB, plus beta, gamma and T) take ~7 us at 3.35 TB/s:
// bytes bound it.  The TPU kernels' dense formulation does 4*K*W flops
// per document and iteration over every cell (25 GFLOP per launch, 60x
// the function's) and reads C on every iteration; this kernel does the
// non-zero work only and reads C once:
//
//  * Prologue, once per launch.  A CTA of up to 8 warps takes a block of
//    BB <= 4 documents and reads their cells of C once, coalesced in both
//    layouts (row-major: lanes along w; W-major: lanes along d, so a
//    warp's load covers 32 / BB columns of the BB documents).  Each warp
//    owns a contiguous range of 32-column groups; per group and document
//    a ballot gives the non-zero columns as a 32-bit mask (written to
//    `masks` [W / 32, B], which T reads later), and popc counts them.  The
//    counts, summed over the warps in warp order, place each document's
//    list of non-zero cells in ascending w (ballot + popc fix the order).
//    A second pass over the masks copies each listed cell's count and its
//    K values of exp(log beta)[:, w] into shared memory with cp.async
//    (beta does not change within a launch): [K, cells] plus the counts,
//    (K + 1) * 4 bytes a cell.
//  * Overflow.  Where a block's cells do not fit in the CTA's shared
//    memory (full-V dense over a long bucket: up to 5,632 cells a
//    document), the same lists go to this CTA's slice of a per-launch
//    scratch in device memory (the wrapper's torch.empty), where they sit
//    in L2.  A slice holds `block_cells` cells: BB * min(W, L) for a batch
//    densified from [B, L] token lists, since a document has at most
//    min(W, L) distinct words.  Nothing sized by W or by a document's
//    length fails; a block takes the scratch exactly when its non-zero
//    cells outnumber `smem_cells`.
//  * Iterations.  The fixed point then reads only the lists: the warps of
//    a document (warps_per_doc, from ops/dense_estep.py launch_geometry)
//    stride over its cells, with the per-document core of
//    estep_common.cuh (shared with fixed_point_estep.cu): q, the s
//    contraction, sums over the lanes then over the document's warps in
//    warp order, the lane-parallel gamma update, and the block's delta
//    for the Pallas per-block stop, so converged documents iterate with
//    their block.
//  * T without a re-scan of C.  The tail writes each cell's c / q to
//    `ratio` [B, W] (the first n_d entries of row d), and the T kernel
//    reads only the masks, the per-(group, doc) list offsets (`pref`), the
//    documents' em rows and those ratios.  A CTA owns 32 columns; each of
//    its 8 warps walks a fixed contiguous range of the documents in
//    order, and the 8 partial sums are added in warp order: no atomics,
//    T is bit-identical from run to run.
//  * Why not tensor cores.  At 1.7% non-zero cells and K = 20 an MMA over
//    the dense [B, W] matrix does ~60x the work the function needs; f32
//    agreement would need 3xTF32; cuBLAS's f32 pair of products per
//    iteration (3.10 ms at the flow day's batch on an H100 at 700 W) is the
//    yardstick this kernel must beat by touching the non-zero cells only.
//  * The TPU's approximate reciprocal + one Newton step becomes
//    rcp.approx.ftz.f32 + one Newton step.  The products are full f32 FMAs.
//  * Under the chunk driver (models/fused.py) both kernels take a device
//    pointer to the driver's stop flag and return at once once it is set.
//    A fixed-point launch that runs past that check adds one to the
//    wrapper's device counter `executed`.
//  * The bf16 storage mode (precision "bf16", the TPU kernels' `_cast_for`
//    path) is a compile-time instantiation: RB rounds beta, exp_et and
//    each cell's ratio to bf16 (round-to-nearest-even) before the two
//    fixed-point products, whose sums stay f32, and gamma' = alpha + e * s
//    takes the unrounded e; the tail stays full f32 on f32 beta.  Beta
//    arrives in f32 once, and the fixed point rounds it in registers as it
//    reads a cell (the tail needs the f32 values of the same cells), so
//    its bytes do not change.  TC is the corpus' storage type: bf16 where
//    every cell is <= 256 (ops/dense_estep.py corpus_dtype, exact), which
//    halves the bytes C moves; its counts are upcast as they are read and
//    staged as f32.  The f32 instantiation (float, false) is the code
//    above, unchanged.  One library holds one mode, chosen by
//    ONI_DENSE_MODE when this source is compiled (ops/_cuda.py builds
//    the three libraries in parallel, one nvcc each): 0 f32, 1 bf16
//    operands over a float corpus, 2 bf16 operands over a bf16 corpus.

#include <cuda_bf16.h>
#include <stdint.h>

#include "estep_common.cuh"

namespace {

using oni::kFull;

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kUnroll = 4;  // column groups loaded at once in the prologue

// One count of C, upcast exactly from its storage type.
__device__ __forceinline__ float load_count(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_count(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

template <int KT, int BB, typename TC, bool RB>
__global__ void __launch_bounds__(kMaxThreads, 2)
dense_fixed_point_kernel(const float* __restrict__ expb,       // [K, W]
                         const TC* __restrict__ C,             // (d, w) at d*sd + w*sw
                         long long sd, long long sw, int wmajor,
                         const float* __restrict__ doc_mask,   // [B]
                         const float* __restrict__ gamma_in,   // [B, K]
                         const float* __restrict__ alpha_ptr,  // [1]
                         const int* __restrict__ stop_flag,    // [1] or null
                         int* __restrict__ executed,           // [1] or null
                         int warm, int B, int W, int K, int var_max_iters, float var_tol,
                         int smem_cells,                       // cells shared memory holds
                         int block_cells,                      // cells a scratch slice holds
                         float* scratch,                       // [B / BB, block_cells * (K + 1)] or null
                         unsigned* masks,                      // [ceil(W / 32), B]
                         int* pref,                            // [ceil(W / 32), B]
                         float* __restrict__ ratio,            // [B, W]
                         float* __restrict__ gamma_out,        // [B, K]
                         float* __restrict__ em_out,           // [B, K] exp_et * mask
                         float* __restrict__ docll,            // [B]
                         float* __restrict__ ass,              // [B]
                         int32_t* __restrict__ iters_out) {    // [B / BB]
  if (oni::stopped(stop_flag)) return;
  oni::count_executed(executed);
  constexpr int NS = oni::NS<KT>;
  extern __shared__ __align__(16) float s_dyn[];
  __shared__ int s_cnt[kMaxWarps][BB];
  __shared__ float s_ndp[kMaxWarps][BB];
  __shared__ float s_red[2][kMaxWarps * NS * 32];
  __shared__ float s_delta[2][BB];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int wpd = nwarps / BB;  // warps per document
  const long long d0 = (long long)blockIdx.x * BB;
  const int ngroups = (W + 31) / 32;
  const int gpw = (ngroups + nwarps - 1) / nwarps;
  const int glo = min(ngroups, warp * gpw), ghi = min(ngroups, glo + gpw);
  const unsigned below = (1u << lane) - 1u;

  // Pass A: read the block's cells of C once; per 32-column group and
  // document, the non-zero columns as a mask; counts and N_d per warp.
  {
    int cnt[BB];
    float ndp[BB];
#pragma unroll
    for (int j = 0; j < BB; ++j) {
      cnt[j] = 0;
      ndp[j] = 0.0f;
    }
    constexpr int CPB = 32 / BB;  // W-major: columns per 32-lane load
    for (int g0 = glo; g0 < ghi; g0 += kUnroll) {
      float v[kUnroll][BB];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int t = 0; t < BB; ++t) {
          const int g = g0 + u;
          const int w = wmajor ? g * 32 + t * CPB + lane / BB : g * 32 + lane;
          const int dd = wmajor ? lane % BB : t;
          v[u][t] = (g < ghi && w < W) ? load_count(C + (d0 + dd) * sd + (long long)w * sw)
                                       : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int g = g0 + u;
        if (g >= ghi) break;
        unsigned colmask[BB];
        if (wmajor) {
          unsigned nz[BB];
#pragma unroll
          for (int t = 0; t < BB; ++t) nz[t] = __ballot_sync(kFull, v[u][t] != 0.0f);
          // Column g*32 + lane sits in load lane / CPB, at lane
          // (lane % CPB) * BB + j for document j.
          unsigned mine = nz[0];
#pragma unroll
          for (int t = 1; t < BB; ++t)
            if (lane / CPB == t) mine = nz[t];
          const int sh = (lane % CPB) * BB;
#pragma unroll
          for (int j = 0; j < BB; ++j) {
            colmask[j] = __ballot_sync(kFull, (mine >> (sh + j)) & 1u);
#pragma unroll
            for (int t = 0; t < BB; ++t) ndp[j] += (lane % BB == j) ? v[u][t] : 0.0f;
          }
        } else {
#pragma unroll
          for (int j = 0; j < BB; ++j) {
            colmask[j] = __ballot_sync(kFull, v[u][j] != 0.0f);
            ndp[j] += v[u][j];
          }
        }
#pragma unroll
        for (int j = 0; j < BB; ++j) {
          if (lane == 0) masks[(size_t)g * B + d0 + j] = colmask[j];
          cnt[j] += __popc(colmask[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < BB; ++j) {
      const float nd = oni::warp_sum(ndp[j]);
      if (lane == 0) {
        s_cnt[warp][j] = cnt[j];
        s_ndp[warp][j] = nd;
      }
    }
  }
  __syncthreads();

  // Where each document's list starts (off), where this warp's cells of it
  // start within it (run), the block's total and N_d, all in warp order.
  int off[BB], run[BB], ntot = 0;
#pragma unroll
  for (int j = 0; j < BB; ++j) {
    int n = 0, mine = 0;
    for (int w = 0; w < nwarps; ++w) {
      if (w == warp) mine = n;
      n += s_cnt[w][j];
    }
    off[j] = ntot;
    run[j] = mine;
    ntot += n;
  }
  const bool staged = ntot <= smem_cells;
  float* cs;
  if (staged) {
    cs = s_dyn;
  } else {
    // The wrapper sizes the scratch for every block that can overflow; a
    // block with more cells than its slice means the caller's per-document
    // bound was wrong, and the launch stops rather than write past it.
    if (scratch == nullptr || ntot > block_cells) __trap();
    cs = scratch + (size_t)blockIdx.x * block_cells * (K + 1);
  }
  float* bs = cs + ntot;  // [K, ntot]

  // Pass B: copy each listed cell's count and beta column into the lists.
  for (int g = glo; g < ghi; ++g) {
#pragma unroll
    for (int j = 0; j < BB; ++j) {
      const unsigned mw = masks[(size_t)g * B + d0 + j];
      if (lane == 0) pref[(size_t)g * B + d0 + j] = run[j];
      if ((mw >> lane) & 1u) {
        const int i = off[j] + run[j] + __popc(mw & below);
        const int w = g * 32 + lane;
        const TC* src_c = C + (d0 + j) * sd + (long long)w * sw;
        if (staged) {
          if constexpr (sizeof(TC) == sizeof(float))
            oni::cp_async4(cs + i, src_c);
          else
            cs[i] = load_count(src_c);  // 2 bytes: below cp.async's 4
          for (int k = 0; k < K; ++k) oni::cp_async4(bs + (size_t)k * ntot + i, expb + (size_t)k * W + w);
        } else {
          cs[i] = load_count(src_c);
          for (int k = 0; k < K; ++k) bs[(size_t)k * ntot + i] = __ldg(expb + (size_t)k * W + w);
        }
      }
      run[j] += __popc(mw);
    }
  }
  if (staged) oni::cp_async_wait_all();
  __syncthreads();

  // The fixed point over the lists.
  const int j = warp / wpd, p = warp % wpd;
  const long long d = d0 + j;
  int n_j = 0, off_j = 0;
  float nd = 0.0f;
#pragma unroll
  for (int jj = 0; jj < BB; ++jj)
    if (jj == j) off_j = off[jj];
  for (int w = 0; w < nwarps; ++w) {
    n_j += s_cnt[w][j];
    nd += s_ndp[w][j];
  }
  const float* cj = cs + off_j;
  const float* bj = bs + off_j;
  const float alpha = __ldg(alpha_ptr);
  const float kf = (float)K;
  const float m = doc_mask[d];
  const float mean0 = alpha + nd / kf;  // the fresh start and the delta scale
  const float inv_scale = 1.0f / mean0;

  float gam[NS];  // lane-parallel: topic lane + 32 h
#pragma unroll
  for (int h = 0; h < NS; ++h) {
    const int k = lane + 32 * h;
    gam[h] = (k < K) ? (warm ? gamma_in[d * K + k] : mean0) : 0.0f;
  }

  float e[KT], acc[KT], s[NS], el_mine[NS], e_mine[NS];
  float delta = INFINITY, prev = INFINITY;
  int it = 0;
  while (oni::fp_continue(it, delta, prev, var_max_iters, var_tol)) {
    const int buf = it & 1;
    oni::e_log_theta<KT>(gam, K, lane, el_mine, e_mine, e);
    if constexpr (RB) oni::round_bf16_all<KT>(e);  // e_mine stays f32
#pragma unroll
    for (int k = 0; k < KT; ++k) acc[k] = 0.0f;
    oni::accumulate_cells<KT, false, RB>(bj, ntot, cj, p * 32 + lane, n_j, 32 * wpd, e, K, acc);
    oni::warp_topic_sums<KT>(acc, lane, s);
    oni::doc_sums<KT>(s, s_red[buf], warp, j, wpd, lane);
    const float d_doc =
        (oni::gamma_update<KT>(gam, e_mine, s, alpha, K, lane) / kf) * inv_scale * m;
    float bmax = d_doc;
    if constexpr (BB > 1) {
      if (p == 0 && lane == 0) s_delta[buf][j] = d_doc;
      __syncthreads();
      bmax = s_delta[buf][0];
#pragma unroll
      for (int q = 1; q < BB; ++q) bmax = fmaxf(bmax, s_delta[buf][q]);
    }
    prev = delta;
    delta = bmax;
    ++it;
  }

  // Converged tail: E[log theta], the token term sum c log q (cells with
  // C = 0 add exactly zero), each cell's c / q for T, the ELBO's terms.
  oni::e_log_theta<KT>(gam, K, lane, el_mine, e_mine, e);
  float tok = oni::token_term<KT>(bj, ntot, cj, p * 32 + lane, n_j, 32 * wpd, e, K,
                                  ratio + d * W);
  tok = oni::doc_sum1(oni::warp_sum(tok), s_red[it & 1], warp, j, wpd, lane);
  if (p == 0) {
    float gsum = 0.0f, core = 0.0f, as = 0.0f;
#pragma unroll
    for (int h = 0; h < NS; ++h) {
      const int k = lane + 32 * h;
      if (k < K) {
        gsum += gam[h];
        core += (alpha - gam[h]) * el_mine[h] + oni::gammaln_pos(gam[h]);
        as += el_mine[h];
        gamma_out[d * K + k] = gam[h];
        em_out[d * K + k] = e_mine[h] * m;
      }
    }
    gsum = oni::warp_sum(gsum);
    core = oni::warp_sum(core) - oni::gammaln_pos(gsum);
    as = oni::warp_sum(as);
    if (lane == 0) {
      docll[d] = (core + tok) * m;
      ass[d] = as * m;
    }
  }
  if (threadIdx.x == 0) iters_out[blockIdx.x] = it;
}

// T[k, w] = sum_d em[d, k] * ratio of cell (d, w) over the unmasked
// documents, from the fixed-point launch's masks, list offsets and
// ratios.  A CTA owns the 32 columns of one group (lane = column); warp i
// walks documents [i * per, (i + 1) * per) in chunks of 32: the chunk's
// masks, offsets and em rows are loaded once (coalesced) into the warp's
// shared memory, then each lane walks only the documents whose cell in
// its column is non-zero, in order, so one lane's loads do not stall the
// others.  The 8 partial sums are added in warp order.
constexpr int kThreads = 256;  // the T kernel's CTA
constexpr int kWarps = kThreads / 32;

template <int KT>
__global__ void __launch_bounds__(kThreads)
dense_suffstats_kernel(const unsigned* __restrict__ masks,   // [ceil(W / 32), B]
                       const int* __restrict__ pref,         // [ceil(W / 32), B]
                       const float* __restrict__ ratio,      // [B, W]
                       const float* __restrict__ doc_mask,   // [B]
                       const float* __restrict__ em,         // [B, K]
                       const int* __restrict__ stop_flag,    // [1] or null
                       int B, int W, int K,
                       float* __restrict__ T) {              // [K, W]
  if (oni::stopped(stop_flag)) return;
  __shared__ float s_buf[kWarps][32 * KT];  // a chunk's em rows, then the sums
  __shared__ unsigned s_m[kWarps][32];
  __shared__ int s_pf[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x;
  const unsigned below = (1u << lane) - 1u;
  float* s_em = s_buf[warp];
  float acc[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) acc[k] = 0.0f;
  const int per = (B + kWarps - 1) / kWarps;
  const int lo = min(B, warp * per), hi = min(B, lo + per);
  for (int db = lo; db < hi; db += 32) {
    const int nd = min(32, hi - db);
    unsigned mw = 0u;
    if (lane < nd && __ldg(doc_mask + db + lane) != 0.0f)
      mw = __ldg(masks + (size_t)g * B + db + lane);
    s_m[warp][lane] = mw;
    s_pf[warp][lane] = lane < nd ? __ldg(pref + (size_t)g * B + db + lane) : 0;
    for (int i = lane; i < nd * K; i += 32) s_em[i] = __ldg(em + (size_t)db * K + i);
    // Bit t: document db + t has a non-zero cell in this lane's column.
    unsigned hits = 0u;
#pragma unroll 8
    for (int t = 0; t < 32; ++t) hits |= ((__shfl_sync(oni::kFull, mw, t) >> lane) & 1u) << t;
    __syncwarp();
    while (hits) {
      const int t = __ffs(hits) - 1;
      hits &= hits - 1u;
      const unsigned m_t = s_m[warp][t];
      const float r =
          __ldg(ratio + (long long)(db + t) * W + s_pf[warp][t] + __popc(m_t & below));
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const float e = (k < K) ? s_em[t * K + k] : 0.0f;
        acc[k] = fmaf(e, r, acc[k]);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int k = 0; k < KT; ++k) s_em[k * 32 + lane] = acc[k];
  __syncthreads();
  for (int i = threadIdx.x; i < KT * 32; i += kThreads) {
    const int k = i / 32, l = i % 32;
    const int ww = g * 32 + l;
    if (k < K && ww < W) {
      float t = 0.0f;
#pragma unroll
      for (int p = 0; p < kWarps; ++p) t += s_buf[p][k * 32 + l];
      T[(size_t)k * W + ww] = t;
    }
  }
}

struct Args {
  const float* expb;
  const void* C;  // float or __nv_bfloat16
  long long sd, sw;
  int wmajor;
  const float* doc_mask;
  const float* gamma_in;
  const float* alpha;
  const int* stop_flag;
  int* executed;
  int warm, B, W, K, var_max_iters;
  float var_tol;
  int smem_bytes;
  int wpd;
  int block_cells;
  float* scratch;
  unsigned* masks;
  int* pref;
  float* ratio;
  float* gamma_out;
  float* em;
  float* docll;
  float* ass;
  int32_t* iters;
  float* T;
};

template <int KT, int BB, typename TC, bool RB>
cudaError_t launch(const Args& a, cudaStream_t s) {
  auto fp = dense_fixed_point_kernel<KT, BB, TC, RB>;
  if (a.smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fp, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
    if (err != cudaSuccess) return err;
  }
  const int smem_cells = a.smem_bytes / ((a.K + 1) * (int)sizeof(float));
  fp<<<a.B / BB, 32 * BB * a.wpd, a.smem_bytes, s>>>(
      a.expb, static_cast<const TC*>(a.C), a.sd, a.sw, a.wmajor, a.doc_mask, a.gamma_in, a.alpha, a.stop_flag,
      a.executed, a.warm, a.B, a.W, a.K, a.var_max_iters, a.var_tol, smem_cells,
      a.block_cells, a.scratch, a.masks, a.pref, a.ratio, a.gamma_out, a.em, a.docll,
      a.ass, a.iters);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dense_suffstats_kernel<KT><<<(a.W + 31) / 32, kThreads, 0, s>>>(
      a.masks, a.pref, a.ratio, a.doc_mask, a.em, a.stop_flag, a.B, a.W, a.K, a.T);
  return cudaGetLastError();
}

template <int KT, typename TC, bool RB>
cudaError_t launch_bb(int bb, const Args& a, cudaStream_t s) {
  if (bb == 1) return launch<KT, 1, TC, RB>(a, s);
  if (bb == 2) return launch<KT, 2, TC, RB>(a, s);
  if constexpr (KT <= 20) {
    if (bb == 4) return launch<KT, 4, TC, RB>(a, s);
  }
  return cudaErrorInvalidValue;
}

#ifndef ONI_DENSE_MODE
#define ONI_DENSE_MODE 0
#endif
#if ONI_DENSE_MODE == 0
using Corpus = float;
constexpr bool kRound = false;
#elif ONI_DENSE_MODE == 1
using Corpus = float;
constexpr bool kRound = true;
#elif ONI_DENSE_MODE == 2
using Corpus = __nv_bfloat16;
constexpr bool kRound = true;
#else
#error "ONI_DENSE_MODE must be 0, 1 or 2"
#endif

}  // namespace

// `smem_bytes` of dynamic shared memory per CTA hold the block's lists
// where they fit; `scratch` (B / block_docs slices of block_cells * (K + 1)
// floats) takes a block whose lists do not, and may be null only where
// every block's fit (block_cells * (K + 1) * 4 <= smem_bytes).
// `block_cells` bounds a block's non-zero cells: block_docs * min(W, L)
// for a batch densified from [B, L] token lists.  The wrapper
// (ops/dense_estep.py launch_geometry) picks all three.  `C` holds the
// library's corpus type (float, or bf16 in mode 2: see the header).
extern "C" int oni_dense_estep(const float* expb, const void* C, long long stride_d,
                               long long stride_w, int wmajor, const float* doc_mask,
                               const float* gamma_in, const float* alpha,
                               const int* stop_flag, int* executed, int warm, int B,
                               int W, int K, int block_docs, int warps_per_doc,
                               int var_max_iters, float var_tol, int smem_bytes,
                               int block_cells, float* scratch,
                               unsigned* masks, int* pref, float* ratio,
                               float* gamma_out, float* em, float* docll, float* ass,
                               int32_t* iters, float* T,
                               void* stream) {
  if (B <= 0 || W <= 0 || K <= 0 || K > 32 || block_docs <= 0 || B % block_docs != 0 ||
      warps_per_doc <= 0 || 32 * block_docs * warps_per_doc > kMaxThreads || smem_bytes < 0 ||
      block_cells <= 0 || (long long)block_cells > (long long)block_docs * W ||
      (scratch == nullptr &&
       (long long)block_cells * (K + 1) * (long long)sizeof(float) > smem_bytes))
    return (int)cudaErrorInvalidValue;
  const Args a{expb,          C,          stride_d,   stride_w,      wmajor,      doc_mask,
               gamma_in,      alpha,      stop_flag,  executed,      warm,        B,
               W,             K,          var_max_iters, var_tol,    smem_bytes,  warps_per_doc,
               block_cells,   scratch,    masks,      pref,          ratio,       gamma_out,
               em,            docll,      ass,        iters,         T};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (K <= 4) return (int)launch_bb<4, Corpus, kRound>(block_docs, a, s);
  if (K <= 8) return (int)launch_bb<8, Corpus, kRound>(block_docs, a, s);
  if (K <= 16) return (int)launch_bb<16, Corpus, kRound>(block_docs, a, s);
  if (K <= 20) return (int)launch_bb<20, Corpus, kRound>(block_docs, a, s);
  return (int)launch_bb<32, Corpus, kRound>(block_docs, a, s);
}
