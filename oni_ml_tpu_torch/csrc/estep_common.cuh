// Device helpers shared by the port's E-step kernels (sparse_estep.cu,
// dense_estep.cu): the stop rule, the special functions and the reciprocal
// of oni_ml_tpu/ops/pallas_estep.py:67-120 and ops/stop.py.  ops/_cuda.py
// hashes this header into every kernel's build key.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

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

}  // namespace oni

// One definition per library: each library is built from one .cu file.
extern "C" const char* oni_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
