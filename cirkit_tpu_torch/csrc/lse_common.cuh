// Device helpers shared by the log-einsum-exp forward and backward kernels.

#pragma once

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

namespace cirkit {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// The exponential of a staged element: the fast approximation (2 + 1.2|x|
// ulps) where the contraction sums positive terms (lse), the accurate expf
// where it sums terms of both signs (signed): a sum that cancels amplifies
// each term's error by its cancellation ratio, and squared circuits square
// that ratio.
template <bool ACCURATE>
__device__ __forceinline__ float staged_exp(float x) {
  return ACCURATE ? expf(x) : __expf(x);
}

// The row max clamped to the finite range, so a row that is all -inf
// shifts by -FLT_MAX and yields log(0) = -inf instead of NaN.
__device__ __forceinline__ float clamp_max(float m) {
  return fminf(fmaxf(m, -FLT_MAX), FLT_MAX);
}

// One warp's pass over a softmax row: its max (0 for a row that is all
// -inf, so padding units stage exp(-inf) = 0) and the sum of exp(row - max),
// in one pass (a running max that rescales the running sum). Every lane
// returns the same pair.
__device__ __forceinline__ void softmax_row_stats(const float* row, int n, int lane,
                                                  float* max_out, float* sum_out) {
  float mx = -INFINITY, s = 0.f;
  for (int k = lane; k < n; k += 32) {
    const float v = row[k];
    if (v == -INFINITY) continue;
    if (v > mx) {
      s *= __expf(mx - v);
      mx = v;
    }
    s += __expf(v - mx);
  }
  const float m = warp_max(mx);
  s = warp_sum(mx == -INFINITY ? 0.f : s * __expf(mx - m));
  *max_out = m == -INFINITY ? 0.f : m;
  *sum_out = s;
}

}  // namespace cirkit
