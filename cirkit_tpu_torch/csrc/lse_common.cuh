// Device helpers shared by the log-einsum-exp kernels, real, signed and
// complex. The kernels are templates over their scalar type: each helper has
// a float and a double form behind one name.

#pragma once

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

namespace cirkit {

__device__ __forceinline__ float max_t(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_t(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
// The fast exponential where f32 has one (2 + 1.2|x| ulps); double has none.
__device__ __forceinline__ float fast_exp(float x) { return __expf(x); }
__device__ __forceinline__ double fast_exp(double x) { return exp(x); }

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = max_t(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// The exponential of a staged element: the fast approximation where the
// contraction sums positive terms (lse), the accurate one where it sums
// terms of both signs (signed): a sum that cancels amplifies each term's
// error by its cancellation ratio, and squared circuits square that ratio.
template <bool ACCURATE, typename T>
__device__ __forceinline__ T staged_exp(T x) {
  return ACCURATE ? exp_t(x) : fast_exp(x);
}

// The row max clamped to the finite range, so a row that is all -inf
// shifts by the lowest finite value and yields log(0) = -inf instead of NaN.
__device__ __forceinline__ float clamp_max(float m) {
  return fminf(fmaxf(m, -FLT_MAX), FLT_MAX);
}
__device__ __forceinline__ double clamp_max(double m) { return fmin(fmax(m, -DBL_MAX), DBL_MAX); }

// Four neighbouring values of a 16-byte aligned shared-memory row, read (or
// written to device memory) as 16-byte accesses.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 t0 = *reinterpret_cast<const double2*>(p);
  const double2 t1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = t0.x, v[1] = t0.y, v[2] = t1.x, v[3] = t1.y;
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(double* p, double a, double b, double c, double d) {
  reinterpret_cast<double2*>(p)[0] = make_double2(a, b);
  reinterpret_cast<double2*>(p)[1] = make_double2(c, d);
}

// One warp's pass over a softmax row: its max (0 for a row that is all
// -inf, so padding units stage exp(-inf) = 0) and the sum of exp(row - max),
// in one pass (a running max that rescales the running sum). Every lane
// returns the same pair.
template <typename T>
__device__ __forceinline__ void softmax_row_stats(const T* row, int n, int lane, T* max_out,
                                                  T* sum_out) {
  T mx = -INFINITY, s = T(0);
  for (int k = lane; k < n; k += 32) {
    const T v = row[k];
    if (v == -INFINITY) continue;
    if (v > mx) {
      s *= fast_exp(mx - v);
      mx = v;
    }
    s += fast_exp(v - mx);
  }
  const T m = warp_max(mx);
  s = warp_sum(mx == -INFINITY ? T(0) : s * fast_exp(mx - m));
  *max_out = m == -INFINITY ? T(0) : m;
  *sum_out = s;
}

}  // namespace cirkit
