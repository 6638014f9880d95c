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

// The batch chunks of a launch whose blocks split the batch, with ``tiles``
// blocks a chunk: enough chunks for about ``target`` blocks in all, at least
// ``least`` rows a chunk; ``rows`` gets a chunk's rows, a multiple of
// ``step``.
inline int batch_chunks(long long tiles, int B, int step, int least, long long target,
                        int* rows) {
  const long long want = (target + tiles - 1) / tiles;
  const int most = (B + least - 1) / least;
  const int n = want < most ? static_cast<int>(want) : most;
  *rows = (B + n - 1) / n;
  *rows = (*rows + step - 1) / step * step;
  return (B + *rows - 1) / *rows;
}

// The shared memory one block may take on the card (227 KB on the H100).
constexpr size_t MAX_SMEM = 232448;

// The layout of a CUDA-core backward's gy scratch, in the values it holds:
// gy (F, B, O) (none on the narrow route, which keeps gy on chip), then the
// dw partials (n_bc, F, O, I) of a batch split into n_bc > 1 chunks, then
// for a Tucker dx too wide for one block the K1 split's partials.
struct GyPlan {
  int n_bc = 1, rows = 0;   // dw: batch chunks and their rows
  bool narrow = false;      // dense, I and O <= 32: the one-pass kernel, no gy
  bool split = false;       // Tucker dx: the K1 split
  size_t dw_part = 0, dx_part = 0, total = 0;  // offsets of the parts, size
};

// The values of a K1-split Tucker dx's partials: (ceil(K2 / bn), F, B, K1)
// for dx1, then (ceil(K1 / i_per), F, B, K2) for dx2.
inline size_t tucker_split_size(int F, int B, int K1, int K2, int bn, int i_per) {
  return (size_t)F * B *
         ((size_t)((K2 + bn - 1) / bn) * K1 + (size_t)((K1 + i_per - 1) / i_per) * K2);
}

// out[e] = sum_p part[p][e] over n_parts planes of n values, in plane order:
// the second pass of a reduction split across blocks, so every call adds in
// the same order and gives the same bits.
template <typename T>
__global__ void __launch_bounds__(256)
sum_partials(const T* __restrict__ part, T* __restrict__ out, size_t n, int n_parts) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    T s = part[e];
    for (int p = 1; p < n_parts; ++p) s += part[p * n + e];
    out[e] = s;
  }
}

template <typename T>
inline cudaError_t launch_sum_partials(const T* part, T* out, size_t n, int n_parts,
                                       cudaStream_t s) {
  const size_t blocks = (n + 255) / 256;
  sum_partials<T><<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      part, out, n, n_parts);
  return cudaGetLastError();
}

}  // namespace cirkit
