// Max-product and routing kernels of the arity-2 Tucker layer for Hopper
// (sm_90a): the upward max-plus contraction of MAP and the downward choice
// of one composite index per (fold, row) for MAP and sampling.
//
// Replaces two Pallas TPU kernels of cirkit_tpu/ops/lse_einsum.py:
//
//   tropical_tucker: `_tropical_kernel` (dispatched by `tropical_tucker2`)
//     out[f,b,o] = max_m lw[f,o,m] + x1[f,b,m/K2] + x2[f,b,m%K2]
//     lw = log_softmax(theta) over m (log_weights) or log(w) (linear weights)
//
//   route_tucker: `_route_kernel` (dispatched by `route_tucker2`)
//     out[f,b] = argmax_m  s[m] (+ Gumbel noise for the sample kind),
//     s[m] = (x1[f,b,m/K2] + x2[f,b,m%K2]) + lw[f, sel[f,b], m]
//     lw = the raw logits (log_weights: a row constant cannot change the
//     choice) or log(w).
//
// Neither carries the TPU's workarounds: no bf16 three-term splits, no 0/1
// selector matmuls, no indices in f32, no -1e30 floors (in f32 with no split
// a -inf score simply loses), and any K1, K2, O >= 1 and ragged batch.
//
// tropical_tucker is the max-plus twin of the forward kernel (lse_einsum.cu):
// one block of 256 threads per (fold, 64 output units, 128 batch rows), each
// thread holding an 8x4 tile of running maxima in registers, the composite
// x1[i] + x2[j] and the log weights staged 16 columns at a time in shared
// memory, the next chunk loaded into registers while the current one is
// reduced. There is no tensor-core form of (max, +), so it runs on the f32
// cores: at the flagship's largest entry (F=784, B=128, O=64, M=4096) that is
// 26 G add-max pairs, two instructions each, over 411 MB of logits read once
// per batch tile: bound by instruction issue, not by memory. The softmax
// normalizer of each logits row is a per-block prologue (one warp pass per
// row), subtracted after the max.
//
// route_tucker gives one warp to each (fold, row): the lanes walk the
// selected weight row four columns at a time (one Philox4x32-10 call per four
// columns for the sample kind, counter (m/4, row, fold), key = the 64-bit
// seed), keep the best (score, index) pair with the lower index winning a
// tie, and reduce across the warp by shuffles: first match, as jnp.argmax.
// Uniforms lie in [2^-24, 1 - 2^-24]. It reads one weight row per (fold, row),
// 16 KB at the flagship, from L2 (a fold's 64 rows fit), so it is bound by
// load and issue latency; at the flagship 100K warps keep the card full.
//
// Both kernels are templates over their scalar type T, float or double (the
// entries with _f64); a double block of the tropical kernel is alone on its SM.
// The Gumbel draw keeps its Philox key and bits in either type and forms the
// uniform, its logarithms and the score in T.
//
// Each extern "C" entry selects the given device, launches on the given
// stream and returns cudaGetLastError() of the launch (0 on success).

#include <cfloat>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "lse_common.cuh"

namespace {

constexpr int BM = 128;  // batch rows per block
constexpr int BN = 64;   // output units per block
constexpr int BK = 16;   // composite columns staged per chunk
constexpr int TM = 8;    // batch rows per thread
constexpr int TN = 4;    // output units per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int WARPS = THREADS / 32;
constexpr int AS = BM + 4;  // padded strides keep float4 reads aligned
constexpr int BS = BN + 4;

template <typename T, bool LOGW>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? 2 : 1)
tropical_tucker_kernel(const T* __restrict__ x1,  // (F,B,K1)
                       const T* __restrict__ x2,  // (F,B,K2)
                       const T* __restrict__ th,  // (F,O,K1*K2) logits or weights
                       T* __restrict__ out,       // (F,B,O)
                       int B, int K1, int K2, int O) {
  __shared__ __align__(16) T As[BK][AS];  // composite x1[i] + x2[j], k-major
  __shared__ __align__(16) T Bs[BK][BS];  // logits or log weights, k-major
  __shared__ T lse[BN];                   // log_weights: row normalizers

  const int M = K1 * K2;
  const int f = blockIdx.x;
  const int o0 = blockIdx.y * BN;
  const int b0 = blockIdx.z * BM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* x1f = x1 + (size_t)f * B * K1;
  const T* x2f = x2 + (size_t)f * B * K2;
  const T* thf = th + (size_t)f * O * M;
  T* outf = out + (size_t)f * B * O;

  if (LOGW) {
    for (int r = warp; r < BN; r += WARPS) {
      const int o = o0 + r;
      T s = T(1), m = T(0);
      if (o < O) cirkit::softmax_row_stats(thf + (size_t)o * M, M, lane, &m, &s);
      if (lane == 0) lse[r] = m + cirkit::log_t(s);
    }
    __syncthreads();
  }

  // Staging map: thread tid stages column kk = tid % BK of each chunk for
  // the rows tid / BK + n * (THREADS / BK); neighbouring threads read
  // neighbouring columns.
  const int skk = tid % BK;
  const int srow = tid / BK;
  constexpr int RSTEP = THREADS / BK;
  constexpr int A_PER = BM / RSTEP;
  constexpr int W_PER = BN / RSTEP;

  T pa[A_PER], pw[W_PER];
  auto load_chunk = [&](int k0) {
    const int k = k0 + skk;
    const int i = k / K2;
    const int j = k - i * K2;
#pragma unroll
    for (int n = 0; n < A_PER; ++n) {
      const int b = b0 + srow + n * RSTEP;
      pa[n] = (b < B && k < M) ? x1f[(size_t)b * K1 + i] + x2f[(size_t)b * K2 + j] : -INFINITY;
    }
#pragma unroll
    for (int n = 0; n < W_PER; ++n) {
      const int o = o0 + srow + n * RSTEP;
      T w = -INFINITY;
      if (o < O && k < M) {
        w = thf[(size_t)o * M + k];
        if (!LOGW) w = cirkit::log_t(w);  // log(0) = -inf: a zero weight never wins
      }
      pw[n] = w;
    }
  };

  const int tx = tid % (BN / TN);  // output-unit group
  const int ty = tid / (BN / TN);  // batch-row group
  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = -INFINITY;

  load_chunk(0);
  for (int k0 = 0; k0 < M; k0 += BK) {
#pragma unroll
    for (int n = 0; n < A_PER; ++n) As[skk][srow + n * RSTEP] = pa[n];
#pragma unroll
    for (int n = 0; n < W_PER; ++n) Bs[skk][srow + n * RSTEP] = pw[n];
    __syncthreads();
    if (k0 + BK < M) load_chunk(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[TM], bb[TN];
      cirkit::load4(&As[kk][ty * TM], a);
      cirkit::load4(&As[kk][ty * TM + 4], a + 4);
      cirkit::load4(&Bs[kk][tx * TN], bb);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = cirkit::max_t(acc[i][j], a[i] + bb[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = b0 + ty * TM + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx * TN + j;
      const int o = o0 + c;
      if (o >= O) continue;
      outf[(size_t)b * O + o] = LOGW ? acc[i][j] - lse[c] : acc[i][j];
    }
  }
}

// Philox4x32-10 (Salmon et al., SC'11): four 32-bit words from a 128-bit
// counter and a 64-bit key.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = c.x * 0xD2511F53u, hi0 = __umulhi(c.x, 0xD2511F53u);
    const uint32_t lo1 = c.z * 0xCD9E8D57u, hi1 = __umulhi(c.z, 0xCD9E8D57u);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// Gumbel noise -log(-log(u)) for u = (bits >> 9) * 2^-23 + 2^-24, in
// [2^-24, 1 - 2^-24]: finite, so a -inf score still loses.
template <typename T>
__device__ __forceinline__ T gumbel(uint32_t bits) {
  const T u = (T)(bits >> 9) * T(1.1920928955078125e-07) + T(5.9604644775390625e-08);
  return -cirkit::log_t(-cirkit::log_t(u));
}

// The better of two (score, index) pairs: the larger score, the lower index
// on a tie.
template <typename T>
__device__ __forceinline__ bool better(T s, int m, T best, int bi) {
  return s > best || (s == best && m < bi);
}

constexpr int ROUTE_WARPS = 8;  // warps (one (fold, row) each) per block

template <typename T, bool LOGW, bool SAMPLE>
__global__ void __launch_bounds__(ROUTE_WARPS * 32)
route_tucker_kernel(const T* __restrict__ x1,       // (F,B,K1)
                    const T* __restrict__ x2,       // (F,B,K2)
                    const T* __restrict__ th,       // (F,O,K1*K2)
                    const int64_t* __restrict__ sel,    // (F,B) selected unit
                    int64_t* __restrict__ out,          // (F,B) composite index
                    int F, int B, int K1, int K2, int O, uint32_t seed_lo,
                    uint32_t seed_hi) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ROUTE_WARPS + (threadIdx.x >> 5);
  if (row >= (long long)F * B) return;
  const int f = (int)(row / B);
  const int b = (int)(row - (long long)f * B);
  const int M = K1 * K2;
  long long o = sel[row];
  o = o < 0 ? 0 : (o >= O ? O - 1 : o);  // the caller masks rows with sel < 0
  const T* w = th + ((size_t)f * O + (size_t)o) * M;
  const T* xa = x1 + (size_t)row * K1;
  const T* xb = x2 + (size_t)row * K2;

  T best = -INFINITY;
  int bi = INT_MAX;
  for (int g = lane; 4 * g < M; g += 32) {
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    if (SAMPLE) bits = philox4x32_10(make_uint4((uint32_t)g, (uint32_t)b, (uint32_t)f, 0u),
                                     seed_lo, seed_hi);
    const uint32_t words[4] = {bits.x, bits.y, bits.z, bits.w};
    const int m0 = 4 * g;
    int i = m0 / K2;
    int j = m0 - i * K2;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = m0 + r;
      if (m >= M) break;
      const T lw = LOGW ? w[m] : cirkit::log_t(w[m]);
      T s = (xa[i] + xb[j]) + lw;
      if (SAMPLE) s += gumbel<T>(words[r]);
      if (better(s, m, best, bi)) {
        best = s;
        bi = m;
      }
      if (++j == K2) {
        j = 0;
        ++i;
      }
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const T os = __shfl_xor_sync(0xffffffffu, best, d);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, d);
    if (better(os, oi, best, bi)) {
      best = os;
      bi = oi;
    }
  }
  if (lane == 0) out[row] = bi == INT_MAX ? 0 : bi;  // INT_MAX: every score NaN
}

template <typename T, bool LOGW>
int launch_tropical(const T* x1, const T* x2, const T* th, T* out, int F,
                    int B, int K1, int K2, int O, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(F, (O + BN - 1) / BN, (B + BM - 1) / BM);
  tropical_tucker_kernel<T, LOGW><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, x2, th, out, B, K1, K2, O);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool LOGW, bool SAMPLE>
int launch_route(const T* x1, const T* x2, const T* th, const int64_t* sel,
                 int64_t* out, int F, int B, int K1, int K2, int O, unsigned long long seed,
                 int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long rows = (long long)F * B;
  const unsigned blocks = (unsigned)((rows + ROUTE_WARPS - 1) / ROUTE_WARPS);
  route_tucker_kernel<T, LOGW, SAMPLE>
      <<<blocks, ROUTE_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          x1, x2, th, sel, out, F, B, K1, K2, O, (uint32_t)(seed & 0xffffffffull),
          (uint32_t)(seed >> 32));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both entries exist for float (the plain name) and for double (_f64).
#define TUCKER_ROUTE_ENTRIES(SUFFIX, T)                                                          \
  int tropical_tucker##SUFFIX(const T* x1, const T* x2, const T* th, T* out, int F, int B,       \
                              int K1, int K2, int O, int log_weights, int device,                \
                              void* stream) {                                                    \
    return log_weights                                                                           \
               ? launch_tropical<T, true>(x1, x2, th, out, F, B, K1, K2, O, device, stream)      \
               : launch_tropical<T, false>(x1, x2, th, out, F, B, K1, K2, O, device, stream);    \
  }                                                                                              \
  int route_tucker##SUFFIX(const T* x1, const T* x2, const T* th, const int64_t* sel,            \
                           int64_t* out, int F, int B, int K1, int K2, int O, int log_weights,   \
                           int sample, unsigned long long seed, int device, void* stream) {      \
    if (log_weights)                                                                             \
      return sample ? launch_route<T, true, true>(x1, x2, th, sel, out, F, B, K1, K2, O, seed,   \
                                                  device, stream)                                \
                    : launch_route<T, true, false>(x1, x2, th, sel, out, F, B, K1, K2, O, seed,  \
                                                   device, stream);                              \
    return sample ? launch_route<T, false, true>(x1, x2, th, sel, out, F, B, K1, K2, O, seed,    \
                                                 device, stream)                                 \
                  : launch_route<T, false, false>(x1, x2, th, sel, out, F, B, K1, K2, O, seed,   \
                                                  device, stream);                               \
  }

TUCKER_ROUTE_ENTRIES(, float)
TUCKER_ROUTE_ENTRIES(_f64, double)
#undef TUCKER_ROUTE_ENTRIES

}  // extern "C"
