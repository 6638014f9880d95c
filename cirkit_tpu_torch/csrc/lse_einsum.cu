// Fused log-einsum-exp forward for Hopper (sm_90a): the folded sum-layer
// contraction of the lse-sum semiring, dense or arity-2 Tucker, with an
// optional softmax of the weight rows, and its signed variant.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// cirkit_tpu/ops/lse_einsum.py (dispatched by `_call_fwd`), in its four
// configurations, and with SIGNED the kernel `_s_fwd_kernel` of the same
// file (dispatched by `_s_call_fwd` / `slse_dispatch`), in its four. Per
// fold f, with m the clamped row max of each input:
//
//   dense:   out[b,o] = log sum_i exp(x[b,i] - m[b]) * w[o,i] + m[b]
//   tucker:  out[b,o] = log sum_{i,j} e1[b,i] * e2[b,j] * w[o,i*K2+j]
//                       + m1[b] + m2[b],     e_h = exp(x_h - m_h)
//   softmax: w = softmax(theta, axis=-1), computed on the fly from the
//            per-row max and sum of theta; the normalized table is never
//            stored.
//   signed:  the signed log semiring's values are (log|v|, sign v) pairs,
//            so each input x comes with its sign s (f32 in {-1, 0, +1}), the
//            staged value is e = s * exp(x - m) (for Tucker the product of
//            both factors' signs), the weights may be negative, and the
//            epilogue writes log|y| + shift and sign(y) to two outputs. An
//            exact cancellation y = 0 gives log 0 = -inf and sign 0, never
//            NaN. The rest of the kernel is the lse-sum one: the signs cost
//            one extra load and multiply per staged element, and the staged
//            exponentials use the accurate expf (staged_exp), since a sum
//            that cancels amplifies each term's error.
//
// The (B, K1*K2) Tucker outer product is formed chunk by chunk in shared
// memory inside the contraction loop and never written to device memory,
// which is the point of the TPU kernel too.
//
// What bounds it on the H100: the Tucker flagship (K=64, batch 128) does
// about 105 GFLOP per forward over 1.69 GB of f32 weights, some 62 FLOP per
// byte, and the dense layers stream their weights once per block. On f32
// CUDA cores (67 TFLOP/s against 3.35 TB/s) that is bound by arithmetic,
// not by memory. The design answers with a register-tiled FMA loop: one
// block of 256 threads per (fold, 64 output units, 128 batch rows), each
// thread accumulating an 8x4 tile in registers from 16-wide chunks staged
// in shared memory, so every weight element is read once per batch tile.
// The next chunk's operands are loaded into registers while the current
// chunk is contracted, and staging costs one exponential per element.
// Accumulation is f32 FMA, at least as accurate as the TPU's bf16x3 dots.
// Any O >= 1 is taken (the Ko=1 root layers included) and the ragged batch
// edge is masked, with no padding. wgmma, TMA and TF32x3 are left for later.
// The signed squared circuits' TensorDot entries (I = O = 32, B*Kq = 4096
// rows) do 8 FLOP per element read, so there the kernel is bound by memory:
// it reads each (a, s) element about twice (the row max, then the chunk).
//
// Each extern "C" entry selects the given device, launches on the given
// stream and returns cudaGetLastError() of the launch (0 on success).

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cuda_runtime.h>

#include "lse_common.cuh"

namespace {

using cirkit::abs_t;
using cirkit::clamp_max;
using cirkit::fast_exp;
using cirkit::fma_t;
using cirkit::load4;
using cirkit::log_t;
using cirkit::max_t;
using cirkit::staged_exp;
using cirkit::warp_max;

constexpr int BM = 128;  // batch rows per block
constexpr int BN = 64;   // output units per block
constexpr int BK = 16;   // contraction chunk staged in shared memory
constexpr int TM = 8;    // batch rows per thread
constexpr int TN = 4;    // output units per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int WARPS = THREADS / 32;
constexpr int AS = BM + 4;  // padded strides keep 16-byte reads aligned
constexpr int BS = BN + 4;

// T is float or double; the double instances hold twice the registers for
// their accumulators, so one block of them is resident on an SM, not two.
template <typename T, bool TUCKER, bool SOFTMAX, bool SIGNED>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? 2 : 1)
lse_fwd(const T* __restrict__ xa,  // dense: x (F,B,I); tucker: x1 (F,B,K1)
        const T* __restrict__ xb,  // tucker: x2 (F,B,K2); dense: unused
        const T* __restrict__ w,   // w or theta (F,O,I), I = K1*K2 for tucker
        T* __restrict__ out,       // (F,B,O); signed: log|y|
        const T* __restrict__ sa,  // signed: the sign of xa; else unused
        const T* __restrict__ sb,  // signed tucker: the sign of xb
        T* __restrict__ out_sign,  // signed: sign(y) (F,B,O)
        int B, int I, int K1, int K2, int O) {
  __shared__ __align__(16) T As[BK][AS];  // exponentials, k-major
  __shared__ __align__(16) T Bs[BK][BS];  // weights, k-major
  __shared__ T ma[BM];   // shift of x (x1 for tucker)
  __shared__ T mb[BM];   // shift of x2 (tucker)
  __shared__ T mw[BN];   // softmax: row max of theta
  __shared__ T lsw[BN];  // softmax: log of the row sum of exp(theta - mw)

  const int f = blockIdx.x;
  const int o0 = blockIdx.y * BN;
  const int b0 = blockIdx.z * BM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int KA = TUCKER ? K1 : I;
  const T* xaf = xa + (size_t)f * B * KA;
  const T* xbf = TUCKER ? xb + (size_t)f * B * K2 : nullptr;
  const T* saf = SIGNED ? sa + (size_t)f * B * KA : nullptr;
  const T* sbf = SIGNED && TUCKER ? sb + (size_t)f * B * K2 : nullptr;
  const T* wf = w + (size_t)f * O * I;
  T* outf = out + (size_t)f * B * O;

  // Prologue: the clamped row max of every batch row of this tile.
  for (int r = warp; r < BM; r += WARPS) {
    const int b = b0 + r;
    T m1 = -INFINITY, m2 = -INFINITY;
    if (b < B) {
      for (int k = lane; k < KA; k += 32) m1 = max_t(m1, xaf[(size_t)b * KA + k]);
      if (TUCKER)
        for (int k = lane; k < K2; k += 32) m2 = max_t(m2, xbf[(size_t)b * K2 + k]);
    }
    m1 = warp_max(m1);
    m2 = warp_max(m2);
    if (lane == 0) {
      ma[r] = clamp_max(m1);
      mb[r] = clamp_max(m2);
    }
  }
  // Prologue: the max and log-sum of every softmax row of this tile, in one
  // pass (a running max that rescales the running sum).
  if (SOFTMAX) {
    for (int r = warp; r < BN; r += WARPS) {
      const int o = o0 + r;
      T m = T(0), s = T(0);
      if (o < O) cirkit::softmax_row_stats(wf + (size_t)o * I, I, lane, &m, &s);
      if (lane == 0) {
        mw[r] = m;  // units past O stage exp(-inf) = 0
        lsw[r] = log_t(s);
      }
    }
  }
  __syncthreads();

  // Staging map: thread tid stages contraction index kk = tid % BK of each
  // chunk, for the rows (batch rows of A, output units of W) tid / BK + n *
  // (THREADS / BK). Neighbouring threads read neighbouring k.
  const int skk = tid % BK;
  const int srow = tid / BK;
  constexpr int RSTEP = THREADS / BK;
  constexpr int A_PER = BM / RSTEP;
  constexpr int W_PER = BN / RSTEP;
  const float inv_k2 = TUCKER ? 1.f / (float)K2 : 0.f;

  // The next chunk's operands, loaded into registers while the current
  // chunk is contracted: the exponent of each A element (and its sign) and
  // the raw W.
  T pa[A_PER], ps[A_PER], pw[W_PER];
  auto load_chunk = [&](int k0) {
    const int k = k0 + skk;
    int i = 0, j = 0;
    if (TUCKER) {  // k = i * K2 + j, without an integer division
      i = __float2int_rz((float)k * inv_k2);
      j = k - i * K2;
      if (j < 0) {
        --i;
        j += K2;
      } else if (j >= K2) {
        ++i;
        j -= K2;
      }
    }
#pragma unroll
    for (int n = 0; n < A_PER; ++n) {
      const int r = srow + n * RSTEP;
      const int b = b0 + r;
      T v = -INFINITY, sg = T(0);
      if (b < B && k < I) {
        v = TUCKER ? (xaf[(size_t)b * K1 + i] - ma[r]) + (xbf[(size_t)b * K2 + j] - mb[r])
                   : xaf[(size_t)b * I + k] - ma[r];
        if (SIGNED)
          sg = TUCKER ? saf[(size_t)b * K1 + i] * sbf[(size_t)b * K2 + j]
                      : saf[(size_t)b * I + k];
      }
      pa[n] = v;
      if (SIGNED) ps[n] = sg;
    }
#pragma unroll
    for (int n = 0; n < W_PER; ++n) {
      const int c = srow + n * RSTEP;
      const int o = o0 + c;
      pw[n] = (o < O && k < I) ? wf[(size_t)o * I + k] : T(SOFTMAX ? -INFINITY : 0.f);
    }
  };

  const int tx = tid % (BN / TN);  // output-unit group
  const int ty = tid / (BN / TN);  // batch-row group
  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  load_chunk(0);
  for (int k0 = 0; k0 < I; k0 += BK) {
    // Stage this chunk: the shifted exponentials (for tucker the outer
    // product e1[b,i] * e2[b,j], formed one chunk at a time) and the
    // weights (unnormalized softmax numerators).
#pragma unroll
    for (int n = 0; n < A_PER; ++n)
      As[skk][srow + n * RSTEP] = SIGNED ? ps[n] * staged_exp<true>(pa[n]) : fast_exp(pa[n]);
#pragma unroll
    for (int n = 0; n < W_PER; ++n) {
      const int c = srow + n * RSTEP;
      Bs[skk][c] = SOFTMAX ? staged_exp<SIGNED>(pw[n] - mw[c]) : pw[n];
    }
    __syncthreads();
    if (k0 + BK < I) load_chunk(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[TM], bb[TN];
      load4(&As[kk][ty * TM], a);
      load4(&As[kk][ty * TM + 4], a + 4);
      load4(&Bs[kk][tx * TN], bb);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma_t(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: back to log space, masking the ragged batch and unit edges.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    const int b = b0 + r;
    if (b >= B) continue;
    const T shift = TUCKER ? ma[r] + mb[r] : ma[r];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx * TN + j;
      const int o = o0 + c;
      if (o >= O) continue;
      const T v = acc[i][j];
      T y = log_t(SIGNED ? abs_t(v) : v);
      if (SOFTMAX) y -= lsw[c];
      outf[(size_t)b * O + o] = y + shift;
      if (SIGNED) out_sign[(size_t)f * B * O + (size_t)b * O + o] = T((v > T(0)) - (v < T(0)));
    }
  }
}

template <typename T, bool TUCKER, bool SOFTMAX, bool SIGNED = false>
int launch(const T* xa, const T* xb, const T* w, T* out, int F, int B, int I, int K1, int K2,
           int O, int device, void* stream, const T* sa = nullptr, const T* sb = nullptr,
           T* out_sign = nullptr) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(F, (O + BN - 1) / BN, (B + BM - 1) / BM);
  lse_fwd<T, TUCKER, SOFTMAX, SIGNED><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      xa, xb, w, out, sa, sb, out_sign, B, I, K1, K2, O);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* cirkit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Every entry exists for float (the plain name) and for double (the name with
// _f64). The signed entries take (log-magnitude, sign) inputs and write
// (log|y|, sign y).
#define LSE_FWD_ENTRIES(SUFFIX, T)                                                              \
  int lse_fwd_dense##SUFFIX(const T* x, const T* w, T* out, int F, int B, int I, int O,         \
                            int device, void* stream) {                                         \
    return launch<T, false, false>(x, nullptr, w, out, F, B, I, 0, 1, O, device, stream);       \
  }                                                                                             \
  int lse_fwd_dense_softmax##SUFFIX(const T* x, const T* theta, T* out, int F, int B, int I,    \
                                    int O, int device, void* stream) {                          \
    return launch<T, false, true>(x, nullptr, theta, out, F, B, I, 0, 1, O, device, stream);    \
  }                                                                                             \
  int lse_fwd_tucker##SUFFIX(const T* x1, const T* x2, const T* w, T* out, int F, int B,        \
                             int K1, int K2, int O, int device, void* stream) {                 \
    return launch<T, true, false>(x1, x2, w, out, F, B, K1 * K2, K1, K2, O, device, stream);    \
  }                                                                                             \
  int lse_fwd_tucker_softmax##SUFFIX(const T* x1, const T* x2, const T* theta, T* out, int F,   \
                                     int B, int K1, int K2, int O, int device, void* stream) {  \
    return launch<T, true, true>(x1, x2, theta, out, F, B, K1 * K2, K1, K2, O, device,          \
                                 stream);                                                       \
  }                                                                                             \
  int slse_fwd_dense##SUFFIX(const T* a, const T* s, const T* w, T* oa, T* os, int F, int B,    \
                             int I, int O, int device, void* stream) {                          \
    return launch<T, false, false, true>(a, nullptr, w, oa, F, B, I, 0, 1, O, device, stream,   \
                                         s, nullptr, os);                                       \
  }                                                                                             \
  int slse_fwd_dense_softmax##SUFFIX(const T* a, const T* s, const T* theta, T* oa, T* os,      \
                                     int F, int B, int I, int O, int device, void* stream) {    \
    return launch<T, false, true, true>(a, nullptr, theta, oa, F, B, I, 0, 1, O, device,        \
                                        stream, s, nullptr, os);                                \
  }                                                                                             \
  int slse_fwd_tucker##SUFFIX(const T* a1, const T* s1, const T* a2, const T* s2, const T* w,   \
                              T* oa, T* os, int F, int B, int K1, int K2, int O, int device,    \
                              void* stream) {                                                   \
    return launch<T, true, false, true>(a1, a2, w, oa, F, B, K1 * K2, K1, K2, O, device,        \
                                        stream, s1, s2, os);                                    \
  }                                                                                             \
  int slse_fwd_tucker_softmax##SUFFIX(const T* a1, const T* s1, const T* a2, const T* s2,       \
                                      const T* theta, T* oa, T* os, int F, int B, int K1,       \
                                      int K2, int O, int device, void* stream) {                \
    return launch<T, true, true, true>(a1, a2, theta, oa, F, B, K1 * K2, K1, K2, O, device,     \
                                       stream, s1, s2, os);                                     \
  }

LSE_FWD_ENTRIES(, float)
LSE_FWD_ENTRIES(_f64, double)
#undef LSE_FWD_ENTRIES

}  // extern "C"
