// Fused log-einsum-exp forward for Hopper (sm_90a): the folded sum-layer
// contraction of the lse-sum semiring, dense or arity-2 Tucker, with an
// optional softmax of the weight rows.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// cirkit_tpu/ops/lse_einsum.py (dispatched by `_call_fwd`), in its four
// configurations. Per fold f, with m the clamped row max of each input:
//
//   dense:   out[b,o] = log sum_i exp(x[b,i] - m[b]) * w[o,i] + m[b]
//   tucker:  out[b,o] = log sum_{i,j} e1[b,i] * e2[b,j] * w[o,i*K2+j]
//                       + m1[b] + m2[b],     e_h = exp(x_h - m_h)
//   softmax: w = softmax(theta, axis=-1), computed on the fly from the
//            per-row max and sum of theta; the normalized table is never
//            stored.
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
//
// Each extern "C" entry selects the given device, launches on the given
// stream and returns cudaGetLastError() of the launch (0 on success).

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cuda_runtime.h>

#include "lse_common.cuh"

namespace {

using cirkit::clamp_max;
using cirkit::warp_max;

constexpr int BM = 128;  // batch rows per block
constexpr int BN = 64;   // output units per block
constexpr int BK = 16;   // contraction chunk staged in shared memory
constexpr int TM = 8;    // batch rows per thread
constexpr int TN = 4;    // output units per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int WARPS = THREADS / 32;
constexpr int AS = BM + 4;  // padded strides keep float4 reads aligned
constexpr int BS = BN + 4;

template <bool TUCKER, bool SOFTMAX>
__global__ void __launch_bounds__(THREADS, 2)
lse_fwd(const float* __restrict__ xa,  // dense: x (F,B,I); tucker: x1 (F,B,K1)
        const float* __restrict__ xb,  // tucker: x2 (F,B,K2); dense: unused
        const float* __restrict__ w,   // w or theta (F,O,I), I = K1*K2 for tucker
        float* __restrict__ out,       // (F,B,O)
        int B, int I, int K1, int K2, int O) {
  __shared__ __align__(16) float As[BK][AS];  // exponentials, k-major
  __shared__ __align__(16) float Bs[BK][BS];  // weights, k-major
  __shared__ float ma[BM];   // shift of x (x1 for tucker)
  __shared__ float mb[BM];   // shift of x2 (tucker)
  __shared__ float mw[BN];   // softmax: row max of theta
  __shared__ float lsw[BN];  // softmax: log of the row sum of exp(theta - mw)

  const int f = blockIdx.x;
  const int o0 = blockIdx.y * BN;
  const int b0 = blockIdx.z * BM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int KA = TUCKER ? K1 : I;
  const float* xaf = xa + (size_t)f * B * KA;
  const float* xbf = TUCKER ? xb + (size_t)f * B * K2 : nullptr;
  const float* wf = w + (size_t)f * O * I;
  float* outf = out + (size_t)f * B * O;

  // Prologue: the clamped row max of every batch row of this tile.
  for (int r = warp; r < BM; r += WARPS) {
    const int b = b0 + r;
    float m1 = -INFINITY, m2 = -INFINITY;
    if (b < B) {
      for (int k = lane; k < KA; k += 32) m1 = fmaxf(m1, xaf[(size_t)b * KA + k]);
      if (TUCKER)
        for (int k = lane; k < K2; k += 32) m2 = fmaxf(m2, xbf[(size_t)b * K2 + k]);
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
      float m = 0.f, s = 0.f;
      if (o < O) cirkit::softmax_row_stats(wf + (size_t)o * I, I, lane, &m, &s);
      if (lane == 0) {
        mw[r] = m;  // units past O stage exp(-inf) = 0
        lsw[r] = logf(s);
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
  // chunk is contracted: the exponent of each A element and the raw W.
  float pa[A_PER], pw[W_PER];
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
      float v = -INFINITY;
      if (b < B && k < I) {
        v = TUCKER ? (xaf[(size_t)b * K1 + i] - ma[r]) + (xbf[(size_t)b * K2 + j] - mb[r])
                   : xaf[(size_t)b * I + k] - ma[r];
      }
      pa[n] = v;
    }
#pragma unroll
    for (int n = 0; n < W_PER; ++n) {
      const int c = srow + n * RSTEP;
      const int o = o0 + c;
      pw[n] = (o < O && k < I) ? wf[(size_t)o * I + k] : (SOFTMAX ? -INFINITY : 0.f);
    }
  };

  const int tx = tid % (BN / TN);  // output-unit group
  const int ty = tid / (BN / TN);  // batch-row group
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load_chunk(0);
  for (int k0 = 0; k0 < I; k0 += BK) {
    // Stage this chunk: the shifted exponentials (for tucker the outer
    // product e1[b,i] * e2[b,j], formed one chunk at a time) and the
    // weights (unnormalized softmax numerators).
#pragma unroll
    for (int n = 0; n < A_PER; ++n) As[skk][srow + n * RSTEP] = __expf(pa[n]);
#pragma unroll
    for (int n = 0; n < W_PER; ++n) {
      const int c = srow + n * RSTEP;
      Bs[skk][c] = SOFTMAX ? __expf(pw[n] - mw[c]) : pw[n];
    }
    __syncthreads();
    if (k0 + BK < I) load_chunk(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: back to log space, masking the ragged batch and unit edges.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    const int b = b0 + r;
    if (b >= B) continue;
    const float shift = TUCKER ? ma[r] + mb[r] : ma[r];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx * TN + j;
      const int o = o0 + c;
      if (o >= O) continue;
      float y = logf(acc[i][j]);
      if (SOFTMAX) y -= lsw[c];
      outf[(size_t)b * O + o] = y + shift;
    }
  }
}

template <bool TUCKER, bool SOFTMAX>
int launch(const float* xa, const float* xb, const float* w, float* out, int F, int B,
           int I, int K1, int K2, int O, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(F, (O + BN - 1) / BN, (B + BM - 1) / BM);
  lse_fwd<TUCKER, SOFTMAX><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      xa, xb, w, out, B, I, K1, K2, O);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* cirkit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int lse_fwd_dense(const float* x, const float* w, float* out, int F, int B, int I, int O,
                  int device, void* stream) {
  return launch<false, false>(x, nullptr, w, out, F, B, I, 0, 1, O, device, stream);
}

int lse_fwd_dense_softmax(const float* x, const float* theta, float* out, int F, int B,
                          int I, int O, int device, void* stream) {
  return launch<false, true>(x, nullptr, theta, out, F, B, I, 0, 1, O, device, stream);
}

int lse_fwd_tucker(const float* x1, const float* x2, const float* w, float* out, int F,
                   int B, int K1, int K2, int O, int device, void* stream) {
  return launch<true, false>(x1, x2, w, out, F, B, K1 * K2, K1, K2, O, device, stream);
}

int lse_fwd_tucker_softmax(const float* x1, const float* x2, const float* theta,
                           float* out, int F, int B, int K1, int K2, int O, int device,
                           void* stream) {
  return launch<true, true>(x1, x2, theta, out, F, B, K1 * K2, K1, K2, O, device, stream);
}

}  // extern "C"
