// Complex log-einsum-exp for Hopper (sm_90a), forward and backward: the
// folded sum-layer contraction of the complex log semiring, dense or arity-2
// Tucker, in complex64 and complex128, against complex or real weights.
//
// Replaces the Pallas TPU kernels `_c_fwd_kernel` and `_c_bwd_kernel` of
// cirkit_tpu/ops/lse_einsum.py (dispatched by `_c_call_fwd` / `_c_call_bwd`
// behind `clse_matmul_parts`, the custom VJP `_cfused_p`). A value z = a + ib
// stands for exp(a) (cos b + i sin b). Per fold f, with m the clamped row max
// of the real parts and e = exp(z - m) = exp(a - m) (cos b + i sin b):
//
//   dense:   y[b,o] = sum_i e[b,i] * w[o,i]
//   tucker:  y[b,o] = sum_{i,j} e1[b,i] * e2[b,j] * w[o,i*K2+j]
//   out[b,o] = log|y| + shift + i atan2(Im y, Re y),  shift = m (m1 + m2)
//
// and, with g the cotangent of out as (dL/dRe, dL/dIm) pairs (PyTorch's
// complex cotangent, so every gradient below is plain real calculus on the
// real and imaginary planes):
//
//   gy = g / conj(y) = g * exp(shift - Re out) (cos Im out + i sin Im out),
//        set to 0 where not finite (an exact cancellation y = 0, a row that
//        is all -inf)
//   de = gy @ conj(w)                      (B, I), never stored
//   dense:   dx[b,i]  = conj(e[b,i]) * de[b,i]
//   tucker:  dx1[b,i] = conj(e1[b,i]) * sum_j de[b,i*K2+j] * conj(e2[b,j])
//            dx2[b,j] = conj(e2[b,j]) * sum_i de[b,i*K2+j] * conj(e1[b,i])
//   dw[o,c] = sum_b gy[b,o] * conj(e[b,c])   (its real part for a real w)
//
// The TPU kernel returns (Re y, Im y, m) and leaves the logarithm to XLA
// (Mosaic has no atan2), packs real and imaginary parts along the contraction
// axis and splits every product into bf16 passes; none of that is needed
// here. The logarithm is the forward's epilogue and its VJP the backward's
// first pass, the (B, K1*K2) Tucker outer product is formed chunk by chunk in
// shared memory and never written to device memory, and the products are f32
// (f64) FMAs: a complex multiply-add is 4 of them, 2 against a real weight.
// The exponentials and sincos are the accurate ones: sums of complex terms
// cancel, and a cancellation amplifies each term's error.
//
// What bounds it on the H100: at the squared circuits' TensorDot entries
// (F=144, B*Kq=4096, I=O=32) the 4 FMAs per complex product against 16 bytes
// read put the bytes' time (0.09 ms) just above the FMAs' (0.07 ms); at the
// K=64 Tucker entry (F=784, B=128, K1=K2=O=64) 2.63e10 complex multiply-adds
// bind it to f32 arithmetic (3.1 ms with a complex weight). The design is the
// lse kernels' register-tiled FMA loop on split real and imaginary planes in
// shared memory: a block of 256 threads per 64 x 64 output tile, each thread
// a 4 x 4 complex tile, 16-wide chunks whose operands are loaded into
// registers while the previous chunk is contracted. Every sum runs in an
// order fixed by the code (no atomics). Any O >= 1, any batch and any K1, K2
// are taken, ragged edges masked. wgmma and TMA are left for later.
//
// The launches of one backward call: clse_bwd_prep (row shifts and gy), the
// dx kernel (dense: a de tile per block, times conj(e) in the epilogue;
// Tucker: one block per (fold, 64 batch rows; 32 in complex128) walks K1
// segments in tiles of 64 columns of K2 and folds each de tile into the
// block's dx1 and dx2 accumulators in shared memory, (rows x (K1 + K2 + 2))
// x 2 complex numbers, 133 KB at K1 = K2 = 64; where those do not fit the
// card's 227 KB, from K1 = K2 = 105 in complex64 and 100 in complex128, the
// blocks split K1 and K2, write partial sums and ctucker_split_finish adds
// them in a fixed order), and the dw kernel, whose blocks split the batch
// into chunks and write one plane of partial sums a chunk that sum_partials
// adds in chunk order. A dense layer with I and O at most 32 (the squared
// circuits' TensorDot entries) takes one pass instead, clse_bwd_narrow, whose
// blocks split the batch and keep the row shifts, gy and e on chip, then
// sum_partials. A null dx or dw pointer skips that gradient.
//
// Each extern "C" entry selects the given device, launches on the given
// stream, checks cudaGetLastError() after each launch and returns the first
// error (0 on success). Values are PyTorch's interleaved (re, im) pairs.

#include <cmath>
#include <cstddef>
#include <cuda_runtime.h>

#include "lse_common.cuh"

namespace {

using cirkit::batch_chunks;
using cirkit::GyPlan;
using cirkit::MAX_SMEM;
using cirkit::tucker_split_size;
using cirkit::clamp_max;
using cirkit::exp_t;
using cirkit::fma_t;
using cirkit::log_t;
using cirkit::max_t;
using cirkit::warp_max;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BK = 16;  // contraction chunk staged in shared memory
constexpr int BN = 64;  // columns of a block's tile
constexpr int TN = 4;   // columns per thread
constexpr int BS = BN + 4;  // padded stride keeps 16-byte reads aligned
constexpr int RSTEP = THREADS / BK;  // rows per staging pass, chunk-major operands
constexpr int CSTEP = THREADS / BN;  // chunk rows per staging pass, column-major operands
constexpr int C_PER = BK / CSTEP;    // 4

// ---------------------------------------------------------------------------
// Scalar types: float and double behind one set of names (exp_t, log_t, fma_t,
// max_t, clamp_max and warp_max come from lse_common.cuh)
// ---------------------------------------------------------------------------

template <typename T> struct Cplx;
template <> struct Cplx<float> { using type = float2; };
template <> struct Cplx<double> { using type = double2; };

__device__ __forceinline__ float hypot_t(float x, float y) { return hypotf(x, y); }
__device__ __forceinline__ double hypot_t(double x, double y) { return hypot(x, y); }
__device__ __forceinline__ float atan2_t(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double atan2_t(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ void sincos_t(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void sincos_t(double x, double* s, double* c) { sincos(x, s, c); }

// N (2 or 4) neighbouring values of a shared-memory row, as 16-byte reads
// where the type allows.
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  }
}
template <int N>
__device__ __forceinline__ void load_n(const double* p, double (&v)[N]) {
#pragma unroll
  for (int n = 0; n < N; n += 2) {
    const double2 t = *reinterpret_cast<const double2*>(p + n);
    v[n] = t.x, v[n + 1] = t.y;
  }
}

// The shifted exponential of a staged element from its real exponent and its
// phase: exp(re) (cos im + i sin im); re = -inf gives 0.
template <typename T>
__device__ __forceinline__ void cexp_t(T re, T im, T* er, T* ei) {
  const T mag = exp_t(re);
  T s, c;
  sincos_t(im, &s, &c);
  *er = mag * c;
  *ei = mag * s;
}

// One 16-wide chunk of a block's complex product: acc += a * b for the
// thread's TM x TN tile, a from the rows (ar, ai) and b from (br, bi) of each
// chunk index. A real b (BCPLX false) has no bi; RE_ONLY keeps only the real
// part of the product (the gradient of a real weight).
template <typename T, int TM, int ASTRIDE, bool BCPLX, bool RE_ONLY>
__device__ __forceinline__ void cmac_chunk(const T (*ar)[ASTRIDE], const T (*ai)[ASTRIDE],
                                           const T (*br)[BS], const T (*bi)[BS], int ty, int tx,
                                           T (&accr)[TM][TN], T (&acci)[TM][TN]) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    T a_r[TM], a_i[TM], b_r[TN], b_i[TN];
    load_n<TM>(&ar[kk][ty * TM], a_r);
    load_n<TM>(&ai[kk][ty * TM], a_i);
    load_n<TN>(&br[kk][tx * TN], b_r);
    if (BCPLX) load_n<TN>(&bi[kk][tx * TN], b_i);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        accr[i][j] = fma_t(a_r[i], b_r[j], accr[i][j]);
        if (BCPLX) accr[i][j] = fma_t(-a_i[i], b_i[j], accr[i][j]);
        if (!RE_ONLY) {
          acci[i][j] = fma_t(a_i[i], b_r[j], acci[i][j]);
          if (BCPLX) acci[i][j] = fma_t(a_r[i], b_i[j], acci[i][j]);
        }
      }
  }
}

template <typename T, int TM>
__device__ __forceinline__ void zero_acc(T (&accr)[TM][TN], T (&acci)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) accr[i][j] = acci[i][j] = T(0);
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

namespace fwd {
constexpr int BM = 64;  // batch rows per block
constexpr int TM = 4;
constexpr int AS = BM + 4;
constexpr int A_PER = BM / RSTEP;  // 4
constexpr int W_PER = BN / RSTEP;  // 4
}  // namespace fwd

template <typename T, bool TUCKER, bool WCPLX>
__global__ void __launch_bounds__(THREADS)
clse_fwd_kernel(const void* __restrict__ xa_,  // dense: x (F,B,I); tucker: x1 (F,B,K1)
                const void* __restrict__ xb_,  // tucker: x2 (F,B,K2)
                const void* __restrict__ w_,   // (F,O,I) complex or real, I = K1*K2 for tucker
                void* __restrict__ out_,       // (F,B,O)
                int B, int I, int K1, int K2, int O) {
  using namespace fwd;
  using C = typename Cplx<T>::type;
  __shared__ __align__(16) T Ar[BK][AS];  // Re e, chunk-major
  __shared__ __align__(16) T Ai[BK][AS];  // Im e
  __shared__ __align__(16) T Wr[BK][BS];  // Re w
  __shared__ __align__(16) T Wi[WCPLX ? BK : 1][BS];  // Im w
  __shared__ T ma[BM];  // shift of x (x1 for tucker)
  __shared__ T mb[BM];  // shift of x2 (tucker)

  const int f = blockIdx.x;
  const int o0 = blockIdx.y * BN;
  const int b0 = blockIdx.z * BM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int KA = TUCKER ? K1 : I;
  const C* xaf = static_cast<const C*>(xa_) + (size_t)f * B * KA;
  const C* xbf = TUCKER ? static_cast<const C*>(xb_) + (size_t)f * B * K2 : nullptr;
  const C* wcf = WCPLX ? static_cast<const C*>(w_) + (size_t)f * O * I : nullptr;
  const T* wrf = WCPLX ? nullptr : static_cast<const T*>(w_) + (size_t)f * O * I;
  C* outf = static_cast<C*>(out_) + (size_t)f * B * O;

  // Prologue: the clamped max of the real parts of every batch row of the tile.
  for (int r = warp; r < BM; r += WARPS) {
    const int b = b0 + r;
    T m1 = -INFINITY, m2 = -INFINITY;
    if (b < B) {
      for (int k = lane; k < KA; k += 32) m1 = max_t(m1, xaf[(size_t)b * KA + k].x);
      if (TUCKER)
        for (int k = lane; k < K2; k += 32) m2 = max_t(m2, xbf[(size_t)b * K2 + k].x);
    }
    m1 = warp_max(m1);
    m2 = warp_max(m2);
    if (lane == 0) {
      ma[r] = clamp_max(m1);
      mb[r] = clamp_max(m2);
    }
  }
  __syncthreads();

  // Staging map: thread tid stages contraction index tid % BK of each chunk,
  // for the rows (batch rows of e, output units of w) tid / BK + n * RSTEP.
  const int skk = tid % BK;
  const int srow = tid / BK;
  // The next chunk's operands: each e element's real exponent and phase, and w.
  T pre[A_PER], pim[A_PER], pwr[W_PER], pwi[W_PER];
  auto load_chunk = [&](int k0) {
    const int k = k0 + skk;
    const int i = TUCKER ? k / K2 : 0;
    const int j = TUCKER ? k - i * K2 : 0;
#pragma unroll
    for (int n = 0; n < A_PER; ++n) {
      const int r = srow + n * RSTEP;
      const int b = b0 + r;
      T re = -INFINITY, im = T(0);
      if (b < B && k < I) {
        if (TUCKER) {
          const C v1 = xaf[(size_t)b * K1 + i], v2 = xbf[(size_t)b * K2 + j];
          re = (v1.x - ma[r]) + (v2.x - mb[r]);
          im = v1.y + v2.y;
        } else {
          const C v = xaf[(size_t)b * I + k];
          re = v.x - ma[r];
          im = v.y;
        }
      }
      pre[n] = re;
      pim[n] = im;
    }
#pragma unroll
    for (int n = 0; n < W_PER; ++n) {
      const int o = o0 + srow + n * RSTEP;
      T wr = T(0), wi = T(0);
      if (o < O && k < I) {
        if (WCPLX) {
          const C v = wcf[(size_t)o * I + k];
          wr = v.x, wi = v.y;
        } else {
          wr = wrf[(size_t)o * I + k];
        }
      }
      pwr[n] = wr;
      pwi[n] = wi;
    }
  };

  const int tx = tid % (BN / TN);  // output-unit group
  const int ty = tid / (BN / TN);  // batch-row group
  T accr[TM][TN], acci[TM][TN];
  zero_acc<T, TM>(accr, acci);

  load_chunk(0);
  for (int k0 = 0; k0 < I; k0 += BK) {
#pragma unroll
    for (int n = 0; n < A_PER; ++n)
      cexp_t(pre[n], pim[n], &Ar[skk][srow + n * RSTEP], &Ai[skk][srow + n * RSTEP]);
#pragma unroll
    for (int n = 0; n < W_PER; ++n) {
      Wr[skk][srow + n * RSTEP] = pwr[n];
      if (WCPLX) Wi[skk][srow + n * RSTEP] = pwi[n];
    }
    __syncthreads();
    if (k0 + BK < I) load_chunk(k0 + BK);
    cmac_chunk<T, TM, AS, WCPLX, false>(Ar, Ai, Wr, Wi, ty, tx, accr, acci);
    __syncthreads();
  }

  // Epilogue: the complex logarithm, masking the ragged batch and unit edges.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    const int b = b0 + r;
    if (b >= B) continue;
    const T shift = TUCKER ? ma[r] + mb[r] : ma[r];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = o0 + tx * TN + j;
      if (o >= O) continue;
      C v;
      v.x = log_t(hypot_t(accr[i][j], acci[i][j])) + shift;
      v.y = atan2_t(acci[i][j], accr[i][j]);
      outf[(size_t)b * O + o] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward 1: row shifts and gy = g / conj(y)
// ---------------------------------------------------------------------------

template <typename T, bool TUCKER>
__global__ void __launch_bounds__(THREADS)
clse_bwd_prep(const void* __restrict__ xa_, const void* __restrict__ xb_,
              const void* __restrict__ out_, const void* __restrict__ g_,
              T* __restrict__ sa, T* __restrict__ sb, void* __restrict__ gy_,
              int B, int KA, int K2, int O) {
  using C = typename Cplx<T>::type;
  const C* xa = static_cast<const C*>(xa_);
  const C* xb = static_cast<const C*>(xb_);
  const C* out = static_cast<const C*>(out_);
  const C* g = static_cast<const C*>(g_);
  C* gy = static_cast<C*>(gy_);
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // warp-uniform
  const size_t row = (size_t)blockIdx.x * B + b;
  T m1 = -INFINITY, m2 = -INFINITY;
  for (int k = lane; k < KA; k += 32) m1 = max_t(m1, xa[row * KA + k].x);
  if (TUCKER)
    for (int k = lane; k < K2; k += 32) m2 = max_t(m2, xb[row * K2 + k].x);
  m1 = clamp_max(warp_max(m1));
  m2 = clamp_max(warp_max(m2));
  if (lane == 0) {
    sa[row] = m1;
    if (TUCKER) sb[row] = m2;
  }
  const T shift = TUCKER ? m1 + m2 : m1;
  for (int o = lane; o < O; o += 32) {
    const size_t idx = row * O + o;
    const C ov = out[idx], gv = g[idx];
    T ur, ui;  // 1 / conj(y)
    cexp_t(shift - ov.x, ov.y, &ur, &ui);
    C v;
    v.x = gv.x * ur - gv.y * ui;
    v.y = gv.x * ui + gv.y * ur;
    if (!(isfinite(v.x) && isfinite(v.y))) v.x = v.y = T(0);
    gy[idx] = v;
  }
}

// One chunk of gy (rows b0.., units o0..o0+BK) into registers, chunk-major
// staging: thread tid takes unit tid % BK and the rows tid / BK + n * RSTEP.
template <typename T, int PER>
__device__ __forceinline__ void load_gy(const typename Cplx<T>::type* gyf, int b0, int o0, int B,
                                        int O, int tid, T (&pr)[PER], T (&pi)[PER]) {
  const int o = o0 + tid % BK;
#pragma unroll
  for (int n = 0; n < PER; ++n) {
    const int b = b0 + tid / BK + n * RSTEP;
    T r = T(0), i = T(0);
    if (b < B && o < O) {
      const typename Cplx<T>::type v = gyf[(size_t)b * O + o];
      r = v.x, i = v.y;
    }
    pr[n] = r;
    pi[n] = i;
  }
}

// ---------------------------------------------------------------------------
// Backward 2a. dx, dense: dx = conj(e) * (gy @ conj(w))
// ---------------------------------------------------------------------------

template <typename T, bool WCPLX>
__global__ void __launch_bounds__(THREADS)
clse_bwd_dx_dense(const void* __restrict__ x_, const void* __restrict__ w_,
                  const T* __restrict__ sa, const void* __restrict__ gy_,
                  void* __restrict__ dx_, int B, int I, int O) {
  using namespace fwd;  // the forward's 64 x 64 tile, columns of I for units
  using C = typename Cplx<T>::type;
  __shared__ __align__(16) T Ar[BK][AS];  // gy, unit-major
  __shared__ __align__(16) T Ai[BK][AS];
  __shared__ __align__(16) T Wr[BK][BS];  // conj(w), unit-major
  __shared__ __align__(16) T Wi[WCPLX ? BK : 1][BS];

  const int f = blockIdx.x;
  const int i0 = blockIdx.y * BN;
  const int b0 = blockIdx.z * BM;
  const int tid = threadIdx.x;
  const C* gyf = static_cast<const C*>(gy_) + (size_t)f * B * O;
  const C* wcf = WCPLX ? static_cast<const C*>(w_) + (size_t)f * O * I : nullptr;
  const T* wrf = WCPLX ? nullptr : static_cast<const T*>(w_) + (size_t)f * O * I;

  // w staging: column tid % BN, units tid / BN + n * CSTEP.
  const int skk = tid % BK;
  const int srow = tid / BK;
  const int wcol = tid % BN;
  const int wk = tid / BN;
  T par[A_PER], pai[A_PER], pwr[C_PER], pwi[C_PER];
  auto load_chunk = [&](int o0) {
    load_gy<T, A_PER>(gyf, b0, o0, B, O, tid, par, pai);
#pragma unroll
    for (int n = 0; n < C_PER; ++n) {
      const int o = o0 + wk + n * CSTEP;
      const int i = i0 + wcol;
      T wr = T(0), wi = T(0);
      if (o < O && i < I) {
        if (WCPLX) {
          const C v = wcf[(size_t)o * I + i];
          wr = v.x, wi = -v.y;
        } else {
          wr = wrf[(size_t)o * I + i];
        }
      }
      pwr[n] = wr;
      pwi[n] = wi;
    }
  };

  const int tx = tid % (BN / TN);  // column group
  const int ty = tid / (BN / TN);  // batch-row group
  T accr[TM][TN], acci[TM][TN];
  zero_acc<T, TM>(accr, acci);

  load_chunk(0);
  for (int o0 = 0; o0 < O; o0 += BK) {
#pragma unroll
    for (int n = 0; n < A_PER; ++n) {
      Ar[skk][srow + n * RSTEP] = par[n];
      Ai[skk][srow + n * RSTEP] = pai[n];
    }
#pragma unroll
    for (int n = 0; n < C_PER; ++n) {
      Wr[wk + n * CSTEP][wcol] = pwr[n];
      if (WCPLX) Wi[wk + n * CSTEP][wcol] = pwi[n];
    }
    __syncthreads();
    if (o0 + BK < O) load_chunk(o0 + BK);
    cmac_chunk<T, TM, AS, WCPLX, false>(Ar, Ai, Wr, Wi, ty, tx, accr, acci);
    __syncthreads();
  }

  const C* xf = static_cast<const C*>(x_) + (size_t)f * B * I;
  C* dxf = static_cast<C*>(dx_) + (size_t)f * B * I;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = b0 + ty * TM + i;
    if (b >= B) continue;
    const T m = sa[(size_t)f * B + b];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = i0 + tx * TN + j;
      if (c >= I) continue;
      const size_t idx = (size_t)b * I + c;
      const C xv = xf[idx];
      T er, ei;
      cexp_t(xv.x - m, xv.y, &er, &ei);
      C d;  // conj(e) * de
      d.x = er * accr[i][j] + ei * acci[i][j];
      d.y = er * acci[i][j] - ei * accr[i][j];
      dxf[idx] = d;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward 2b. dx, Tucker: de tiles folded into K1-segment and K2-column sums
// ---------------------------------------------------------------------------

template <typename T> struct TuckerDx {
  // batch rows per block: the accumulators of a block stay within the card's
  // shared memory at K1 = K2 = 64 in both types
  static constexpr int BM = sizeof(T) == 4 ? 64 : 32;
  static constexpr int TM = BM / (THREADS / (BN / TN));  // 4 or 2
  static constexpr int AS = BM + 4;
  static constexpr int A_PER = BM / RSTEP;  // 4 or 2
};

// Dynamic shared memory of the Tucker dx kernel, in bytes: e1, e2 and the
// two accumulators, as complex numbers with rows padded by one.
template <typename T>
inline size_t tucker_dx_smem(int K1, int K2) {
  return 2 * sizeof(T) * TuckerDx<T>::BM * (2 * (size_t)(K1 + 1) + 2 * (size_t)(K2 + 1));
}

template <typename T, bool WCPLX>
__global__ void __launch_bounds__(THREADS)
clse_bwd_dx_tucker(const void* __restrict__ x1_, const void* __restrict__ x2_,
                   const void* __restrict__ w_, const T* __restrict__ sa,
                   const T* __restrict__ sb, const void* __restrict__ gy_,
                   void* __restrict__ dx1_, void* __restrict__ dx2_, int B, int K1, int K2,
                   int O) {
  using C = typename Cplx<T>::type;
  constexpr int BM = TuckerDx<T>::BM, TM = TuckerDx<T>::TM, AS = TuckerDx<T>::AS;
  constexpr int A_PER = TuckerDx<T>::A_PER;
  __shared__ __align__(16) T Ar[BK][AS];  // gy, unit-major
  __shared__ __align__(16) T Ai[BK][AS];
  __shared__ __align__(16) T Wr[BK][BS];  // conj(w), unit-major
  __shared__ __align__(16) T Wi[WCPLX ? BK : 1][BS];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int E1S = K1 + 1, E2S = K2 + 1;
  C* E1 = reinterpret_cast<C*>(smem_raw);  // [BM][K1+1] conj(e1) of the block's rows
  C* E2 = E1 + BM * E1S;                   // [BM][K2+1] conj(e2)
  C* A1 = E2 + BM * E2S;                   // [BM][K1+1] sum_j de conj(e2)
  C* A2 = A1 + BM * E1S;                   // [BM][K2+1] sum_i de conj(e1)

  const int f = blockIdx.x;
  const int b0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int I = K1 * K2;
  const C* x1 = static_cast<const C*>(x1_);
  const C* x2 = static_cast<const C*>(x2_);
  const C* gyf = static_cast<const C*>(gy_) + (size_t)f * B * O;
  const C* wcf = WCPLX ? static_cast<const C*>(w_) + (size_t)f * O * I : nullptr;
  const T* wrf = WCPLX ? nullptr : static_cast<const T*>(w_) + (size_t)f * O * I;

  // Prologue: the conjugated exponentials of the block's rows, zeroed sums.
  for (int t = tid; t < BM * K1; t += THREADS) {
    const int r = t / K1, k = t - r * K1;
    const int b = b0 + r;
    C e;
    e.x = e.y = T(0);
    if (b < B) {
      const C v = x1[((size_t)f * B + b) * K1 + k];
      cexp_t(v.x - sa[(size_t)f * B + b], -v.y, &e.x, &e.y);
    }
    E1[r * E1S + k] = e;
    A1[r * E1S + k].x = A1[r * E1S + k].y = T(0);
  }
  for (int t = tid; t < BM * K2; t += THREADS) {
    const int r = t / K2, k = t - r * K2;
    const int b = b0 + r;
    C e;
    e.x = e.y = T(0);
    if (b < B) {
      const C v = x2[((size_t)f * B + b) * K2 + k];
      cexp_t(v.x - sb[(size_t)f * B + b], -v.y, &e.x, &e.y);
    }
    E2[r * E2S + k] = e;
    A2[r * E2S + k].x = A2[r * E2S + k].y = T(0);
  }

  const int skk = tid % BK;
  const int srow = tid / BK;
  const int wcol = tid % BN;
  const int wk = tid / BN;
  // A tile is 64 columns j0.. of one K1 segment i (columns past K2 masked), so
  // every tile folds the same way whatever K2 is.
  const int n_jt = (K2 + BN - 1) / BN;
  const int n_chunks = (O + BK - 1) / BK;
  const int n_steps = K1 * n_jt * n_chunks;
  T par[A_PER], pai[A_PER], pwr[C_PER], pwi[C_PER];
  // One step of the flattened (segment, column tile, unit chunk) loop.
  auto load_chunk = [&](int step) {
    const int tile = step / n_chunks;
    const int o0 = (step - tile * n_chunks) * BK;
    const int i = tile / n_jt;
    const int j = (tile - i * n_jt) * BN + wcol;
    load_gy<T, A_PER>(gyf, b0, o0, B, O, tid, par, pai);
#pragma unroll
    for (int n = 0; n < C_PER; ++n) {
      const int o = o0 + wk + n * CSTEP;
      T wr = T(0), wi = T(0);
      if (o < O && j < K2) {
        const size_t idx = (size_t)o * I + (size_t)i * K2 + j;
        if (WCPLX) {
          const C v = wcf[idx];
          wr = v.x, wi = -v.y;
        } else {
          wr = wrf[idx];
        }
      }
      pwr[n] = wr;
      pwi[n] = wi;
    }
  };

  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  T accr[TM][TN], acci[TM][TN];
  load_chunk(0);
  for (int step = 0; step < n_steps; ++step) {
    const int tile = step / n_chunks;
    const int chunk = step - tile * n_chunks;
    if (chunk == 0) zero_acc<T, TM>(accr, acci);
#pragma unroll
    for (int n = 0; n < A_PER; ++n) {
      Ar[skk][srow + n * RSTEP] = par[n];
      Ai[skk][srow + n * RSTEP] = pai[n];
    }
#pragma unroll
    for (int n = 0; n < C_PER; ++n) {
      Wr[wk + n * CSTEP][wcol] = pwr[n];
      if (WCPLX) Wi[wk + n * CSTEP][wcol] = pwi[n];
    }
    __syncthreads();  // (the first one also orders the prologue's writes)
    if (step + 1 < n_steps) load_chunk(step + 1);
    cmac_chunk<T, TM, AS, WCPLX, false>(Ar, Ai, Wr, Wi, ty, tx, accr, acci);
    __syncthreads();
    if (chunk != n_chunks - 1) continue;

    // Tile epilogue: each thread adds its de values times conj(e1[b,i]) into
    // the dx2 sums of its own columns, and the dx1 sum of a row reduces over
    // the 16 threads that share it by a fixed butterfly.
    const int i = tile / n_jt;
    const int j0 = (tile - i * n_jt) * BN + tx * TN;
#pragma unroll
    for (int ii = 0; ii < TM; ++ii) {
      const int r = ty * TM + ii;
      const C e1 = E1[r * E1S + i];
      T pr = T(0), pi = T(0);
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) {
        const int j = j0 + jj;
        if (j >= K2) continue;
        const T dr = accr[ii][jj], di = acci[ii][jj];
        C* a2 = A2 + r * E2S + j;
        a2->x += dr * e1.x - di * e1.y;
        a2->y += dr * e1.y + di * e1.x;
        const C e2 = E2[r * E2S + j];
        pr += dr * e2.x - di * e2.y;
        pi += dr * e2.y + di * e2.x;
      }
#pragma unroll
      for (int d = BN / TN / 2; d > 0; d >>= 1) {
        pr += __shfl_xor_sync(0xffffffffu, pr, d);
        pi += __shfl_xor_sync(0xffffffffu, pi, d);
      }
      if (tx == 0) {
        A1[r * E1S + i].x += pr;
        A1[r * E1S + i].y += pi;
      }
    }
  }
  __syncthreads();

  // Epilogue: dx1 = conj(e1) * A1, dx2 = conj(e2) * A2 for the block's rows.
  if (dx1_ != nullptr) {
    C* dx1 = static_cast<C*>(dx1_);
    for (int t = tid; t < BM * K1; t += THREADS) {
      const int r = t / K1, k = t - r * K1;
      const int b = b0 + r;
      if (b >= B) continue;
      const C e = E1[r * E1S + k], a = A1[r * E1S + k];
      C d;
      d.x = e.x * a.x - e.y * a.y;
      d.y = e.x * a.y + e.y * a.x;
      dx1[((size_t)f * B + b) * K1 + k] = d;
    }
  }
  if (dx2_ != nullptr) {
    C* dx2 = static_cast<C*>(dx2_);
    for (int t = tid; t < BM * K2; t += THREADS) {
      const int r = t / K2, k = t - r * K2;
      const int b = b0 + r;
      if (b >= B) continue;
      const C e = E2[r * E2S + k], a = A2[r * E2S + k];
      C d;
      d.x = e.x * a.x - e.y * a.y;
      d.y = e.x * a.y + e.y * a.x;
      dx2[((size_t)f * B + b) * K2 + k] = d;
    }
  }
}

// dx, Tucker, split over K1 and K2: one block per (fold and BM batch rows, 64
// columns j of K2, I_PER rows i of K1), for the widths at which the
// accumulators of clse_bwd_dx_tucker (a block's rows x (K1 + K2) complex sums)
// do not fit a block's shared memory. For each of its rows i the block
// contracts the de tile over the units (the loop above), then folds it in
// registers: the dx2 sums sum_i de conj(e1[b,i]) stay in each thread's tile,
// the dx1 sums sum_j de conj(e2[b,j]) (conj(e2) held in registers too) reduce
// over the 16 threads of a row. The block writes both as partials, dx1 over
// its j tile and dx2 over its rows i; ctucker_split_finish adds them in a
// fixed order and multiplies by conj(e).
constexpr int I_PER = 16;  // rows i of K1 per block of the split Tucker dx

template <typename T, bool WCPLX>
__global__ void __launch_bounds__(THREADS)
clse_bwd_dx_tucker_split(const void* __restrict__ x1_, const void* __restrict__ x2_,
                         const void* __restrict__ w_, const T* __restrict__ sa,
                         const T* __restrict__ sb, const void* __restrict__ gy_,
                         void* __restrict__ part1_, void* __restrict__ part2_, int F, int B,
                         int K1, int K2, int O, int n_bt) {
  using C = typename Cplx<T>::type;
  constexpr int BM = TuckerDx<T>::BM, TM = TuckerDx<T>::TM, AS = TuckerDx<T>::AS;
  constexpr int A_PER = TuckerDx<T>::A_PER;
  __shared__ __align__(16) T Ar[BK][AS];  // gy, unit-major
  __shared__ __align__(16) T Ai[BK][AS];
  __shared__ __align__(16) T Wr[BK][BS];  // conj(w), unit-major
  __shared__ __align__(16) T Wi[WCPLX ? BK : 1][BS];
  __shared__ C E1[I_PER][BM];             // conj(e1) of the block's rows i

  const int f = blockIdx.x / n_bt;
  const int b0 = (blockIdx.x - f * n_bt) * BM;
  const int j0 = blockIdx.y * BN;
  const int i0 = blockIdx.z * I_PER;
  const int n_i = min(I_PER, K1 - i0);
  const int I = K1 * K2;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const C* x1 = static_cast<const C*>(x1_);
  const C* x2 = static_cast<const C*>(x2_);
  const C* gyf = static_cast<const C*>(gy_) + (size_t)f * B * O;
  const C* wcf = WCPLX ? static_cast<const C*>(w_) + (size_t)f * O * I : nullptr;
  const T* wrf = WCPLX ? nullptr : static_cast<const T*>(w_) + (size_t)f * O * I;
  C* part1 = static_cast<C*>(part1_);
  C* part2 = static_cast<C*>(part2_);

  for (int e = tid; e < I_PER * BM; e += THREADS) {
    const int il = e / BM, r = e - il * BM, b = b0 + r;
    C v;
    v.x = v.y = T(0);
    if (b < B && il < n_i) {
      const C xv = x1[((size_t)f * B + b) * K1 + i0 + il];
      cexp_t(xv.x - sa[(size_t)f * B + b], -xv.y, &v.x, &v.y);
    }
    E1[il][r] = v;
  }
  T e2r[TM][TN], e2i[TM][TN], a2r[TM][TN], a2i[TM][TN];
#pragma unroll
  for (int ii = 0; ii < TM; ++ii)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int b = b0 + ty * TM + ii, j = j0 + tx * TN + jj;
      T er = T(0), ei = T(0);
      if (b < B && j < K2) {
        const C xv = x2[((size_t)f * B + b) * K2 + j];
        cexp_t(xv.x - sb[(size_t)f * B + b], -xv.y, &er, &ei);
      }
      e2r[ii][jj] = er, e2i[ii][jj] = ei;
      a2r[ii][jj] = a2i[ii][jj] = T(0);
    }

  const int skk = tid % BK, srow = tid / BK;
  const int wcol = tid % BN, wk = tid / BN;
  T par[A_PER], pai[A_PER], pwr[C_PER], pwi[C_PER];
  auto load_chunk = [&](int il, int o0) {
    load_gy<T, A_PER>(gyf, b0, o0, B, O, tid, par, pai);
    const size_t col = (size_t)(i0 + il) * K2 + j0 + wcol;
#pragma unroll
    for (int n = 0; n < C_PER; ++n) {
      const int o = o0 + wk + n * CSTEP;
      T wr = T(0), wi = T(0);
      if (o < O && j0 + wcol < K2) {
        if (WCPLX) {
          const C v = wcf[(size_t)o * I + col];
          wr = v.x, wi = -v.y;
        } else {
          wr = wrf[(size_t)o * I + col];
        }
      }
      pwr[n] = wr;
      pwi[n] = wi;
    }
  };

  T accr[TM][TN], acci[TM][TN];
  const int n_chunks = (O + BK - 1) / BK;
  const int n_steps = n_i * n_chunks;
  load_chunk(0, 0);
  for (int step = 0; step < n_steps; ++step) {
    const int il = step / n_chunks;
    const int chunk = step - il * n_chunks;
    if (chunk == 0) zero_acc<T, TM>(accr, acci);
#pragma unroll
    for (int n = 0; n < A_PER; ++n) {
      Ar[skk][srow + n * RSTEP] = par[n];
      Ai[skk][srow + n * RSTEP] = pai[n];
    }
#pragma unroll
    for (int n = 0; n < C_PER; ++n) {
      Wr[wk + n * CSTEP][wcol] = pwr[n];
      if (WCPLX) Wi[wk + n * CSTEP][wcol] = pwi[n];
    }
    __syncthreads();  // (the first one also orders the prologue's E1)
    if (step + 1 < n_steps) {
      const int nl = (step + 1) / n_chunks;
      load_chunk(nl, (step + 1 - nl * n_chunks) * BK);
    }
    cmac_chunk<T, TM, AS, WCPLX, false>(Ar, Ai, Wr, Wi, ty, tx, accr, acci);
    __syncthreads();
    if (chunk != n_chunks - 1) continue;
#pragma unroll
    for (int ii = 0; ii < TM; ++ii) {
      const int r = ty * TM + ii;
      const C e1 = E1[il][r];
      T pr = T(0), pi = T(0);
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) {
        const T dr = accr[ii][jj], di = acci[ii][jj];
        a2r[ii][jj] += dr * e1.x - di * e1.y;
        a2i[ii][jj] += dr * e1.y + di * e1.x;
        pr += dr * e2r[ii][jj] - di * e2i[ii][jj];
        pi += dr * e2i[ii][jj] + di * e2r[ii][jj];
      }
#pragma unroll
      for (int d = BN / TN / 2; d > 0; d >>= 1) {
        pr += __shfl_xor_sync(0xffffffffu, pr, d);
        pi += __shfl_xor_sync(0xffffffffu, pi, d);
      }
      if (tx == 0 && b0 + r < B) {
        C v;
        v.x = pr, v.y = pi;
        part1[(((size_t)blockIdx.y * F + f) * B + b0 + r) * K1 + i0 + il] = v;
      }
    }
  }

  // part2[it][f][b][j] over this block's rows i
#pragma unroll
  for (int ii = 0; ii < TM; ++ii) {
    const int b = b0 + ty * TM + ii;
    if (b >= B) continue;
    C* dst = part2 + (((size_t)blockIdx.z * F + f) * B + b) * K2;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int j = j0 + tx * TN + jj;
      if (j < K2) {
        C v;
        v.x = a2r[ii][jj], v.y = a2i[ii][jj];
        dst[j] = v;
      }
    }
  }
}

// dx1 = conj(e1) * (sum of the n1 dx1 partials), dx2 = conj(e2) * (sum of
// the n2 dx2 partials), added in partial order; one warp per (fold, row).
template <typename T>
__global__ void __launch_bounds__(THREADS)
ctucker_split_finish(const void* __restrict__ x1_, const void* __restrict__ x2_,
                     const T* __restrict__ sa, const T* __restrict__ sb,
                     const void* __restrict__ part1_, const void* __restrict__ part2_,
                     void* __restrict__ dx1_, void* __restrict__ dx2_, int F, int B, int K1,
                     int K2, int n1, int n2) {
  using C = typename Cplx<T>::type;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;
  const size_t row = (size_t)blockIdx.x * B + b;
  const size_t plane = (size_t)F * B;
  const C* xs[2] = {static_cast<const C*>(x1_), static_cast<const C*>(x2_)};
  const C* parts[2] = {static_cast<const C*>(part1_), static_cast<const C*>(part2_)};
  C* dxs[2] = {static_cast<C*>(dx1_), static_cast<C*>(dx2_)};
  const T shifts[2] = {sa[row], sb[row]};
  const int ks[2] = {K1, K2}, ns[2] = {n1, n2};
  for (int h = 0; h < 2; ++h) {
    if (dxs[h] == nullptr) continue;
    const int K = ks[h];
    for (int k = lane; k < K; k += 32) {
      T sr = T(0), si = T(0);
      for (int p = 0; p < ns[h]; ++p) {
        const C v = parts[h][(p * plane + row) * K + k];
        sr += v.x, si += v.y;
      }
      const C xv = xs[h][row * K + k];
      T er, ei;  // conj(e)
      cexp_t(xv.x - shifts[h], -xv.y, &er, &ei);
      C d;
      d.x = er * sr - ei * si;
      d.y = er * si + ei * sr;
      dxs[h][row * K + k] = d;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward 3. dw = sum_b gy^T conj(e), split over the batch
// ---------------------------------------------------------------------------

// One block per (fold, NI rows i of K1, a chunk of the batch, BJ columns j of
// K2, BO units); dense is K1 = 1, K2 = I with no e1. The block stages BB rows
// of its chunk at a time (gy over its units, conj(e2) over its columns,
// conj(e1) over its rows i: one complex exponential per staged value, not one
// per product) and contracts them for each row i in turn, conj(e2[b, j])
// against gy[b, o] conj(e1[b, i]), each thread a 4-unit x TM-column complex
// tile (its real part alone against a real weight). With one row i the sums
// stay in registers over the whole chunk; with several they go to the output
// tile between staged rows and come back (the same thread writes and reads
// them). A chunk's sums go to its own plane of partials, or straight to dw
// when the batch is one chunk; sum_partials then adds the planes in chunk
// order, so every call gives the same bits with no atomics.
namespace cdw {
constexpr int NI = 8;   // rows i per block (Tucker)
constexpr int BO = 64;  // units per block
constexpr int BJ = 64;  // columns j per block
constexpr int TM = 4;   // columns per thread (TN units)
static_assert((BO / TN) * (BJ / TM) == THREADS, "a thread per 4 x 4 tile");
template <typename T> constexpr int BB = sizeof(T) == 4 ? 64 : 32;  // rows staged at once
template <typename T>
constexpr size_t smem() {
  return 2 * sizeof(T) * ((size_t)BB<T> * (BO + 4) + (size_t)BB<T> * (BJ + 4) + (size_t)NI * BB<T>);
}
}  // namespace cdw


template <typename T, bool TUCKER, bool WCPLX>
__global__ void __launch_bounds__(THREADS)
clse_bwd_dw_part(const void* __restrict__ xa_, const void* __restrict__ xb_,
                 const T* __restrict__ sa, const T* __restrict__ sb,
                 const void* __restrict__ gy_, void* __restrict__ out_, int F, int B, int K1,
                 int K2, int O, int n_it, int n_bc, int rows) {
  using C = typename Cplx<T>::type;
  constexpr int BB = cdw::BB<T>, NI = cdw::NI, BO = cdw::BO, BJ = cdw::BJ, TM = cdw::TM;
  constexpr int NT = THREADS;
  constexpr int GS = BO + 4, ES = BJ + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T(*Gr)[GS] = reinterpret_cast<T(*)[GS]>(smem_raw);  // [BB][GS]: gy
  T(*Gi)[GS] = Gr + BB;
  T(*Er)[ES] = reinterpret_cast<T(*)[ES]>(Gi + BB);    // [BB][ES]: conj(e2)
  T(*Ei)[ES] = Er + BB;
  T* E1r = reinterpret_cast<T*>(Ei + BB);              // [NI][BB]: conj(e1)
  T* E1i = E1r + NI * BB;

  const int I = K1 * K2;
  const int bc = blockIdx.x % n_bc;
  const int fi = blockIdx.x / n_bc;
  const int f = fi / n_it;
  const int i0 = (fi - f * n_it) * NI;
  const int n_i = TUCKER ? min(NI, K1 - i0) : 1;
  const int j0 = blockIdx.y * BJ;
  const int o0 = blockIdx.z * BO;
  const int b_begin = bc * rows, b_end = min(B, b_begin + rows);
  const int tid = threadIdx.x;
  const int tx = tid % (BO / TN), ty = tid / (BO / TN);  // unit group, column group
  const C* xef = static_cast<const C*>(TUCKER ? xb_ : xa_) + (size_t)f * B * K2;
  const T* sef = (TUCKER ? sb : sa) + (size_t)f * B;
  const C* x1f = static_cast<const C*>(xa_) + (size_t)f * B * K1;
  const T* s1f = sa + (size_t)f * B;
  const C* gyf = static_cast<const C*>(gy_) + (size_t)f * B * O;
  const size_t off = ((size_t)bc * F + f) * O * I;
  C* dstc = WCPLX ? static_cast<C*>(out_) + off : nullptr;
  T* dstr = WCPLX ? nullptr : static_cast<T*>(out_) + off;

  auto stage = [&](int b0) {
    const int nb = min(BB, b_end - b0);
#pragma unroll 4
    for (int e = tid; e < BB * BO; e += NT) {
      const int k = e / BO, o = e - k * BO;
      T r = T(0), i = T(0);
      if (k < nb && o0 + o < O) {
        const C v = gyf[(size_t)(b0 + k) * O + o0 + o];
        r = v.x, i = v.y;
      }
      Gr[k][o] = r, Gi[k][o] = i;
    }
#pragma unroll 4
    for (int e = tid; e < BB * BJ; e += NT) {
      const int k = e / BJ, j = e - k * BJ;
      T r = T(0), i = T(0);
      if (k < nb && j0 + j < K2) {
        const C v = xef[(size_t)(b0 + k) * K2 + j0 + j];
        cexp_t(v.x - sef[b0 + k], -v.y, &r, &i);
      }
      Er[k][j] = r, Ei[k][j] = i;
    }
    if (TUCKER)
      for (int e = tid; e < NI * BB; e += NT) {
        const int il = e / BB, k = e - il * BB;
        T r = T(0), i = T(0);
        if (k < nb && il < n_i) {
          const C v = x1f[(size_t)(b0 + k) * K1 + i0 + il];
          cexp_t(v.x - s1f[b0 + k], -v.y, &r, &i);
        }
        E1r[e] = r, E1i[e] = i;
      }
  };

  T accr[TN][TM], acci[TN][TM];
  auto zero = [&]() {
#pragma unroll
    for (int n = 0; n < TN; ++n)
#pragma unroll
      for (int m = 0; m < TM; ++m) accr[n][m] = acci[n][m] = T(0);
  };
  // the thread's tile of the output row il: fn(offset, unit n, column m)
  auto tile = [&](int il, auto&& fn) {
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int o = o0 + tx * TN + n;
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const int j = j0 + ty * TM + m;
        if (o < O && j < K2) fn((size_t)o * I + (size_t)(i0 + il) * K2 + j, n, m);
      }
    }
  };
  zero();
  for (int b0 = b_begin; b0 < b_end; b0 += BB) {
    __syncthreads();  // the previous rows' contraction is done with the tiles
    stage(b0);
    __syncthreads();
    const int nk = (min(BB, b_end - b0) + 3) & ~3;  // rows past the chunk staged as 0
    const bool first = b0 == b_begin, last = b0 + BB >= b_end;
    for (int il = 0; il < n_i; ++il) {
      if (n_i > 1) {
        if (first) {
          zero();
        } else if (WCPLX) {
          tile(il, [&](size_t p, int n, int m) { accr[n][m] = dstc[p].x, acci[n][m] = dstc[p].y; });
        } else {
          tile(il, [&](size_t p, int n, int m) { accr[n][m] = dstr[p]; });
        }
      }
#pragma unroll 4
      for (int k = 0; k < nk; ++k) {
        T ar[TN], ai[TN], br[TM], bi[TM];
        load_n<TN>(&Gr[k][tx * TN], ar);
        load_n<TN>(&Gi[k][tx * TN], ai);
        if (TUCKER) {  // gy conj(e1)
          const T cr = E1r[il * BB + k], ci = E1i[il * BB + k];
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            const T r = ar[n] * cr - ai[n] * ci;
            ai[n] = ar[n] * ci + ai[n] * cr;
            ar[n] = r;
          }
        }
        load_n<TM>(&Er[k][ty * TM], br);
        load_n<TM>(&Ei[k][ty * TM], bi);
#pragma unroll
        for (int n = 0; n < TN; ++n)
#pragma unroll
          for (int m = 0; m < TM; ++m) {
            accr[n][m] = fma_t(ar[n], br[m], accr[n][m]);
            accr[n][m] = fma_t(-ai[n], bi[m], accr[n][m]);
            if (WCPLX) {
              acci[n][m] = fma_t(ai[n], br[m], acci[n][m]);
              acci[n][m] = fma_t(ar[n], bi[m], acci[n][m]);
            }
          }
      }
      if (n_i > 1 || last) {
        if (WCPLX) {
          tile(il, [&](size_t p, int n, int m) {
            C v;
            v.x = accr[n][m], v.y = acci[n][m];
            dstc[p] = v;
          });
        } else {
          tile(il, [&](size_t p, int n, int m) { dstr[p] = accr[n][m]; });
        }
      }
    }
  }
}

// The whole complex backward of a narrow dense layer (I, O <= 32: the squared
// circuits' TensorDot entries) in one pass over its rows: one block per (fold,
// chunk of the batch) stages conj(w) once, then takes RT rows at a time, each
// row held by TPR threads of V neighbouring columns: it reads x, out and g
// once (the next rows' while the current ones are contracted), takes the
// row's clamped max of Re x by shuffles, forms conj(e) = exp(conj(x) - m) and
// gy = g / conj(y) (zeroed where not finite) in registers, writes dx =
// conj(e) (gy @ conj(w)) for its columns, and adds gy^T conj(e) into the
// block's dw tile (a thread's 4 columns of one unit; the real part alone
// against a real weight). No row shift, gy or e reaches device memory. The
// chunk's dw goes to its plane of partials (sum_partials adds them in chunk
// order) or straight to dw when the batch is one chunk.
namespace narrow {
constexpr int W = 32;  // the widest I and O
template <typename T> constexpr int V = sizeof(T) == 4 ? 4 : 2;  // columns a thread of a row
template <typename T> constexpr int TPR = W / V<T>;               // threads a row
template <typename T> constexpr int RT = THREADS / TPR<T>;        // rows a pass
}  // namespace narrow

template <typename T, bool WCPLX>
__global__ void __launch_bounds__(THREADS, 2)
clse_bwd_narrow(const void* __restrict__ x_, const void* __restrict__ w_,
                const void* __restrict__ out_, const void* __restrict__ g_,
                void* __restrict__ dx_, void* __restrict__ dw_, int F, int B, int I, int O,
                int n_bc, int rows) {
  using C = typename Cplx<T>::type;
  using narrow::W;
  constexpr int V = narrow::V<T>, TPR = narrow::TPR<T>, RT = narrow::RT<T>;
  __shared__ __align__(16) T Wr[W][W + 4];  // conj(w)[o][i], 0 outside O x I
  __shared__ __align__(16) T Wi[WCPLX ? W : 1][W + 4];
  __shared__ __align__(16) T Er[RT][W + 4];  // conj(e) of the pass's rows
  __shared__ __align__(16) T Ei[RT][W + 4];
  __shared__ T Gr[RT][W + 1];                // gy of the pass's rows
  __shared__ T Gi[RT][W + 1];

  const int f = blockIdx.x / n_bc, bc = blockIdx.x - f * n_bc;
  const int b_begin = bc * rows, b_end = min(B, b_begin + rows);
  const int tid = threadIdx.x;
  const int r = tid / TPR, c0 = (tid % TPR) * V;         // row of the pass, first column
  const int wo = tid / (W / 4), wi = (tid % (W / 4)) * 4;  // the thread's dw tile
  const C* x = static_cast<const C*>(x_) + (size_t)f * B * I;
  const C* out = static_cast<const C*>(out_) + (size_t)f * B * O;
  const C* g = static_cast<const C*>(g_) + (size_t)f * B * O;
  for (int e = tid; e < W * W; e += THREADS) {
    const int o = e / W, i = e - o * W;
    T wr = T(0), wi_ = T(0);
    if (o < O && i < I) {
      const size_t idx = ((size_t)f * O + o) * I + i;
      if (WCPLX) {
        const C v = static_cast<const C*>(w_)[idx];
        wr = v.x, wi_ = -v.y;
      } else {
        wr = static_cast<const T*>(w_)[idx];
      }
    }
    Wr[o][i] = wr;
    if (WCPLX) Wi[o][i] = wi_;
  }
  // the pass's raw values: x over the row's V columns of I, out and g over
  // its V columns of O
  C px[V], po[V], pg[V];
  auto load = [&](int b0) {
    const int b = b0 + r;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = c0 + v;
      C xv, ov, gv;
      xv.x = -INFINITY, xv.y = T(0);
      ov.x = ov.y = gv.x = gv.y = T(0);
      if (b < b_end && c < I) xv = x[(size_t)b * I + c];
      if (b < b_end && c < O) {
        ov = out[(size_t)b * O + c];
        gv = g[(size_t)b * O + c];
      }
      px[v] = xv, po[v] = ov, pg[v] = gv;
    }
  };
  T dwr[4] = {T(0), T(0), T(0), T(0)}, dwi[4] = {T(0), T(0), T(0), T(0)};
  load(b_begin);
  for (int b0 = b_begin; b0 < b_end; b0 += RT) {
    T m = -INFINITY;
#pragma unroll
    for (int v = 0; v < V; ++v) m = max_t(m, px[v].x);
#pragma unroll
    for (int d = TPR / 2; d > 0; d >>= 1) m = max_t(m, __shfl_xor_sync(0xffffffffu, m, d));
    m = clamp_max(m);
    T cr[V], ci[V];  // conj(e)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      cexp_t(px[v].x - m, -px[v].y, &cr[v], &ci[v]);
      Er[r][c0 + v] = cr[v], Ei[r][c0 + v] = ci[v];
      T ur, ui;  // 1 / conj(y)
      cexp_t(m - po[v].x, po[v].y, &ur, &ui);
      T gr = pg[v].x * ur - pg[v].y * ui, gi = pg[v].x * ui + pg[v].y * ur;
      if (!(isfinite(gr) && isfinite(gi))) gr = gi = T(0);
      Gr[r][c0 + v] = gr, Gi[r][c0 + v] = gi;  // (after the previous pass's barrier)
    }
    __syncthreads();
    const int b = b0 + r;
    if (b0 + RT < b_end) load(b0 + RT);
    if (dx_ != nullptr) {
      T ar[V], ai[V];  // de = gy @ conj(w)
#pragma unroll
      for (int v = 0; v < V; ++v) ar[v] = ai[v] = T(0);
#pragma unroll 8
      for (int o = 0; o < W; ++o) {
        const T gr = Gr[r][o], gi = Gi[r][o];
        T br[V], bi[V];
        load_n<V>(&Wr[o][c0], br);
        if (WCPLX) load_n<V>(&Wi[o][c0], bi);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          ar[v] = fma_t(gr, br[v], ar[v]);
          ai[v] = fma_t(gi, br[v], ai[v]);
          if (WCPLX) {
            ar[v] = fma_t(-gi, bi[v], ar[v]);
            ai[v] = fma_t(gr, bi[v], ai[v]);
          }
        }
      }
      if (b < b_end) {
        C* drow = static_cast<C*>(dx_) + (size_t)f * B * I + (size_t)b * I;
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (c0 + v < I) {
            C d;  // conj(e) * de
            d.x = cr[v] * ar[v] - ci[v] * ai[v];
            d.y = cr[v] * ai[v] + ci[v] * ar[v];
            drow[c0 + v] = d;
          }
      }
    }
    if (dw_ != nullptr)
#pragma unroll 8
      for (int rr = 0; rr < RT; ++rr) {
        const T gr = Gr[rr][wo], gi = Gi[rr][wo];
        T er[4], ei[4];
        load_n<4>(&Er[rr][wi], er);
        load_n<4>(&Ei[rr][wi], ei);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dwr[j] = fma_t(gr, er[j], dwr[j]);
          dwr[j] = fma_t(-gi, ei[j], dwr[j]);
          if (WCPLX) {
            dwi[j] = fma_t(gr, ei[j], dwi[j]);
            dwi[j] = fma_t(gi, er[j], dwi[j]);
          }
        }
      }
    __syncthreads();  // the pass's tiles are read before the next one rewrites them
  }
  if (dw_ != nullptr && wo < O) {
    const size_t row = (((size_t)bc * F + f) * O + wo) * I;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (wi + j >= I) continue;
      if (WCPLX) {
        C v;
        v.x = dwr[j], v.y = dwi[j];
        static_cast<C*>(dw_)[row + wi + j] = v;
      } else {
        static_cast<T*>(dw_)[row + wi + j] = dwr[j];
      }
    }
  }
}


// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

inline unsigned cdiv(int a, int b) { return static_cast<unsigned>((a + b - 1) / b); }

template <typename T, bool TUCKER, bool WCPLX>
int launch_fwd(const void* xa, const void* xb, const void* w, void* out, int F, int B, int I,
               int K1, int K2, int O, cudaStream_t s) {
  const dim3 grid(F, cdiv(O, BN), cdiv(B, fwd::BM));
  clse_fwd_kernel<T, TUCKER, WCPLX><<<grid, THREADS, 0, s>>>(xa, xb, w, out, B, I, K1, K2, O);
  return static_cast<int>(cudaGetLastError());
}

// Whether a block of clse_bwd_dx_tucker (its accumulators and the static
// staging tiles) fits the card's shared memory; wider layers take the K1
// split.
template <typename T>
inline bool tucker_dx_fits(int K1, int K2) {
  return tucker_dx_smem<T>(K1, K2) + sizeof(T) * BK * 2 * (TuckerDx<T>::AS + BS) <= MAX_SMEM;
}

// The gy scratch, in complex values (GyPlan's layout): the narrow route is
// clse_bwd_narrow's, a real weight's dw partials are real (two to a complex
// value), and the K1 split is taken at widths past tucker_dx_fits.
template <typename T>
inline GyPlan gy_plan(bool tucker, bool w_complex, int F, int B, int K1, int K2, int O) {
  GyPlan p;
  const int k1 = tucker ? K1 : 1, k2 = tucker ? K2 : K1;  // dense: K1 = I
  const size_t I = (size_t)k1 * k2;
  p.narrow = !tucker && k2 <= narrow::W && O <= narrow::W;
  const long long tiles =
      (long long)F * cdiv(k1, cdw::NI) * cdiv(k2, cdw::BJ) * cdiv(O, cdw::BO);
  p.n_bc = p.narrow ? batch_chunks(F, B, narrow::RT<T>, 4 * narrow::RT<T>, 1024, &p.rows)
                    : batch_chunks(tiles, B, cdw::BB<T>, 2 * cdw::BB<T>, 2048, &p.rows);
  p.dw_part = p.narrow ? 0 : (size_t)F * B * O;
  const size_t dw_vals = (size_t)p.n_bc * F * O * I;
  p.dx_part = p.dw_part + (p.n_bc > 1 ? (w_complex ? dw_vals : (dw_vals + 1) / 2) : 0);
  p.split = tucker && !tucker_dx_fits<T>(K1, K2);
  p.total = p.dx_part + (p.split ? tucker_split_size(F, B, K1, K2, BN, I_PER) : 0);
  return p;
}

// The complex dw in the batch chunks of the plan (to ``out``: dw, or the
// chunks' planes when there are several).
template <typename T, bool TUCKER, bool WCPLX>
cudaError_t launch_dw(const void* xa, const void* xb, const T* sa, const T* sb, const void* gy,
                      void* out, int F, int B, int K1, int K2, int O, const GyPlan& p,
                      cudaStream_t s) {
  constexpr size_t smem = cdw::smem<T>();
  auto kernel = clse_bwd_dw_part<T, TUCKER, WCPLX>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_it = TUCKER ? static_cast<int>(cdiv(K1, cdw::NI)) : 1;
  const dim3 grid(F * n_it * p.n_bc, cdiv(K2, cdw::BJ), cdiv(O, cdw::BO));
  kernel<<<grid, THREADS, smem, s>>>(xa, xb, sa, sb, gy, out, F, B, TUCKER ? K1 : 1, K2, O, n_it,
                                     p.n_bc, p.rows);
  return cudaGetLastError();
}

template <typename T, bool TUCKER, bool WCPLX>
int launch_bwd(const void* xa, const void* xb, const void* w, const void* out, const void* g,
               void* dxa, void* dxb, void* dw, void* sa_, void* sb_, void* gy_, int F, int B,
               int I, int K1, int K2, int O, cudaStream_t s) {
  using C = typename Cplx<T>::type;
  T* sa = static_cast<T*>(sa_);
  T* sb = static_cast<T*>(sb_);
  C* gy = static_cast<C*>(gy_);
  const GyPlan plan = gy_plan<T>(TUCKER, WCPLX, F, B, K1, K2, O);
  cudaError_t err;
  if (plan.narrow) {
    void* dwo = dw == nullptr ? nullptr : plan.n_bc > 1 ? static_cast<void*>(gy) : dw;
    clse_bwd_narrow<T, WCPLX><<<F * plan.n_bc, THREADS, 0, s>>>(xa, w, out, g, dxa, dwo, F, B,
                                                                  I, O, plan.n_bc, plan.rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if (dw != nullptr && plan.n_bc > 1)  // real values, two to a complex one
      return static_cast<int>(cirkit::launch_sum_partials<T>(
          static_cast<const T*>(dwo), static_cast<T*>(dw), (size_t)F * O * I * (WCPLX ? 2 : 1),
          plan.n_bc, s));
    return 0;
  }
  clse_bwd_prep<T, TUCKER><<<dim3(F, cdiv(B, WARPS)), THREADS, 0, s>>>(
      xa, xb, out, g, sa, sb, gy, B, TUCKER ? K1 : I, K2, O);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (dxa != nullptr || dxb != nullptr) {
    if (TUCKER && plan.split) {
      const int n_bt = static_cast<int>(cdiv(B, TuckerDx<T>::BM));
      const int n_jt = static_cast<int>(cdiv(K2, BN));
      const int n_it = static_cast<int>(cdiv(K1, I_PER));
      C* part1 = gy + plan.dx_part;
      C* part2 = part1 + (size_t)n_jt * F * B * K1;
      clse_bwd_dx_tucker_split<T, WCPLX><<<dim3(F * n_bt, n_jt, n_it), THREADS, 0, s>>>(
          xa, xb, w, sa, sb, gy, part1, part2, F, B, K1, K2, O, n_bt);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
      ctucker_split_finish<T><<<dim3(F, cdiv(B, WARPS)), THREADS, 0, s>>>(
          xa, xb, sa, sb, part1, part2, dxa, dxb, F, B, K1, K2, n_jt, n_it);
    } else if (TUCKER) {
      const size_t smem = tucker_dx_smem<T>(K1, K2);
      err = cudaFuncSetAttribute(clse_bwd_dx_tucker<T, WCPLX>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      clse_bwd_dx_tucker<T, WCPLX><<<dim3(F, cdiv(B, TuckerDx<T>::BM)), THREADS, smem, s>>>(
          xa, xb, w, sa, sb, gy, dxa, dxb, B, K1, K2, O);
    } else {
      clse_bwd_dx_dense<T, WCPLX><<<dim3(F, cdiv(I, BN), cdiv(B, fwd::BM)), THREADS, 0, s>>>(
          xa, w, sa, gy, dxa, B, I, O);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (dw != nullptr) {
    const int k2 = TUCKER ? K2 : I;
    void* dst = plan.n_bc > 1 ? static_cast<void*>(gy + plan.dw_part) : dw;
    err = launch_dw<T, TUCKER, WCPLX>(xa, xb, sa, sb, gy, dst, F, B, K1, k2, O, plan, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (plan.n_bc > 1 &&  // the chunks' planes, real values (two to a complex one)
        (err = cirkit::launch_sum_partials<T>(static_cast<const T*>(dst), static_cast<T*>(dw),
                                              (size_t)F * O * I * (WCPLX ? 2 : 1), plan.n_bc,
                                              s)) != cudaSuccess)
      return static_cast<int>(err);
  }
  return 0;
}

// Calls fn.template operator()<T, TUCKER, WCPLX>() for the run-time flags.
template <typename Fn>
int dispatch(int tucker, int w_complex, int is_double, Fn fn) {
#define CLSE_CASE(T, TU, WC) return fn.template operator()<T, TU, WC>()
  if (is_double) {
    if (tucker) {
      if (w_complex) CLSE_CASE(double, true, true);
      CLSE_CASE(double, true, false);
    }
    if (w_complex) CLSE_CASE(double, false, true);
    CLSE_CASE(double, false, false);
  }
  if (tucker) {
    if (w_complex) CLSE_CASE(float, true, true);
    CLSE_CASE(float, true, false);
  }
  if (w_complex) CLSE_CASE(float, false, true);
  CLSE_CASE(float, false, false);
#undef CLSE_CASE
}

struct FwdCall {
  const void *xa, *xb, *w;
  void* out;
  int F, B, I, K1, K2, O;
  cudaStream_t s;
  template <typename T, bool TUCKER, bool WCPLX>
  int operator()() const {
    return launch_fwd<T, TUCKER, WCPLX>(xa, xb, w, out, F, B, I, K1, K2, O, s);
  }
};

struct BwdCall {
  const void *xa, *xb, *w, *out, *g;
  void *dxa, *dxb, *dw, *sa, *sb, *gy;
  int F, B, I, K1, K2, O;
  cudaStream_t s;
  template <typename T, bool TUCKER, bool WCPLX>
  int operator()() const {
    return launch_bwd<T, TUCKER, WCPLX>(xa, xb, w, out, g, dxa, dxb, dw, sa, sb, gy, F, B, I, K1,
                                        K2, O, s);
  }
};

}  // namespace

extern "C" {

// The complex values the backward's gy scratch holds (gy and the partial
// sums of the batch-split dw and the K1-split Tucker dx) at these sizes.
size_t clse_bwd_gy_size(int F, int B, int K1, int K2, int O, int tucker, int w_complex,
                        int is_double) {
  return is_double ? gy_plan<double>(tucker != 0, w_complex != 0, F, B, K1, K2, O).total
                   : gy_plan<float>(tucker != 0, w_complex != 0, F, B, K1, K2, O).total;
}

// Forward. Dense: xa = x (F,B,K1), xb null, K2 = 1; Tucker: xa = x1, xb = x2.
// w is (F,O,K1*K2), complex when w_complex, else real; out (F,B,O) complex.
int clse_fwd(const void* xa, const void* xb, const void* w, void* out, int F, int B, int K1,
             int K2, int O, int tucker, int w_complex, int is_double, int device,
             void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return dispatch(tucker, w_complex, is_double,
                  FwdCall{xa, xb, w, out, F, B, K1 * K2, K1, K2, O,
                          static_cast<cudaStream_t>(stream)});
}

// Backward: the forward's operands and output, the cotangent g; the gradients
// (a null pointer skips one; dw is real for a real w); scratch: the row shifts
// sa (F,B) and, for Tucker, sb, and gy, clse_bwd_gy_size complex values.
int clse_bwd(const void* xa, const void* xb, const void* w, const void* out, const void* g,
             void* dxa, void* dxb, void* dw, void* sa, void* sb, void* gy, int F, int B, int K1,
             int K2, int O, int tucker, int w_complex, int is_double, int device,
             void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return dispatch(tucker, w_complex, is_double,
                  BwdCall{xa, xb, w, out, g, dxa, dxb, dw, sa, sb, gy, F, B, K1 * K2, K1, K2, O,
                          static_cast<cudaStream_t>(stream)});
}

}  // extern "C"
