// Log-einsum-exp backward for Hopper (sm_90a): the gradients of the folded
// sum-layer contraction of the lse-sum semiring, dense or arity-2 Tucker,
// with an optional softmax of the weight rows, and its signed variant.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of
// cirkit_tpu/ops/lse_einsum.py (dispatched by `_call_bwd`, wired in as the
// custom VJP of `_fused_p`), in its four configurations, and with SIGNED
// the kernel `_s_bwd_kernel` of the same file (`_s_call_bwd`, the custom
// VJP of `_sfused_p`), in its four. Per fold f, with
// out the forward's output, g its cotangent, shift the summed clamped row
// maxes of the inputs and e the shifted exponentials (for Tucker
// e[b, i*K2+j] = e1[b,i] * e2[b,j]):
//
//   gy = g * exp(shift - out)       non-finite values set to 0
//   s  = gy @ w                     (B, I), never stored
//   dense:   dx[b,i]  = e[b,i] * s[b,i]
//   tucker:  dx1[b,i] = e1[b,i] * sum_j s[b,i*K2+j] * e2[b,j]
//            dx2[b,j] = e2[b,j] * sum_i s[b,i*K2+j] * e1[b,i]
//   dw[o,c] = sum_b gy[b,o] * e[b,c]       summed over the whole batch
//   softmax: dtheta = w * (dw - sum_c w_c dw_c) per row, w = softmax(theta)
//   signed:  out is log|y| with sign(y) beside it, each input has its sign
//            s, and e = s * exp(x - m) throughout (dx is then the gradient
//            of the log-magnitude input): gy = g * sign(y) * exp(shift -
//            out), zeroed where not finite (an exact cancellation y = 0 has
//            sign 0 and out = -inf, so its gy is 0 * inf = NaN -> 0). The
//            sign output's cotangent is dropped, and no gradient of the sign
//            inputs is computed: the TPU kernel's ds output only ever
//            reaches jnp.sign, a dropped sign output or a constant, so it
//            never reaches a parameter.
//
// The work is two contractions of the forward's size (s and dw). The float
// instances of the lse backward (unsigned: the flagship's training) run both
// on the tensor cores, section 6 below. The double instances and every
// signed one run each contraction on the CUDA cores in the forward's
// register-tiled FMA loop (16-wide chunks staged in shared memory, the next
// chunk loaded into registers while the current one is contracted), in
// these launches:
//
//   1. bwd_prep: per batch row, the clamped maxes (kept for the other
//      kernels) and the gy row, zeroed where not finite, so a row that is
//      all -inf gives zero gradients and no NaN;
//   2. softmax_weights (softmax only): per weight row, w = softmax(theta)
//      into a scratch the size of dw, so the later kernels read w with no
//      exponential per staged element (the forward never stores it; the
//      backward allocates dw of that size anyway);
//   3. the dx kernel (skipped when no input needs a gradient):
//      dense: one block per (fold, 64 input columns, 128 batch rows), the
//        s tile contracted over O, times e in the epilogue;
//      tucker: one block per (fold, 64 batch rows) that walks all K1*K2
//        columns in tiles of 64 and folds each s tile into the block's own
//        dx1 (K1-segment sums) and dx2 (sums mod K2) accumulators in shared
//        memory, so s never reaches device memory. When K2 is a multiple of
//        64 (the flagship's K=64) a tile lies in one K1 segment: dx2 adds
//        elementwise and dx1 reduces by warp shuffles; otherwise the tile
//        goes through shared memory and one thread per row folds it;
//   4. lse_bwd_dw (skipped when the weight needs no gradient): one block per
//      (fold, 64 output units, 8 tiles of 128 weight columns); for each tile
//      it loops over the whole batch, the TPU kernel's sequential batch-tile
//      accumulation. The batch is short (128 at the flagship), so the block
//      walks its tiles in one prefetched loop rather than a block per tile,
//      and writes each finished tile as whole 32-byte sectors;
//   5. softmax_vjp (softmax only): one warp per weight row rewrites the
//      finished dw row into dtheta in place.
//
// PERF.md has the times of both paths against the plain PyTorch version.
//
// Every sum runs in an order fixed by the code (no atomics), so a call is
// deterministic from run to run. Any O >= 1 and any batch are taken, the
// ragged edges masked. The Tucker dx kernel of sections 1-5 keeps (64 x
// (K1+K2+2)) * 2 + 64 x 65 floats of dynamic shared memory (83 KB at
// K1=K2=64); the wrapper refuses widths past the card's 227 KB (in double
// from K1 = K2 = 90). Section 6 takes any K1 and K2.
//
// Each extern "C" entry selects the given device, launches on the given
// stream, checks cudaGetLastError() after each launch and returns the first
// error (0 on success). A null dx or dw pointer skips that gradient.

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "lse_common.cuh"
#include "tc_common.cuh"

namespace {

using cirkit::clamp_max;
using cirkit::exp_t;
using cirkit::fast_exp;
using cirkit::fma_t;
using cirkit::load4;
using cirkit::max_t;
using cirkit::staged_exp;
using cirkit::store4;
using cirkit::warp_max;
using cirkit::warp_sum;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BK = 16;  // contraction chunk staged in shared memory
// Every kernel is a template over its scalar type T, float or double. The
// double instances hold twice the registers for their accumulators, so one
// block of the register-tiled kernels is resident on an SM, not two.
template <typename T> constexpr int RESIDENT = sizeof(T) == 4 ? 2 : 1;

// --------------------------------------------------------------------------
// 1. Row shifts and gy
// --------------------------------------------------------------------------

template <typename T, bool TUCKER, bool SIGNED>
__global__ void __launch_bounds__(THREADS)
bwd_prep(const T* __restrict__ xa, const T* __restrict__ xb,
         const T* __restrict__ out, const T* __restrict__ g,
         const T* __restrict__ out_sign,  // signed: sign(y); else unused
         T* __restrict__ sa, T* __restrict__ sb, T* __restrict__ gy,
         int B, int KA, int K2, int O) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // warp-uniform
  const size_t row = (size_t)blockIdx.x * B + b;
  T m1 = -INFINITY, m2 = -INFINITY;
  for (int k = lane; k < KA; k += 32) m1 = max_t(m1, xa[row * KA + k]);
  if (TUCKER)
    for (int k = lane; k < K2; k += 32) m2 = max_t(m2, xb[row * K2 + k]);
  m1 = clamp_max(warp_max(m1));
  m2 = clamp_max(warp_max(m2));
  if (lane == 0) {
    sa[row] = m1;
    if (TUCKER) sb[row] = m2;
  }
  const T shift = TUCKER ? m1 + m2 : m1;
  for (int o = lane; o < O; o += 32) {
    const size_t idx = row * O + o;
    T v = g[idx] * exp_t(shift - out[idx]);
    if (SIGNED) v *= out_sign[idx];
    gy[idx] = isfinite(v) ? v : T(0);
  }
}

// --------------------------------------------------------------------------
// 2. Softmax weights: w[o, :] = softmax(theta[o, :])
// --------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
softmax_weights(const T* __restrict__ theta, T* __restrict__ w, int O, int I) {
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (o >= O) return;
  const size_t row = ((size_t)blockIdx.x * O + o) * I;
  T m, s;
  cirkit::softmax_row_stats(theta + row, I, lane, &m, &s);
  const T inv = T(1) / s;
  for (int k = lane; k < I; k += 32) w[row + k] = exp_t(theta[row + k] - m) * inv;
}

// --------------------------------------------------------------------------
// 3a. dx, dense: dx = e * (gy @ w)
// --------------------------------------------------------------------------

namespace dense_dx {
constexpr int BM = 128;  // batch rows per block
constexpr int BN = 64;   // input columns per block
constexpr int TM = 8;
constexpr int TN = 4;
constexpr int AS = BM + 4;
constexpr int BS = BN + 4;
constexpr int RSTEP = THREADS / BK;       // gy staging: rows per pass
constexpr int A_PER = BM / RSTEP;         // 8
constexpr int WSTEP = THREADS / BN;       // w staging: units per pass
constexpr int W_PER = BK / WSTEP;         // 4
}  // namespace dense_dx

template <typename T, bool SIGNED>
__global__ void __launch_bounds__(THREADS, RESIDENT<T>)
lse_bwd_dx_dense(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ sa, const T* __restrict__ gy,
                 const T* __restrict__ sx,  // signed: the sign of x
                 T* __restrict__ dx, int B, int I, int O) {
  using namespace dense_dx;
  __shared__ __align__(16) T As[BK][AS];  // gy, unit-major
  __shared__ __align__(16) T Bs[BK][BS];  // w, unit-major

  const int f = blockIdx.x;
  const int i0 = blockIdx.y * BN;
  const int b0 = blockIdx.z * BM;
  const int tid = threadIdx.x;
  const T* gyf = gy + (size_t)f * B * O;
  const T* wf = w + (size_t)f * O * I;

  // gy staging: unit kk = tid % BK of each chunk, rows tid / BK + n * RSTEP;
  // w staging: column tid % BN, units tid / BN + n * WSTEP.
  const int skk = tid % BK;
  const int srow = tid / BK;
  const int wcol = tid % BN;
  const int wk = tid / BN;
  T pa[A_PER], pw[W_PER];
  auto load_chunk = [&](int o0) {
#pragma unroll
    for (int n = 0; n < A_PER; ++n) {
      const int b = b0 + srow + n * RSTEP;
      const int o = o0 + skk;
      pa[n] = (b < B && o < O) ? gyf[(size_t)b * O + o] : T(0);
    }
#pragma unroll
    for (int n = 0; n < W_PER; ++n) {
      const int o = o0 + wk + n * WSTEP;
      const int i = i0 + wcol;
      pw[n] = (o < O && i < I) ? wf[(size_t)o * I + i] : T(0);
    }
  };

  const int tx = tid % (BN / TN);  // column group
  const int ty = tid / (BN / TN);  // batch-row group
  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  load_chunk(0);
  for (int o0 = 0; o0 < O; o0 += BK) {
#pragma unroll
    for (int n = 0; n < A_PER; ++n) As[skk][srow + n * RSTEP] = pa[n];
#pragma unroll
    for (int n = 0; n < W_PER; ++n) Bs[wk + n * WSTEP][wcol] = pw[n];
    __syncthreads();
    if (o0 + BK < O) load_chunk(o0 + BK);
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

  const T* xf = x + (size_t)f * B * I;
  T* dxf = dx + (size_t)f * B * I;
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
      const T e = exp_t(xf[idx] - m);
      dxf[idx] = (SIGNED ? sx[(size_t)f * B * I + idx] * e : e) * acc[i][j];
    }
  }
}

// --------------------------------------------------------------------------
// 3b. dx, Tucker: s tiles folded into K1-segment and mod-K2 sums
// --------------------------------------------------------------------------

namespace tucker_dx {
constexpr int BM = 64;  // batch rows per block
constexpr int BN = 64;  // columns of s per tile
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int AS = BM + 4;
constexpr int BS = BN + 4;
constexpr int SS = BN + 1;             // odd stride: rows on distinct banks
constexpr int RSTEP = THREADS / BK;    // 16
constexpr int A_PER = BM / RSTEP;      // 4
constexpr int WSTEP = THREADS / BN;    // 4
constexpr int W_PER = BK / WSTEP;      // 4
}  // namespace tucker_dx

// Dynamic shared memory of the Tucker dx kernel, in bytes.
template <typename T>
inline size_t tucker_dx_smem(int K1, int K2) {
  using namespace tucker_dx;
  return sizeof(T) * BM * (2 * (K1 + 1) + 2 * (K2 + 1) + SS);
}

template <typename T, bool SIGNED>
__global__ void __launch_bounds__(THREADS)
lse_bwd_dx_tucker(const T* __restrict__ x1, const T* __restrict__ x2,
                  const T* __restrict__ w, const T* __restrict__ sa,
                  const T* __restrict__ sb,
                  const T* __restrict__ gy,
                  const T* __restrict__ s1,  // signed: the signs of x1, x2
                  const T* __restrict__ s2,
                  T* __restrict__ dx1,
                  T* __restrict__ dx2, int B, int K1, int K2, int O) {
  using namespace tucker_dx;
  __shared__ __align__(16) T As[BK][AS];  // gy, unit-major
  __shared__ __align__(16) T Bs[BK][BS];  // w, unit-major
  // one extern array per type: two declarations of one name with different
  // types conflict (and a helper function that returns it costs registers)
  T* smem;
  if constexpr (sizeof(T) == 4) {
    extern __shared__ float smem_f32[];
    smem = smem_f32;
  } else {
    extern __shared__ double smem_f64[];
    smem = smem_f64;
  }
  const int E1S = K1 + 1, E2S = K2 + 1;
  T* E1 = smem;               // [BM][K1+1] e1 of the block's rows
  T* E2 = E1 + BM * E1S;      // [BM][K2+1] e2
  T* A1 = E2 + BM * E2S;      // [BM][K1+1] sum_j s e2
  T* A2 = A1 + BM * E1S;      // [BM][K2+1] sum_i s e1
  T* S = A2 + BM * E2S;       // [BM][BN+1] the current s tile

  const int f = blockIdx.x;
  const int b0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int I = K1 * K2;
  const T* gyf = gy + (size_t)f * B * O;
  const T* wf = w + (size_t)f * O * I;

  // Prologue: the block's (signed) exponentials and zeroed accumulators.
  for (int t = tid; t < BM * K1; t += THREADS) {
    const int r = t / K1, k = t - r * K1;
    const int b = b0 + r;
    T e = T(0);
    if (b < B) {
      const size_t idx = ((size_t)f * B + b) * K1 + k;
      e = exp_t(x1[idx] - sa[(size_t)f * B + b]);
      if (SIGNED) e *= s1[idx];
    }
    E1[r * E1S + k] = e;
    A1[r * E1S + k] = T(0);
  }
  for (int t = tid; t < BM * K2; t += THREADS) {
    const int r = t / K2, k = t - r * K2;
    const int b = b0 + r;
    T e = T(0);
    if (b < B) {
      const size_t idx = ((size_t)f * B + b) * K2 + k;
      e = exp_t(x2[idx] - sb[(size_t)f * B + b]);
      if (SIGNED) e *= s2[idx];
    }
    E2[r * E2S + k] = e;
    A2[r * E2S + k] = T(0);
  }

  const int skk = tid % BK;
  const int srow = tid / BK;
  const int wcol = tid % BN;
  const int wk = tid / BN;
  T pa[A_PER], pw[W_PER];
  // One step of the flattened (column tile, unit chunk) loop.
  auto load_chunk = [&](int c0, int o0) {
#pragma unroll
    for (int n = 0; n < A_PER; ++n) {
      const int b = b0 + srow + n * RSTEP;
      const int o = o0 + skk;
      pa[n] = (b < B && o < O) ? gyf[(size_t)b * O + o] : T(0);
    }
#pragma unroll
    for (int n = 0; n < W_PER; ++n) {
      const int o = o0 + wk + n * WSTEP;
      const int c = c0 + wcol;
      pw[n] = (o < O && c < I) ? wf[(size_t)o * I + c] : T(0);
    }
  };

  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const bool aligned = K2 % BN == 0;
  const int n_chunks = (O + BK - 1) / BK;
  const int n_steps = ((I + BN - 1) / BN) * n_chunks;
  T acc[TM][TN];
  load_chunk(0, 0);
  for (int step = 0; step < n_steps; ++step) {
    const int tile = step / n_chunks;
    const int chunk = step - tile * n_chunks;
    const int c0 = tile * BN;
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = T(0);
    }
#pragma unroll
    for (int n = 0; n < A_PER; ++n) As[skk][srow + n * RSTEP] = pa[n];
#pragma unroll
    for (int n = 0; n < W_PER; ++n) Bs[wk + n * WSTEP][wcol] = pw[n];
    // (this barrier also orders the previous tile's reduction, which reads
    // S, before this tile's epilogue rewrites it)
    __syncthreads();
    if (step + 1 < n_steps) {
      const int nxt = step + 1;
      const int nt = nxt / n_chunks;
      load_chunk(nt * BN, (nxt - nt * n_chunks) * BK);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[TM], bb[TN];
      load4(&As[kk][ty * TM], a);
      load4(&Bs[kk][tx * TN], bb);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma_t(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
    if (chunk != n_chunks - 1) continue;

    if (aligned) {
      // Tile epilogue when K2 is a multiple of BN: the tile lies in the one
      // K1 segment i, so each thread adds its s values times e1[b,i] into
      // the distinct dx2 accumulators of its columns, and the dx1 sum of a
      // row reduces over the 16 threads that share it by a fixed butterfly.
      const int i = c0 / K2;
      const int j0 = c0 - i * K2 + tx * TN;
#pragma unroll
      for (int ii = 0; ii < TM; ++ii) {
        const int r = ty * TM + ii;
        const T e1 = E1[r * E1S + i];
        T* a2 = A2 + r * E2S + j0;
        const T* e2 = E2 + r * E2S + j0;
        T p = T(0);
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) {
          a2[jj] = fma_t(acc[ii][jj], e1, a2[jj]);
          p = fma_t(acc[ii][jj], e2[jj], p);
        }
#pragma unroll
        for (int d = BN / TN / 2; d > 0; d >>= 1) p += __shfl_xor_sync(0xffffffffu, p, d);
        if (tx == 0) A1[r * E1S + i] += p;
      }
      continue;
    }

    // Tile epilogue otherwise: s to shared memory, then one thread per batch
    // row folds it into that row's dx1 accumulator and another into its dx2
    // accumulator, column by column in order.
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) S[(ty * TM + i) * SS + tx * TN + j] = acc[i][j];
    __syncthreads();
    const int width = min(BN, I - c0);
    const bool first = tid < BM;  // warp-uniform
    if (tid < 2 * BM && (first ? dx1 != nullptr : dx2 != nullptr)) {
      const int r = tid % BM;
      int i = c0 / K2;
      int j = c0 - i * K2;
      const T* srow_p = S + r * SS;
      if (first) {
        T* a1 = A1 + r * E1S;
        const T* e2 = E2 + r * E2S;
        for (int cc = 0; cc < width; ++cc) {
          a1[i] = fma_t(srow_p[cc], e2[j], a1[i]);
          if (++j == K2) {
            j = 0;
            ++i;
          }
        }
      } else {
        T* a2 = A2 + r * E2S;
        const T* e1 = E1 + r * E1S;
        for (int cc = 0; cc < width; ++cc) {
          a2[j] = fma_t(srow_p[cc], e1[i], a2[j]);
          if (++j == K2) {
            j = 0;
            ++i;
          }
        }
      }
    }
  }
  __syncthreads();

  // Epilogue: dx1 = e1 * A1, dx2 = e2 * A2 for the block's rows.
  if (dx1 != nullptr) {
    for (int t = tid; t < BM * K1; t += THREADS) {
      const int r = t / K1, k = t - r * K1;
      const int b = b0 + r;
      if (b < B) dx1[((size_t)f * B + b) * K1 + k] = E1[r * E1S + k] * A1[r * E1S + k];
    }
  }
  if (dx2 != nullptr) {
    for (int t = tid; t < BM * K2; t += THREADS) {
      const int r = t / K2, k = t - r * K2;
      const int b = b0 + r;
      if (b < B) dx2[((size_t)f * B + b) * K2 + k] = E2[r * E2S + k] * A2[r * E2S + k];
    }
  }
}

// --------------------------------------------------------------------------
// 4. dw = gy^T e, summed over the whole batch
// --------------------------------------------------------------------------

namespace dw_tile {
constexpr int BM = 128;  // weight columns per tile
constexpr int BN = 64;   // output units per block
constexpr int TILES = 8;  // column tiles per block, walked in one loop
constexpr int TM = 8;
constexpr int TN = 4;
constexpr int AS = BM + 4;
constexpr int BS = BN + 4;
constexpr int ESTEP = THREADS / BM;   // e staging: batch rows per pass (2)
constexpr int E_PER = BK / ESTEP;     // 8
constexpr int GSTEP = THREADS / BN;   // gy staging: batch rows per pass (4)
constexpr int G_PER = BK / GSTEP;     // 4
}  // namespace dw_tile

template <typename T, bool TUCKER, bool SIGNED>
__global__ void __launch_bounds__(THREADS, RESIDENT<T>)
lse_bwd_dw(const T* __restrict__ xa, const T* __restrict__ xb,
           const T* __restrict__ sa, const T* __restrict__ sb,
           const T* __restrict__ gy,
           const T* __restrict__ sga,  // signed: the signs of xa, xb
           const T* __restrict__ sgb,
           T* __restrict__ dw, int B, int I, int K1,
           int K2, int O) {
  using namespace dw_tile;
  __shared__ __align__(16) T As[BK][AS];  // e, batch-major
  __shared__ __align__(16) T Bs[BK][BS];  // gy, batch-major

  const int f = blockIdx.x;
  const int o0 = blockIdx.y * BN;
  const int tile0 = blockIdx.z * TILES;
  const int n_tiles = min(TILES, (I + BM - 1) / BM - tile0);
  const int n_chunks = (B + BK - 1) / BK;
  const int n_steps = n_tiles * n_chunks;
  const int tid = threadIdx.x;
  const int KA = TUCKER ? K1 : I;
  const T* xaf = xa + (size_t)f * B * KA;
  const T* xbf = TUCKER ? xb + (size_t)f * B * K2 : nullptr;
  const T* saf = sa + (size_t)f * B;
  const T* sbf = TUCKER ? sb + (size_t)f * B : nullptr;
  const T* gyf = gy + (size_t)f * B * O;
  const T* sgaf = SIGNED ? sga + (size_t)f * B * KA : nullptr;
  const T* sgbf = SIGNED && TUCKER ? sgb + (size_t)f * B * K2 : nullptr;

  // e staging: column ec = tid % BM of the tile, batch rows tid / BM + n *
  // ESTEP; gy staging: unit tid % BN, batch rows tid / BN + n * GSTEP.
  const int ec = tid % BM;
  const int eb = tid / BM;
  const int go = tid % BN;
  const int gb = tid / BN;
  T pe[E_PER], ps[E_PER], pg[G_PER];
  // One step of the flattened (column tile, batch chunk) loop.
  auto load_chunk = [&](int step) {
    const int tile = step / n_chunks;
    const int k0 = (step - tile * n_chunks) * BK;
    const int c = (tile0 + tile) * BM + ec;
    const int ci = TUCKER ? c / K2 : c;
    const int cj = TUCKER ? c - ci * K2 : 0;
#pragma unroll
    for (int n = 0; n < E_PER; ++n) {
      const int b = k0 + eb + n * ESTEP;
      T v = -INFINITY, sg = T(0);
      if (b < B && c < I) {
        v = TUCKER ? (xaf[(size_t)b * K1 + ci] - saf[b]) + (xbf[(size_t)b * K2 + cj] - sbf[b])
                   : xaf[(size_t)b * I + c] - saf[b];
        if (SIGNED)
          sg = TUCKER ? sgaf[(size_t)b * K1 + ci] * sgbf[(size_t)b * K2 + cj]
                      : sgaf[(size_t)b * I + c];
      }
      pe[n] = v;
      if (SIGNED) ps[n] = sg;
    }
#pragma unroll
    for (int n = 0; n < G_PER; ++n) {
      const int b = k0 + gb + n * GSTEP;
      const int o = o0 + go;
      pg[n] = (b < B && o < O) ? gyf[(size_t)b * O + o] : T(0);
    }
  };

  const int tx = tid % (BN / TN);  // unit group
  const int ty = tid / (BN / TN);  // column group
  T* dwf = dw + (size_t)f * O * I;
  const bool vec_store = I % 4 == 0;  // dw rows start 16-byte aligned
  T acc[TM][TN];
  load_chunk(0);
  for (int step = 0; step < n_steps; ++step) {
    const int tile = step / n_chunks;
    const int chunk = step - tile * n_chunks;
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = T(0);
    }
#pragma unroll
    for (int n = 0; n < E_PER; ++n)
      As[eb + n * ESTEP][ec] = SIGNED ? ps[n] * staged_exp<true>(pe[n]) : fast_exp(pe[n]);
#pragma unroll
    for (int n = 0; n < G_PER; ++n) Bs[gb + n * GSTEP][go] = pg[n];
    __syncthreads();
    if (step + 1 < n_steps) load_chunk(step + 1);
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
    if (chunk != n_chunks - 1) continue;

    // Tile epilogue: the finished dw tile, masking the ragged edges. A
    // thread's TM columns of one unit are contiguous: two 16-byte stores fill
    // one 32-byte sector (f32) where the row is 16-byte aligned.
    const int cc = (tile0 + tile) * BM + ty * TM;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = o0 + tx * TN + j;
      if (o >= O) continue;
      T* dst = dwf + (size_t)o * I + cc;
      if (vec_store && cc + TM <= I) {
        store4(dst, acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
        store4(dst + 4, acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i)
          if (cc + i < I) dst[i] = acc[i][j];
      }
    }
  }
}

// --------------------------------------------------------------------------
// 5. Softmax VJP, in place: dtheta = w * (dw - sum_c w_c dw_c)
// --------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
softmax_vjp(const T* __restrict__ w, T* __restrict__ dw, int O, int I) {
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (o >= O) return;
  const size_t row = ((size_t)blockIdx.x * O + o) * I;
  const T* wr = w + row;
  T* d = dw + row;
  T dot = T(0);
  for (int k = lane; k < I; k += 32) dot = fma_t(wr[k], d[k], dot);
  dot = warp_sum(dot);
  for (int k = lane; k < I; k += 32) d[k] = wr[k] * (d[k] - dot);
}

// --------------------------------------------------------------------------
// 6. The tensor-core path of the float, unsigned instances
// --------------------------------------------------------------------------
//
// Both contractions run on the tensor cores as warp-level
// mma.sync.m16n8k8 TF32 products in 3xTF32: each operand is split into a
// TF32 high part and a TF32 remainder, and hi*hi + hi*lo + lo*hi is summed
// in f32 registers (the counterpart of the TPU kernel's three-pass `_dot3`;
// one TF32 pass keeps 11 bits, too few for the gradients' bound). Operands
// are staged in shared memory as f32 and split as the warps read their
// fragments; each warp holds a 32x32 tile of the block's output. The Tucker
// dx kernel streams its operand chunks through a cp.async ring; the dw
// kernel stages a whole batch chunk once and contracts it for each of its
// rows i; the dense dx kernel prefetches the next chunk into registers.
// Softmax needs no (F, O, I) copy of the weights and no VJP pass: a prep
// kernel writes each row's log-normalizer, the dx kernels form w =
// exp(theta - lse) as they read theta, and the dw kernel's epilogue writes
// dtheta = w * (dw - r_o) with r_o = sum_c w_oc dw_oc = sum_b g_bo over the
// rows whose gy is finite (as sum_c w_oc e_bc = exp(out_bo - shift_b), gy_bo
// exp(out_bo - shift_b) = g_bo).

// The primitives (the TF32 split, the mma, the fragment loop mma_k8, the
// cp.async copies) are in tc_common.cuh.
namespace tc = cirkit::tc;
using cirkit::cp_async_commit;
using cirkit::cp_async_f32;
using cirkit::cp_async_f32x4;
using cirkit::cp_async_wait;
using cirkit::mma_k8;
using cirkit::zero_acc;


// Per weight row of the softmax: its log-normalizer lse_o and r_o = sum_b
// g_bo over the rows whose gy_bo is finite and nonzero (gy is zeroed where
// not finite; where it is 0 otherwise, g is 0). One warp per row.
__global__ void __launch_bounds__(THREADS)
tc_softmax_stats(const float* __restrict__ theta, const float* __restrict__ g,
                 const float* __restrict__ gy, float* __restrict__ lse, float* __restrict__ rsum,
                 int B, int O, int I) {
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (o >= O) return;  // warp-uniform
  const size_t row = (size_t)blockIdx.x * O + o;
  float m, s;
  cirkit::softmax_row_stats(theta + row * I, I, lane, &m, &s);
  const float* gf = g + (size_t)blockIdx.x * B * O + o;
  const float* gyf = gy + (size_t)blockIdx.x * B * O + o;
  float r = 0.f;
  for (int b = lane; b < B; b += 32) r += gyf[(size_t)b * O] != 0.f ? gf[(size_t)b * O] : 0.f;
  r = warp_sum(r);
  if (lane == 0) {
    lse[row] = m + logf(s);
    rsum[row] = r;
  }
}

// The dx kernels' operands: A = gy (batch rows x units), B = the weight
// chunk (units x columns); a block has 128 batch rows and 64 columns, its
// warps 4 x 2.
namespace tc_dx {
constexpr int BM = 128;
constexpr int BN = 64;
constexpr int AS = BM + tc::PAD;
constexpr int BS = BN + tc::PAD;
constexpr int A_PER = BM * tc::BK / THREADS;  // 8
constexpr int W_PER = BN * tc::BK / THREADS;  // 4
constexpr int RSTEP = THREADS / tc::BK;       // gy staging: rows per pass (16)
constexpr int WSTEP = THREADS / BN;           // w staging: units per pass (4)
}  // namespace tc_dx

// Registers of one dx chunk: gy[b0 + m][o0 + k] at k = tid % BK, m = tid /
// BK + n RSTEP; and w[o0 + k][c0 + n] at n = tid % BN, k = tid / BN + q
// WSTEP, for n < ncols (softmax: theta and the row's lse, staged as
// exp(theta - lse), 0 outside).
template <bool SOFTMAX>
struct DxChunk {
  float pa[tc_dx::A_PER], pw[tc_dx::W_PER], pl[tc_dx::W_PER];

  __device__ __forceinline__ void load(const float* gyf, const float* wf, const float* lsef,
                                       int b0, int o0, int c0, int ncols, int B, int O, int I,
                                       int tid) {
    using namespace tc_dx;
    const int k = tid % tc::BK, m = tid / tc::BK;
#pragma unroll
    for (int n = 0; n < A_PER; ++n) {
      const int b = b0 + m + n * RSTEP;
      pa[n] = (b < B && o0 + k < O) ? gyf[(size_t)b * O + o0 + k] : 0.f;
    }
    const int c = tid % BN, kw = tid / BN;
#pragma unroll
    for (int q = 0; q < W_PER; ++q) {
      const int o = o0 + kw + q * WSTEP;
      const bool in = o < O && c < ncols;
      pw[q] = in ? wf[(size_t)o * I + c0 + c] : (SOFTMAX ? -INFINITY : 0.f);
      if (SOFTMAX) pl[q] = in ? lsef[o] : 0.f;
    }
  }

  __device__ __forceinline__ void store(float (*As)[tc_dx::AS], float (*Bs)[tc_dx::BS],
                                        int tid) const {
    using namespace tc_dx;
    const int k = tid % tc::BK, m = tid / tc::BK;
#pragma unroll
    for (int n = 0; n < A_PER; ++n) As[k][m + n * RSTEP] = pa[n];
    const int c = tid % BN, kw = tid / BN;
#pragma unroll
    for (int q = 0; q < W_PER; ++q)
      Bs[kw + q * WSTEP][c] = SOFTMAX ? fast_exp(pw[q] - pl[q]) : pw[q];
  }
};

// dx, dense: dx = e * (gy @ w), one block per (fold, 64 columns, 128 rows).
template <bool SOFTMAX>
__global__ void __launch_bounds__(THREADS, 2)
tc_dx_dense(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ lse, const float* __restrict__ sa,
            const float* __restrict__ gy, float* __restrict__ dx, int B, int I, int O) {
  using namespace tc_dx;
  __shared__ __align__(16) float As[tc::BK][AS];
  __shared__ __align__(16) float Bs[tc::BK][BS];
  const int f = blockIdx.x;
  const int c0 = blockIdx.y * BN;
  const int b0 = blockIdx.z * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * tc::WT, wn = (warp & 1) * tc::WT;
  const float* gyf = gy + (size_t)f * B * O;
  const float* wf = w + (size_t)f * O * I;
  const float* lsef = SOFTMAX ? lse + (size_t)f * O : nullptr;

  float acc[tc::MT][tc::NT][4];
  zero_acc(acc);
  DxChunk<SOFTMAX> chunk;
  chunk.load(gyf, wf, lsef, b0, 0, c0, I - c0, B, O, I, tid);
  for (int o0 = 0; o0 < O; o0 += tc::BK) {
    chunk.store(As, Bs, tid);
    __syncthreads();
    if (o0 + tc::BK < O) chunk.load(gyf, wf, lsef, b0, o0 + tc::BK, c0, I - c0, B, O, I, tid);
#pragma unroll
    for (int k = 0; k < tc::BK; k += 8) mma_k8<AS, BS>(As, Bs, k, wm, wn, lane, 0.f, 0.f, acc);
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
  const float* xf = x + (size_t)f * B * I;
  float* dxf = dx + (size_t)f * B * I;
#pragma unroll
  for (int mt = 0; mt < tc::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = b0 + wm + mt * 16 + g + 8 * h;
      if (b >= B) continue;
      const float m = sa[(size_t)f * B + b];
#pragma unroll
      for (int nt = 0; nt < tc::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + wn + nt * 8 + 2 * t + e;
          if (c >= I) continue;
          const size_t idx = (size_t)b * I + c;
          dxf[idx] = expf(xf[idx] - m) * acc[mt][nt][2 * h + e];
        }
    }
}

// dx, Tucker: one block per (fold and 128 batch rows, 64 columns j of the
// K2 segment, I_PER rows i of K1). For each of its i it contracts the s
// tile s[b, i*K2 + j] = sum_o gy[b,o] w[o, i*K2 + j] over the units, then
// folds it: the dx2 sums sum_i s e1[b,i] accumulate in the warps' registers
// (the same fragment layout as s), and the dx1 sums sum_j s e2[b,j] reduce
// over a quad of lanes and the block's two warp columns. The block writes
// both as partials (dx1 over its j tile, dx2 over its i rows), and
// tucker_dx_finish adds them in a fixed order and multiplies by e. The
// operand chunks (gy over 16 units, row-major, and the weights or logits of
// those units over the 64 columns, with their rows' lse) arrive by cp.async
// in a ring of STAGES, two chunks ahead of the one contracted (16-byte
// copies where ``vec``: O and K2 multiples of 4); softmax weights are formed
// as exp(theta - lse) as the warps read them. Shared memory stays at 100 KB
// whatever K1 and K2, so two blocks share an SM.
namespace tc_tucker {
constexpr int I_PER = 16;
constexpr int STAGES = 3;
constexpr int AK = tc::BK + 4;     // row stride of a staged gy chunk [BM][AK]
constexpr int ES = tc_dx::BN + 1;  // E2 row stride
// one stage: the gy chunk [BM][AK], the weight chunk [BK][BS], its lse [BK]
constexpr int STAGE = tc_dx::BM * AK + tc::BK * tc_dx::BS + tc::BK;
// dynamic shared memory: the stages, E1 [I_PER][BM], E2 [BM][ES], P1 [2][BM][I_PER]
constexpr size_t SMEM = sizeof(float) * (STAGES * STAGE + I_PER * tc_dx::BM +
                                         tc_dx::BM * ES + 2 * tc_dx::BM * I_PER);
}  // namespace tc_tucker

template <bool SOFTMAX>
__global__ void __launch_bounds__(THREADS, 2)
tc_dx_tucker(const float* __restrict__ x1, const float* __restrict__ x2,
             const float* __restrict__ w, const float* __restrict__ lse,
             const float* __restrict__ sa, const float* __restrict__ sb,
             const float* __restrict__ gy, float* __restrict__ part1,
             float* __restrict__ part2, int F, int B, int K1, int K2, int O, int n_bt,
             bool vec) {
  using tc_dx::BM;
  using tc_dx::BN;
  using tc_dx::BS;
  using namespace tc_tucker;
  extern __shared__ float smem[];
  float* E1 = smem + STAGES * STAGE;  // [I_PER][BM]: e1 of the block's rows i
  float* E2 = E1 + I_PER * BM;        // [BM][ES]: e2 of the block's columns j
  float* P1 = E2 + BM * ES;           // [2][BM][I_PER]: dx1 sums of each warp column

  const int f = blockIdx.x / n_bt;
  const int b0 = (blockIdx.x - f * n_bt) * BM;
  const int j0 = blockIdx.y * BN;
  const int i0 = blockIdx.z * I_PER;
  const int n_i = min(I_PER, K1 - i0);
  const int I = K1 * K2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * tc::WT, wn = (warp & 1) * tc::WT;
  const float* gyf = gy + (size_t)f * B * O;
  const float* wf = w + (size_t)f * O * I;
  const float* lsef = SOFTMAX ? lse + (size_t)f * O : nullptr;
  const int n_chunks = (O + tc::BK - 1) / tc::BK;
  const int n_steps = n_i * n_chunks;
  const int ncols = K2 - j0;

  // the copies of step's chunks into its slot of the ring
  auto fetch = [&](int step) {
    const int il = step / n_chunks;
    const int o0 = (step - il * n_chunks) * tc::BK;
    const float* wc = wf + (size_t)(i0 + il) * K2 + j0;
    float* As = smem + (step % STAGES) * STAGE;
    float* Bs = As + BM * AK;
    if (vec) {
      for (int e = tid; e < BM * tc::BK / 4; e += THREADS) {
        const int r = e >> 2, k = 4 * (e & 3), b = b0 + r;
        const bool in = b < B && o0 + k < O;
        cp_async_f32x4(As + r * AK + k, in ? gyf + (size_t)b * O + o0 + k : gyf, in);
      }
      for (int e = tid; e < tc::BK * BN / 4; e += THREADS) {
        const int k = e / (BN / 4), c = 4 * (e - k * (BN / 4));
        const bool in = o0 + k < O && c < ncols;
        cp_async_f32x4(Bs + k * BS + c, in ? wc + (size_t)(o0 + k) * I + c : wf, in);
      }
    } else {
      for (int e = tid; e < BM * tc::BK; e += THREADS) {
        const int r = e / tc::BK, k = e - r * tc::BK, b = b0 + r;
        const bool in = b < B && o0 + k < O;
        cp_async_f32(As + r * AK + k, in ? gyf + (size_t)b * O + o0 + k : gyf, in);
      }
      for (int e = tid; e < tc::BK * BN; e += THREADS) {
        const int k = e / BN, c = e - k * BN;
        const bool in = o0 + k < O && c < ncols;
        cp_async_f32(Bs + k * BS + c, in ? wc + (size_t)(o0 + k) * I + c : wf, in);
      }
    }
    // the rows' lse (0 past O, whose gy is 0)
    if (SOFTMAX && tid < tc::BK)
      cp_async_f32(Bs + tc::BK * BS + tid, o0 + tid < O ? lsef + o0 + tid : lsef, o0 + tid < O);
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) fetch(s);
    cp_async_commit();
  }

  for (int e = tid; e < I_PER * BM; e += THREADS) {
    const int il = e / BM, r = e - il * BM, b = b0 + r;
    E1[e] = (b < B && il < n_i)
                ? expf(x1[((size_t)f * B + b) * K1 + i0 + il] - sa[(size_t)f * B + b]) : 0.f;
  }
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e - r * BN, b = b0 + r;
    E2[r * ES + c] = (b < B && j0 + c < K2)
                         ? expf(x2[((size_t)f * B + b) * K2 + j0 + c] - sb[(size_t)f * B + b])
                         : 0.f;
  }

  const int g = lane >> 2, t = lane & 3;
  float acc[tc::MT][tc::NT][4], a2[tc::MT][tc::NT][4];
  zero_acc(a2);
  for (int step = 0; step < n_steps; ++step) {
    const int il = step / n_chunks;
    const int ck = step - il * n_chunks;
    if (ck == 0) zero_acc(acc);
    cp_async_wait<STAGES - 2>();  // this thread's copies of step have landed
    __syncthreads();              // everyone's, and step - 1's slot is free
    if (step + STAGES - 1 < n_steps) fetch(step + STAGES - 1);
    cp_async_commit();
    const float* st = smem + (step % STAGES) * STAGE;
    const auto As = reinterpret_cast<const float(*)[AK]>(st);
    const auto Bs = reinterpret_cast<const float(*)[BS]>(st + BM * AK);
    const float* Ls = st + BM * AK + tc::BK * BS;
#pragma unroll
    for (int k = 0; k < tc::BK; k += 8)
      mma_k8<AK, BS, SOFTMAX ? 2 : 0, true>(As, Bs, k, wm, wn, lane,
                                            SOFTMAX ? Ls[k + t] : 0.f,
                                            SOFTMAX ? Ls[k + t + 4] : 0.f, acc);
    if (ck != n_chunks - 1) continue;
#pragma unroll
    for (int mt = 0; mt < tc::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm + mt * 16 + g + 8 * h;
        const float e1 = E1[il * BM + row];
        const float* e2 = E2 + row * ES + wn + 2 * t;
        float p = 0.f;
#pragma unroll
        for (int nt = 0; nt < tc::NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float s = acc[mt][nt][2 * h + e];
            a2[mt][nt][2 * h + e] = fmaf(s, e1, a2[mt][nt][2 * h + e]);
            p = fmaf(s, e2[nt * 8 + e], p);
          }
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        if (t == 0) P1[((warp & 1) * BM + row) * I_PER + il] = p;
      }
  }
  cp_async_wait<0>();
  __syncthreads();

  // part1[jt][f][b][i] over this block's j tile; part2[it][f][b][j] over
  // its rows i
  for (int e = tid; e < BM * I_PER; e += THREADS) {
    const int r = e / I_PER, il = e - r * I_PER, b = b0 + r;
    if (b < B && il < n_i)
      part1[(((size_t)blockIdx.y * F + f) * B + b) * K1 + i0 + il] =
          P1[r * I_PER + il] + P1[(BM + r) * I_PER + il];
  }
#pragma unroll
  for (int mt = 0; mt < tc::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = b0 + wm + mt * 16 + g + 8 * h;
      if (b >= B) continue;
      float* dst = part2 + (((size_t)blockIdx.z * F + f) * B + b) * K2;
#pragma unroll
      for (int nt = 0; nt < tc::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + wn + nt * 8 + 2 * t + e;
          if (j < K2) dst[j] = a2[mt][nt][2 * h + e];
        }
    }
}

// dx1 = e1 * (sum of the n1 dx1 partials), dx2 = e2 * (sum of the n2 dx2
// partials), added in partial order; one warp per (fold, batch row).
__global__ void __launch_bounds__(THREADS)
tucker_dx_finish(const float* __restrict__ x1, const float* __restrict__ x2,
                 const float* __restrict__ sa, const float* __restrict__ sb,
                 const float* __restrict__ part1, const float* __restrict__ part2,
                 float* __restrict__ dx1, float* __restrict__ dx2, int F, int B, int K1, int K2,
                 int n1, int n2) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;
  const size_t row = (size_t)blockIdx.x * B + b;
  const size_t plane = (size_t)F * B;
  if (dx1 != nullptr)
    for (int k = lane; k < K1; k += 32) {
      float s = 0.f;
      for (int p = 0; p < n1; ++p) s += part1[(p * plane + row) * K1 + k];
      dx1[row * K1 + k] = expf(x1[row * K1 + k] - sa[row]) * s;
    }
  if (dx2 != nullptr)
    for (int k = lane; k < K2; k += 32) {
      float s = 0.f;
      for (int p = 0; p < n2; ++p) s += part2[(p * plane + row) * K2 + k];
      dx2[row * K2 + k] = expf(x2[row * K2 + k] - sb[row]) * s;
    }
}

// dw = gy^T e summed over the batch, one block per (fold and NI rows i of
// K1, 64 columns j of K2, BO units); dense is the case K1 = 1, K2 = I with
// no e1. The block stages a chunk of up to 128 batch rows once: gy^T, e2 =
// exp(x2 - shift) over its columns and e1 over its rows i. It then contracts
// the chunk for each row i in turn, the B operand e2[b, j] scaled by e1[b, i]
// as the warps read it, so the operands are read from device memory once a
// block and not once a row i (a batch of more than 128 rows is staged again
// for each row i). The warps tile BO x 64 in 32 x 32 tiles; with BO = 64 the
// two halves of the warps take alternate rows i. Softmax: the epilogue writes
// dtheta = w * (dw - r_o) with w = exp(theta - lse_o), two neighbouring
// columns a thread where the rows allow 8-byte accesses (``pair``).
namespace tc_dw {
constexpr int BB = 128;  // batch rows staged at once
constexpr int BJ = 64;   // columns j
constexpr int NI = 8;    // rows i per block (Tucker)
constexpr int BS = BJ + tc::PAD;
constexpr size_t smem_bytes(int bo) {
  return sizeof(float) * (BB * (bo + tc::PAD) + BB * BS + NI * BB);
}
}  // namespace tc_dw

template <bool TUCKER, bool SOFTMAX, int BO>
__global__ void __launch_bounds__(THREADS, 2)
tc_dw_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
             const float* __restrict__ sa, const float* __restrict__ sb,
             const float* __restrict__ gy, const float* __restrict__ theta,
             const float* __restrict__ lse, const float* __restrict__ rsum,
             float* __restrict__ dw, int B, int K1, int K2, int O, int n_it, bool pair) {
  using namespace tc_dw;
  constexpr int AS = BO + tc::PAD;
  constexpr int WO = BO / tc::WT;  // warps along the units in a group of 2 WO
  extern __shared__ float smem[];
  float(*Gs)[AS] = reinterpret_cast<float(*)[AS]>(smem);           // [BB][AS]: gy^T
  float(*Es)[BS] = reinterpret_cast<float(*)[BS]>(smem + BB * AS);  // [BB][BS]: e2
  float* E1s = smem + BB * (AS + BS);                               // [NI][BB]: e1

  const int I = K1 * K2;
  const int f = blockIdx.x / n_it;
  const int i0 = (blockIdx.x - f * n_it) * NI;
  const int j0 = blockIdx.y * BJ;
  const int o0 = blockIdx.z * BO;
  const int n_i = min(NI, K1 - i0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ig = warp / (2 * WO);  // this warp's group: rows i ig, ig + IG, ...
  const int wq = warp - ig * 2 * WO;
  const int wm = (wq >> 1) * tc::WT, wn = (wq & 1) * tc::WT;
  const int g = lane >> 2, t = lane & 3;
  const float* xef = (TUCKER ? xb : xa) + (size_t)f * B * K2;  // the operand of e2
  const float* sef = (TUCKER ? sb : sa) + (size_t)f * B;
  const float* x1f = xa + (size_t)f * B * K1;
  const float* s1f = sa + (size_t)f * B;
  const float* gyf = gy + (size_t)f * B * O;

  auto stage = [&](int b0) {
    const int nb = min(BB, B - b0);
    for (int e = tid; e < BB * BO; e += THREADS) {
      const int k = e / BO, o = e - k * BO;
      Gs[k][o] = (k < nb && o0 + o < O) ? gyf[(size_t)(b0 + k) * O + o0 + o] : 0.f;
    }
    for (int e = tid; e < BB * BJ; e += THREADS) {
      const int k = e / BJ, j = e - k * BJ;
      Es[k][j] = (k < nb && j0 + j < K2)
                     ? fast_exp(xef[(size_t)(b0 + k) * K2 + j0 + j] - sef[b0 + k]) : 0.f;
    }
    if (TUCKER)
      for (int e = tid; e < NI * BB; e += THREADS) {
        const int il = e / BB, k = e - il * BB;
        E1s[e] = (k < nb && il < n_i)
                     ? fast_exp(x1f[(size_t)(b0 + k) * K1 + i0 + il] - s1f[b0 + k]) : 0.f;
      }
  };

  const bool multi = B > BB;
  if (!multi) {
    stage(0);
    __syncthreads();
  }
  float* dwf = dw + (size_t)f * O * I;
  const float* thf = SOFTMAX ? theta + (size_t)f * O * I : nullptr;
  for (int base = 0; base < n_i; base += 128 / BO) {
    const int il = base + ig;
    const size_t col0 = (size_t)(min(il, n_i - 1) + i0) * K2;
    // softmax: the tile's logits, loaded ahead of the contraction they wait for
    float2 th[tc::MT][2][tc::NT];
    if (SOFTMAX && pair)
#pragma unroll
      for (int mt = 0; mt < tc::MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int nt = 0; nt < tc::NT; ++nt) {
            const int o = o0 + wm + mt * 16 + g + 8 * h;
            const int j = j0 + wn + nt * 8 + 2 * t;
            th[mt][h][nt] = il < n_i && o < O && j < K2
                                ? *reinterpret_cast<const float2*>(thf + (size_t)o * I + col0 + j)
                                : make_float2(0.f, 0.f);
          }
    float acc[tc::MT][tc::NT][4];
    zero_acc(acc);
    for (int b0 = 0; b0 < B; b0 += BB) {
      if (multi) {
        __syncthreads();
        stage(b0);
        __syncthreads();
      }
      if (il >= n_i) continue;
      const int nk = min(BB, (B - b0 + 7) & ~7);
      const float* e1 = E1s + il * BB;
      for (int k = 0; k < nk; k += 8)
        mma_k8<AS, BS, TUCKER ? 1 : 0>(Gs, Es, k, wm, wn, lane, TUCKER ? e1[k + t] : 1.f,
                               TUCKER ? e1[k + t + 4] : 1.f, acc);
    }
    if (il >= n_i) continue;

#pragma unroll
    for (int mt = 0; mt < tc::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = o0 + wm + mt * 16 + g + 8 * h;
        if (o >= O) continue;
        float l = 0.f, r = 0.f;
        if (SOFTMAX) {
          l = lse[(size_t)f * O + o];
          r = rsum[(size_t)f * O + o];
        }
        float* drow = dwf + (size_t)o * I + col0;
        const float* trow = SOFTMAX ? thf + (size_t)o * I + col0 : nullptr;
#pragma unroll
        for (int nt = 0; nt < tc::NT; ++nt) {
          const int j = j0 + wn + nt * 8 + 2 * t;
          const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
          if (pair && j < K2) {  // K2 even: j + 1 < K2 too
            float2 d = make_float2(v0, v1);
            if (SOFTMAX) {
              const float2 tv = th[mt][h][nt];
              d = make_float2(expf(tv.x - l) * (v0 - r), expf(tv.y - l) * (v1 - r));
            }
            *reinterpret_cast<float2*>(drow + j) = d;
          } else {
            if (j < K2) drow[j] = SOFTMAX ? expf(trow[j] - l) * (v0 - r) : v0;
            if (j + 1 < K2) drow[j + 1] = SOFTMAX ? expf(trow[j + 1] - l) * (v1 - r) : v1;
          }
        }
      }
  }
}

// --------------------------------------------------------------------------
// Launch
// --------------------------------------------------------------------------

inline unsigned cdiv(int a, int b) { return static_cast<unsigned>((a + b - 1) / b); }

// ``w`` is the weight, or for SOFTMAX the logits and ``ws`` the (F, O, I)
// scratch that receives their softmax. SIGNED takes the inputs' signs
// ``sga``/``sgb`` and the forward's sign output ``out_sign``.
template <typename T, bool TUCKER, bool SOFTMAX, bool SIGNED = false>
int launch_bwd(const T* xa, const T* xb, const T* w, const T* out,
               const T* g, T* dxa, T* dxb, T* dw, T* sa, T* sb,
               T* gy, T* ws, int F, int B, int I, int K1, int K2, int O, int device,
               void* stream, const T* sga = nullptr, const T* sgb = nullptr,
               const T* out_sign = nullptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool need_dx = dxa != nullptr || dxb != nullptr;
  const int KA = TUCKER ? K1 : I;

  bwd_prep<T, TUCKER, SIGNED><<<dim3(F, cdiv(B, WARPS)), THREADS, 0, s>>>(
      xa, xb, out, g, out_sign, sa, sb, gy, B, KA, K2, O);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (SOFTMAX) {
    softmax_weights<T><<<dim3(F, cdiv(O, WARPS)), THREADS, 0, s>>>(w, ws, O, I);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    w = ws;
  }
  if (need_dx) {
    if (TUCKER) {
      const size_t smem = tucker_dx_smem<T>(K1, K2);
      err = cudaFuncSetAttribute(lse_bwd_dx_tucker<T, SIGNED>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      lse_bwd_dx_tucker<T, SIGNED><<<dim3(F, cdiv(B, tucker_dx::BM)), THREADS, smem, s>>>(
          xa, xb, w, sa, sb, gy, sga, sgb, dxa, dxb, B, K1, K2, O);
    } else {
      lse_bwd_dx_dense<T, SIGNED>
          <<<dim3(F, cdiv(I, dense_dx::BN), cdiv(B, dense_dx::BM)), THREADS, 0, s>>>(
              xa, w, sa, gy, sga, dxa, B, I, O);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (dw != nullptr) {
    const dim3 grid(F, cdiv(O, dw_tile::BN), cdiv(I, dw_tile::BM * dw_tile::TILES));
    lse_bwd_dw<T, TUCKER, SIGNED><<<grid, THREADS, 0, s>>>(xa, xb, sa, sb, gy, sga, sgb, dw, B,
                                                           I, K1, K2, O);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if (SOFTMAX) {
      softmax_vjp<T><<<dim3(F, cdiv(O, WARPS)), THREADS, 0, s>>>(w, dw, O, I);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

// The number of floats of the tensor-core path's scratch ``ws``: for softmax
// the (F, O) log-normalizers and row dots, then for Tucker the dx partials,
// (ceil(K2 / 64), F, B, K1) for dx1 and (ceil(K1 / I_PER), F, B, K2) for dx2.
inline size_t tc_scratch(bool tucker, bool softmax, int F, int B, int K1, int K2, int O) {
  size_t n = softmax ? 2 * (size_t)F * O : 0;
  if (tucker)
    n += (size_t)F * B * ((size_t)cdiv(K2, tc_dx::BN) * K1 +
                          (size_t)cdiv(K1, tc_tucker::I_PER) * K2);
  return n;
}

// The dw kernel with BO units a block: two blocks of 108 KB (BO = 128) share
// an SM, so the launch asks for the largest shared-memory carveout.
template <bool TUCKER, bool SOFTMAX, int BO>
cudaError_t launch_tc_dw(const float* xa, const float* xb, const float* sa, const float* sb,
                         const float* gy, const float* theta, const float* lse,
                         const float* rsum, float* dw, int F, int B, int K1, int K2, int O,
                         bool pair, cudaStream_t s) {
  constexpr size_t smem = tc_dw::smem_bytes(BO);
  auto kernel = tc_dw_kernel<TUCKER, SOFTMAX, BO>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int n_it = static_cast<int>(cdiv(K1, tc_dw::NI));
  const dim3 grid(F * n_it, cdiv(K2, tc_dw::BJ), cdiv(O, BO));
  kernel<<<grid, THREADS, smem, s>>>(xa, xb, sa, sb, gy, theta, lse, rsum, dw, B, K1, K2, O,
                                     n_it, pair);
  return cudaGetLastError();
}

// The float, unsigned instances: bwd_prep, the softmax statistics, the dx
// kernel (Tucker: and its finish), the dw kernel, on the tensor cores.
template <bool TUCKER, bool SOFTMAX>
int launch_bwd_tc(const float* xa, const float* xb, const float* w, const float* out,
                  const float* g, float* dxa, float* dxb, float* dw, float* sa, float* sb,
                  float* gy, float* ws, int F, int B, int I, int K1, int K2, int O, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int KA = TUCKER ? K1 : I;

  bwd_prep<float, TUCKER, false><<<dim3(F, cdiv(B, WARPS)), THREADS, 0, s>>>(
      xa, xb, out, g, nullptr, sa, sb, gy, B, KA, K2, O);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  float* lse = nullptr;
  float* rsum = nullptr;
  float* part = ws;
  if (SOFTMAX) {
    lse = ws;
    rsum = ws + (size_t)F * O;
    part = ws + 2 * (size_t)F * O;
    tc_softmax_stats<<<dim3(F, cdiv(O, WARPS)), THREADS, 0, s>>>(w, g, gy, lse, rsum, B, O, I);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (dxa != nullptr || dxb != nullptr) {
    if (TUCKER) {
      const int n_bt = static_cast<int>(cdiv(B, tc_dx::BM));
      const int n_jt = static_cast<int>(cdiv(K2, tc_dx::BN));
      const int n_it = static_cast<int>(cdiv(K1, tc_tucker::I_PER));
      float* part1 = part;
      float* part2 = part + (size_t)n_jt * F * B * K1;
      // 16-byte copies where every gy row and weight row segment starts
      // 16-byte aligned
      const bool vec = O % 4 == 0 && K2 % 4 == 0 && reinterpret_cast<uintptr_t>(gy) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
      err = cudaFuncSetAttribute(tc_dx_tucker<SOFTMAX>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(tc_tucker::SMEM));
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(tc_dx_tucker<SOFTMAX>,
                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return static_cast<int>(err);
      tc_dx_tucker<SOFTMAX><<<dim3(F * n_bt, n_jt, n_it), THREADS, tc_tucker::SMEM, s>>>(
          xa, xb, w, lse, sa, sb, gy, part1, part2, F, B, K1, K2, O, n_bt, vec);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
      tucker_dx_finish<<<dim3(F, cdiv(B, WARPS)), THREADS, 0, s>>>(
          xa, xb, sa, sb, part1, part2, dxa, dxb, F, B, K1, K2, n_jt, n_it);
    } else {
      tc_dx_dense<SOFTMAX><<<dim3(F, cdiv(I, tc_dx::BN), cdiv(B, tc_dx::BM)), THREADS, 0, s>>>(
          xa, w, lse, sa, gy, dxa, B, I, O);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (dw != nullptr) {
    // dense: one row i of K1 = 1, K2 = I columns
    const int k1 = TUCKER ? K1 : 1, k2 = TUCKER ? K2 : I;
    const bool pair = k2 % 2 == 0 && reinterpret_cast<uintptr_t>(dw) % 8 == 0 &&
                      reinterpret_cast<uintptr_t>(w) % 8 == 0;
    err = O <= 64 ? launch_tc_dw<TUCKER, SOFTMAX, 64>(xa, xb, sa, sb, gy, w, lse, rsum, dw, F, B,
                                                       k1, k2, O, pair, s)
                  : launch_tc_dw<TUCKER, SOFTMAX, 128>(xa, xb, sa, sb, gy, w, lse, rsum, dw, F,
                                                        B, k1, k2, O, pair, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// Every entry exists for float (the plain name) and for double (the name with
// _f64). The float lse entries take the tensor-core path (section 6), with
// the scratch ws of lse_bwd_scratch floats (its Tucker entries gain that
// argument); the double ones and every signed entry the kernels of sections
// 1-5, the softmax with an (F, O, I) scratch ws. lse_bwd_tucker_smem: the
// shared memory a block of those sections' Tucker dx kernel uses at (K1,
// K2), static staging tiles included, in bytes. The
// signed entries take the (log-magnitude, sign) inputs and the forward's
// (log|y|, sign y) outputs, and write the gradients of the log-magnitude
// inputs and of the weight (a null pointer skips one).
#define LSE_BWD_ENTRIES(SUFFIX, T)                                                                  \
  int lse_bwd_dense##SUFFIX(const T* x, const T* w, const T* out, const T* g, T* dx, T* dw,     \
                            T* sa, T* gy, int F, int B, int I, int O, int device,               \
                            void* stream) {                                                     \
    return launch_bwd<T, false, false>(x, nullptr, w, out, g, dx, nullptr, dw, sa, nullptr,     \
                                       gy, nullptr, F, B, I, I, 1, O, device, stream);          \
  }                                                                                             \
  int lse_bwd_dense_softmax##SUFFIX(const T* x, const T* theta, const T* out, const T* g,       \
                                    T* dx, T* dtheta, T* sa, T* gy, T* ws, int F, int B,        \
                                    int I, int O, int device, void* stream) {                   \
    return launch_bwd<T, false, true>(x, nullptr, theta, out, g, dx, nullptr, dtheta, sa,       \
                                      nullptr, gy, ws, F, B, I, I, 1, O, device, stream);       \
  }                                                                                             \
  int lse_bwd_tucker##SUFFIX(const T* x1, const T* x2, const T* w, const T* out, const T* g,    \
                             T* dx1, T* dx2, T* dw, T* sa, T* sb, T* gy, int F, int B, int K1,  \
                             int K2, int O, int device, void* stream) {                         \
    return launch_bwd<T, true, false>(x1, x2, w, out, g, dx1, dx2, dw, sa, sb, gy, nullptr, F,  \
                                      B, K1 * K2, K1, K2, O, device, stream);                   \
  }                                                                                             \
  int lse_bwd_tucker_softmax##SUFFIX(const T* x1, const T* x2, const T* theta, const T* out,    \
                                     const T* g, T* dx1, T* dx2, T* dtheta, T* sa, T* sb,       \
                                     T* gy, T* ws, int F, int B, int K1, int K2, int O,         \
                                     int device, void* stream) {                                \
    return launch_bwd<T, true, true>(x1, x2, theta, out, g, dx1, dx2, dtheta, sa, sb, gy, ws,   \
                                     F, B, K1 * K2, K1, K2, O, device, stream);                 \
  }

#define SLSE_BWD_ENTRIES(SUFFIX, T)                                                                 \
  size_t lse_bwd_tucker_smem##SUFFIX(int K1, int K2) {                                          \
    using namespace tucker_dx;                                                                  \
    return tucker_dx_smem<T>(K1, K2) + sizeof(T) * BK * (AS + BS);                              \
  }                                                                                             \
  int slse_bwd_dense##SUFFIX(const T* a, const T* s, const T* w, const T* oa, const T* os,      \
                             const T* g, T* da, T* dw, T* sa, T* gy, int F, int B, int I,       \
                             int O, int device, void* stream) {                                 \
    return launch_bwd<T, false, false, true>(a, nullptr, w, oa, g, da, nullptr, dw, sa,         \
                                             nullptr, gy, nullptr, F, B, I, I, 1, O, device,    \
                                             stream, s, nullptr, os);                           \
  }                                                                                             \
  int slse_bwd_dense_softmax##SUFFIX(const T* a, const T* s, const T* theta, const T* oa,       \
                                     const T* os, const T* g, T* da, T* dtheta, T* sa, T* gy,   \
                                     T* ws, int F, int B, int I, int O, int device,             \
                                     void* stream) {                                            \
    return launch_bwd<T, false, true, true>(a, nullptr, theta, oa, g, da, nullptr, dtheta, sa,  \
                                            nullptr, gy, ws, F, B, I, I, 1, O, device, stream,  \
                                            s, nullptr, os);                                    \
  }                                                                                             \
  int slse_bwd_tucker##SUFFIX(const T* a1, const T* s1, const T* a2, const T* s2, const T* w,   \
                              const T* oa, const T* os, const T* g, T* da1, T* da2, T* dw,      \
                              T* sa, T* sb, T* gy, int F, int B, int K1, int K2, int O,         \
                              int device, void* stream) {                                       \
    return launch_bwd<T, true, false, true>(a1, a2, w, oa, g, da1, da2, dw, sa, sb, gy,         \
                                            nullptr, F, B, K1 * K2, K1, K2, O, device, stream,  \
                                            s1, s2, os);                                        \
  }                                                                                             \
  int slse_bwd_tucker_softmax##SUFFIX(const T* a1, const T* s1, const T* a2, const T* s2,       \
                                      const T* theta, const T* oa, const T* os, const T* g,     \
                                      T* da1, T* da2, T* dtheta, T* sa, T* sb, T* gy, T* ws,    \
                                      int F, int B, int K1, int K2, int O, int device,          \
                                      void* stream) {                                           \
    return launch_bwd<T, true, true, true>(a1, a2, theta, oa, g, da1, da2, dtheta, sa, sb, gy,  \
                                           ws, F, B, K1 * K2, K1, K2, O, device, stream, s1,    \
                                           s2, os);                                             \
  }

size_t lse_bwd_scratch(int tucker, int softmax, int F, int B, int K1, int K2, int O) {
  return tc_scratch(tucker != 0, softmax != 0, F, B, K1, K2, O);
}
int lse_bwd_dense(const float* x, const float* w, const float* out, const float* g, float* dx,
                  float* dw, float* sa, float* gy, int F, int B, int I, int O, int device,
                  void* stream) {
  return launch_bwd_tc<false, false>(x, nullptr, w, out, g, dx, nullptr, dw, sa, nullptr, gy,
                                     nullptr, F, B, I, I, 1, O, device, stream);
}
int lse_bwd_dense_softmax(const float* x, const float* theta, const float* out, const float* g,
                          float* dx, float* dtheta, float* sa, float* gy, float* ws, int F, int B,
                          int I, int O, int device, void* stream) {
  return launch_bwd_tc<false, true>(x, nullptr, theta, out, g, dx, nullptr, dtheta, sa, nullptr,
                                    gy, ws, F, B, I, I, 1, O, device, stream);
}
int lse_bwd_tucker(const float* x1, const float* x2, const float* w, const float* out,
                   const float* g, float* dx1, float* dx2, float* dw, float* sa, float* sb,
                   float* gy, float* ws, int F, int B, int K1, int K2, int O, int device,
                   void* stream) {
  return launch_bwd_tc<true, false>(x1, x2, w, out, g, dx1, dx2, dw, sa, sb, gy, ws, F, B,
                                    K1 * K2, K1, K2, O, device, stream);
}
int lse_bwd_tucker_softmax(const float* x1, const float* x2, const float* theta,
                           const float* out, const float* g, float* dx1, float* dx2,
                           float* dtheta, float* sa, float* sb, float* gy, float* ws, int F,
                           int B, int K1, int K2, int O, int device, void* stream) {
  return launch_bwd_tc<true, true>(x1, x2, theta, out, g, dx1, dx2, dtheta, sa, sb, gy, ws, F,
                                   B, K1 * K2, K1, K2, O, device, stream);
}
LSE_BWD_ENTRIES(_f64, double)
SLSE_BWD_ENTRIES(, float)
SLSE_BWD_ENTRIES(_f64, double)
#undef LSE_BWD_ENTRIES
#undef SLSE_BWD_ENTRIES

}  // extern "C"
