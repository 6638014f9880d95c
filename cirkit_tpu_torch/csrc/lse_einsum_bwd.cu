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
// The work is two contractions of the forward's size (s and dw), so like the
// forward it is bound by f32 arithmetic on the CUDA cores, not by memory.
// Each contraction runs the forward's register-tiled FMA loop (16-wide
// chunks staged in shared memory, the next chunk loaded into registers
// while the current one is contracted). The launches of one call:
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
// Measured on an H100 (700 W) at the Tucker softmax flagship shape (F=784,
// B=128, K1=K2=O=64): 8.45 ms against 10.24 ms for the plain PyTorch
// version; dw alone 3.3 ms, 16 TFLOP/s. Softmax adds two memory-bound
// passes over the weights (2.3 ms); see PERF.md for the history.
//
// Every sum runs in an order fixed by the code (no atomics), so a call is
// deterministic from run to run. Any O >= 1 and any batch are taken, the
// ragged edges masked. The Tucker dx kernel keeps (64 x (K1+K2+2)) * 2 +
// 64 x 65 floats of dynamic shared memory (83 KB at K1=K2=64); the wrapper
// refuses widths past the card's 227 KB.
//
// Each extern "C" entry selects the given device, launches on the given
// stream, checks cudaGetLastError() after each launch and returns the first
// error (0 on success). A null dx or dw pointer skips that gradient.

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cuda_runtime.h>

#include "lse_common.cuh"

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

}  // namespace

extern "C" {

// Every entry exists for float (the plain name) and for double (the name with
// _f64). lse_bwd_tucker_smem: the shared memory a block of the Tucker dx
// kernel uses at (K1, K2), static staging tiles included, in bytes. The
// signed entries take the (log-magnitude, sign) inputs and the forward's
// (log|y|, sign y) outputs, and write the gradients of the log-magnitude
// inputs and of the weight (a null pointer skips one).
#define LSE_BWD_ENTRIES(SUFFIX, T)                                                              \
  size_t lse_bwd_tucker_smem##SUFFIX(int K1, int K2) {                                          \
    using namespace tucker_dx;                                                                  \
    return tucker_dx_smem<T>(K1, K2) + sizeof(T) * BK * (AS + BS);                              \
  }                                                                                             \
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

LSE_BWD_ENTRIES(, float)
LSE_BWD_ENTRIES(_f64, double)
#undef LSE_BWD_ENTRIES

}  // extern "C"
