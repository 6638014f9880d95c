// Log-einsum-exp backward for Hopper (sm_90a): the gradients of the folded
// sum-layer contraction of the lse-sum semiring, dense or arity-2 Tucker,
// with an optional softmax of the weight rows.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of
// cirkit_tpu/ops/lse_einsum.py (dispatched by `_call_bwd`, wired in as the
// custom VJP of `_fused_p`), in its four configurations. Per fold f, with
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
using cirkit::warp_max;
using cirkit::warp_sum;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BK = 16;  // contraction chunk staged in shared memory

// --------------------------------------------------------------------------
// 1. Row shifts and gy
// --------------------------------------------------------------------------

template <bool TUCKER>
__global__ void __launch_bounds__(THREADS)
bwd_prep(const float* __restrict__ xa, const float* __restrict__ xb,
         const float* __restrict__ out, const float* __restrict__ g,
         float* __restrict__ sa, float* __restrict__ sb, float* __restrict__ gy,
         int B, int KA, int K2, int O) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // warp-uniform
  const size_t row = (size_t)blockIdx.x * B + b;
  float m1 = -INFINITY, m2 = -INFINITY;
  for (int k = lane; k < KA; k += 32) m1 = fmaxf(m1, xa[row * KA + k]);
  if (TUCKER)
    for (int k = lane; k < K2; k += 32) m2 = fmaxf(m2, xb[row * K2 + k]);
  m1 = clamp_max(warp_max(m1));
  m2 = clamp_max(warp_max(m2));
  if (lane == 0) {
    sa[row] = m1;
    if (TUCKER) sb[row] = m2;
  }
  const float shift = TUCKER ? m1 + m2 : m1;
  for (int o = lane; o < O; o += 32) {
    const size_t idx = row * O + o;
    const float v = g[idx] * expf(shift - out[idx]);
    gy[idx] = isfinite(v) ? v : 0.f;
  }
}

// --------------------------------------------------------------------------
// 2. Softmax weights: w[o, :] = softmax(theta[o, :])
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
softmax_weights(const float* __restrict__ theta, float* __restrict__ w, int O, int I) {
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (o >= O) return;
  const size_t row = ((size_t)blockIdx.x * O + o) * I;
  float m, s;
  cirkit::softmax_row_stats(theta + row, I, lane, &m, &s);
  const float inv = 1.f / s;
  for (int k = lane; k < I; k += 32) w[row + k] = expf(theta[row + k] - m) * inv;
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

__global__ void __launch_bounds__(THREADS, 2)
lse_bwd_dx_dense(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ sa, const float* __restrict__ gy,
                 float* __restrict__ dx, int B, int I, int O) {
  using namespace dense_dx;
  __shared__ __align__(16) float As[BK][AS];  // gy, unit-major
  __shared__ __align__(16) float Bs[BK][BS];  // w, unit-major

  const int f = blockIdx.x;
  const int i0 = blockIdx.y * BN;
  const int b0 = blockIdx.z * BM;
  const int tid = threadIdx.x;
  const float* gyf = gy + (size_t)f * B * O;
  const float* wf = w + (size_t)f * O * I;

  // gy staging: unit kk = tid % BK of each chunk, rows tid / BK + n * RSTEP;
  // w staging: column tid % BN, units tid / BN + n * WSTEP.
  const int skk = tid % BK;
  const int srow = tid / BK;
  const int wcol = tid % BN;
  const int wk = tid / BN;
  float pa[A_PER], pw[W_PER];
  auto load_chunk = [&](int o0) {
#pragma unroll
    for (int n = 0; n < A_PER; ++n) {
      const int b = b0 + srow + n * RSTEP;
      const int o = o0 + skk;
      pa[n] = (b < B && o < O) ? gyf[(size_t)b * O + o] : 0.f;
    }
#pragma unroll
    for (int n = 0; n < W_PER; ++n) {
      const int o = o0 + wk + n * WSTEP;
      const int i = i0 + wcol;
      pw[n] = (o < O && i < I) ? wf[(size_t)o * I + i] : 0.f;
    }
  };

  const int tx = tid % (BN / TN);  // column group
  const int ty = tid / (BN / TN);  // batch-row group
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

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

  const float* xf = x + (size_t)f * B * I;
  float* dxf = dx + (size_t)f * B * I;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = b0 + ty * TM + i;
    if (b >= B) continue;
    const float m = sa[(size_t)f * B + b];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = i0 + tx * TN + j;
      if (c >= I) continue;
      const size_t idx = (size_t)b * I + c;
      dxf[idx] = expf(xf[idx] - m) * acc[i][j];
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
inline size_t tucker_dx_smem(int K1, int K2) {
  using namespace tucker_dx;
  return sizeof(float) * BM * (2 * (K1 + 1) + 2 * (K2 + 1) + SS);
}

__global__ void __launch_bounds__(THREADS)
lse_bwd_dx_tucker(const float* __restrict__ x1, const float* __restrict__ x2,
                  const float* __restrict__ w, const float* __restrict__ sa,
                  const float* __restrict__ sb,
                  const float* __restrict__ gy, float* __restrict__ dx1,
                  float* __restrict__ dx2, int B, int K1, int K2, int O) {
  using namespace tucker_dx;
  __shared__ __align__(16) float As[BK][AS];  // gy, unit-major
  __shared__ __align__(16) float Bs[BK][BS];  // w, unit-major
  extern __shared__ float smem[];
  const int E1S = K1 + 1, E2S = K2 + 1;
  float* E1 = smem;               // [BM][K1+1] e1 of the block's rows
  float* E2 = E1 + BM * E1S;      // [BM][K2+1] e2
  float* A1 = E2 + BM * E2S;      // [BM][K1+1] sum_j s e2
  float* A2 = A1 + BM * E1S;      // [BM][K2+1] sum_i s e1
  float* S = A2 + BM * E2S;       // [BM][BN+1] the current s tile

  const int f = blockIdx.x;
  const int b0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int I = K1 * K2;
  const float* gyf = gy + (size_t)f * B * O;
  const float* wf = w + (size_t)f * O * I;

  // Prologue: the block's exponentials and zeroed accumulators.
  for (int t = tid; t < BM * K1; t += THREADS) {
    const int r = t / K1, k = t - r * K1;
    const int b = b0 + r;
    E1[r * E1S + k] = b < B ? expf(x1[((size_t)f * B + b) * K1 + k] - sa[(size_t)f * B + b])
                            : 0.f;
    A1[r * E1S + k] = 0.f;
  }
  for (int t = tid; t < BM * K2; t += THREADS) {
    const int r = t / K2, k = t - r * K2;
    const int b = b0 + r;
    E2[r * E2S + k] = b < B ? expf(x2[((size_t)f * B + b) * K2 + k] - sb[(size_t)f * B + b])
                            : 0.f;
    A2[r * E2S + k] = 0.f;
  }

  const int skk = tid % BK;
  const int srow = tid / BK;
  const int wcol = tid % BN;
  const int wk = tid / BN;
  float pa[A_PER], pw[W_PER];
  // One step of the flattened (column tile, unit chunk) loop.
  auto load_chunk = [&](int c0, int o0) {
#pragma unroll
    for (int n = 0; n < A_PER; ++n) {
      const int b = b0 + srow + n * RSTEP;
      const int o = o0 + skk;
      pa[n] = (b < B && o < O) ? gyf[(size_t)b * O + o] : 0.f;
    }
#pragma unroll
    for (int n = 0; n < W_PER; ++n) {
      const int o = o0 + wk + n * WSTEP;
      const int c = c0 + wcol;
      pw[n] = (o < O && c < I) ? wf[(size_t)o * I + c] : 0.f;
    }
  };

  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const bool aligned = K2 % BN == 0;
  const int n_chunks = (O + BK - 1) / BK;
  const int n_steps = ((I + BN - 1) / BN) * n_chunks;
  float acc[TM][TN];
  load_chunk(0, 0);
  for (int step = 0; step < n_steps; ++step) {
    const int tile = step / n_chunks;
    const int chunk = step - tile * n_chunks;
    const int c0 = tile * BN;
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
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
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float a[TM] = {av.x, av.y, av.z, av.w};
      const float bb[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
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
        const float e1 = E1[r * E1S + i];
        float* a2 = A2 + r * E2S + j0;
        const float* e2 = E2 + r * E2S + j0;
        float p = 0.f;
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) {
          a2[jj] = fmaf(acc[ii][jj], e1, a2[jj]);
          p = fmaf(acc[ii][jj], e2[jj], p);
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
      const float* srow_p = S + r * SS;
      if (first) {
        float* a1 = A1 + r * E1S;
        const float* e2 = E2 + r * E2S;
        for (int cc = 0; cc < width; ++cc) {
          a1[i] = fmaf(srow_p[cc], e2[j], a1[i]);
          if (++j == K2) {
            j = 0;
            ++i;
          }
        }
      } else {
        float* a2 = A2 + r * E2S;
        const float* e1 = E1 + r * E1S;
        for (int cc = 0; cc < width; ++cc) {
          a2[j] = fmaf(srow_p[cc], e1[i], a2[j]);
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

template <bool TUCKER>
__global__ void __launch_bounds__(THREADS, 2)
lse_bwd_dw(const float* __restrict__ xa, const float* __restrict__ xb,
           const float* __restrict__ sa, const float* __restrict__ sb,
           const float* __restrict__ gy, float* __restrict__ dw, int B, int I, int K1,
           int K2, int O) {
  using namespace dw_tile;
  __shared__ __align__(16) float As[BK][AS];  // e, batch-major
  __shared__ __align__(16) float Bs[BK][BS];  // gy, batch-major

  const int f = blockIdx.x;
  const int o0 = blockIdx.y * BN;
  const int tile0 = blockIdx.z * TILES;
  const int n_tiles = min(TILES, (I + BM - 1) / BM - tile0);
  const int n_chunks = (B + BK - 1) / BK;
  const int n_steps = n_tiles * n_chunks;
  const int tid = threadIdx.x;
  const int KA = TUCKER ? K1 : I;
  const float* xaf = xa + (size_t)f * B * KA;
  const float* xbf = TUCKER ? xb + (size_t)f * B * K2 : nullptr;
  const float* saf = sa + (size_t)f * B;
  const float* sbf = TUCKER ? sb + (size_t)f * B : nullptr;
  const float* gyf = gy + (size_t)f * B * O;

  // e staging: column ec = tid % BM of the tile, batch rows tid / BM + n *
  // ESTEP; gy staging: unit tid % BN, batch rows tid / BN + n * GSTEP.
  const int ec = tid % BM;
  const int eb = tid / BM;
  const int go = tid % BN;
  const int gb = tid / BN;
  float pe[E_PER], pg[G_PER];
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
      float v = -INFINITY;
      if (b < B && c < I) {
        v = TUCKER ? (xaf[(size_t)b * K1 + ci] - saf[b]) + (xbf[(size_t)b * K2 + cj] - sbf[b])
                   : xaf[(size_t)b * I + c] - saf[b];
      }
      pe[n] = v;
    }
#pragma unroll
    for (int n = 0; n < G_PER; ++n) {
      const int b = k0 + gb + n * GSTEP;
      const int o = o0 + go;
      pg[n] = (b < B && o < O) ? gyf[(size_t)b * O + o] : 0.f;
    }
  };

  const int tx = tid % (BN / TN);  // unit group
  const int ty = tid / (BN / TN);  // column group
  float* dwf = dw + (size_t)f * O * I;
  const bool vec_store = I % 4 == 0;  // dw rows start 16-byte aligned
  float acc[TM][TN];
  load_chunk(0);
  for (int step = 0; step < n_steps; ++step) {
    const int tile = step / n_chunks;
    const int chunk = step - tile * n_chunks;
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < E_PER; ++n) As[eb + n * ESTEP][ec] = __expf(pe[n]);
#pragma unroll
    for (int n = 0; n < G_PER; ++n) Bs[gb + n * GSTEP][go] = pg[n];
    __syncthreads();
    if (step + 1 < n_steps) load_chunk(step + 1);
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
    if (chunk != n_chunks - 1) continue;

    // Tile epilogue: the finished dw tile, masking the ragged edges. A
    // thread's TM columns of one unit are contiguous: two float4 stores fill
    // one 32-byte sector where the row is 16-byte aligned.
    const int cc = (tile0 + tile) * BM + ty * TM;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = o0 + tx * TN + j;
      if (o >= O) continue;
      float* dst = dwf + (size_t)o * I + cc;
      if (vec_store && cc + TM <= I) {
        reinterpret_cast<float4*>(dst)[0] =
            make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
        reinterpret_cast<float4*>(dst)[1] =
            make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
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

__global__ void __launch_bounds__(THREADS)
softmax_vjp(const float* __restrict__ w, float* __restrict__ dw, int O, int I) {
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (o >= O) return;
  const size_t row = ((size_t)blockIdx.x * O + o) * I;
  const float* wr = w + row;
  float* d = dw + row;
  float dot = 0.f;
  for (int k = lane; k < I; k += 32) dot = fmaf(wr[k], d[k], dot);
  dot = warp_sum(dot);
  for (int k = lane; k < I; k += 32) d[k] = wr[k] * (d[k] - dot);
}

// --------------------------------------------------------------------------
// Launch
// --------------------------------------------------------------------------

inline unsigned cdiv(int a, int b) { return static_cast<unsigned>((a + b - 1) / b); }

// ``w`` is the weight, or for SOFTMAX the logits and ``ws`` the (F, O, I)
// scratch that receives their softmax.
template <bool TUCKER, bool SOFTMAX>
int launch_bwd(const float* xa, const float* xb, const float* w, const float* out,
               const float* g, float* dxa, float* dxb, float* dw, float* sa, float* sb,
               float* gy, float* ws, int F, int B, int I, int K1, int K2, int O, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool need_dx = dxa != nullptr || dxb != nullptr;
  const int KA = TUCKER ? K1 : I;

  bwd_prep<TUCKER><<<dim3(F, cdiv(B, WARPS)), THREADS, 0, s>>>(xa, xb, out, g, sa, sb, gy, B,
                                                                KA, K2, O);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (SOFTMAX) {
    softmax_weights<<<dim3(F, cdiv(O, WARPS)), THREADS, 0, s>>>(w, ws, O, I);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    w = ws;
  }
  if (need_dx) {
    if (TUCKER) {
      const size_t smem = tucker_dx_smem(K1, K2);
      err = cudaFuncSetAttribute(lse_bwd_dx_tucker, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      lse_bwd_dx_tucker<<<dim3(F, cdiv(B, tucker_dx::BM)), THREADS, smem, s>>>(
          xa, xb, w, sa, sb, gy, dxa, dxb, B, K1, K2, O);
    } else {
      lse_bwd_dx_dense<<<dim3(F, cdiv(I, dense_dx::BN), cdiv(B, dense_dx::BM)), THREADS, 0, s>>>(
          xa, w, sa, gy, dxa, B, I, O);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (dw != nullptr) {
    const dim3 grid(F, cdiv(O, dw_tile::BN), cdiv(I, dw_tile::BM * dw_tile::TILES));
    lse_bwd_dw<TUCKER><<<grid, THREADS, 0, s>>>(xa, xb, sa, sb, gy, dw, B, I, K1, K2, O);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if (SOFTMAX) {
      softmax_vjp<<<dim3(F, cdiv(O, WARPS)), THREADS, 0, s>>>(w, dw, O, I);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Shared memory a block of the Tucker dx kernel uses at (K1, K2), static
// staging tiles included, in bytes.
size_t lse_bwd_tucker_smem(int K1, int K2) {
  using namespace tucker_dx;
  return tucker_dx_smem(K1, K2) + sizeof(float) * BK * (AS + BS);
}

int lse_bwd_dense(const float* x, const float* w, const float* out, const float* g, float* dx,
                  float* dw, float* sa, float* gy, int F, int B, int I, int O, int device,
                  void* stream) {
  return launch_bwd<false, false>(x, nullptr, w, out, g, dx, nullptr, dw, sa, nullptr, gy,
                                  nullptr, F, B, I, I, 1, O, device, stream);
}

int lse_bwd_dense_softmax(const float* x, const float* theta, const float* out, const float* g,
                          float* dx, float* dtheta, float* sa, float* gy, float* ws, int F,
                          int B, int I, int O, int device, void* stream) {
  return launch_bwd<false, true>(x, nullptr, theta, out, g, dx, nullptr, dtheta, sa, nullptr,
                                 gy, ws, F, B, I, I, 1, O, device, stream);
}

int lse_bwd_tucker(const float* x1, const float* x2, const float* w, const float* out,
                   const float* g, float* dx1, float* dx2, float* dw, float* sa, float* sb,
                   float* gy, int F, int B, int K1, int K2, int O, int device, void* stream) {
  return launch_bwd<true, false>(x1, x2, w, out, g, dx1, dx2, dw, sa, sb, gy, nullptr, F, B,
                                 K1 * K2, K1, K2, O, device, stream);
}

int lse_bwd_tucker_softmax(const float* x1, const float* x2, const float* theta,
                           const float* out, const float* g, float* dx1, float* dx2,
                           float* dtheta, float* sa, float* sb, float* gy, float* ws, int F,
                           int B, int K1, int K2, int O, int device, void* stream) {
  return launch_bwd<true, true>(x1, x2, theta, out, g, dx1, dx2, dtheta, sa, sb, gy, ws, F, B,
                                K1 * K2, K1, K2, O, device, stream);
}

}  // extern "C"
