// Wide log-einsum-exp kernels for Hopper (sm_90a): the folded sum-layer
// contractions of the lse-sum semiring whose width I (K1*K2 for Tucker)
// reaches the K=128 circuits' 16384, where a weight row no longer fits the
// single-pass kernel's working set on the TPU.
//
// Replaces three Pallas TPU kernels of cirkit_tpu/ops/lse_einsum.py:
//
//   ct_fwd       `_ct_fwd_kernel` (`_ct_fwd_call`): the K1-chunked Tucker
//                forward, plain weights or logits with an online softmax;
//   blocked_fwd  `_blocked_fwd_kernel` (`_blocked_fwd_call`): the dense
//                forward with an online row max, which it also writes out;
//   blocked_bwd  `_blocked_bwd_kernel` (`_blocked_bwd_call`): the dense
//                backward, reading that row max.
//
// Per fold f, with m the clamped row max of each input and e = exp(x - m):
//
//   tucker:  out[b,o] = log sum_{i,j} w[o,i*K2+j] e1[b,i] e2[b,j] + m1 + m2
//   softmax: w = softmax(theta) over the row, never stored: each K1-chunk
//            of KC rows (KC*K2 columns, the last one ragged) first raises
//            every unit's running max to the chunk's max, rescales that
//            unit's accumulators and normalizer by exp(old - new), then
//            contracts exp(theta - max); out subtracts the log normalizer;
//   dense:   out[b,o] = log sum_i e[b,i] w[o,i] + m[b], the row max grown
//            chunk by chunk of CHUNK columns in the same way, m written out;
//   backward: gy = g * exp(m - out), 0 where not finite;
//            dx = e * (gy @ w),  dw = gy^T e (summed over the whole batch).
//
// What bounds them on the H100: at the K=128 entries (F=784, B=128,
// I=16384, O=128) each forward does 421 GFLOP over 6.6 GB (Tucker) or
// 13.2 GB (dense) read once, the backward 842 GFLOP over 26.3 GB, so all
// three are bound by f32 arithmetic on the CUDA cores (67 TFLOP/s), not by
// memory (3.35 TB/s). They run the register-tiled FMA loop of the
// single-pass kernels (csrc/lse_einsum.cu): 16-wide chunks staged in shared
// memory, each thread accumulating a TMxTN tile, the next chunk loaded into
// registers while the current one is contracted. The chunk-max passes read
// a chunk that the contraction then reads again from L2, so the weights
// (and for the dense forward the inputs) stream from device memory once.
// The dense forward orders its blocks so the two unit tiles of one batch
// tile run side by side and share the input tile through L2. The backward
// gives each block one 64-column strip of a fold: it forms dx of the strip
// over every batch tile (contracting over O), then dw over every unit tile
// (contracting over the batch), so the strip's x and w come from device
// memory once; the batch sum runs in a fixed order with no atomics, so a
// call is deterministic. Any B, O >= 1 and K1, K2 are taken, the ragged
// edges masked. wgmma, TMA and TF32x3 are left for later.
//
// Every kernel is a template over its scalar type T, float or double (the
// entries with _f64), as in lse_einsum.cu: a double block holds twice the
// registers for its accumulators, so one is resident on an SM, not two.
//
// Offsets into the operands are size_t; the sizes, I and the block counts
// must stay below 2^31, which the Python wrappers check. Each extern "C"
// entry selects the given device, launches on the given stream, checks
// cudaGetLastError() after each launch and returns the first error (0 on
// success).

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
using cirkit::log_t;
using cirkit::max_t;
using cirkit::store4;
using cirkit::warp_max;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BK = 16;  // contraction chunk staged in shared memory
template <typename T> constexpr int RESIDENT = sizeof(T) == 4 ? 2 : 1;
// The lowest finite value, the clamped max of an empty prefix.
template <typename T>
__device__ __forceinline__ T lowest() {
  return sizeof(T) == 4 ? -FLT_MAX : -DBL_MAX;
}

// acc[i][j] += sum_kk As[kk][ty*TM + i] * Bs[kk][tx*TN + j] over one staged
// chunk; rows of As and Bs are 16-byte aligned, TM and TN multiples of 4.
template <int TM, int TN, int AS, int BS, typename T>
__device__ __forceinline__ void fma_chunk(const T (*As)[AS], const T (*Bs)[BS], int ty, int tx,
                                          T (&acc)[TM][TN]) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    T a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; i += 4) load4(&As[kk][ty * TM + i], a + i);
#pragma unroll
    for (int j = 0; j < TN; j += 4) load4(&Bs[kk][tx * TN + j], b + j);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fma_t(a[i], b[j], acc[i][j]);
  }
}

// The forward kernels' tiles: 128 batch rows x 64 output units per block,
// 8x4 per thread. Staging: thread tid stages contraction index tid % BK of
// each chunk for the rows (batch rows of A, units of W) tid / BK + n * RSTEP.
namespace fwd {
constexpr int BM = 128;
constexpr int BN = 64;
constexpr int TM = 8;
constexpr int TN = 4;
constexpr int AS = BM + 4;  // padded strides keep float4 reads aligned
constexpr int BS = BN + 4;
constexpr int RSTEP = THREADS / BK;  // 16
constexpr int A_PER = BM / RSTEP;    // 8
constexpr int W_PER = BN / RSTEP;    // 4
}  // namespace fwd

// --------------------------------------------------------------------------
// The K1-chunked Tucker forward (`_ct_fwd_kernel`)
// --------------------------------------------------------------------------

constexpr int CT_CHUNK = 512;  // target columns of a K1-chunk (KC = CT_CHUNK / K2 rows)

template <typename T, bool SOFTMAX>
__global__ void __launch_bounds__(THREADS, RESIDENT<T>)
ct_fwd(const T* __restrict__ x1,  // (F, B, K1)
       const T* __restrict__ x2,  // (F, B, K2)
       const T* __restrict__ w,   // (F, O, K1*K2): weights, or logits for SOFTMAX
       T* __restrict__ out,       // (F, B, O)
       int B, int K1, int K2, int O, int KC) {
  using namespace fwd;
  __shared__ __align__(16) T As[BK][AS];  // e1 * e2, k-major
  __shared__ __align__(16) T Bs[BK][BS];  // weights, k-major
  __shared__ T m1s[BM], m2s[BM];          // the global shifts of x1 and x2
  __shared__ T wmax[BN];  // softmax: each unit's running logit max
  __shared__ T wscl[BN];  // softmax: this chunk's rescale factor
  __shared__ T lsum[BN];  // softmax: log of each unit's normalizer

  const int f = blockIdx.x;
  const int o0 = blockIdx.y * BN;
  const int b0 = blockIdx.z * BM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int I = K1 * K2;
  const T* x1f = x1 + (size_t)f * B * K1;
  const T* x2f = x2 + (size_t)f * B * K2;
  const T* wf = w + (size_t)f * O * I;

  // Prologue: the clamped max of every batch row of x1 and of x2, the shifts
  // of the whole contraction, so the chunks add up with no rescaling.
  for (int r = warp; r < BM; r += WARPS) {
    const int b = b0 + r;
    T a = -INFINITY, c = -INFINITY;
    if (b < B) {
      for (int k = lane; k < K1; k += 32) a = max_t(a, x1f[(size_t)b * K1 + k]);
      for (int k = lane; k < K2; k += 32) c = max_t(c, x2f[(size_t)b * K2 + k]);
    }
    a = warp_max(a);
    c = warp_max(c);
    if (lane == 0) {
      m1s[r] = clamp_max(a);
      m2s[r] = clamp_max(c);
    }
  }
  if (SOFTMAX)
    for (int r = tid; r < BN; r += THREADS) wmax[r] = -INFINITY;
  __syncthreads();

  const int skk = tid % BK;
  const int srow = tid / BK;
  const int tx = tid % (BN / TN);  // output-unit group
  const int ty = tid / (BN / TN);  // batch-row group
  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);
  T part[W_PER];  // softmax: this thread's share of its staged units' normalizers
#pragma unroll
  for (int n = 0; n < W_PER; ++n) part[n] = T(0);
  T pa[A_PER], pw[W_PER];

  for (int i0 = 0; i0 < K1; i0 += KC) {
    const int c0 = i0 * K2;                // first column of the chunk
    const int c1 = min(i0 + KC, K1) * K2;  // one past its last
    if (SOFTMAX) {
      // Each unit's max over the chunk raises its running max; the unit's
      // accumulators and normalizer shrink by exp(old - new). While a
      // unit's logits are all -inf its max stays -inf: scale 1, and the
      // staging below shifts by 0 so exp(-inf) = 0, never NaN.
      for (int r = warp; r < BN; r += WARPS) {
        const int o = o0 + r;
        T cm = -INFINITY;
        if (o < O)
          for (int k = c0 + lane; k < c1; k += 32) cm = max_t(cm, wf[(size_t)o * I + k]);
        cm = warp_max(cm);
        if (lane == 0) {
          const T mo = wmax[r];
          const T mn = max_t(mo, cm);
          wscl[r] = mn == -INFINITY ? T(1) : fast_exp(mo - mn);
          wmax[r] = mn;
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] *= wscl[tx * TN + j];
#pragma unroll
      for (int n = 0; n < W_PER; ++n) part[n] *= wscl[srow + n * RSTEP];
    }

    // This thread's staging column k = c0 + skk + step * BK has digits
    // (si, sj), k = si * K2 + sj, stepped without a division.
    int si = i0 + skk / K2;
    int sj = skk % K2;
    auto load_chunk = [&](int k) {
#pragma unroll
      for (int n = 0; n < A_PER; ++n) {
        const int r = srow + n * RSTEP;
        const int b = b0 + r;
        pa[n] = (b < B && k < c1)
                    ? (x1f[(size_t)b * K1 + si] - m1s[r]) + (x2f[(size_t)b * K2 + sj] - m2s[r])
                    : -INFINITY;
      }
#pragma unroll
      for (int n = 0; n < W_PER; ++n) {
        const int o = o0 + srow + n * RSTEP;
        pw[n] = (o < O && k < c1) ? wf[(size_t)o * I + k] : (SOFTMAX ? -INFINITY : T(0));
      }
    };

    load_chunk(c0 + skk);
    for (int k0 = c0; k0 < c1; k0 += BK) {
#pragma unroll
      for (int n = 0; n < A_PER; ++n) As[skk][srow + n * RSTEP] = fast_exp(pa[n]);
#pragma unroll
      for (int n = 0; n < W_PER; ++n) {
        const int c = srow + n * RSTEP;
        T v = pw[n];
        if (SOFTMAX) {
          const T mx = wmax[c];
          v = fast_exp(v - (mx == -INFINITY ? T(0) : mx));
          part[n] += v;
        }
        Bs[skk][c] = v;
      }
      __syncthreads();
      if (k0 + BK < c1) {
        for (sj += BK; sj >= K2; sj -= K2) ++si;
        load_chunk(k0 + BK + skk);
      }
      fma_chunk<TM, TN, AS, BS>(As, Bs, ty, tx, acc);
      __syncthreads();
    }
  }

  if (SOFTMAX) {
    // The normalizer of each unit: the 16 lanes that staged it (one half of
    // a warp) add their shares by a fixed butterfly.
#pragma unroll
    for (int n = 0; n < W_PER; ++n) {
      T s = part[n];
#pragma unroll
      for (int d = BK / 2; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
      if (skk == 0) lsum[srow + n * RSTEP] = log_t(s);
    }
    __syncthreads();
  }

  // Epilogue: back to log space, masking the ragged batch and unit edges.
  T* outf = out + (size_t)f * B * O;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    const int b = b0 + r;
    if (b >= B) continue;
    const T shift = m1s[r] + m2s[r];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx * TN + j;
      const int o = o0 + c;
      if (o >= O) continue;
      T y = log_t(acc[i][j]);
      if (SOFTMAX) y -= lsum[c];
      outf[(size_t)b * O + o] = y + shift;
    }
  }
}

// --------------------------------------------------------------------------
// The blocked dense forward (`_blocked_fwd_kernel`)
// --------------------------------------------------------------------------

constexpr int BLK_CHUNK = 256;  // columns per step of the online row max

template <typename T>
__global__ void __launch_bounds__(THREADS, RESIDENT<T>)
blocked_fwd(const T* __restrict__ x,  // (F, B, I)
            const T* __restrict__ w,  // (F, O, I)
            T* __restrict__ out,      // (F, B, O)
            T* __restrict__ m_out,    // (F, B): the clamped row max of x
            int B, int I, int O, int n_ot, int n_bt) {
  using namespace fwd;
  __shared__ __align__(16) T As[BK][AS];  // e, k-major
  __shared__ __align__(16) T Bs[BK][BS];  // w, k-major
  __shared__ T rmax[BM];  // running clamped max of each batch row
  __shared__ T rscl[BM];  // this chunk's rescale factor

  // Unit tile fastest: the blocks that share one x tile run side by side.
  const int ot = blockIdx.x % n_ot;
  const int rest = blockIdx.x / n_ot;
  const int bt = rest % n_bt;
  const int f = rest / n_bt;
  const int o0 = ot * BN;
  const int b0 = bt * BM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* xf = x + (size_t)f * B * I;
  const T* wf = w + (size_t)f * O * I;

  // The clamped max of an empty prefix: a row of -inf keeps it, shifts by
  // the lowest finite value and gives log(0) = -inf, never NaN.
  for (int r = tid; r < BM; r += THREADS) rmax[r] = lowest<T>();
  __syncthreads();

  const int skk = tid % BK;
  const int srow = tid / BK;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);
  T pa[A_PER], pw[W_PER];
  int c1 = 0;
  auto load_chunk = [&](int k) {
#pragma unroll
    for (int n = 0; n < A_PER; ++n) {
      const int b = b0 + srow + n * RSTEP;
      pa[n] = (b < B && k < c1) ? xf[(size_t)b * I + k] : -INFINITY;
    }
#pragma unroll
    for (int n = 0; n < W_PER; ++n) {
      const int o = o0 + srow + n * RSTEP;
      pw[n] = (o < O && k < c1) ? wf[(size_t)o * I + k] : T(0);
    }
  };

  for (int c0 = 0; c0 < I; c0 += BLK_CHUNK) {
    c1 = min(c0 + BLK_CHUNK, I);
    // The chunk's row maxes raise the running ones; each row's
    // accumulators shrink by exp(old - new) (both finite: no NaN).
    for (int r = warp; r < BM; r += WARPS) {
      const int b = b0 + r;
      T cm = -INFINITY;
      if (b < B)
        for (int k = c0 + lane; k < c1; k += 32) cm = max_t(cm, xf[(size_t)b * I + k]);
      cm = clamp_max(warp_max(cm));
      if (lane == 0) {
        const T mo = rmax[r];
        const T mn = max_t(mo, cm);
        rscl[r] = fast_exp(mo - mn);
        rmax[r] = mn;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const T s = rscl[ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] *= s;
    }

    load_chunk(c0 + skk);
    for (int k0 = c0; k0 < c1; k0 += BK) {
#pragma unroll
      for (int n = 0; n < A_PER; ++n) {
        const int r = srow + n * RSTEP;
        As[skk][r] = fast_exp(pa[n] - rmax[r]);
      }
#pragma unroll
      for (int n = 0; n < W_PER; ++n) Bs[skk][srow + n * RSTEP] = pw[n];
      __syncthreads();
      if (k0 + BK < c1) load_chunk(k0 + BK + skk);
      fma_chunk<TM, TN, AS, BS>(As, Bs, ty, tx, acc);
      __syncthreads();
    }
  }

  T* outf = out + (size_t)f * B * O;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    const int b = b0 + r;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = o0 + tx * TN + j;
      if (o < O) outf[(size_t)b * O + o] = log_t(acc[i][j]) + rmax[r];
    }
  }
  if (ot == 0 && tid < BM && b0 + tid < B) m_out[(size_t)f * B + b0 + tid] = rmax[tid];
}

// --------------------------------------------------------------------------
// The blocked dense backward (`_blocked_bwd_kernel`)
// --------------------------------------------------------------------------

// gy = g * exp(m - out), 0 where not finite (a row that is all -inf, a
// cotangent of 0 against out = -inf): one warp per batch row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
blocked_gy(const T* __restrict__ out, const T* __restrict__ m,
           const T* __restrict__ g, T* __restrict__ gy, int B, int O) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // warp-uniform
  const size_t row = (size_t)blockIdx.x * B + b;
  const T mb = m[row];
  for (int o = lane; o < O; o += 32) {
    const size_t idx = row * O + o;
    const T v = g[idx] * exp_t(mb - out[idx]);
    gy[idx] = isfinite(v) ? v : T(0);
  }
}

// The backward's tiles: 64 rows (batch rows for dx, units for dw) x 64
// strip columns, 4x4 per thread.
namespace bwd {
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int AS = BM + 4;
constexpr int BS = BN + 4;
constexpr int RSTEP = THREADS / BK;  // 16: row-major staging, rows per pass
constexpr int R_PER = BM / RSTEP;    // 4
constexpr int CSTEP = THREADS / BN;  // 4: strip-major staging, k per pass
constexpr int C_PER = BK / CSTEP;    // 4
static_assert(R_PER == C_PER, "the dw loop stages gy^T into the dx loop's registers");
}  // namespace bwd

// No residency bound: the float instance needs 77 registers, and either
// instance takes what it needs.
template <typename T>
__global__ void __launch_bounds__(THREADS)
blocked_bwd(const T* __restrict__ x,   // (F, B, I)
            const T* __restrict__ w,   // (F, O, I)
            const T* __restrict__ m,   // (F, B) from blocked_fwd
            const T* __restrict__ gy,  // (F, B, O) from blocked_gy
            T* __restrict__ dx,        // (F, B, I), or null
            T* __restrict__ dw,        // (F, O, I), or null
            int B, int I, int O, int n_strips) {
  using namespace bwd;
  __shared__ __align__(16) T As[BK][AS];
  __shared__ __align__(16) T Bs[BK][BS];

  const int f = blockIdx.x / n_strips;
  const int i0 = (blockIdx.x % n_strips) * BN;
  const int tid = threadIdx.x;
  const T* xf = x + (size_t)f * B * I;
  const T* wf = w + (size_t)f * O * I;
  const T* mf = m + (size_t)f * B;
  const T* gyf = gy + (size_t)f * B * O;

  // Row-major staging (gy rows for dx): k = tid % BK, rows tid / BK + n *
  // RSTEP. Strip-major staging (w and e of the strip, gy^T for dw): column
  // tid % BN, k = tid / BN + n * CSTEP. Neighbouring threads read
  // neighbouring addresses in both.
  const int skk = tid % BK;
  const int srow = tid / BK;
  const int scol = tid % BN;
  const int sk = tid / BN;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int c = i0 + scol;  // this thread's staged strip column
  T pa[R_PER], pb[C_PER];
  T acc[TM][TN];
  auto zero = [&] {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = T(0);
  };

  if (dx != nullptr) {
    // dx of the strip, one batch tile at a time: s = gy @ w over the units.
    for (int b0 = 0; b0 < B; b0 += BM) {
      auto load_chunk = [&](int k0) {
#pragma unroll
        for (int n = 0; n < R_PER; ++n) {
          const int b = b0 + srow + n * RSTEP;
          const int o = k0 + skk;
          pa[n] = (b < B && o < O) ? gyf[(size_t)b * O + o] : T(0);
        }
#pragma unroll
        for (int n = 0; n < C_PER; ++n) {
          const int o = k0 + sk + n * CSTEP;
          pb[n] = (o < O && c < I) ? wf[(size_t)o * I + c] : T(0);
        }
      };
      zero();
      load_chunk(0);
      for (int k0 = 0; k0 < O; k0 += BK) {
#pragma unroll
        for (int n = 0; n < R_PER; ++n) As[skk][srow + n * RSTEP] = pa[n];
#pragma unroll
        for (int n = 0; n < C_PER; ++n) Bs[sk + n * CSTEP][scol] = pb[n];
        __syncthreads();
        if (k0 + BK < O) load_chunk(k0 + BK);
        fma_chunk<TM, TN, AS, BS>(As, Bs, ty, tx, acc);
        __syncthreads();
      }
      T* dxf = dx + (size_t)f * B * I;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int b = b0 + ty * TM + i;
        if (b >= B) continue;
        const T mb = mf[b];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int cc = i0 + tx * TN + j;
          if (cc >= I) continue;
          const size_t idx = (size_t)b * I + cc;
          dxf[idx] = exp_t(xf[idx] - mb) * acc[i][j];
        }
      }
    }
  }

  if (dw != nullptr) {
    // dw of the strip, one unit tile at a time: gy^T e over the whole batch,
    // summed in batch order.
    T* dwf = dw + (size_t)f * O * I;
    const bool vec_store = I % 4 == 0;  // dw rows start 16-byte aligned
    for (int u0 = 0; u0 < O; u0 += BM) {
      auto load_chunk = [&](int k0) {
#pragma unroll
        for (int n = 0; n < C_PER; ++n) {
          const int b = k0 + sk + n * CSTEP;
          const int o = u0 + scol;
          pa[n] = (b < B && o < O) ? gyf[(size_t)b * O + o] : T(0);
          pb[n] = (b < B && c < I) ? xf[(size_t)b * I + c] - mf[b] : -INFINITY;
        }
      };
      zero();
      load_chunk(0);
      for (int k0 = 0; k0 < B; k0 += BK) {
#pragma unroll
        for (int n = 0; n < C_PER; ++n) {
          As[sk + n * CSTEP][scol] = pa[n];
          Bs[sk + n * CSTEP][scol] = fast_exp(pb[n]);
        }
        __syncthreads();
        if (k0 + BK < B) load_chunk(k0 + BK);
        fma_chunk<TM, TN, AS, BS>(As, Bs, ty, tx, acc);
        __syncthreads();
      }
      const int cc = i0 + tx * TN;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int o = u0 + ty * TM + i;
        if (o >= O) continue;
        T* dst = dwf + (size_t)o * I + cc;
        if (vec_store && cc + TN <= I) {
          store4(dst, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        } else {
#pragma unroll
          for (int j = 0; j < TN; ++j)
            if (cc + j < I) dst[j] = acc[i][j];
        }
      }
    }
  }
}

inline unsigned cdiv(int a, int b) { return static_cast<unsigned>((a + b - 1) / b); }

template <typename T, bool SOFTMAX>
int launch_ct(const T* x1, const T* x2, const T* w, T* out, int F, int B, int K1, int K2, int O,
              int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int kc = K2 >= CT_CHUNK ? 1 : CT_CHUNK / K2;
  const dim3 grid(F, cdiv(O, fwd::BN), cdiv(B, fwd::BM));
  ct_fwd<T, SOFTMAX><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x1, x2, w, out, B,
                                                                              K1, K2, O, kc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_blocked_fwd(const T* x, const T* w, T* out, T* m, int F, int B, int I, int O,
                       int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int n_ot = static_cast<int>(cdiv(O, fwd::BN));
  const int n_bt = static_cast<int>(cdiv(B, fwd::BM));
  blocked_fwd<T><<<F * n_ot * n_bt, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, out, m, B, I, O, n_ot, n_bt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_blocked_bwd(const T* x, const T* w, const T* out, const T* m, const T* g, T* dx,
                       T* dw, T* gy, int F, int B, int I, int O, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  blocked_gy<T><<<dim3(F, cdiv(B, WARPS)), THREADS, 0, s>>>(out, m, g, gy, B, O);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int n_strips = static_cast<int>(cdiv(I, bwd::BN));
  blocked_bwd<T><<<F * n_strips, THREADS, 0, s>>>(x, w, m, gy, dx, dw, B, I, O, n_strips);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every entry exists for float (the plain name) and for double (_f64).
#define LSE_WIDE_ENTRIES(SUFFIX, T)                                                            \
  int lse_fwd_ct##SUFFIX(const T* x1, const T* x2, const T* w, T* out, int F, int B, int K1,   \
                         int K2, int O, int device, void* stream) {                            \
    return launch_ct<T, false>(x1, x2, w, out, F, B, K1, K2, O, device, stream);               \
  }                                                                                            \
  int lse_fwd_ct_softmax##SUFFIX(const T* x1, const T* x2, const T* theta, T* out, int F,      \
                                 int B, int K1, int K2, int O, int device, void* stream) {     \
    return launch_ct<T, true>(x1, x2, theta, out, F, B, K1, K2, O, device, stream);            \
  }                                                                                            \
  int lse_fwd_blocked##SUFFIX(const T* x, const T* w, T* out, T* m, int F, int B, int I,       \
                              int O, int device, void* stream) {                               \
    return launch_blocked_fwd<T>(x, w, out, m, F, B, I, O, device, stream);                    \
  }                                                                                            \
  int lse_bwd_blocked##SUFFIX(const T* x, const T* w, const T* out, const T* m, const T* g,    \
                              T* dx, T* dw, T* gy, int F, int B, int I, int O, int device,     \
                              void* stream) {                                                  \
    return launch_blocked_bwd<T>(x, w, out, m, g, dx, dw, gy, F, B, I, O, device, stream);     \
  }

LSE_WIDE_ENTRIES(, float)
LSE_WIDE_ENTRIES(_f64, double)
#undef LSE_WIDE_ENTRIES

}  // extern "C"
