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
// 13.2 GB (dense) read once, the backward 842 GFLOP over 26.3 GB. On the
// f32 CUDA cores (67 TFLOP/s) the arithmetic binds all three; in 3xTF32 on
// the tensor cores (three TF32 products of 495 TFLOP/s for an f32-grade
// one) the Tucker forward still is (2.6 ms against 2.0 ms of bytes), while
// the dense backward is bound by its bytes (7.9 ms at 3.35 TB/s).
//
// The float K1-chunked Tucker forward (ct_fwd_tc), the float dense forward
// (blocked_fwd_tc) and the float dense backward (blocked_gy_tc +
// blocked_bwd_tc) run on the tensor cores: warp mma.sync.m16n8k8 in 3xTF32
// with f32 accumulators (tc_common.cuh), each operand split into its TF32
// high and low parts once, as it is staged in shared memory (a plane of
// each), so the warps only load fragments and issue mma instructions;
// sixteen warps a block, four on each SM sub-partition, since one warp
// issues TF32 mma.sync at a fraction of the tensor core's rate. Their
// designs are described above each kernel. The float32 K1-chunked kernel
// also has bf16-weight instances (WT; ops/lse_einsum.py's INSTANCES), which
// stage the weight as bf16 and drop the products with its zero low parts;
// its fast-mode instances run on the bf16 tensor cores (tucker_fwd_bf16,
// csrc/tucker_bf16.cu), and so do the blocked kernels' bf16-weight and
// fast-mode instances (csrc/blocked_bf16.cu).
// The double instances run the register-tiled FMA loop of
// csrc/lse_einsum.cu on the CUDA cores: 16-wide chunks staged in shared
// memory, each thread accumulating a TMxTN tile, the next chunk loaded into
// registers while the current one is contracted. The chunk-max passes read
// a chunk that the contraction then reads again from L2, so the weights
// (and for the dense forward the inputs) stream from device memory once.
// The double dense forward orders its blocks so the two unit tiles of one
// batch tile run side by side and share the input tile through L2. Both
// backwards give each block one 64-column strip of a fold, so the strip's x
// and w come from device memory once; the batch sum runs in a fixed order
// with no atomics, so a call is deterministic. Any B, O >= 1 and K1, K2 are taken, the ragged edges
// masked. wgmma and TMA are left for later.
//
// Every kernel but the tensor-core ones is a template over its scalar type
// T, float or double (the entries with _f64), as in lse_einsum.cu: a double
// block holds twice the registers for its accumulators, so one is resident
// on an SM, not two.
//
// Offsets into the operands are size_t; the sizes, I and the block counts
// must stay below 2^31, which the Python wrappers check. Each extern "C"
// entry selects the given device, launches on the given stream, checks
// cudaGetLastError() after each launch and returns the first error (0 on
// success).

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
using cirkit::load_w4;
using cirkit::widen;
using cirkit::fast_exp;
using cirkit::fma_t;
using cirkit::load4;
using cirkit::log_t;
using cirkit::max_t;
using cirkit::store4;
using cirkit::warp_max;
using cirkit::cp_async_commit;
using cirkit::cp_async_wait;
using cirkit::mma3_tf32;
using cirkit::split_tf32;
using cirkit::split_tf32x4;

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

// The double instances on the CUDA cores; the float ones are ct_fwd_tc below.
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

// The float instances on the tensor cores. For a fixed row i the operand is
// diag(e1[:, i]) E2, so a block (fold, 128 batch rows, 128 units) stages
// E2 = exp(x2 - m2) of its rows once, chunk by chunk of JC columns j, split
// into TF32 high and low parts as it is staged; for each row i it contracts
// S = E2 W_i^T over the chunk's j on the tensor cores (3xTF32 mma.sync,
// each of the 16 warps a 32 x 32 tile), W_i the chunk's weights w[o, i*K2 +
// j] of the block's units, streamed through registers into a ring of two
// split buffers (the next row's loads in flight while the current one is
// contracted), and folds acc += e1[b, i] * S in f32 registers. Softmax, in
// one pass over theta: the eight threads that stage a unit's segment (its
// 32 logits of row i) raise the unit's running max to the segment's max,
// held in their registers, and stage w = exp(theta - max); the fold first
// scales the unit's accumulators by exp(old max - new max), and the
// stagers' normalizer partials shrink by the same factor. A unit whose
// logits have all been -inf so far keeps max -inf, scale 1 and shift 0, so
// exp(-inf) = 0 and no NaN.
//
// WT as in tucker_fwd_tc (csrc/lse_einsum.cu): a bf16 weight is read 8
// bytes for four and its zero low plane dropped (two mma.sync where three
// ran). The fast modes' instances run on the bf16 tensor cores instead
// (tucker_fwd_bf16, csrc/tucker_bf16.cu).
namespace ct_tc {
constexpr int BM = 128;     // batch rows a block
constexpr int BN = 128;     // units a block
constexpr int JC = 32;      // columns j a chunk
constexpr int IC = 32;      // rows i whose e1 is staged at once
constexpr int S = JC + 4;   // plane row stride in words, 4 mod 32: fragment loads hit 32 banks
constexpr int NT_ = 512;  // threads a block: four warps on each SM sub-partition
constexpr int NW = NT_ / 32;
constexpr int RS = NT_ / 8;                // staging rows a pass
constexpr int Q = BN * JC / 4 / NT_;       // float4 slots a thread stages of a chunk (2)
// E2's two planes, the ring's two buffers of two planes, e1, the shifts and
// the softmax's factors and normalizers
constexpr size_t SMEM = sizeof(float) * (2 * (BM + 2 * BN) * S + IC * BM + 2 * BM + 3 * BN);
}  // namespace ct_tc

template <bool SOFTMAX, typename WT = float>
__global__ void __launch_bounds__(ct_tc::NT_, 1)
ct_fwd_tc(const float* __restrict__ x1,    // (F, B, K1)
          const float* __restrict__ x2,    // (F, B, K2)
          const WT* __restrict__ w,        // (F, O, K1*K2): weights, or logits for SOFTMAX
          float* __restrict__ out,         // (F, B, O)
          int B, int K1, int K2, int O, bool vec) {
  using namespace ct_tc;
  constexpr bool W_SPLIT = SOFTMAX || sizeof(WT) == 4;
  extern __shared__ __align__(16) uint32_t ct_smem[];
  uint32_t* E2h = ct_smem;     // [BM][S]: E2's high parts, then its low parts
  uint32_t* E2l = E2h + BM * S;
  uint32_t* Wsm = E2l + BM * S;  // [2][2][BN][S]: the ring, each buffer high then low
  float* E1s = reinterpret_cast<float*>(Wsm + 4 * BN * S);  // [IC][BM]
  float* m1s = E1s + IC * BM;
  float* m2s = m1s + BM;
  float* wscl = m2s + BM;    // softmax: [2][BN], each staged segment's rescale factors
  float* lsum = wscl + 2 * BN;  // softmax: each unit's log-normalizer

  const int f = blockIdx.x;
  const int o0 = blockIdx.y * BN;
  const int b0 = blockIdx.z * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;  // the warp's 32 x 32 tile
  const int I = K1 * K2;
  const float* x1f = x1 + (size_t)f * B * K1;
  const float* x2f = x2 + (size_t)f * B * K2;
  const WT* wf = w + (size_t)f * O * I;

  // Prologue: the clamped row maxes of x1 and x2 (the shifts of the whole
  // contraction) and, for softmax, each unit's log-normalizer.
  for (int r = warp; r < BM; r += NW) {
    const int b = b0 + r;
    float a = -INFINITY, c = -INFINITY;
    if (b < B) {
      for (int k = lane; k < K1; k += 32) a = fmaxf(a, x1f[(size_t)b * K1 + k]);
      for (int k = lane; k < K2; k += 32) c = fmaxf(c, x2f[(size_t)b * K2 + k]);
    }
    a = warp_max(a);
    c = warp_max(c);
    if (lane == 0) {
      m1s[r] = clamp_max(a);
      m2s[r] = clamp_max(c);
    }
  }
  __syncthreads();

  // Staging map of a chunk (E2 and W alike): row tid / 8 + RS q, columns
  // 4 (tid % 8) .. + 3 of the chunk.
  const int sr = tid >> 3, sc = 4 * (tid & 7);
  float4 pw[Q];
  float rmax[Q], part[Q];  // softmax: the running max and normalizer share of rows sr + RS q
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    rmax[q] = -INFINITY;
    part[q] = 0.f;
  }
  auto load_w = [&](int i, int j0) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int o = o0 + sr + RS * q;
      const int j = j0 + sc;
      const WT* src = wf + (size_t)o * I + (size_t)i * K2 + j;
      const float pad = SOFTMAX ? -INFINITY : 0.f;
      if (vec) {  // K2 % 4 == 0: the four columns are in or out together
        pw[q] = o < O && j < K2 ? load_w4(src) : make_float4(pad, pad, pad, pad);
      } else {
        const bool in = o < O;
        pw[q] = make_float4(in && j < K2 ? widen(src[0]) : pad,
                            in && j + 1 < K2 ? widen(src[1]) : pad,
                            in && j + 2 < K2 ? widen(src[2]) : pad,
                            in && j + 3 < K2 ? widen(src[3]) : pad);
      }
    }
  };
  auto store_w = [&](int buf, int i, int j0) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int r = sr + RS * q;
      float4 v = pw[q];
      if (SOFTMAX) {  // exp(-inf) = 0 past the edges and at logits of -inf
        float cm = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
#pragma unroll
        for (int d = 1; d < 8; d <<= 1) cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, d));
        const float mn = fmaxf(rmax[q], cm);
        const float scl = mn == -INFINITY ? 1.f : fast_exp(rmax[q] - mn);
        const float sh = mn == -INFINITY ? 0.f : mn;
        rmax[q] = mn;
        v = make_float4(fast_exp(v.x - sh), fast_exp(v.y - sh), fast_exp(v.z - sh),
                        fast_exp(v.w - sh));
        part[q] = fmaf(part[q], scl, (v.x + v.y) + (v.z + v.w));
        if (sc == 0) wscl[buf * BN + r] = scl;
      }
      uint32_t* wh = Wsm + 2 * buf * BN * S;
      if (W_SPLIT) {
        uint4 hi, lo;
        split_tf32x4(v, hi, lo);
        *reinterpret_cast<uint4*>(wh + r * S + sc) = hi;
        *reinterpret_cast<uint4*>(wh + (BN + r) * S + sc) = lo;
      } else {  // a bf16 weight: exact in TF32
        *reinterpret_cast<uint4*>(wh + r * S + sc) = make_uint4(
            __float_as_uint(v.x), __float_as_uint(v.y), __float_as_uint(v.z), __float_as_uint(v.w));
      }
    }
  };

  float acc[2][4][4], s[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int j0 = 0; j0 < K2; j0 += JC) {
    const int nk = (min(JC, K2 - j0) + 7) / 8;  // k-steps of 8 columns holding data
    for (int i0 = 0; i0 < K1; i0 += IC) {
      const int n_i = min(IC, K1 - i0);
      __syncthreads();  // every warp is done with the buffers of the last chunk
      load_w(i0, j0);
      if (i0 == 0) {  // E2 of the chunk's columns
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int r = sr + RS * q, b = b0 + r;
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + sc + e;
            v[e] = b < B && j < K2 ? expf(x2f[(size_t)b * K2 + j] - m2s[r]) : 0.f;
          }
          uint4 hi, lo;
          split_tf32x4(make_float4(v[0], v[1], v[2], v[3]), hi, lo);
          *reinterpret_cast<uint4*>(E2h + r * S + sc) = hi;
          *reinterpret_cast<uint4*>(E2l + r * S + sc) = lo;
        }
      }
      for (int e = tid; e < IC * BM; e += NT_) {  // e1 of the rows i0 .. i0 + n_i - 1
        const int il = e / BM, r = e - il * BM, b = b0 + r;
        E1s[e] = b < B && il < n_i ? expf(x1f[(size_t)b * K1 + i0 + il] - m1s[r]) : 0.f;
      }
      store_w(0, i0, j0);
      __syncthreads();

      for (int il = 0; il < n_i; ++il) {
        const int cur = il & 1;
        const bool more = il + 1 < n_i;
        if (more) load_w(i0 + il + 1, j0);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
        const uint32_t* wh = Wsm + 2 * cur * BN * S;
        const uint32_t* wl = wh + BN * S;
        for (int k8 = 0; k8 < nk; ++k8) {
          const int kk = 8 * k8 + t;
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int o = (wn + 8 * nt + g) * S + kk;
            bh[nt][0] = wh[o];
            bh[nt][1] = wh[o + 4];
            if (W_SPLIT) {
              bl[nt][0] = wl[o];
              bl[nt][1] = wl[o + 4];
            }
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int o = (wm + 16 * mt + g) * S + kk;
            const uint32_t ah[4] = {E2h[o], E2h[o + 8 * S], E2h[o + 4], E2h[o + 8 * S + 4]};
            const uint32_t al[4] = {E2l[o], E2l[o + 8 * S], E2l[o + 4], E2l[o + 8 * S + 4]};
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              if (W_SPLIT) {
                mma3_tf32(s[mt][nt], ah, al, bh[nt], bl[nt]);
              } else {  // the weight's low plane is 0
                cirkit::mma_tf32(s[mt][nt], al, bh[nt]);
                cirkit::mma_tf32(s[mt][nt], ah, bh[nt]);
              }
            }
          }
        }
        // acc += e1[b, i] * S, softmax: acc scaled by its unit's factor first
        const float* e1 = E1s + il * BM;
        float2 scl[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          scl[nt] = SOFTMAX ? *reinterpret_cast<const float2*>(&wscl[cur * BN + wn + 8 * nt + 2 * t])
                            : make_float2(1.f, 1.f);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float e = e1[wm + 16 * mt + g + 8 * h];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              float* a = acc[mt][nt] + 2 * h;
              const float* sv = s[mt][nt] + 2 * h;
              a[0] = fmaf(e, sv[0], SOFTMAX ? a[0] * scl[nt].x : a[0]);
              a[1] = fmaf(e, sv[1], SOFTMAX ? a[1] * scl[nt].y : a[1]);
            }
          }
        if (more) store_w(cur ^ 1, i0 + il + 1, j0);
        __syncthreads();
      }
    }
  }

  if (SOFTMAX) {
    // The normalizer of each unit: the eight threads that staged it add
    // their shares by a fixed butterfly.
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float p = part[q];
#pragma unroll
      for (int d = 1; d < 8; d <<= 1) p += __shfl_xor_sync(0xffffffffu, p, d);
      if (sc == 0) lsum[sr + RS * q] = logf(p);
    }
    __syncthreads();
  }

  // Epilogue: back to log space, masking the ragged batch and unit edges.
  float* outf = out + (size_t)f * B * O;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + 16 * mt + g + 8 * h, b = b0 + r;
      if (b >= B) continue;
      const float shift = m1s[r] + m2s[r];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = wn + 8 * nt + 2 * t + e, o = o0 + c;
          float y = logf(acc[mt][nt][2 * h + e]);
          if (SOFTMAX) y -= lsum[c];
          if (o < O) outf[(size_t)b * O + o] = y + shift;
        }
    }
}

// --------------------------------------------------------------------------
// The blocked dense forward (`_blocked_fwd_kernel`)
// --------------------------------------------------------------------------

// The double instance on the CUDA cores; the float one is blocked_fwd_tc below.
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

// The float instance on the tensor cores. A block owns one fold, BM batch
// rows and BN units (all 128 of the K=128 circuits), so x streams from
// device memory once a fold and each weight element once a batch tile. It
// walks I in chunks of KC columns: the chunk's x rows and w rows are copied
// by cp.async into a ring of STAGES raw buffers (two chunks in flight while
// one is staged and contracted). The four threads that stage a row of x
// take the chunk's max from the staged chunk (two shuffles), raise the
// row's running clamped max, which they hold in a register, write the
// row's factor exp(old - new) and stage e = exp(x - new); w is staged as it
// is; each split into a plane of TF32 high parts and one of low parts. The
// 16 warps (each a 32 x 32 tile, four on each SM sub-partition) contract the
// chunk in 3xTF32 mma.sync from zero, then scale their rows' accumulators
// by the factors and add the chunk's sums in f32 FMAs: the tensor core's
// own f32 accumulation drifts over long sums (accumulated there over all
// 16384 columns of the K=128 entry, the sum is off float64 by 2.7e-4 in log
// space), over 32 columns it does not. So x is read once, the row max from
// the chunk already in shared memory. The clamped max of an empty prefix is the lowest finite value:
// a row of -inf keeps it, scales by exp(0) = 1, stages exp(-inf) = 0 and
// gives log(0) = -inf, never NaN; columns past I and rows past B stage as
// -inf and 0. Plane rows of S = KC + 4 words (4 mod 32) let every fragment
// load hit 32 banks. Ragged I or unaligned operands take 4-byte copies.
namespace blk_tc {
constexpr int BM = 128;          // batch rows a block
constexpr int BN = 128;          // units a block
constexpr int KC = 32;           // columns a chunk
constexpr int S = KC + 4;        // plane and ring row stride in words
constexpr int STAGES = 3;        // the cp.async ring
constexpr int NT_ = 512;         // threads a block: four warps on each SM sub-partition
constexpr int ROWS = BM + BN;    // a chunk's rows: x's, then w's
constexpr int CQ = ROWS * KC / 4 / NT_;  // float4 copies a thread issues a chunk (4)
// the ring, the two planes and the row factors: 185 KB, one block an SM
constexpr size_t SMEM = sizeof(float) * ((STAGES + 2) * ROWS * S + BM);
}  // namespace blk_tc

__global__ void __launch_bounds__(blk_tc::NT_, 1)
blocked_fwd_tc(const float* __restrict__ x,  // (F, B, I)
               const float* __restrict__ w,  // (F, O, I)
               float* __restrict__ out,      // (F, B, O)
               float* __restrict__ m_out,    // (F, B): the clamped row max of x
               int B, int I, int O, int n_ot, int n_bt, bool vec) {
  using namespace blk_tc;
  extern __shared__ __align__(16) float blk_smem[];
  float* ring = blk_smem;  // [STAGES][ROWS][S]
  uint32_t* Ph = reinterpret_cast<uint32_t*>(ring + STAGES * ROWS * S);  // [ROWS][S] high parts
  uint32_t* Pl = Ph + ROWS * S;                                          //           low parts
  float* rscl = reinterpret_cast<float*>(Pl + ROWS * S);  // [BM] this chunk's row factors

  // Unit tile fastest: the blocks that share one x tile run side by side.
  const int ot = blockIdx.x % n_ot;
  const int rest = blockIdx.x / n_ot;
  const int bt = rest % n_bt;
  const int f = rest / n_bt;
  const int o0 = ot * BN, b0 = bt * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;  // the warp's 32 x 32 tile
  const float* xf = x + (size_t)f * B * I;
  const float* wf = w + (size_t)f * O * I;
  const int n_ch = (I + KC - 1) / KC;

  // Copy map: ring rows tid / 8 + 64 q (x rows b0 + r, then w rows o0 + r -
  // BM), columns 4 (tid % 8) .. + 3 of the chunk.
  const int cr = tid >> 3, cc = 4 * (tid & 7);
  auto fetch = [&](int ch) {
    float* dst = ring + (ch % STAGES) * ROWS * S;
    const int c = ch * KC + cc;
#pragma unroll
    for (int q = 0; q < CQ; ++q) {
      const int r = cr + 64 * q;
      const bool xrow = r < BM;
      const int gr = xrow ? b0 + r : o0 + r - BM;
      const bool in_row = gr < (xrow ? B : O);
      const float* src = (xrow ? xf : wf) + (size_t)gr * I + c;
      float* d = dst + r * S + cc;
      if (vec) {  // I % 4 == 0: the four columns are in or out together
        const bool in = in_row && c < I;
        cirkit::cp_async_f32x4(d, in ? src : x, in);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = in_row && c + e < I;
          cirkit::cp_async_f32(d + e, in ? src + e : x, in);
        }
      }
    }
  };

  // Staging map: row tid / 4 of x and of w, columns 8 (tid % 4) .. + 7; the
  // four threads of a row are neighbouring lanes.
  const int sr = tid >> 2, sc = 8 * (tid & 3);
  const bool row_in = b0 + sr < B;
  float rm = -FLT_MAX;  // the running clamped max of x's row b0 + sr
  auto store_split = [&](uint32_t* hi, uint32_t* lo, const float4& v) {
    uint4 h, l;
    split_tf32x4(v, h, l);
    *reinterpret_cast<uint4*>(hi) = h;
    *reinterpret_cast<uint4*>(lo) = l;
  };

  float acc[2][4][4], part[2][4][4];  // the sums so far, and the chunk's
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int ch = 0; ch < STAGES - 1; ++ch) {
    if (ch < n_ch) fetch(ch);
    cp_async_commit();
  }
  for (int ch = 0; ch < n_ch; ++ch) {
    cp_async_wait<STAGES - 2>();
    // the chunk has landed for every thread; every warp is done with the
    // planes and with the ring buffer refilled next
    __syncthreads();
    if (ch + STAGES - 1 < n_ch) fetch(ch + STAGES - 1);
    cp_async_commit();
    {
      const float* src = ring + (ch % STAGES) * ROWS * S;
      const int c0 = ch * KC + sc;
      const float4 x0 = *reinterpret_cast<const float4*>(src + sr * S + sc);
      const float4 x1 = *reinterpret_cast<const float4*>(src + sr * S + sc + 4);
      float v[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      float cm = -INFINITY;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (!row_in || c0 + e >= I) v[e] = -INFINITY;
        cm = fmaxf(cm, v[e]);
      }
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
      const float mn = fmaxf(rm, clamp_max(cm));
      if ((tid & 3) == 0) rscl[sr] = expf(rm - mn);
      rm = mn;
      store_split(Ph + sr * S + sc, Pl + sr * S + sc,
                  make_float4(expf(v[0] - mn), expf(v[1] - mn), expf(v[2] - mn),
                              expf(v[3] - mn)));
      store_split(Ph + sr * S + sc + 4, Pl + sr * S + sc + 4,
                  make_float4(expf(v[4] - mn), expf(v[5] - mn), expf(v[6] - mn),
                              expf(v[7] - mn)));
      const float* wr = src + (BM + sr) * S + sc;
      store_split(Ph + (BM + sr) * S + sc, Pl + (BM + sr) * S + sc,
                  *reinterpret_cast<const float4*>(wr));
      store_split(Ph + (BM + sr) * S + sc + 4, Pl + (BM + sr) * S + sc + 4,
                  *reinterpret_cast<const float4*>(wr + 4));
    }
    __syncthreads();  // the chunk's planes and row factors are staged

#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
    const uint32_t* Wh = Ph + BM * S;
    const uint32_t* Wl = Pl + BM * S;
#pragma unroll
    for (int k8 = 0; k8 < KC / 8; ++k8) {
      const int kk = 8 * k8 + t;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int o = (wn + 8 * nt + g) * S + kk;
        bh[nt][0] = Wh[o];
        bh[nt][1] = Wh[o + 4];
        bl[nt][0] = Wl[o];
        bl[nt][1] = Wl[o + 4];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int o = (wm + 16 * mt + g) * S + kk;
        const uint32_t ah[4] = {Ph[o], Ph[o + 8 * S], Ph[o + 4], Ph[o + 8 * S + 4]};
        const uint32_t al[4] = {Pl[o], Pl[o + 8 * S], Pl[o + 4], Pl[o + 8 * S + 4]};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma3_tf32(part[mt][nt], ah, al, bh[nt], bl[nt]);
      }
    }
    // acc = acc * exp(old max - new max) + the chunk's products, in f32 FMAs
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float scl = rscl[wm + 16 * mt + g + 8 * h];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          acc[mt][nt][2 * h] = fmaf(acc[mt][nt][2 * h], scl, part[mt][nt][2 * h]);
          acc[mt][nt][2 * h + 1] = fmaf(acc[mt][nt][2 * h + 1], scl, part[mt][nt][2 * h + 1]);
        }
      }
  }
  cp_async_wait<0>();

  // Epilogue: each row's final max, from its stagers, then back to log
  // space, masking the ragged batch and unit edges.
  __syncthreads();  // every warp is done with the row factors
  if ((tid & 3) == 0) rscl[sr] = rm;
  __syncthreads();
  float* outf = out + (size_t)f * B * O;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + 16 * mt + g + 8 * h, b = b0 + r;
      if (b >= B) continue;
      const float mb = rscl[r];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + wn + 8 * nt + 2 * t + e;
          if (o < O) outf[(size_t)b * O + o] = logf(acc[mt][nt][2 * h + e]) + mb;
        }
    }
  if (ot == 0 && (tid & 3) == 0 && row_in) m_out[(size_t)f * B + b0 + sr] = rm;
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

// The double instances on the CUDA cores (the float ones are blocked_gy_tc
// and blocked_bwd_tc below). No residency bound: the instance takes what it
// needs.
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

// The float instance on the tensor cores. blocked_gy_tc writes gy already
// split into a plane of TF32 high parts and one of low parts, once an
// element, since every strip of a fold reads all of it. A block (one an SM,
// walking the strips s, s + grid, ...) takes one strip of SN columns of a
// fold and BC batch rows at a time: it stages the strip's e = exp(x - m),
// split as it is staged, and streams the units in chunks of OC: gy of the
// chunk by cp.async (from L2, where the fold's gy stays while the blocks
// walk its strips), the chunk's weights through registers, split once, into
// a ring of two buffers. While one chunk is contracted the next one's
// weights are in flight, and while a strip is contracted the next strip's x
// is loaded into registers, so the block's device-memory reads overlap its
// arithmetic. Warps 0-7 accumulate dx = gy w over the chunks (each a 32 x 32
// tile of the 128 x 64 strip); warps 8-15 contract the chunk's dw = gy^T e
// over the batch rows (each a 32 x 16 tile of the 64 x 64 chunk) and write
// it: the two halves do the same work, all 3xTF32 mma.sync, four warps on
// each SM sub-partition (a warp issues a TF32 mma.sync at a fraction of the
// tensor core's rate). Every operand
// sits in shared memory as two planes (high parts, low parts) of rows of SW
// words, 8 mod 32, so the warps' fragment loads hit 32 banks; gy, which dx
// reads along its rows and dw down its columns, has the columns of every
// row r XORed with r & 4 for the same. A batch of more than BC rows repeats
// the stream for each batch chunk, adding dw to what the earlier chunks
// wrote (the same thread, in batch order: no atomics, and two calls are
// equal to the bit).
namespace bwd_tc {
constexpr int SN = 64;       // strip columns
constexpr int BC = 128;      // batch rows staged at once
constexpr int OC = 64;       // units a chunk
constexpr int SW = 72;       // plane row stride in words
constexpr int NT_ = 512;     // threads a block
constexpr int RS = NT_ / 16;  // staging rows a pass
constexpr int XQ = BC / RS;  // float4 slots of x a thread stages (4)
constexpr int WQ = OC / RS;  // float4 slots of w a thread stages (2)
// e, the weight ring and one gy chunk, two planes each: 216 KB, one block an SM
constexpr size_t SMEM = sizeof(float) * 2 * SW * (BC + 2 * OC + BC);
}  // namespace bwd_tc

// gy as blocked_gy computes it, written as TF32 high parts (gy) and low
// parts (gy + F B O).
__global__ void __launch_bounds__(THREADS)
blocked_gy_tc(const float* __restrict__ out, const float* __restrict__ m,
              const float* __restrict__ g, uint32_t* __restrict__ gy, int F, int B, int O) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // warp-uniform
  const size_t row = (size_t)blockIdx.x * B + b;
  const size_t plane = (size_t)F * B * O;
  const float mb = m[row];
  for (int o = lane; o < O; o += 32) {
    const size_t idx = row * O + o;
    const float v = g[idx] * expf(mb - out[idx]);
    split_tf32(isfinite(v) ? v : 0.f, gy[idx], gy[plane + idx]);
  }
}

__global__ void __launch_bounds__(bwd_tc::NT_, 1)
blocked_bwd_tc(const float* __restrict__ x,       // (F, B, I)
               const float* __restrict__ w,       // (F, O, I)
               const float* __restrict__ m,       // (F, B) from blocked_fwd
               const uint32_t* __restrict__ gy,   // 2 x (F, B, O) from blocked_gy_tc
               float* __restrict__ dx,            // (F, B, I), or null
               float* __restrict__ dw,            // (F, O, I), or null
               int F, int B, int I, int O, int n_strips, bool vec, bool vec_gy, bool pair) {
  using namespace bwd_tc;
  constexpr int NP = 2;  // gy's planes
  extern __shared__ __align__(16) uint32_t bwd_smem[];
  uint32_t* Eh = bwd_smem;          // [BC][SW] e: high parts
  uint32_t* El = Eh + BC * SW;      //           low parts
  uint32_t* Wr = El + BC * SW;      // [2][2][OC][SW] the weight ring, each buffer high then low
  uint32_t* Gh = Wr + 4 * OC * SW;  // [BC][SW] the gy chunk, columns swizzled: high parts
  uint32_t* Gl = Gh + BC * SW;      //                                            low parts

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool dx_warp = warp < 8;
  const int wq = warp & 7;
  const int wm = (wq >> 1) * 32, wn = (wq & 1) * 32;  // dx warps: the tile at rows wm, columns wn
  const int dm = (wq >> 2) * 32, dn = (wq & 3) * 16;  // dw warps: the tile at rows dm, columns dn
  const int n_oc = (O + OC - 1) / OC;
  const int n_bc = (B + BC - 1) / BC;
  const int total = F * n_strips;
  const size_t gplane = (size_t)F * B * O;

  // The block's work units, in order: (strip, batch chunk), the strips
  // blockIdx.x, blockIdx.x + gridDim.x, ..., each over its batch chunks; a
  // unit's fold, first strip column and first batch row, or f = -1 past the
  // last.
  auto unit = [&](int u, int& f, int& c0, int& b0) {
    const int s = blockIdx.x + (u / n_bc) * gridDim.x;
    f = s < total ? s / n_strips : -1;
    c0 = (s - (s / n_strips) * n_strips) * SN;
    b0 = (u % n_bc) * BC;
  };

  // Staging maps: x and w rows tid / 16 + RS q, strip columns 4 (tid % 16) .. + 3.
  const int sr = tid >> 4, sc = 4 * (tid & 15);
  auto ld4 = [&](const float* row, int c, bool in) {
    if (vec)
      return in && c < I ? *reinterpret_cast<const float4*>(row + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    return make_float4(in && c < I ? row[c] : 0.f, in && c + 1 < I ? row[c + 1] : 0.f,
                       in && c + 2 < I ? row[c + 2] : 0.f, in && c + 3 < I ? row[c + 3] : 0.f);
  };
  auto store_split = [](uint32_t* hi, uint32_t* lo, const float4& v) {
    uint4 h, l;
    split_tf32x4(v, h, l);
    *reinterpret_cast<uint4*>(hi) = h;
    *reinterpret_cast<uint4*>(lo) = l;
  };
  float4 px[XQ], pw[WQ];
  auto load_x = [&](int f, int c0, int b0) {
    const float* xf = x + (size_t)f * B * I;
#pragma unroll
    for (int q = 0; q < XQ; ++q) {
      const int b = b0 + sr + RS * q;
      px[q] = ld4(xf + (size_t)b * I, c0 + sc, b < B);
    }
  };
  auto load_w = [&](int f, int c0, int o0) {
    const float* wf = w + (size_t)f * O * I;
#pragma unroll
    for (int q = 0; q < WQ; ++q) {
      const int o = o0 + sr + RS * q;
      pw[q] = ld4(wf + (size_t)o * I, c0 + sc, o < O);
    }
  };
  auto store_w = [&](int buf) {
    uint32_t* wh = Wr + 2 * buf * OC * SW;
#pragma unroll
    for (int q = 0; q < WQ; ++q) {
      const int r = sr + RS * q;
      store_split(wh + r * SW + sc, wh + (OC + r) * SW + sc, pw[q]);
    }
  };
  // gy[b0 + r, o0 + k] -> Gh, Gl at row r, column k ^ (r & 4)
  auto fetch_gy = [&](int f, int b0, int o0) {
    const uint32_t* src = gy + (size_t)f * B * O;
    if (vec_gy) {  // O % 4 == 0: 16-byte copies of four columns
      for (int e = tid; e < NP * BC * OC / 4; e += NT_) {
        const int p = e / (BC * OC / 4), rest = e - p * (BC * OC / 4);
        const int r = rest / (OC / 4), k = 4 * (rest - r * (OC / 4));
        const int b = b0 + r, o = o0 + k;
        const bool in = b < B && o < O;
        const uint32_t* s = src + p * gplane + (size_t)b * O + o;
        cirkit::cp_async_f32x4(reinterpret_cast<float*>(Gh + p * BC * SW + r * SW + (k ^ (r & 4))),
                               reinterpret_cast<const float*>(in ? s : src), in);
      }
    } else {
      for (int e = tid; e < NP * BC * OC; e += NT_) {
        const int p = e / (BC * OC), rest = e - p * (BC * OC);
        const int r = rest / OC, k = rest - r * OC;
        const int b = b0 + r, o = o0 + k;
        const bool in = b < B && o < O;
        const uint32_t* s = src + p * gplane + (size_t)b * O + o;
        cirkit::cp_async_f32(reinterpret_cast<float*>(Gh + p * BC * SW + r * SW + (k ^ (r & 4))),
                             reinterpret_cast<const float*>(in ? s : src), in);
      }
    }
  };

  int f, c0, b0;
  unit(0, f, c0, b0);
  if (f < 0) return;  // block-uniform
  load_x(f, c0, b0);
  fetch_gy(f, b0, 0);
  cp_async_commit();
  if (dx != nullptr) load_w(f, c0, 0);
  int step = 0;  // chunks contracted so far: the parity of the ring

  float acc[2][4][4];  // dx warps
  float d[2][2][4];    // dw warps
  for (int u = 0; f >= 0; ++u) {
    int nf, nc0, nb0;
    unit(u + 1, nf, nc0, nb0);
    const int nb = min(BC, B - b0);
    __syncthreads();  // every warp is done with the last unit's e
    {
      const float* mf = m + (size_t)f * B;
#pragma unroll
      for (int q = 0; q < XQ; ++q) {  // e of the strip, from the registers
        const int r = sr + RS * q, b = b0 + r;
        const float mb = b < B ? mf[b] : 0.f;
        const float4 v = px[q];
        store_split(Eh + r * SW + sc, El + r * SW + sc,
                    b < B ? make_float4(expf(v.x - mb), expf(v.y - mb), expf(v.z - mb),
                                        expf(v.w - mb))
                          : make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
    if (dx != nullptr) store_w(step & 1);
    if (nf >= 0) load_x(nf, nc0, nb0);  // lands while this unit is contracted
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    for (int ch = 0; ch < n_oc; ++ch, ++step) {
      const int cur = step & 1, o0 = ch * OC;
      cp_async_wait<0>();
      __syncthreads();  // the chunk's gy has landed, and the other weight buffer is free
      // the next chunk: this unit's, or the next unit's first
      const bool more = ch + 1 < n_oc;
      const int qf = more ? f : nf, qc0 = more ? c0 : nc0, qb0 = more ? b0 : nb0;
      const int qo0 = more ? o0 + OC : 0;
      if (qf >= 0 && dx != nullptr) load_w(qf, qc0, qo0);
      if (dx_warp && dx != nullptr) {
        // dx += gy[:, chunk] w[chunk, :], over the chunk's units
        const uint32_t* wh = Wr + 2 * cur * OC * SW;
        const uint32_t* wl = wh + OC * SW;
        const int nk = (min(OC, O - o0) + 7) / 8;
        for (int k8 = 0; k8 < nk; ++k8) {
          const int kk = 8 * k8 + t;
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int o = kk * SW + wn + 8 * nt + g;
            bh[nt][0] = wh[o];
            bh[nt][1] = wh[o + 4 * SW];
            bl[nt][0] = wl[o];
            bl[nt][1] = wl[o + 4 * SW];
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            // rows r and r + 8 share r & 4 = g & 4
            const int r = wm + 16 * mt + g, o = r * SW + (kk ^ (g & 4));
            const uint32_t ah[4] = {Gh[o], Gh[o + 8 * SW], Gh[o ^ 4], Gh[(o + 8 * SW) ^ 4]};
            const uint32_t al[4] = {Gl[o], Gl[o + 8 * SW], Gl[o ^ 4], Gl[(o + 8 * SW) ^ 4]};
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma3_tf32(acc[mt][nt], ah, al, bh[nt], bl[nt]);
          }
        }
      } else if (!dx_warp && dw != nullptr) {
        // dw[chunk, :] (+)= gy[:, chunk]^T e over the batch chunk's rows
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) d[mt][nt][e] = 0.f;
        const int nk = (nb + 7) / 8;
        for (int k8 = 0; k8 < nk; ++k8) {
          const int kk = 8 * k8 + t;  // rows kk and kk + 4: r & 4 is 0 and 4
          uint32_t bh[2][2], bl[2][2];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int o = kk * SW + dn + 8 * nt + g;
            bh[nt][0] = Eh[o];
            bh[nt][1] = Eh[o + 4 * SW];
            bl[nt][0] = El[o];
            bl[nt][1] = El[o + 4 * SW];
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int c = dm + 16 * mt + g, o = kk * SW + c, o4 = (kk + 4) * SW + (c ^ 4);
            const uint32_t ah[4] = {Gh[o], Gh[o + 8], Gh[o4], Gh[o4 + 8]};
            const uint32_t al[4] = {Gl[o], Gl[o + 8], Gl[o4], Gl[o4 + 8]};
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) mma3_tf32(d[mt][nt], ah, al, bh[nt], bl[nt]);
          }
        }
      }
      __syncthreads();  // every warp is done with the gy chunk
      if (qf >= 0) fetch_gy(qf, qb0, qo0);
      cp_async_commit();
      if (!dx_warp && dw != nullptr) {  // write dw while the next chunk's gy lands
        float* dwf = dw + (size_t)f * O * I;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int o = o0 + dm + 16 * mt + g + 8 * h;
            if (o >= O) continue;
            float* drow = dwf + (size_t)o * I;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const int c = c0 + dn + 8 * nt + 2 * t;
              float2 v = make_float2(d[mt][nt][2 * h], d[mt][nt][2 * h + 1]);
              if (pair && c < I) {  // I even: c + 1 < I too
                float2* p = reinterpret_cast<float2*>(drow + c);
                if (b0 > 0) {
                  const float2 old = *p;
                  v = make_float2(old.x + v.x, old.y + v.y);
                }
                *p = v;
              } else {
                if (c < I) drow[c] = b0 > 0 ? drow[c] + v.x : v.x;
                if (c + 1 < I) drow[c + 1] = b0 > 0 ? drow[c + 1] + v.y : v.y;
              }
            }
          }
      }
      if (more && dx != nullptr) store_w(cur ^ 1);
    }

    if (dx_warp && dx != nullptr) {
      // dx = e * (gy w), e read back from its two parts
      float* dxf = dx + (size_t)f * B * I;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm + 16 * mt + g + 8 * h, b = b0 + r;
          if (b >= B) continue;
          float* drow = dxf + (size_t)b * I;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int cl = wn + 8 * nt + 2 * t, c = c0 + cl;
            const uint2 eh = *reinterpret_cast<const uint2*>(Eh + r * SW + cl);
            const uint2 el = *reinterpret_cast<const uint2*>(El + r * SW + cl);
            const float v0 = (__uint_as_float(eh.x) + __uint_as_float(el.x)) * acc[mt][nt][2 * h];
            const float v1 =
                (__uint_as_float(eh.y) + __uint_as_float(el.y)) * acc[mt][nt][2 * h + 1];
            if (pair && c < I) {
              *reinterpret_cast<float2*>(drow + c) = make_float2(v0, v1);
            } else {
              if (c < I) drow[c] = v0;
              if (c + 1 < I) drow[c + 1] = v1;
            }
          }
        }
    }
    f = nf, c0 = nc0, b0 = nb0;
  }
  cp_async_wait<0>();
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

template <bool SOFTMAX, typename WT = float>
int launch_ct_tc(const float* x1, const float* x2, const WT* w, float* out, int F, int B, int K1,
                 int K2, int O, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = ct_fwd_tc<SOFTMAX, WT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(ct_tc::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte (bf16: 8-byte) weight loads where every row segment starts aligned
  const bool vec = K2 % 4 == 0 && reinterpret_cast<uintptr_t>(w) % (4 * sizeof(WT)) == 0;
  const dim3 grid(F, cdiv(O, ct_tc::BN), cdiv(B, ct_tc::BM));
  kernel<<<grid, ct_tc::NT_, ct_tc::SMEM, s>>>(x1, x2, w, out, B, K1, K2, O, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_blocked_fwd_tc(const float* x, const float* w, float* out, float* m, int F, int B,
                          int I, int O, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = blocked_fwd_tc;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(blk_tc::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies where every row starts 16-byte aligned
  const bool vec = I % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int n_ot = static_cast<int>(cdiv(O, blk_tc::BN));
  const int n_bt = static_cast<int>(cdiv(B, blk_tc::BM));
  kernel<<<F * n_ot * n_bt, blk_tc::NT_, blk_tc::SMEM, static_cast<cudaStream_t>(stream)>>>(
      x, w, out, m, B, I, O, n_ot, n_bt, vec);
  return static_cast<int>(cudaGetLastError());
}

// ``gy`` is the wrapper's scratch of 2 F B O floats: the high and low
// planes.
int launch_blocked_bwd_tc(const float* x, const float* w, const float* out, const float* m,
                          const float* g, float* dx, float* dw, float* gy, int F, int B, int I,
                          int O, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* gy2 = reinterpret_cast<uint32_t*>(gy);
  blocked_gy_tc<<<dim3(F, cdiv(B, WARPS)), THREADS, 0, s>>>(out, m, g, gy2, F, B, O);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  auto kernel = blocked_bwd_tc;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bwd_tc::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block an SM, each walking its strips
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto aligned = [](const void* p, uintptr_t n) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  // 16-byte loads of x rows and w rows and copies of gy rows, 8-byte stores
  // of dx and dw pairs
  const bool vec = I % 4 == 0 && aligned(x, 16) && aligned(w, 16);
  const bool vec_gy = O % 4 == 0 && aligned(gy, 16) && ((size_t)F * B * O) % 4 == 0;
  const bool pair = I % 2 == 0 && aligned(dx, 8) && aligned(dw, 8);
  const int n_strips = static_cast<int>(cdiv(I, bwd_tc::SN));
  const int grid = F * n_strips < sms ? F * n_strips : sms;
  kernel<<<grid, bwd_tc::NT_, bwd_tc::SMEM, s>>>(x, w, m, gy2, dx, dw, F, B, I, O, n_strips, vec,
                                              vec_gy, pair);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every entry exists for float (the plain name) and for double (_f64). The
// float K1-chunked Tucker forward and blocked forward and backward run on the
// tensor cores (ct_fwd_tc, blocked_fwd_tc, blocked_gy_tc + blocked_bwd_tc;
// the backward's gy scratch then holds 2 F B O floats), the double ones on
// the CUDA cores.
#define LSE_WIDE_ENTRIES(SUFFIX, T, CT, CT_SOFTMAX, BLK, BWD)                                   \
  int lse_fwd_ct##SUFFIX(const T* x1, const T* x2, const T* w, T* out, int F, int B, int K1,   \
                         int K2, int O, int device, void* stream) {                            \
    return CT(x1, x2, w, out, F, B, K1, K2, O, device, stream);                                \
  }                                                                                            \
  int lse_fwd_ct_softmax##SUFFIX(const T* x1, const T* x2, const T* theta, T* out, int F,      \
                                 int B, int K1, int K2, int O, int device, void* stream) {     \
    return CT_SOFTMAX(x1, x2, theta, out, F, B, K1, K2, O, device, stream);                    \
  }                                                                                            \
  int lse_fwd_blocked##SUFFIX(const T* x, const T* w, T* out, T* m, int F, int B, int I,       \
                              int O, int device, void* stream) {                               \
    return BLK(x, w, out, m, F, B, I, O, device, stream);                                      \
  }                                                                                            \
  int lse_bwd_blocked##SUFFIX(const T* x, const T* w, const T* out, const T* m, const T* g,    \
                              T* dx, T* dw, T* gy, int F, int B, int I, int O, int device,     \
                              void* stream) {                                                  \
    return BWD(x, w, out, m, g, dx, dw, gy, F, B, I, O, device, stream);                       \
  }

LSE_WIDE_ENTRIES(, float, launch_ct_tc<false>, launch_ct_tc<true>, launch_blocked_fwd_tc,
                 launch_blocked_bwd_tc)
LSE_WIDE_ENTRIES(_f64, double, (launch_ct<double, false>), (launch_ct<double, true>),
                 launch_blocked_fwd<double>, launch_blocked_bwd<double>)
#undef LSE_WIDE_ENTRIES

// The bf16-weight (_w16) instances of the float K1-chunked Tucker forward
// (ops/lse_einsum.py's INSTANCES; the fast modes' are csrc/tucker_bf16.cu's).
int lse_fwd_ct_w16(const float* x1, const float* x2, const __nv_bfloat16* w, float* out, int F,
                   int B, int K1, int K2, int O, int device, void* stream) {
  return launch_ct_tc<false>(x1, x2, w, out, F, B, K1, K2, O, device, stream);
}
int lse_fwd_ct_softmax_w16(const float* x1, const float* x2, const __nv_bfloat16* theta,
                           float* out, int F, int B, int K1, int K2, int O, int device,
                           void* stream) {
  return launch_ct_tc<true>(x1, x2, theta, out, F, B, K1, K2, O, device, stream);
}

}  // extern "C"
