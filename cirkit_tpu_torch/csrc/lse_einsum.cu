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
// edge is masked, with no padding. That loop runs the dense, signed dense
// and double instances. The float Tucker instances, the K=64 flagships'
// forwards, run on the tensor cores instead (tucker_fwd_tc, in 3xTF32
// mma.sync: on the f32 CUDA cores the Tucker entry's 52.6 GFLOP take 0.785
// ms, in 3xTF32 on the tensor cores 0.319 ms, against 0.245 ms of weight
// bytes): the unsigned ones, the signed ones (SIGNED: the signs folded into
// e1 and e2 as they are staged) and the complex64 one against a real weight
// (CPLX: real products over stacked real and imaginary planes); its design
// is described above it. wgmma and TMA are left for later. Their fast-mode
// instances run on the bf16 tensor cores, in csrc/tucker_bf16.cu.
// The signed squared circuits' TensorDot entries (F = 144, I = O = 32,
// B*Kq = 4096 rows) do 8 FLOP per element read, so there the work is bound
// by memory: 302 MB of (a, s) read and (log|y|, sign y) written, 0.090 ms.
// A 64 x 64 tile of the loop above would be half masked there and read each
// row twice (the row max, then the chunk), so every signed dense layer with
// I and O at most 32 takes a kernel of its own, slse_fwd_narrow (described
// above it): one pass over the rows, each row read once and kept on chip.
//
// Each extern "C" entry selects the given device, launches on the given
// stream and returns cudaGetLastError() of the launch (0 on success).

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "lse_common.cuh"
#include "tc_common.cuh"

namespace {

using cirkit::abs_t;
using cirkit::batch_chunks;
using cirkit::load_w4;
using cirkit::round_op;
using cirkit::widen;
using cirkit::clamp_max;
using cirkit::exp_t;
using cirkit::fast_exp;
using cirkit::fma_t;
using cirkit::load4;
using cirkit::log_t;
using cirkit::max_t;
using cirkit::mma3_tf32;
using cirkit::split_tf32x4;
using cirkit::staged_exp;
using cirkit::store4;
using cirkit::warp_max;
using cirkit::warp_sum;

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
// WT is the weight's storage type (T, or bf16 beside float: read widened).
// The fast modes (MODE, tc_common.cuh; the float dense instances, unsigned
// (the mixing sums) and signed) stage each exponential (signed: s * exp(x -
// m), at its flat index in (F, B, I)) and weight (softmax: exp(theta - row
// max), the normalizer kept in f32) rounded to bf16 and FMA in f32.
template <typename T, bool TUCKER, bool SOFTMAX, bool SIGNED, typename WT = T,
          int MODE = cirkit::F32>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? 2 : 1)
lse_fwd(const T* __restrict__ xa,  // dense: x (F,B,I); tucker: x1 (F,B,K1)
        const T* __restrict__ xb,  // tucker: x2 (F,B,K2); dense: unused
        const WT* __restrict__ w,  // w or theta (F,O,I), I = K1*K2 for tucker
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
  const WT* wf = w + (size_t)f * O * I;
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
      pw[n] = (o < O && k < I) ? T(widen(wf[(size_t)o * I + k])) : T(SOFTMAX ? -INFINITY : 0.f);
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
    if constexpr (MODE != cirkit::F32) {  // float dense: unsigned or signed
      const int k = k0 + skk;
#pragma unroll
      for (int n = 0; n < A_PER; ++n) {
        const int r = srow + n * RSTEP;
        float e = expf(pa[n]);
        if constexpr (SIGNED) e = ps[n] * e;
        As[skk][r] = round_op<MODE>(e, ((size_t)f * B + b0 + r) * I + k, cirkit::ROLE_E);
      }
#pragma unroll
      for (int n = 0; n < W_PER; ++n) {
        const int c = srow + n * RSTEP;
        Bs[skk][c] = round_op<MODE>(SOFTMAX ? expf(pw[n] - mw[c]) : pw[n],
                                    ((size_t)f * O + o0 + c) * I + k, cirkit::ROLE_W);
      }
    } else {
#pragma unroll
      for (int n = 0; n < A_PER; ++n)
        As[skk][srow + n * RSTEP] = SIGNED ? ps[n] * staged_exp<true>(pa[n]) : fast_exp(pa[n]);
#pragma unroll
      for (int n = 0; n < W_PER; ++n) {
        const int c = srow + n * RSTEP;
        Bs[skk][c] = SOFTMAX ? staged_exp<SIGNED>(pw[n] - mw[c]) : pw[n];
      }
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

// The signed forward of a narrow dense layer (I, O <= 32: the squared
// circuits' TensorDot entries) in one pass over its rows. One block per
// (fold, chunk of the batch) stages the fold's weight once, transposed so
// that a thread's V neighbouring units are one 16-byte read (with logits:
// each unit's softmax from its 32 logits, one warp a unit, stored as
// exp(theta - max) beside the log of its normalizer). Then it takes RT rows
// at a time, each row held by TPR threads of V neighbouring columns (32
// bytes of a and 32 of s a thread, read coalesced, the next rows' while the
// current ones are contracted): the row's clamped max by shuffles among its
// threads, e = s exp(a - m) (the accurate exp) once per element into the
// row's line of a shared tile, and each thread's V outputs y[o] = sum_i e[i]
// w[o,i], summed over i in order in f32 (f64) FMAs. The epilogue writes
// log|y| + m (minus the normalizer's log) and sign y, an exact cancellation
// giving (-inf, 0). A row lives in one warp, so the passes need no block
// barrier. Nothing but the inputs read once and the outputs written once
// reaches device memory. WT is the weight's storage type (bf16 beside float:
// read widened); the fast modes (MODE) round each e as it is written to the
// row's line (at its flat index in (F, B, I)) and each staged weight (with
// logits exp(theta - max), the normalizer summed unrounded).
namespace narrow {
constexpr int W = 32;                                              // the widest I and O
template <typename T> constexpr int V = 32 / sizeof(T);            // columns a thread of a row
template <typename T> constexpr int TPR = W / V<T>;                // threads a row
template <typename T> constexpr int RT = THREADS / TPR<T>;         // rows a pass
template <typename T> constexpr int RESIDENT = sizeof(T) == 4 ? 4 : 3;  // blocks an SM
}  // namespace narrow

template <typename T, bool SOFTMAX, typename WT = T, int MODE = cirkit::F32>
__global__ void __launch_bounds__(THREADS, narrow::RESIDENT<T>)
slse_fwd_narrow(const T* __restrict__ x, const T* __restrict__ sx, const WT* __restrict__ w,
                T* __restrict__ out, T* __restrict__ out_sign, int B, int I, int O, int n_bc,
                int rows, bool vec) {
  using narrow::W;
  constexpr int V = narrow::V<T>, TPR = narrow::TPR<T>, RT = narrow::RT<T>;
  __shared__ __align__(16) T Wt[W][W + 4];   // w[o][i] at [i][o], 0 outside I x O
  __shared__ __align__(16) T Es[RT][W + 4];  // e of the pass's rows
  __shared__ T lsw[W];                       // softmax: log of each unit's normalizer

  const int f = blockIdx.x / n_bc, bc = blockIdx.x - f * n_bc;
  const int b_begin = bc * rows, b_end = min(B, b_begin + rows);
  const int tid = threadIdx.x, lane = tid & 31;
  const int r = tid / TPR, c0 = (tid % TPR) * V;  // row of the pass, first column
  const size_t xoff = (size_t)f * B * I, ooff = (size_t)f * B * O;
  for (int o = tid >> 5; o < W; o += WARPS) {  // one warp a unit, lane i its column i
    const T pad = SOFTMAX ? -INFINITY : T(0);
    T v = o < O && lane < I ? T(widen(w[((size_t)f * O + o) * I + lane])) : pad;
    if (SOFTMAX) {  // a unit whose logits are all -inf (or past O) stages 0
      T m = warp_max(v);
      m = m == -INFINITY ? T(0) : m;
      v = exp_t(v - m);
      const T s = warp_sum(v);
      if (lane == 0) lsw[o] = log_t(s);
    }
    if constexpr (MODE != cirkit::F32) v = round_op<MODE>(v, ((size_t)f * O + o) * I + lane,
                                                          cirkit::ROLE_W);
    Wt[lane][o] = v;
  }
  __syncthreads();

  // the pass's raw values: a and its sign over the row's V columns, 16 bytes
  // at a time where ``vec`` (I and O multiples of 4, 16-byte aligned tensors)
  T px[V], ps[V];
  auto load = [&](int b0) {
    const int b = b0 + r;
    const size_t xr = xoff + (size_t)b * I;
#pragma unroll
    for (int v = 0; v < V; v += 4) {
      const int c = c0 + v;
      if (vec && b < b_end && c + 4 <= I) {
        load4(x + xr + c, px + v);
        load4(sx + xr + c, ps + v);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool in = b < b_end && c + u < I;
          px[v + u] = in ? x[xr + c + u] : -INFINITY;
          ps[v + u] = in ? sx[xr + c + u] : T(0);
        }
      }
    }
  };
  load(b_begin);
  for (int b0 = b_begin; b0 < b_end; b0 += RT) {
    T m = -INFINITY;
#pragma unroll
    for (int v = 0; v < V; ++v) m = max_t(m, px[v]);
#pragma unroll
    for (int d = TPR / 2; d > 0; d >>= 1) m = max_t(m, __shfl_xor_sync(0xffffffffu, m, d));
    m = clamp_max(m);
    if constexpr (MODE != cirkit::F32) {
      const size_t e0 = ((size_t)f * B + b0 + r) * I + c0;
#pragma unroll
      for (int v = 0; v < V; ++v)
        Es[r][c0 + v] = round_op<MODE>(ps[v] * exp_t(px[v] - m), e0 + v, cirkit::ROLE_E);
    } else {
#pragma unroll
      for (int v = 0; v < V; v += 4)
        store4(&Es[r][c0 + v], ps[v] * exp_t(px[v] - m), ps[v + 1] * exp_t(px[v + 1] - m),
               ps[v + 2] * exp_t(px[v + 2] - m), ps[v + 3] * exp_t(px[v + 3] - m));
    }
    __syncwarp();  // the row's threads are one warp's
    const int b = b0 + r;
    if (b0 + RT < b_end) load(b0 + RT);
    T acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = T(0);
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      T ev[4];
      load4(&Es[r][i], ev);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        T wv[V];
#pragma unroll
        for (int v = 0; v < V; v += 4) load4(&Wt[i + u][c0 + v], wv + v);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = fma_t(ev[u], wv[v], acc[v]);
      }
    }
    __syncwarp();  // the row's e is read before the next pass rewrites it
    if (b < b_end) {
      T ya[V], ys[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        ya[v] = log_t(abs_t(acc[v])) + m;
        if (SOFTMAX) ya[v] -= lsw[c0 + v];
        ys[v] = T((acc[v] > T(0)) - (acc[v] < T(0)));
      }
      T* oa = out + ooff + (size_t)b * O + c0;
      T* os = out_sign + ooff + (size_t)b * O + c0;
#pragma unroll
      for (int v = 0; v < V; v += 4) {
        if (vec && c0 + v + 4 <= O) {
          store4(oa + v, ya[v], ya[v + 1], ya[v + 2], ya[v + 3]);
          store4(os + v, ys[v], ys[v + 1], ys[v + 2], ys[v + 3]);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (c0 + v + u < O) oa[v + u] = ya[v + u], os[v + u] = ys[v + u];
        }
      }
    }
  }
}

// The float Tucker instances on the tensor cores (the double ones are
// lse_fwd above). The fold of the K1-chunked kernel
// (ct_fwd_tc in csrc/lse_wide.cu) with its tile sized for O = 64, the K=64
// circuits' width: for a fixed row i the operand is diag(e1[:, i]) E2, so a
// block (fold, 128 batch rows, 64 units) stages E2 = exp(x2 - m2) of its
// rows once, chunk by chunk of JC columns j, split into TF32 high and low
// parts as it is staged; for each row i it contracts S = E2 W_i^T over the
// chunk's j on the tensor cores (3xTF32 mma.sync, each of the 8 warps a 32
// x 32 tile), W_i the chunk's weights w[o, i*K2 + j] of the block's units,
// streamed through registers into a ring of two split buffers (the next
// row's loads in flight while the current one is contracted), and folds
// acc += e1[b, i] * S in f32 registers. Two blocks are resident on an SM,
// so four warps issue on each sub-partition. Softmax, in one pass over
// theta: the eight threads that stage a unit's segment (its 32 logits of
// row i) raise the unit's running max to the segment's max, held in their
// registers, and stage w = exp(theta - max); the fold first scales the
// unit's accumulators by exp(old max - new max), and the stagers'
// normalizer partials shrink by the same factor. A unit whose logits have
// all been -inf so far keeps max -inf, scale 1 and shift 0, so exp(-inf) =
// 0 and no NaN. Ragged B, O, K1 and K2 are masked; a K2 that is not a
// multiple of 4, or a weight that is not 16-byte aligned, takes 4-byte
// loads. It is a kernel of its own, not an instance of a template shared
// with ct_fwd_tc, whose machine code stays as it was: one template for both
// reorders ct_fwd_tc's instructions.
//
// WT is the weight's storage type: float, or bf16 (the serving store), read
// 8 bytes for four weights and widened as staged. A bf16 weight is exact in
// TF32, so its low plane is 0 and its product is dropped: two mma.sync where
// three ran (logits are not: exp(theta - max) is a full f32). The fast
// modes' instances run on the bf16 tensor cores instead (tucker_fwd_bf16,
// csrc/tucker_bf16.cu).
//
// SIGNED (the signed Tucker forward, kernel 6): x1 and x2 are the
// log-magnitudes, s1 and s2 their signs, read beside them where e1 = s1
// exp(x1 - m1) and E2 = s2 exp(x2 - m2) are staged (the accurate expf, as
// everywhere here); the epilogue writes log|y| + shift (less the
// normalizer's log) and sign y, an exact cancellation y = 0 giving (-inf,
// 0). The logits' running-max rescale is a positive factor, so it commutes
// with the signs.
//
// CPLX (the complex64 Tucker forward against a real weight, kernel 10;
// PyTorch's interleaved complex x1, x2 and out): E2 = exp(x2 - m2) is staged
// as two real planes, a batch row's real plane at row stacked_at(b) of the
// block's BM rows and its imaginary plane 8 rows below (tc_common.cuh), so a
// block takes 64 batch rows; for each row i the products are one real S_i
// = E2 W_i^T over the stacked rows, and the thread that holds rows g and g +
// 8 of an accumulator tile holds one batch row's S_re and S_im: the fold is
// the complex multiply-add acc += e1[b, i] S_i in registers, e1 = exp(x1 -
// m1) (cexp_f32: the accurate expf and sincosf, its two planes staged as
// E2's), and the epilogue writes log|y| + m1 + m2 + i atan2(Im y, Re y).
// Halving the batch rows a block keeps the tile, its registers and two
// blocks an SM; the two batch tiles of a fold at B = 128 run side by side
// (the grid is F x batch tiles), so the second reads the weight from L2.
namespace tk_tc {
constexpr int BM = 128;    // batch rows a block
constexpr int BN = 64;     // units a block
constexpr int JC = 32;     // columns j a chunk
constexpr int IC = 32;     // rows i whose e1 is staged at once
constexpr int S = JC + 4;  // plane row stride in words, 4 mod 32: fragment loads hit 32 banks
constexpr int NT_ = 256;   // threads a block, two blocks an SM
constexpr int NW = NT_ / 32;
constexpr int RS = NT_ / 8;           // staging rows a pass
constexpr int Q = BN * JC / 4 / NT_;  // float4 slots a thread stages of a weight chunk (2)
constexpr int EQ = BM * JC / 4 / NT_; // float4 slots a thread stages of an E2 chunk (4)
// E2's two planes, the ring's two buffers of two planes, e1, the shifts and
// the softmax's factors and normalizers: 90 KB
constexpr size_t SMEM = sizeof(float) * (2 * (BM + 2 * BN) * S + IC * BM + 2 * BM + 3 * BN);
}  // namespace tk_tc

template <bool SOFTMAX, typename WT = float, bool SIGNED = false, bool CPLX = false>
__global__ void __launch_bounds__(tk_tc::NT_, 2)
tucker_fwd_tc(const float* __restrict__ x1,  // (F, B, K1); CPLX: complex, (re, im) pairs
              const float* __restrict__ x2,  // (F, B, K2); CPLX: complex
              const WT* __restrict__ w,      // (F, O, K1*K2): weights, or logits for SOFTMAX
              float* __restrict__ out,       // (F, B, O); SIGNED: log|y|; CPLX: complex
              int B, int K1, int K2, int O, bool vec,
              const float* __restrict__ s1,   // SIGNED: the signs of x1 and x2; else unused
              const float* __restrict__ s2,
              float* __restrict__ out_sign) {  // SIGNED: sign(y) (F, B, O)
  static_assert(!(SIGNED && CPLX) && !(CPLX && (SOFTMAX || sizeof(WT) != 4)),
                "CPLX: linear float32 weights, unsigned");
  // the staged weights keep a low plane unless they are bf16 weights (exact
  // in TF32)
  constexpr bool W_SPLIT = SOFTMAX || sizeof(WT) == 4;
  // the tile (the file's own BM and BN are the FMA kernel's)
  constexpr int BM = tk_tc::BM, BN = tk_tc::BN, JC = tk_tc::JC, IC = tk_tc::IC, S = tk_tc::S;
  constexpr int NT_ = tk_tc::NT_, NW = tk_tc::NW, RS = tk_tc::RS, Q = tk_tc::Q, EQ = tk_tc::EQ;
  // batch rows a block: CPLX stacks each row's two planes in the BM rows
  constexpr int BB = CPLX ? BM / 2 : BM;
  extern __shared__ __align__(16) uint32_t tk_smem[];
  uint32_t* E2h = tk_smem;  // [BM][S]: E2's high parts, then its low parts
  uint32_t* E2l = E2h + BM * S;
  uint32_t* Wsm = E2l + BM * S;  // [2][2][BN][S]: the ring, each buffer high then low
  float* E1s = reinterpret_cast<float*>(Wsm + 4 * BN * S);  // [IC][BM]
  float* m1s = E1s + IC * BM;
  float* m2s = m1s + BM;
  float* wscl = m2s + BM;       // softmax: [2][BN], each staged segment's rescale factors
  float* lsum = wscl + 2 * BN;  // softmax: each unit's log-normalizer

  int f, b0;
  if constexpr (CPLX) {  // the batch tiles of a fold side by side: they share its weight in L2
    const int n_bt = (B + BB - 1) / BB;
    f = blockIdx.x / n_bt;
    b0 = (blockIdx.x - f * n_bt) * BB;
  } else {
    f = blockIdx.x;
    b0 = blockIdx.z * BM;
  }
  const int o0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;  // the warp's 32 x 32 tile
  const int I = K1 * K2;
  const float* x1f = x1 + (size_t)f * B * K1;
  const float* x2f = x2 + (size_t)f * B * K2;
  const float2* c1f = reinterpret_cast<const float2*>(x1) + (size_t)f * B * K1;  // CPLX
  const float2* c2f = reinterpret_cast<const float2*>(x2) + (size_t)f * B * K2;
  const float* s1f = s1 + (size_t)f * B * K1;  // SIGNED
  const float* s2f = s2 + (size_t)f * B * K2;
  const WT* wf = w + (size_t)f * O * I;

  // Prologue: the clamped row maxes of x1 and x2 (CPLX: of their real
  // parts), the shifts of the whole contraction.
  for (int r = warp; r < BB; r += NW) {
    const int b = b0 + r;
    float a = -INFINITY, c = -INFINITY;
    if (b < B) {
      if constexpr (CPLX) {
        for (int k = lane; k < K1; k += 32) a = fmaxf(a, c1f[(size_t)b * K1 + k].x);
        for (int k = lane; k < K2; k += 32) c = fmaxf(c, c2f[(size_t)b * K2 + k].x);
      } else {
        for (int k = lane; k < K1; k += 32) a = fmaxf(a, x1f[(size_t)b * K1 + k]);
        for (int k = lane; k < K2; k += 32) c = fmaxf(c, x2f[(size_t)b * K2 + k]);
      }
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
        if constexpr (CPLX) {  // a batch row's real and imaginary planes at stacked rows
#pragma unroll
          for (int q = 0; q < EQ / 2; ++q) {
            const int r = sr + RS * q, b = b0 + r;
            float re[4], im[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = j0 + sc + e;
              re[e] = im[e] = 0.f;
              if (b < B && j < K2) {
                const float2 z = c2f[(size_t)b * K2 + j];
                cirkit::cexp_f32(z.x - m2s[r], z.y, &re[e], &im[e]);
              }
            }
            const int sr_re = cirkit::stacked_at(r);
            uint4 hi, lo;
            split_tf32x4(make_float4(re[0], re[1], re[2], re[3]), hi, lo);
            *reinterpret_cast<uint4*>(E2h + sr_re * S + sc) = hi;
            *reinterpret_cast<uint4*>(E2l + sr_re * S + sc) = lo;
            split_tf32x4(make_float4(im[0], im[1], im[2], im[3]), hi, lo);
            *reinterpret_cast<uint4*>(E2h + (sr_re + 8) * S + sc) = hi;
            *reinterpret_cast<uint4*>(E2l + (sr_re + 8) * S + sc) = lo;
          }
        } else {
#pragma unroll
          for (int q = 0; q < EQ; ++q) {
            const int r = sr + RS * q, b = b0 + r;
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = j0 + sc + e;
              if constexpr (SIGNED) {  // e2 = s2 exp(x2 - m2)
                v[e] = b < B && j < K2
                           ? s2f[(size_t)b * K2 + j] * expf(x2f[(size_t)b * K2 + j] - m2s[r])
                           : 0.f;
              } else {
                v[e] = b < B && j < K2 ? expf(x2f[(size_t)b * K2 + j] - m2s[r]) : 0.f;
              }
            }
            uint4 hi, lo;
            split_tf32x4(make_float4(v[0], v[1], v[2], v[3]), hi, lo);
            *reinterpret_cast<uint4*>(E2h + r * S + sc) = hi;
            *reinterpret_cast<uint4*>(E2l + r * S + sc) = lo;
          }
        }
      }
      if constexpr (CPLX) {  // e1 of the rows i0 .. i0 + n_i - 1, both planes
        for (int e = tid; e < IC * BB; e += NT_) {
          const int il = e / BB, r = e - il * BB, b = b0 + r;
          float re = 0.f, im = 0.f;
          if (b < B && il < n_i) {
            const float2 z = c1f[(size_t)b * K1 + i0 + il];
            cirkit::cexp_f32(z.x - m1s[r], z.y, &re, &im);
          }
          E1s[il * BM + cirkit::stacked_at(r)] = re;
          E1s[il * BM + cirkit::stacked_at(r) + 8] = im;
        }
      } else {
        for (int e = tid; e < IC * BM; e += NT_) {  // e1 of the rows i0 .. i0 + n_i - 1
          const int il = e / BM, r = e - il * BM, b = b0 + r;
          if constexpr (SIGNED) {  // e1 = s1 exp(x1 - m1)
            const size_t k = (size_t)b * K1 + i0 + il;
            E1s[e] = b < B && il < n_i ? s1f[k] * expf(x1f[k] - m1s[r]) : 0.f;
          } else {
            E1s[e] = b < B && il < n_i ? expf(x1f[(size_t)b * K1 + i0 + il] - m1s[r]) : 0.f;
          }
        }
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
        if constexpr (CPLX) {
          // rows g and g + 8 of an m-tile are one batch row's planes: S_re
          // and S_im, and the real and imaginary parts of its sums
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const float er = e1[wm + 16 * mt + g], ei = e1[wm + 16 * mt + g + 8];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              float* a = acc[mt][nt];
              const float* sv = s[mt][nt];
              a[0] = fmaf(er, sv[0], fmaf(-ei, sv[2], a[0]));
              a[1] = fmaf(er, sv[1], fmaf(-ei, sv[3], a[1]));
              a[2] = fmaf(er, sv[2], fmaf(ei, sv[0], a[2]));
              a[3] = fmaf(er, sv[3], fmaf(ei, sv[1], a[3]));
            }
          }
        } else {
          float2 scl[4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            scl[nt] = SOFTMAX
                          ? *reinterpret_cast<const float2*>(&wscl[cur * BN + wn + 8 * nt + 2 * t])
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
  if constexpr (CPLX) {  // log|y| + shift + i atan2(Im y, Re y); y = 0 gives (-inf, 0)
    float2* outc = reinterpret_cast<float2*>(out) + (size_t)f * B * O;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = cirkit::stacked_row(wm + 16 * mt + g), b = b0 + r;
      if (b >= B) continue;
      const float shift = m1s[r] + m2s[r];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + wn + 8 * nt + 2 * t + e;
          const float re = acc[mt][nt][e], im = acc[mt][nt][2 + e];
          if (o < O) outc[(size_t)b * O + o] = make_float2(logf(hypotf(re, im)) + shift,
                                                          atan2f(im, re));
        }
    }
    return;
  }
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
          const float v = acc[mt][nt][2 * h + e];
          float y = logf(SIGNED ? fabsf(v) : v);  // signed: y = 0 gives (-inf, 0)
          if (SOFTMAX) y -= lsum[c];
          if (o < O) {
            outf[(size_t)b * O + o] = y + shift;
            if (SIGNED) out_sign[(size_t)f * B * O + (size_t)b * O + o] = (v > 0.f) - (v < 0.f);
          }
        }
    }
}

// The signed dense forward of a narrow layer: slse_fwd_narrow over enough
// batch chunks for about 2048 blocks (F = 144 fills the 132 SMs several
// times). The rows are independent, so a chunk may be a single pass: a few
// folds (the root, F = 1) still fill the card.
template <typename T, bool SOFTMAX, typename WT = T, int MODE = cirkit::F32>
int launch_narrow(const T* x, const T* sx, const WT* w, T* out, T* out_sign, int F, int B, int I,
                  int O, cudaStream_t s) {
  constexpr int RT = narrow::RT<T>;
  int rows;
  const int n_bc = batch_chunks(F, B, RT, RT, 2048, &rows);
  auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  const bool vec = I % 4 == 0 && O % 4 == 0 && aligned(x) && aligned(sx) && aligned(out) &&
                   aligned(out_sign);
  slse_fwd_narrow<T, SOFTMAX, WT, MODE><<<F * n_bc, THREADS, 0, s>>>(x, sx, w, out, out_sign, B,
                                                                      I, O, n_bc, rows, vec);
  return static_cast<int>(cudaGetLastError());
}

// A signed dense layer with I and O at most 32 takes slse_fwd_narrow, every
// other layer lse_fwd.
template <typename T, bool TUCKER, bool SOFTMAX, bool SIGNED = false, typename WT = T,
          int MODE = cirkit::F32>
int launch(const T* xa, const T* xb, const WT* w, T* out, int F, int B, int I, int K1, int K2,
           int O, int device, void* stream, const T* sa = nullptr, const T* sb = nullptr,
           T* out_sign = nullptr) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if constexpr (SIGNED && !TUCKER)
    if (I <= narrow::W && O <= narrow::W)
      return launch_narrow<T, SOFTMAX, WT, MODE>(xa, sa, w, out, out_sign, F, B, I, O,
                                                 static_cast<cudaStream_t>(stream));
  const dim3 grid(F, (O + BN - 1) / BN, (B + BM - 1) / BM);
  lse_fwd<T, TUCKER, SOFTMAX, SIGNED, WT, MODE>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(xa, xb, w, out, sa, sb, out_sign,
                                                                B, I, K1, K2, O);
  return static_cast<int>(cudaGetLastError());
}

// The unsigned Tucker entries: the double instances of lse_fwd, or the
// float kernel on the tensor cores.
template <typename T, bool SOFTMAX>
int launch_tucker(const T* x1, const T* x2, const T* w, T* out, int F, int B, int K1, int K2,
                  int O, int device, void* stream) {
  return launch<T, true, SOFTMAX>(x1, x2, w, out, F, B, K1 * K2, K1, K2, O, device, stream);
}

// The Tucker entries on the tensor cores: the unsigned and SIGNED float32
// ones, and with CPLX the complex64 one against a real weight, whose blocks
// take 64 batch rows (their 128 stacked planes) in a one-dimensional grid of
// F x batch tiles, the batch tiles of a fold side by side.
template <bool SOFTMAX, typename WT = float, bool SIGNED = false, bool CPLX = false>
int launch_tucker_tc(const float* x1, const float* x2, const WT* w, float* out, int F, int B,
                     int K1, int K2, int O, int device, void* stream,
                     const float* s1 = nullptr, const float* s2 = nullptr,
                     float* out_sign = nullptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = tucker_fwd_tc<SOFTMAX, WT, SIGNED, CPLX>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(tk_tc::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte (bf16: 8-byte) weight loads where every row segment starts aligned
  const bool vec = K2 % 4 == 0 && reinterpret_cast<uintptr_t>(w) % (4 * sizeof(WT)) == 0;
  const int n_ot = (O + tk_tc::BN - 1) / tk_tc::BN;
  dim3 grid(F, n_ot, (B + tk_tc::BM - 1) / tk_tc::BM);
  if constexpr (CPLX) {
    const long long blocks = (long long)F * ((B + tk_tc::BM / 2 - 1) / (tk_tc::BM / 2));
    if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid = dim3(static_cast<unsigned>(blocks), n_ot);
  }
  kernel<<<grid, tk_tc::NT_, tk_tc::SMEM, s>>>(x1, x2, w, out, B, K1, K2, O, vec, s1, s2,
                                               out_sign);
  return static_cast<int>(cudaGetLastError());
}

// The signed Tucker entries: float32 on the tensor cores (tucker_fwd_tc with
// SIGNED), double on lse_fwd.
template <bool SOFTMAX, typename T, typename WT = T>
int launch_signed_tucker(const T* a1, const T* s1, const T* a2, const T* s2, const WT* w, T* oa,
                         T* os, int F, int B, int K1, int K2, int O, int device, void* stream) {
  if constexpr (sizeof(T) == 8) {
    return launch<T, true, SOFTMAX, true>(a1, a2, w, oa, F, B, K1 * K2, K1, K2, O, device,
                                          stream, s1, s2, os);
  } else {
    return launch_tucker_tc<SOFTMAX, WT, true>(a1, a2, w, oa, F, B, K1, K2, O, device, stream,
                                               s1, s2, os);
  }
}

}  // namespace

extern "C" {

// The build compiles this source once for each part (-DCIRKIT_FWD_PART=0, 1,
// 2; ops/_build.py), the three side by side: part 0 holds the lse entries and
// their instances and the float and double signed dense entries and the
// double signed Tucker ones, part 1 the float signed Tucker entries, the
// complex Tucker one against a real weight and the float32-weight fast
// instances of the signed dense entries, part 2 the bf16-weight instances of
// the signed entries (the signed Tucker entries' fast instances are
// csrc/tucker_bf16.cu's). A build without the macro holds all of them.
#if !defined(CIRKIT_FWD_PART) || CIRKIT_FWD_PART == 0
const char* cirkit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Every entry exists for float (the plain name) and for double (the name with
// _f64). The signed entries take (log-magnitude, sign) inputs and write
// (log|y|, sign y). The float Tucker entries run tucker_fwd_tc (the signed
// ones below).
#define LSE_FWD_ENTRIES(SUFFIX, T, TK, TK_SOFTMAX)                                              \
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
    return TK(x1, x2, w, out, F, B, K1, K2, O, device, stream);                                 \
  }                                                                                             \
  int lse_fwd_tucker_softmax##SUFFIX(const T* x1, const T* x2, const T* theta, T* out, int F,   \
                                     int B, int K1, int K2, int O, int device, void* stream) {  \
    return TK_SOFTMAX(x1, x2, theta, out, F, B, K1, K2, O, device, stream);                     \
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
  }

LSE_FWD_ENTRIES(, float, launch_tucker_tc<false>, launch_tucker_tc<true>)
LSE_FWD_ENTRIES(_f64, double, (launch_tucker<double, false>), (launch_tucker<double, true>))
#undef LSE_FWD_ENTRIES
#endif

// The signed Tucker entries, with the weight of type WT.
#define SLSE_FWD_TUCKER(SUFFIX, T, WT)                                                          \
  int slse_fwd_tucker##SUFFIX(const T* a1, const T* s1, const T* a2, const T* s2, const WT* w,  \
                              T* oa, T* os, int F, int B, int K1, int K2, int O, int device,    \
                              void* stream) {                                                   \
    return launch_signed_tucker<false, T, WT>(a1, s1, a2, s2, w, oa, os, F, B, K1, K2, O,       \
                                              device, stream);                                  \
  }                                                                                             \
  int slse_fwd_tucker_softmax##SUFFIX(const T* a1, const T* s1, const T* a2, const T* s2,       \
                                      const WT* theta, T* oa, T* os, int F, int B, int K1,      \
                                      int K2, int O, int device, void* stream) {                \
    return launch_signed_tucker<true, T, WT>(a1, s1, a2, s2, theta, oa, os, F, B, K1, K2, O,    \
                                             device, stream);                                   \
  }

#if !defined(CIRKIT_FWD_PART) || CIRKIT_FWD_PART == 0
SLSE_FWD_TUCKER(_f64, double, double)

// The bf16-weight (_w16) and fast-mode (_fast, _sr) instances of the float
// lse forwards (ops/lse_einsum.py's INSTANCES): the dense ones, the mixing
// sums, on the CUDA cores; the Tucker ones on a bf16 weight on the tensor
// cores (the fast modes' Tucker instances are csrc/tucker_bf16.cu's).
#define LSE_FWD_INSTANCES(SUFFIX, WT, MODE)                                                     \
  int lse_fwd_dense##SUFFIX(const float* x, const WT* w, float* out, int F, int B, int I,       \
                            int O, int device, void* stream) {                                  \
    return launch<float, false, false, false, WT, MODE>(x, nullptr, w, out, F, B, I, 0, 1, O,   \
                                                        device, stream);                        \
  }                                                                                             \
  int lse_fwd_dense_softmax##SUFFIX(const float* x, const WT* theta, float* out, int F, int B,  \
                                    int I, int O, int device, void* stream) {                   \
    return launch<float, false, true, false, WT, MODE>(x, nullptr, theta, out, F, B, I, 0, 1,   \
                                                       O, device, stream);                      \
  }

LSE_FWD_INSTANCES(_fast, float, cirkit::BF16)
LSE_FWD_INSTANCES(_sr, float, cirkit::SR)
LSE_FWD_INSTANCES(_w16, __nv_bfloat16, cirkit::F32)
LSE_FWD_INSTANCES(_w16_fast, __nv_bfloat16, cirkit::BF16)
LSE_FWD_INSTANCES(_w16_sr, __nv_bfloat16, cirkit::SR)

int lse_fwd_tucker_w16(const float* x1, const float* x2, const __nv_bfloat16* w, float* out,
                       int F, int B, int K1, int K2, int O, int device, void* stream) {
  return launch_tucker_tc<false>(x1, x2, w, out, F, B, K1, K2, O, device, stream);
}
int lse_fwd_tucker_softmax_w16(const float* x1, const float* x2, const __nv_bfloat16* theta,
                               float* out, int F, int B, int K1, int K2, int O, int device,
                               void* stream) {
  return launch_tucker_tc<true>(x1, x2, theta, out, F, B, K1, K2, O, device, stream);
}
#endif
#undef LSE_FWD_INSTANCES

// The bf16-weight (_w16) and fast-mode (_fast, _sr) instances of the float
// signed dense forwards (ops/slse_einsum.py), with the float signed entries'
// arguments: lse_fwd's SIGNED instances, and slse_fwd_narrow where a dense
// layer's I and O are at most 32.
#define SLSE_FWD_INSTANCES(SUFFIX, WT, MODE)                                                    \
  int slse_fwd_dense##SUFFIX(const float* a, const float* s, const WT* w, float* oa, float* os, \
                             int F, int B, int I, int O, int device, void* stream) {            \
    return launch<float, false, false, true, WT, MODE>(a, nullptr, w, oa, F, B, I, 0, 1, O,     \
                                                       device, stream, s, nullptr, os);         \
  }                                                                                             \
  int slse_fwd_dense_softmax##SUFFIX(const float* a, const float* s, const WT* theta, float* oa,\
                                     float* os, int F, int B, int I, int O, int device,         \
                                     void* stream) {                                            \
    return launch<float, false, true, true, WT, MODE>(a, nullptr, theta, oa, F, B, I, 0, 1, O,  \
                                                      device, stream, s, nullptr, os);          \
  }

#if !defined(CIRKIT_FWD_PART) || CIRKIT_FWD_PART == 1
SLSE_FWD_TUCKER(, float, float)
SLSE_FWD_INSTANCES(_fast, float, cirkit::BF16)
SLSE_FWD_INSTANCES(_sr, float, cirkit::SR)

// The complex64 Tucker forward against a real weight (the complex flagship's:
// its softmaxed weights stay real): tucker_fwd_tc with CPLX, on PyTorch's
// interleaved complex values; its fast-mode instances are
// csrc/tucker_bf16.cu's, with the same arguments. ops/clse_einsum.py's
// fwd_entry picks it; clse_fwd refuses this configuration.
int clse_fwd_tucker_rw(const void* x1, const void* x2, const float* w, void* out, int F, int B,
                       int K1, int K2, int O, int device, void* stream) {
  return launch_tucker_tc<false, float, false, true>(
      static_cast<const float*>(x1), static_cast<const float*>(x2), w, static_cast<float*>(out),
      F, B, K1, K2, O, device, stream);
}
#endif
#if !defined(CIRKIT_FWD_PART) || CIRKIT_FWD_PART == 2
SLSE_FWD_TUCKER(_w16, float, __nv_bfloat16)
SLSE_FWD_INSTANCES(_w16, __nv_bfloat16, cirkit::F32)
SLSE_FWD_INSTANCES(_w16_fast, __nv_bfloat16, cirkit::BF16)
SLSE_FWD_INSTANCES(_w16_sr, __nv_bfloat16, cirkit::SR)
#endif
#undef SLSE_FWD_INSTANCES
#undef SLSE_FWD_TUCKER

}  // extern "C"
