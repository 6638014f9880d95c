// The fast-mode Tucker backward for Hopper (sm_90a) on the bf16 tensor cores:
// the _fast, _sr, _w16_fast and _w16_sr instances of kernel 2's Tucker
// entries (lse_bwd_tucker[_softmax]*; their float32 and _w16 instances are
// section 6 of csrc/lse_einsum_bwd.cu), which are also the backward of the
// K1-chunked Tucker forward (kernel 5); those of the signed Tucker entries
// (slse_bwd_tucker[_softmax]*, kernel 7's: the same products, with the signs
// folded into the prep's gy and e and into the finish), and the _fast and
// _sr instances of the complex64 Tucker backward against a real weight
// (clse_bwd_tucker_rw*, kernel 11's: the products with CPLX on stacked
// planes, below).
//
// Replaces the CIRKIT_TPU_FAST configurations of the Pallas TPU kernels
// `_bwd_kernel` (Tucker, cirkit_tpu/ops/lse_einsum.py:350-395), `_s_bwd_kernel`
// (`:957`) and `_c_bwd_kernel` (`:1439`, a real weight), which run one bf16
// pass (`_fcast`) with f32 accumulation. Per fold f, with gy = g
// exp(m1 + m2 - out) (zero where not finite), e1 = exp(x1 - m1) and e2 =
// exp(x2 - m2) in f32, and W_i the weights of row i (units x K2 columns j):
//
//   s_i[b,j]  = sum_o r(gy[b,o]) W_i[o,j]               (f32 sums)
//   dx1[b,i]  = e1[b,i] sum_j s_i[b,j] e2[b,j]
//   dx2[b,j]  = e2[b,j] sum_i s_i[b,j] e1[b,i]
//   dW_i[o,j] = sum_b r(gy[b,o]) r(e1[b,i] e2[b,j])     over the whole batch
//   logits:     dtheta = w (dW - r_o), w = exp(theta - lse_o), r_o = sum_b g
//
// at the rounding points of ops/lse_einsum.py's lse_tucker2_bwd_ref: r()
// rounds to bf16, to the nearest (BF16) or by sr_bits (SR) of the element's
// flat index in its operand (gy: ROLE_GY in (F, B, O); plain weights: ROLE_WB
// in (F, O, I); e1 e2: ROLE_EB in (F, B, I)); dx's folds stay f32, and so do
// the softmax weights (they carry lse_o, whose last bits no plain version
// reproduces), which s takes as a bf16 pair hi + lo (hi = r(w), lo = r(w -
// hi), to the nearest): two wgmma where one runs, within 2^-17 |w| of w; the
// plain versions form s from the same pair (ops/lse_einsum.py's bf16_pair),
// since a signed sum that cancels carries that difference far above its
// result. A product of two bf16 values is exact in f32,
// so the tensor cores change only the order of the f32 sums. Every
// exponential is the accurate expf (the plain versions' torch.exp).
//
// What bounds it on the H100: at the K=64 entry (F=784, B=128, K1=K2=O=64)
// the two contractions' 105 GFLOP take 0.106 ms on the bf16 tensor cores,
// and the bytes (the weight read once and its gradient written once, 0.82 GB
// each in f32 or 0.41 GB in bf16, beside the activations) 0.537 or 0.291 ms
// at 3.35 TB/s: the weights' bytes bind. The f32-grade kernels of section 6
// read the weights three times (statistics, dx, the dw epilogue) and write
// dw in f32 for a cast pass, and run one TF32 mma.sync pass, about half of
// wgmma's rate on this card (scripts/mma_peak.py).
//
// The design: one block per (fold, group of up to 128 units, chunk of 64
// columns j) holds every row i of its chunk, so it reads its weights from
// device memory once, forms exp(theta - lse_o) once per tile (kept in
// registers for the dtheta epilogue), writes its dW tiles once, in the
// weight's type (the round-to-nearest of the f32 sum), and finishes dx2 and,
// where K2 <= 64 and O <= 128, dx1 itself. A prep pass (tbw_prep) leaves gy
// rounded to bf16 and e1, e2 transposed (batch rows contiguous), so TMA
// copies every operand. The block's 288 threads are a producer warp (one
// thread of it issues the copies) and two consumer warpgroups. The producer
// copies the batch tile's gy and e2 once, then streams each row i's e1 and
// weight tiles (64 units x 64 columns, one box each, zero past the edges)
// into a ring of stages that complete on mbarriers; each consumer warp
// releases a stage through another mbarrier, so no barrier of the whole
// block runs in the loop. Warpgroup w takes batch rows 64 w .. 64 w + 63
// for s (wgmma m64n64k16: gy K-major, the weights MN-major, as TMA copies
// them) and folds s into dx1 (a quad's shuffle) and into its dx2 registers,
// and columns 32 w .. 32 w + 31 for dW (m64n32k16: gy MN-major, so the one
// gy tile serves both products; r(e1 e2) K-major, which the warpgroup
// converts for its own columns, eight batch rows a thread, while its s
// product runs). A bf16 weight with linear values is the s product's
// operand as copied; logits and float32 weights go through a convert step,
// each warpgroup its half of the columns in dW's fragment layout (without
// branches: the masks are selects), after which the two warpgroups meet at
// a named barrier. dW leaves through the warpgroup's r(e1 e2) buffer as
// whole 16-byte chunks of its rows. A weight that is not 16-byte aligned, or
// whose rows of K2 are not 16-byte multiples, is read element by element by
// the convert step. The shared memory's layout is the launch's (Layout):
// what a mode does not use takes no room from the ring.
//
// The softmax statistics stay a pass of their own (tbw_softmax_stats, one
// more read of theta: 0.41 GB at K=64 in bf16): lse_o is needed before the
// first tile's weights enter s, which sums over the units, so the running
// rescale of the forward (where the unit is the output) has no counterpart.
//
// The signed backward (SIGNED): e1 = s1 exp(x1 - m1), e2 = s2 exp(x2 - m2)
// and gy = g sign(y) exp(m1 + m2 - out) in the prep (tbw_prep), dx = e (the
// sums) in the finish; a signed bf16 value is as exact in a product as an
// unsigned one, so the products and their rounding points are the unsigned
// ones (ops/slse_einsum.py's slse_tucker2_bwd_ref).
//
// The complex backward against a real weight (CPLX): t = gy @ w is one real
// product whose rows are gy's planes, and dW = sum_b Re(gy conj(e)) = sum
// gy_re Re(e) + gy_im Im(e) one over the planes too. ctbw_prep stacks a batch
// row's real plane at row 16 (b / 8) + b % 8 and its imaginary plane 8 rows
// below (tc_common.cuh's stacked_at), so that the rows g and g + 8 that a
// thread holds of wgmma's accumulator are one batch row's two planes: the
// fold forms dx2 += t conj(e1) and the dx1 sum of t conj(e2) from them in
// registers, and the conversion of the composite forms Re(e1 e2) and Im(e1
// e2) from e1's and e2's planes 8 rows apart (ROLE_EB at the plane's flat
// index, ops/clse_einsum.py's round_planes). A batch tile holds 64 batch
// rows, 128 stacked ones, so the tile and the registers are the real ones.
//
// A batch of more than 128 rows takes two launches: the dx kernel, one block
// per batch tile as well (the weights shared through L2), and the dW kernel,
// whose blocks walk the batch tiles for each row i, each stage bringing its
// tile's gy and e2 through the ring with e1; a call without dx or without dW
// takes the one it needs. More than 128 units split into groups whose dx
// sums are partial; dx1 is partial over column chunks too; tbw_dx_finish
// adds the partials in a fixed order. No atomics anywhere, so a call repeats
// to the bit.
//
// Each extern "C" entry selects the given device, launches on the given
// stream and returns the first error of its launches (0 on success).

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "lse_common.cuh"
#include "tc_common.cuh"

namespace {

using cirkit::bf16x2;
using cirkit::clamp_max;
using cirkit::fence_proxy_async;
using cirkit::fence_regs;
using cirkit::mbar_arrive;
using cirkit::mbar_expect;
using cirkit::mbar_init;
using cirkit::mbar_wait;
using cirkit::pack_bf16x8;
using cirkit::round_op;
using cirkit::sw128;
using cirkit::sw128_desc;
using cirkit::sw128_desc_mn;
using cirkit::tma_load_3d;
using cirkit::tma_load_4d;
using cirkit::warp_max;
using cirkit::warp_sum;
using cirkit::wgmma_64x32_ta;
using cirkit::wgmma_64x64_tb;
using cirkit::wgmma_commit;
using cirkit::wgmma_fence;
using cirkit::wgmma_wait;
using cirkit::widen;

namespace tbw {
constexpr int BM = 128;       // batch rows a tile: two consumer warpgroups of 64 for s
constexpr int JC = 64;        // columns j a chunk (a block's): one 128-byte bf16 row
constexpr int UT = 64;        // units a unit tile, one TMA box
constexpr int UG = 128;       // units a group (a block's): one or two unit tiles
constexpr int ROW = 128;      // bytes of a bf16 tile row
constexpr int CONS = 256;     // consumer threads: 8 warps
constexpr int NT = CONS + 32; // and the producer warp
constexpr int ET = 32 * ROW;  // a warpgroup's r(e1 e2) tile: 32 columns j x 64 batch rows
constexpr int WARPS = 8;      // warps of the small kernels, a row each
// the launch flags
constexpr int DO_DX = 1, DO_DW = 2, DIRECT1 = 4, DIRECT2 = 8, VEC = 16, STG16 = 32;

// A block on NU unit tiles of weights of type WT: the bytes of a unit tile's
// box, of the batch tile's gy tiles [u][b][o], of one buffer of converted
// weights (hi, and lo for logits, [u][o][j]) and of the warpgroups' r(e1 e2)
// tiles [w][k tile][j][b]; e2 is [j][b] in f32 (BM x JC x 4 bytes), e1 a
// column of BM floats (1 KB in a stage, keeping its tiles 1024-byte aligned).
template <int NU, typename WT, bool SOFTMAX>
struct Cfg {
  static constexpr int TILE = UT * JC * static_cast<int>(sizeof(WT));
  static constexpr int GY = NU * BM * ROW;
  static constexpr int WB = (SOFTMAX ? 2 : 1) * NU * UT * ROW;
  static constexpr int EB = 4 * ET;
  static constexpr int E2 = JC * BM * 4;
};
}  // namespace tbw

inline unsigned cdiv(long long a, long long b) { return static_cast<unsigned>((a + b - 1) / b); }

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The float offset of e2 at (column j, batch row b) in a batch tile's e2:
// four boxes of 32 rows b, each [j][32 b] in the 128-byte swizzle (the
// 16-byte chunk c of row j at c ^ (j % 8)), so a column's eight rows are two
// chunks and the fold's reads of four columns and eight rows meet no bank
// twice.
__device__ __forceinline__ int e2_at(int j, int b) {
  return (b >> 5) * (tbw::JC * 32) + j * 32 + ((((b & 31) >> 2) ^ (j & 7)) << 2) + (b & 3);
}

// Two bf16-exact f32 values as a bf16 pair (the first in the low half).
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return (__float_as_uint(a) >> 16) | (__float_as_uint(b) & 0xFFFF0000u);
}

// Per batch row (a warp each, eight rows a block): the clamped row maxes m1,
// m2 (sa, sb); the gy row, zero where not finite (section 1 of
// csrc/lse_einsum_bwd.cu), and rounded to bf16 (ROLE_GY at its flat index)
// into gyr (F, B, Op); e1 = exp(x1 - m1) and e2 = exp(x2 - m2) transposed,
// into e1t (F, K1, Bp) and e2t (F, K2, Bp), through shared memory so that
// each column's eight rows are one 32-byte write. Op and Bp are multiples of
// 8: every row of the three starts 16-byte aligned, as TMA reads them.
template <int MODE, bool SIGNED = false>
__global__ void __launch_bounds__(256)
tbw_prep(const float* __restrict__ x1, const float* __restrict__ x2,
         const float* __restrict__ out, const float* __restrict__ g, float* __restrict__ sa,
         float* __restrict__ sb, float* __restrict__ gy, __nv_bfloat16* __restrict__ gyr,
         float* __restrict__ e1t, float* __restrict__ e2t, int B, int K1, int K2, int O,
         int Op, int Bp, const float* __restrict__ out_sign, const float* __restrict__ s1,
         const float* __restrict__ s2) {
  constexpr int W = tbw::WARPS, TR = 128;  // rows a block, columns a transpose chunk
  __shared__ float xs[2][W][TR + 1];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int f = blockIdx.x, b0 = blockIdx.y * W, b = b0 + w;
  const size_t row = (size_t)f * B + b;
  float m1 = 0.f, m2 = 0.f;
  if (b < B) {  // warp-uniform
    m1 = -INFINITY, m2 = -INFINITY;
    for (int k = lane; k < K1; k += 32) m1 = fmaxf(m1, x1[row * K1 + k]);
    for (int k = lane; k < K2; k += 32) m2 = fmaxf(m2, x2[row * K2 + k]);
    m1 = clamp_max(warp_max(m1));
    m2 = clamp_max(warp_max(m2));
    if (lane == 0) sa[row] = m1, sb[row] = m2;
    for (int o = lane; o < Op; o += 32) {
      float v = 0.f;
      if (o < O) {
        const size_t idx = row * O + o;
        v = g[idx] * expf(m1 + m2 - out[idx]);
        if constexpr (SIGNED) v *= out_sign[idx];
        v = isfinite(v) ? v : 0.f;
        gy[idx] = v;
        v = round_op<MODE>(v, idx, cirkit::ROLE_GY);
      }
      gyr[row * Op + o] = __float2bfloat16_rn(v);  // exact: v is bf16 already
    }
  }
  for (int c0 = 0; c0 < max(K1, K2); c0 += TR) {
    for (int k = lane; k < TR; k += 32) {
      const int c = c0 + k;
      xs[0][w][k] = b < B && c < K1 ? expf(x1[row * K1 + c] - m1) : 0.f;
      xs[1][w][k] = b < B && c < K2 ? expf(x2[row * K2 + c] - m2) : 0.f;
      if constexpr (SIGNED) {  // e = s exp(a - m)
        if (b < B && c < K1) xs[0][w][k] *= s1[row * K1 + c];
        if (b < B && c < K2) xs[1][w][k] *= s2[row * K2 + c];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < W * TR; e += 256) {
      const int c = c0 + e / W, r = e % W;
      if (b0 + r >= B) continue;
      if (c < K1) e1t[((size_t)f * K1 + c) * Bp + b0 + r] = xs[0][r][e / W];
      if (c < K2) e2t[((size_t)f * K2 + c) * Bp + b0 + r] = xs[1][r][e / W];
    }
    __syncthreads();
  }
}

// Per weight row of the softmax (a warp each): lse_o and r_o = sum_b g_bo
// over the rows whose gy_bo is nonzero (tc_softmax_stats of
// csrc/lse_einsum_bwd.cu).
template <typename WT>
__global__ void __launch_bounds__(256)
tbw_softmax_stats(const WT* __restrict__ theta, const float* __restrict__ g,
                  const float* __restrict__ gy, float* __restrict__ lse,
                  float* __restrict__ rsum, int B, int O, int I) {
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.y * tbw::WARPS + (threadIdx.x >> 5);
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

// dx1 = e1 (the sum of n1 partial planes), dx2 = e2 (the sum of n2), added in
// plane order (a null part skips its gradient); a warp per batch row. SIGNED:
// e = s exp(x - m) with the inputs' signs s1, s2.
template <bool SIGNED = false>
__global__ void __launch_bounds__(256)
tbw_dx_finish(const float* __restrict__ x1, const float* __restrict__ x2,
              const float* __restrict__ sa, const float* __restrict__ sb,
              const float* __restrict__ part1, const float* __restrict__ part2,
              float* __restrict__ dx1, float* __restrict__ dx2, int F, int B, int K1, int K2,
              int n1, int n2, const float* __restrict__ s1, const float* __restrict__ s2) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y * tbw::WARPS + (threadIdx.x >> 5);
  if (b >= B) return;
  const size_t row = (size_t)blockIdx.x * B + b, plane = (size_t)F * B;
  if (part1 != nullptr)
    for (int k = lane; k < K1; k += 32) {
      float s = 0.f;
      for (int p = 0; p < n1; ++p) s += part1[(p * plane + row) * K1 + k];
      float e = expf(x1[row * K1 + k] - sa[row]);
      if constexpr (SIGNED) e *= s1[row * K1 + k];
      dx1[row * K1 + k] = e * s;
    }
  if (part2 != nullptr)
    for (int k = lane; k < K2; k += 32) {
      float s = 0.f;
      for (int p = 0; p < n2; ++p) s += part2[(p * plane + row) * K2 + k];
      float e = expf(x2[row * K2 + k] - sb[row]);
      if constexpr (SIGNED) e *= s2[row * K2 + k];
      dx2[row * K2 + k] = e * s;
    }
}

// The complex Tucker backward against a real weight (launch_bwd_bf16 with
// CPLX) runs the products on stacked planes (tc_common.cuh's stacked_at: a
// batch row's real plane at 16 (b / 8) + b % 8 of the Rs = 2 Bp stacked rows,
// its imaginary plane 8 rows below). Per batch row (a warp each, eight rows
// a block, the batch padded to Bp): the clamped maxes of the real parts (sa,
// sb); gy = g / conj(y), zero where not finite (clse_einsum.cu's
// clse_bwd_prep), each plane rounded (ROLE_GY at the plane's flat index 2 k
// + p, k the value's in (F, B, O)) into its stacked row of gyr (F, Rs, Op);
// e1 = exp(x1 - m1) and e2 = exp(x2 - m2) (accurate expf and sincosf), their
// planes transposed into e1t (F, K1, Rs) and e2t (F, K2, Rs) through shared
// memory. The padding's rows are zero.
template <int MODE>
__global__ void __launch_bounds__(256)
ctbw_prep(const float2* __restrict__ x1, const float2* __restrict__ x2,
          const float2* __restrict__ out, const float2* __restrict__ g, float* __restrict__ sa,
          float* __restrict__ sb, __nv_bfloat16* __restrict__ gyr, float* __restrict__ e1t,
          float* __restrict__ e2t, int B, int K1, int K2, int O, int Op, int Rs) {
  constexpr int W = tbw::WARPS, TR = 64;  // rows a block, columns a transpose chunk
  __shared__ float xs[2][2][W][TR + 1];   // [input][plane][row][column]
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int f = blockIdx.x, b0 = blockIdx.y * W, b = b0 + w;
  const size_t row = (size_t)f * B + b;
  const size_t sr = (size_t)f * Rs + 2 * b0 + w;  // b's real plane: stacked_at(b)
  float m1 = 0.f, m2 = 0.f;
  if (b < B) {  // warp-uniform
    m1 = -INFINITY, m2 = -INFINITY;
    for (int k = lane; k < K1; k += 32) m1 = fmaxf(m1, x1[row * K1 + k].x);
    for (int k = lane; k < K2; k += 32) m2 = fmaxf(m2, x2[row * K2 + k].x);
    m1 = clamp_max(warp_max(m1));
    m2 = clamp_max(warp_max(m2));
    if (lane == 0) sa[row] = m1, sb[row] = m2;
  }
  for (int o = lane; o < Op; o += 32) {
    float vr = 0.f, vi = 0.f;
    if (b < B && o < O) {
      const size_t idx = row * O + o;
      const float2 ov = out[idx], gv = g[idx];
      float ur, ui;  // 1 / conj(y)
      cirkit::cexp_f32(m1 + m2 - ov.x, ov.y, &ur, &ui);
      vr = gv.x * ur - gv.y * ui;
      vi = gv.x * ui + gv.y * ur;
      if (!(isfinite(vr) && isfinite(vi))) vr = vi = 0.f;
      vr = round_op<MODE>(vr, 2 * idx, cirkit::ROLE_GY);
      vi = round_op<MODE>(vi, 2 * idx + 1, cirkit::ROLE_GY);
    }
    gyr[sr * Op + o] = __float2bfloat16_rn(vr);  // exact: bf16 already
    gyr[(sr + 8) * Op + o] = __float2bfloat16_rn(vi);
  }
  for (int c0 = 0; c0 < max(K1, K2); c0 += TR) {
    for (int k = lane; k < TR; k += 32) {
      const int c = c0 + k;
      float r = 0.f, i = 0.f;
      if (b < B && c < K1) {
        const float2 z = x1[row * K1 + c];
        cirkit::cexp_f32(z.x - m1, z.y, &r, &i);
      }
      xs[0][0][w][k] = r, xs[0][1][w][k] = i;
      r = i = 0.f;
      if (b < B && c < K2) {
        const float2 z = x2[row * K2 + c];
        cirkit::cexp_f32(z.x - m2, z.y, &r, &i);
      }
      xs[1][0][w][k] = r, xs[1][1][w][k] = i;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < 2 * W * TR; e += 256) {
      const int c = c0 + e / (2 * W), q = e % (2 * W), p = q / W, r = q % W;
      const size_t at = 2 * (size_t)b0 + 8 * p + r;
      if (c < K1) e1t[((size_t)f * K1 + c) * Rs + at] = xs[0][p][r][e / (2 * W)];
      if (c < K2) e2t[((size_t)f * K2 + c) * Rs + at] = xs[1][p][r][e / (2 * W)];
    }
    __syncthreads();
  }
}

// The shared memory of a launch of the products (tbw_layout), byte offsets
// from the 1024-aligned base: the batch tile's gy and e2, resident where the
// block has one batch tile; two buffers of converted weights, for the s
// product's logits, float32 or misaligned weights; the warpgroups' r(e1 e2)
// tiles; the ring of stages (e1 at row i; the row's weight boxes where they
// are copied; the batch tile's gy and e2 where the block walks the batch);
// the mbarriers.
struct Layout {
  int res, wb, eb, ring, bars, stage, ns, s_w, s_gy, s_e2;
  size_t bytes;
};

// The products, one block per (fold, unit group, column chunk, batch tile
// of the grid); ``flags`` (tbw::DO_DX ...) select the gradients, whether dx1
// and dx2 are written finished (DIRECT*) or as partial planes (then ``dx1``
// and ``dx2`` point at them), the weights' boxes (VEC) and the dW chunk
// stores (STG16). The grid's batch tiles (nbt_grid) or the block's own walk
// over them (nbt_loop, dW alone) cover the batch. TMA copies every operand:
// gy rounded, e1 and e2 as tbw_prep left them, the weights as they are.
template <int NU, bool SOFTMAX, typename WT, int MODE, bool CPLX = false>
__global__ void __launch_bounds__(tbw::NT, 1)
tucker_bwd_bf16(const WT* __restrict__ w,  // (F, O, K1*K2): weights, or logits
                const float* __restrict__ lse, const float* __restrict__ rsum,  // (F, O)
                float* __restrict__ dx1, float* __restrict__ dx2, WT* __restrict__ dw,
                // the weight as (F, O, K1, K2), 64 x 64 boxes of (units, j), unset
                // without VEC; gyr as (F, B, O), 128 x 64 boxes of (b, units); e1t
                // and e2t as (F, K, B), boxes of 1 x 128 and 64 x 32 (j, b)
                const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap gmap,
                const __grid_constant__ CUtensorMap e1map,
                const __grid_constant__ CUtensorMap e2map, const Layout lay, int F, int B,
                int K1, int K2, int O, int n_ug, int n_jc, int nbt_grid, int nbt_loop,
                int flags, int Bc) {
  using C = tbw::Cfg<NU, WT, SOFTMAX>;
  constexpr int BM = tbw::BM, JC = tbw::JC, UT = tbw::UT, ROW = tbw::ROW, CONS = tbw::CONS;
  constexpr int TILE = C::TILE, ET = tbw::ET, GY = C::GY;
  // a bf16 weight with linear values is the s product's operand as copied
  constexpr bool RAW16 = sizeof(WT) == 2 && !SOFTMAX;
  static_assert(MODE != cirkit::F32, "the f32-grade instances are section 6 of lse_einsum_bwd.cu");
  static_assert(!CPLX || (!SOFTMAX && sizeof(WT) == 4), "the complex route has a real f32 weight");

  extern __shared__ __align__(16) unsigned char tbw_raw[];
  unsigned char* smem = tbw_raw + ((1024 - (static_cast<uint32_t>(
                                               __cvta_generic_to_shared(tbw_raw)) & 1023)) & 1023);
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  unsigned char* wb = smem + lay.wb;
  unsigned char* ebuf = smem + lay.eb;  // [2 warpgroups][2 k tiles]: r(e1 e2), [j][b]
  unsigned char* ring = smem + lay.ring;
  const uint32_t wb_s = sbase + lay.wb, eb_s = sbase + lay.eb, ring_s = sbase + lay.ring;
  // [ns] full mbarriers (the producer's arrival and the copies' bytes), [ns]
  // empty ones (an arrival of each consumer warp), the resident batch tile's
  const uint32_t full0 = sbase + lay.bars, empty0 = full0 + 8 * lay.ns;
  const uint32_t batch_bar = empty0 + 8 * lay.ns;
  const int ns = lay.ns;

  // batch tile fastest: the blocks of one fold share its gy and e through L2
  int rest = blockIdx.x;
  const int btg = rest % nbt_grid;
  rest /= nbt_grid;
  const int jc = rest % n_jc;
  rest /= n_jc;
  const int ug = rest % n_ug, f = rest / n_ug;
  const int j0 = jc * JC, o0 = ug * tbw::UG, I = K1 * K2;
  const bool do_dx = flags & tbw::DO_DX, do_dw = flags & tbw::DO_DW, vec = flags & tbw::VEC;
  const bool raw = RAW16 && vec && do_dx;
  const bool conv_w = (do_dx && !raw) || (SOFTMAX && do_dw);  // the convert step's weights
  const bool load_w = vec && (do_dx || SOFTMAX);              // the boxes through the ring
  const int n_st = K1 * nbt_loop;                              // stage t: row t / nbt_loop
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int k = 0; k < ns; ++k) {
      mbar_init(full0 + 8 * k, 1);
      mbar_init(empty0 + 8 * k, CONS / 32);
    }
    mbar_init(batch_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONS) {
    // The producer, one thread: the resident batch tile's gy and e2, then for
    // each stage e1 at row i, the row's weight boxes (its first batch tile)
    // and the batch tile's gy and e2 (walking the batch), by TMA.
    if (tid != CONS) return;
    auto batch = [&](uint32_t dst, int b0, uint32_t bar) {
#pragma unroll
      for (int u = 0; u < NU; ++u) tma_load_3d(dst + u * BM * ROW, &gmap, o0 + UT * u, b0, f, bar);
#pragma unroll
      for (int q = 0; q < BM / 32; ++q)
        tma_load_3d(dst + GY + q * JC * 128, &e2map, b0 + 32 * q, j0, f, bar);
    };
    if (nbt_loop == 1) {
      mbar_expect(batch_bar, GY + JC * BM * 4);
      batch(sbase + lay.res, btg * BM, batch_bar);
    }
    for (int t = 0; t < n_st; ++t) {
      const int slot = t % ns, i = t / nbt_loop, btl = t - i * nbt_loop;
      const int b0 = (nbt_loop > 1 ? btl : btg) * BM;
      const bool w_now = load_w && btl == 0;
      const uint32_t st = ring_s + slot * lay.stage, bar = full0 + 8 * slot;
      mbar_wait(empty0 + 8 * slot, ((t / ns) & 1) ^ 1);
      mbar_expect(bar, BM * 4 + (w_now ? NU * TILE : 0) + (nbt_loop > 1 ? GY + JC * BM * 4 : 0));
      tma_load_3d(st, &e1map, b0, i, f, bar);
      if (w_now)
#pragma unroll
        for (int u = 0; u < NU; ++u)
          tma_load_4d(st + lay.s_w + u * TILE, &wmap, j0, i, o0 + UT * u, f, bar);
      if (nbt_loop > 1) batch(st + lay.s_gy, b0, bar);
    }
    return;
  }

  // The consumers: warpgroup wg, warp wq in it; s rows r0, r0 + 8 of the
  // batch tile, dW units 16 wq + g (+ 8) of each unit tile and columns
  // 32 wg + 8 n + 2 t4 (+ 1) of the chunk.
  const int wg = tid >> 7, tw = tid & 127, wq = tw >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 64 * wg + 16 * wq + g;
  const WT* wf = w + (size_t)f * O * I;

  float lse_r[NU][2], rs_r[NU][2];
#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + UT * u + 16 * wq + g + 8 * h;
      lse_r[u][h] = SOFTMAX && o < O ? lse[(size_t)f * O + o] : 0.f;
      rs_r[u][h] = SOFTMAX && o < O ? rsum[(size_t)f * O + o] : 0.f;
    }
  if (nbt_loop == 1) mbar_wait(batch_bar, 0);

  float sacc[32], x2acc[32], dwacc[NU][16];
  float wv[NU][2][4][2];  // logits: the softmax weights of this thread's dW values
#pragma unroll
  for (int e = 0; e < 32; ++e) x2acc[e] = 0.f;

  // The convert step of row i's weights: this thread's dW positions (units
  // 16 wq + g + 8 h of each unit tile, columns 32 wg + 8 n + 2 t4, + 1),
  // read from the stage's boxes (VEC) or from device memory; logits become
  // w = exp(theta - lse_o) (kept in wv) and the pair hi, lo, others their
  // rounding (ROLE_WB); into buffer ``buf`` for the s product, [u][o][j] in
  // the swizzle, as TMA writes a bf16 box.
  auto convert_w = [&](auto vec_c, const unsigned char* sl, int i, int buf) {
    constexpr bool VEC = decltype(vec_c)::value;
    const bool to_smem = do_dx && !raw;
    unsigned char* hi = wb + buf * C::WB;
    unsigned char* lo = hi + NU * UT * ROW;
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ol = 16 * wq + g + 8 * h, o = o0 + UT * u + ol;
        const bool orow = o < O;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int jl = 32 * wg + 8 * n + 2 * t4, j = j0 + jl;
          const bool m0 = orow && j < K2, m1 = orow && j + 1 < K2;
          // masks as selects, not branches (read element by element, a
          // masked element reads the fold's first weight and drops it)
          float v0, v1;
          if constexpr (VEC && sizeof(WT) == 4) {
            const float2 p = *reinterpret_cast<const float2*>(sl + u * TILE + (ol * JC + jl) * 4);
            v0 = p.x, v1 = p.y;
          } else if constexpr (VEC) {
            const uint32_t p = *reinterpret_cast<const uint32_t*>(sl + u * TILE + sw128(ol, jl));
            v0 = __uint_as_float(p << 16), v1 = __uint_as_float(p & 0xFFFF0000u);
          } else {
            const size_t at = (size_t)o * I + (size_t)i * K2 + j;
            v0 = widen(wf[m0 ? at : 0]);
            v1 = widen(wf[m1 ? at + 1 : 0]);
          }
          uint32_t hw, lw = 0;
          if constexpr (SOFTMAX) {
            v0 = expf(m0 ? v0 - lse_r[u][h] : -INFINITY);
            v1 = expf(m1 ? v1 - lse_r[u][h] : -INFINITY);
            wv[u][h][n][0] = v0, wv[u][h][n][1] = v1;
            hw = bf16x2(v0, v1);
            lw = bf16x2(v0 - __uint_as_float(hw << 16), v1 - __uint_as_float(hw & 0xFFFF0000u));
          } else {
            v0 = m0 ? v0 : 0.f;
            v1 = m1 ? v1 : 0.f;
            const unsigned long long idx =
                ((unsigned long long)f * O + o) * I + (size_t)i * K2 + j;
            hw = MODE == cirkit::BF16 ? bf16x2(v0, v1)
                                      : pack2(round_op<MODE>(v0, idx, cirkit::ROLE_WB),
                                              round_op<MODE>(v1, idx + 1, cirkit::ROLE_WB));
          }
          if (to_smem) {
            *reinterpret_cast<uint32_t*>(hi + u * UT * ROW + sw128(ol, jl)) = hw;
            if (SOFTMAX) *reinterpret_cast<uint32_t*>(lo + u * UT * ROW + sw128(ol, jl)) = lw;
          }
        }
      }
  };

  // r(e1[b, i] e2[b, j]) (ROLE_EB at its flat index in (F, B, I)) for this
  // warpgroup's columns: eight batch rows a chunk, four chunks a thread.
  auto convert_e = [&](const float* e1c, const float* e2c, int i, int b0) {
    unsigned char* et = ebuf + wg * 2 * ET;
    if constexpr (CPLX) {
      // eight stacked rows are one plane p of eight batch rows: Re(e1 e2) =
      // e1r e2r - e1i e2i, Im(e1 e2) = e1r e2i + e1i e2r from the row's own
      // plane and the other one, 8 rows away; ROLE_EB at the plane's flat
      // index 2 k + p, k the value's in (F, B, I), so eight rows step 2 I
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = tw + 128 * q, jl = c >> 4, cb = c & 15;
        const int j = 32 * wg + jl, b = 8 * cb, bo = b ^ 8, p = cb & 1;
        auto ld8 = [](const float* p0, const float* p1, float (&d)[8]) {
          const float4 u = *reinterpret_cast<const float4*>(p0);
          const float4 w4 = *reinterpret_cast<const float4*>(p1);
          d[0] = u.x, d[1] = u.y, d[2] = u.z, d[3] = u.w;
          d[4] = w4.x, d[5] = w4.y, d[6] = w4.z, d[7] = w4.w;
        };
        float e1o[8], e1q[8], e2o[8], e2q[8];
        ld8(e1c + b, e1c + b + 4, e1o);
        ld8(e1c + bo, e1c + bo + 4, e1q);
        ld8(e2c + e2_at(j, b), e2c + e2_at(j, b + 4), e2o);
        ld8(e2c + e2_at(j, bo), e2c + e2_at(j, bo + 4), e2q);
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v[k] = p == 0 ? e1o[k] * e2o[k] - e1q[k] * e2q[k] : e1q[k] * e2o[k] + e1o[k] * e2q[k];
        const unsigned long long idx =
            2 * (((unsigned long long)f * Bc + b0 / 2 + 8 * (cb >> 1)) * I + (size_t)i * K2 +
                 j0 + j) + p;
        *reinterpret_cast<uint4*>(et + (cb >> 3) * ET + sw128(jl, 8 * (cb & 7))) =
            pack_bf16x8<MODE>(v, idx, cirkit::ROLE_EB, 2 * (unsigned long long)I);
      }
      return;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = tw + 128 * q, jl = c >> 4, cb = c & 15;
      const int j = 32 * wg + jl, b = 8 * cb;
      const float4 a0 = *reinterpret_cast<const float4*>(e1c + b);
      const float4 a1 = *reinterpret_cast<const float4*>(e1c + b + 4);
      const float4 c0 = *reinterpret_cast<const float4*>(e2c + e2_at(j, b));
      const float4 c1 = *reinterpret_cast<const float4*>(e2c + e2_at(j, b + 4));
      const float v[8] = {a0.x * c0.x, a0.y * c0.y, a0.z * c0.z, a0.w * c0.w,
                          a1.x * c1.x, a1.y * c1.y, a1.z * c1.z, a1.w * c1.w};
      const unsigned long long idx =
          ((unsigned long long)f * B + b0 + b) * I + (size_t)i * K2 + j0 + j;
      *reinterpret_cast<uint4*>(et + (cb >> 3) * ET + sw128(jl, 8 * (cb & 7))) =
          pack_bf16x8<MODE>(v, idx, cirkit::ROLE_EB, (unsigned long long)I);
    }
  };

  // s_i into dx: dx2 += s e1[b, i] in registers, dx1[b, i] = sum_j s e2 over
  // the chunk (a quad's shuffle), finished or into its partial plane.
  auto fold = [&](const float* e1c, const float* e2c, int i, int b0) {
    if constexpr (CPLX) {
      // rows r0 and r0 + 8 are batch row b's planes, t = s_re + i s_im:
      // dx2 += t conj(e1[b, i]) (x2acc's two halves the planes), the dx1 sum
      // of t conj(e2[b, j]); dx1 = conj(e1) times it, or it into the plane
      const float e1r = e1c[r0], e1i = e1c[r0 + 8];
      float pr = 0.f, pi = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 4 * n + e, jl = 8 * n + 2 * t4 + e;
          const float tr = sacc[k], ti = sacc[k + 2];
          x2acc[k] = fmaf(ti, e1i, fmaf(tr, e1r, x2acc[k]));
          x2acc[k + 2] = fmaf(-tr, e1i, fmaf(ti, e1r, x2acc[k + 2]));
          const float cr = e2c[e2_at(jl, r0)], ci = e2c[e2_at(jl, r0 + 8)];
          pr = fmaf(ti, ci, fmaf(tr, cr, pr));
          pi = fmaf(-tr, ci, fmaf(ti, cr, pi));
        }
      pr += __shfl_xor_sync(0xffffffffu, pr, 1);
      pr += __shfl_xor_sync(0xffffffffu, pr, 2);
      pi += __shfl_xor_sync(0xffffffffu, pi, 1);
      pi += __shfl_xor_sync(0xffffffffu, pi, 2);
      const int b = b0 / 2 + cirkit::stacked_row(r0);
      if (t4 == 0 && dx1 != nullptr && b < Bc) {
        auto* d = reinterpret_cast<float2*>(dx1);
        if (flags & tbw::DIRECT1)
          d[((size_t)f * Bc + b) * K1 + i] = make_float2(e1r * pr + e1i * pi, e1r * pi - e1i * pr);
        else
          d[(((size_t)(ug * n_jc + jc) * F + f) * Bc + b) * K1 + i] = make_float2(pr, pi);
      }
      return;
    }
    float p[2] = {0.f, 0.f}, eh[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) eh[h] = e1c[r0 + 8 * h];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 4 * n + 2 * h + e;
          x2acc[k] = fmaf(sacc[k], eh[h], x2acc[k]);
          p[h] = fmaf(sacc[k], e2c[e2_at(8 * n + 2 * t4 + e, r0 + 8 * h)], p[h]);
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      p[h] += __shfl_xor_sync(0xffffffffu, p[h], 1);
      p[h] += __shfl_xor_sync(0xffffffffu, p[h], 2);
    }
    if (t4 == 0 && dx1 != nullptr)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = b0 + r0 + 8 * h;
        if (b >= B) continue;
        if (flags & tbw::DIRECT1)
          dx1[((size_t)f * B + b) * K1 + i] = eh[h] * p[h];
        else
          dx1[(((size_t)(ug * n_jc + jc) * F + f) * B + b) * K1 + i] = p[h];
      }
  };

  // Row i's dW tiles in the weight's type (logits: w (dW - r_o)), a unit tile
  // at a time through this warpgroup's r(e1 e2) buffer (free once dW's
  // products are done): its 64 units x 32 columns in rows of 16-byte chunks
  // (swizzled, so neither side's accesses collide), then written as whole
  // chunks (STG16: every row of K2 and the gradient 16-byte aligned) or
  // element by element.
  auto epilogue = [&](int i) {
    constexpr int EPC = 16 / static_cast<int>(sizeof(WT));  // elements a chunk
    constexpr int CPR = 32 / EPC;                            // chunks a row
    unsigned char* st = ebuf + wg * 2 * ET;
    auto chunk = [](int r, int k) -> int {
      return sizeof(WT) == 2 ? r * 64 + ((k ^ ((r >> 1) & 3)) << 4)
                             : r * 128 + ((k ^ (r & 7)) << 4);
    };
    WT* dwf = dw + (size_t)f * O * I + (size_t)i * K2 + j0 + 32 * wg;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * wq + g + 8 * h;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int jl = 8 * n + 2 * t4;
          float v0 = dwacc[u][4 * n + 2 * h], v1 = dwacc[u][4 * n + 2 * h + 1];
          if (SOFTMAX) {
            v0 = wv[u][h][n][0] * (v0 - rs_r[u][h]);
            v1 = wv[u][h][n][1] * (v1 - rs_r[u][h]);
          }
          unsigned char* at = st + chunk(r, jl / EPC) + (jl % EPC) * sizeof(WT);
          if constexpr (sizeof(WT) == 2)
            *reinterpret_cast<uint32_t*>(at) = bf16x2(v0, v1);
          else
            *reinterpret_cast<float2*>(at) = make_float2(v0, v1);
        }
      }
      named_bar(2 + wg, 128);
      for (int c = tw; c < UT * CPR; c += 128) {
        const int r = c / CPR, k = c - r * CPR, o = o0 + UT * u + r;
        const int j = j0 + 32 * wg + EPC * k;
        if (o >= O || j >= K2) continue;
        WT* dst = dwf + (size_t)o * I + EPC * k;
        const unsigned char* src = st + chunk(r, k);
        if (flags & tbw::STG16) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            if (j + e < K2) dst[e] = reinterpret_cast<const WT*>(src)[e];
        }
      }
      named_bar(2 + wg, 128);
    }
  };

  for (int t = 0; t < n_st; ++t) {
    const int slot = t % ns, i = t / nbt_loop, btl = t - i * nbt_loop;
    const int b0 = (nbt_loop > 1 ? btl : btg) * BM;
    const unsigned char* sl = ring + slot * lay.stage;
    const float* e1c = reinterpret_cast<const float*>(sl);
    // the batch tile's gy (shared address, for wgmma) and e2: resident, or
    // this stage's copies
    const uint32_t gy_s = nbt_loop > 1 ? ring_s + slot * lay.stage + lay.s_gy : sbase + lay.res;
    const float* e2c = reinterpret_cast<const float*>(
        nbt_loop > 1 ? sl + lay.s_e2 : smem + lay.res + GY);
    const int buf = i & 1;
    mbar_wait(full0 + 8 * slot, (t / ns) & 1);
    if (btl == 0 && conv_w) {
      if (vec)
        convert_w(std::true_type{}, sl + lay.s_w, i, buf);
      else
        convert_w(std::false_type{}, sl + lay.s_w, i, buf);
    }
    if (do_dx && !raw) {  // both halves of the converted weights
      fence_proxy_async();
      named_bar(1, CONS);
    }
    // Two wgmma groups a stage whatever the flags (an empty one where a
    // product is not wanted), so the waits below stand for the same groups
    // on every path.
    fence_regs(sacc);
    wgmma_fence();
    if (do_dx) {
      // s over the unit tiles: gy (K-major, this warpgroup's 64 rows) by the
      // weights (MN-major: rows o, columns j), then the logits' lo part
      const uint32_t a0 = gy_s + wg * 64 * ROW;
      const uint32_t w0 = raw ? ring_s + slot * lay.stage + lay.s_w : wb_s + buf * C::WB;
      const uint32_t wstep = raw ? TILE : UT * ROW;
#pragma unroll
      for (int u = 0; u < NU; ++u)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_64x64_tb(sacc, sw128_desc(a0 + u * BM * ROW) + 2 * ks,
                         sw128_desc_mn(w0 + u * wstep + ks * 2048), (u | ks) != 0);
      if (SOFTMAX)
#pragma unroll
        for (int u = 0; u < NU; ++u)
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_64x64_tb(sacc, sw128_desc(a0 + u * BM * ROW) + 2 * ks,
                           sw128_desc_mn(w0 + (NU + u) * UT * ROW + ks * 2048), 1);
    }
    wgmma_commit();
    if (do_dw) {  // r(e1 e2) of this stage, converted while s runs
      convert_e(e1c, e2c, i, b0);
      fence_proxy_async();
      named_bar(2 + wg, 128);
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) fence_regs(dwacc[u]);
    wgmma_fence();
    if (do_dw) {
      // dW over the batch tile: gy (MN-major: rows b, columns o) by r(e1 e2)
      // (K-major)
#pragma unroll
      for (int u = 0; u < NU; ++u)
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
          wgmma_64x32_ta(dwacc[u], sw128_desc_mn(gy_s + u * BM * ROW + ks * 2048),
                         sw128_desc(eb_s + (wg * 2 + (ks >> 2)) * ET) + 2 * (ks & 3),
                         (ks | btl) != 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sacc);
    if (do_dx) fold(e1c, e2c, i, b0);
    wgmma_wait<0>();
#pragma unroll
    for (int u = 0; u < NU; ++u) fence_regs(dwacc[u]);
    if (do_dw && btl == nbt_loop - 1) epilogue(i);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);
  }

  // dx2 of the batch tile, finished or into its unit group's plane
  if constexpr (CPLX) {  // x2acc's halves are the planes: dx2 = conj(e2) (x2r + i x2i)
    if (do_dx && dx2 != nullptr) {
      const float* e2c = reinterpret_cast<const float*>(smem + lay.res + GY);
      const int b = btg * BM / 2 + cirkit::stacked_row(r0);
      auto* d = reinterpret_cast<float2*>(dx2);
      if (b < Bc)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jl = 8 * n + 2 * t4 + e, j = j0 + jl;
            if (j >= K2) continue;
            const float vr = x2acc[4 * n + e], vi = x2acc[4 * n + 2 + e];
            if (flags & tbw::DIRECT2) {
              const float cr = e2c[e2_at(jl, r0)], ci = e2c[e2_at(jl, r0 + 8)];
              d[((size_t)f * Bc + b) * K2 + j] = make_float2(cr * vr + ci * vi, cr * vi - ci * vr);
            } else {
              d[(((size_t)ug * F + f) * Bc + b) * K2 + j] = make_float2(vr, vi);
            }
          }
    }
    return;
  }
  if (do_dx && dx2 != nullptr) {
    const int b0 = btg * BM;
    const float* e2c = reinterpret_cast<const float*>(smem + lay.res + GY);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, b = b0 + r;
      if (b >= B) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jl = 8 * n + 2 * t4 + e, j = j0 + jl;
          if (j >= K2) continue;
          const float v = x2acc[4 * n + 2 * h + e];
          if (flags & tbw::DIRECT2)
            dx2[((size_t)f * B + b) * K2 + j] = e2c[e2_at(jl, r)] * v;
          else
            dx2[(((size_t)ug * F + f) * B + b) * K2 + j] = v;
        }
    }
  }
}

// The shared memory of a products launch (Layout): the ring takes what the
// fixed parts leave, at most 6 stages.
template <int NU, bool SOFTMAX, typename WT>
Layout tbw_layout(bool conv_to_smem, bool load_w, bool walk) {
  using C = tbw::Cfg<NU, WT, SOFTMAX>;
  Layout l{};
  int at = 0;
  l.res = at;
  at += walk ? 0 : C::GY + C::E2;
  l.wb = at;
  at += conv_to_smem ? 2 * C::WB : 0;
  l.eb = at;
  at += C::EB;
  l.ring = at;
  l.s_w = 1024;  // after e1
  l.s_gy = l.s_w + (load_w ? NU * C::TILE : 0);
  l.s_e2 = l.s_gy + C::GY;
  l.stage = l.s_gy + (walk ? C::GY + C::E2 : 0);
  const int fit = static_cast<int>((cirkit::MAX_SMEM - 1024 - at - 256) / l.stage);
  l.ns = fit < 6 ? fit : 6;
  l.bars = at + l.ns * l.stage;
  l.bytes = 1024 + (size_t)l.bars + 16 * l.ns + 8;
  return l;
}

template <int NU, bool SOFTMAX, typename WT, int MODE, bool CPLX>
cudaError_t launch_products(const WT* w, const float* lse, const float* rsum, float* dx1,
                            float* dx2, WT* dw, const CUtensorMap& wmap, const CUtensorMap& gmap,
                            const CUtensorMap& e1map, const CUtensorMap& e2map, int F, int B,
                            int K1, int K2, int O, int n_ug, int n_jc, int nbt_grid, int nbt_loop,
                            int flags, int Bc, cudaStream_t s) {
  const long long blocks = (long long)F * n_ug * n_jc * nbt_grid;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidConfiguration;
  const bool vec = flags & tbw::VEC, do_dx = flags & tbw::DO_DX;
  const bool raw = sizeof(WT) == 2 && !SOFTMAX && vec && do_dx;
  const Layout lay = tbw_layout<NU, SOFTMAX, WT>(do_dx && !raw, vec && (do_dx || SOFTMAX),
                                                 nbt_loop > 1);
  if (lay.ns < 2) return cudaErrorInvalidConfiguration;
  auto kernel = tucker_bwd_bf16<NU, SOFTMAX, WT, MODE, CPLX>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(lay.bytes));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), tbw::NT, lay.bytes, s>>>(
      w, lse, rsum, dx1, dx2, dw, wmap, gmap, e1map, e2map, lay, F, B, K1, K2, O, n_ug, n_jc,
      nbt_grid, nbt_loop, flags, Bc);
  return cudaGetLastError();
}

// prep, the softmax statistics, the products (one launch where the batch is
// one tile and both gradients are wanted, else a dx and a dW launch), and
// where dx is partial its finish. ``ws`` (ops/lse_einsum.py's
// _tucker_bf16_bwd_scratch floats): e1t (F, K1, Bp) and e2t (F, K2, Bp) in
// f32 and gyr (F, B, Op) in bf16, Bp and Op the batch and the units rounded
// up to 8; for logits lse and r_o, (F, O) each; the dx1 partials (n_ug n_jc
// planes of (F, B, K1)) where there are more than one; the dx2 partials
// (n_ug planes of (F, B, K2)) where n_ug > 1. SIGNED (the signed Tucker
// backward: sga, sgb the inputs' signs, out_sign sign(y)) forms the signed gy
// and e in the prep and the finish, and runs the same products. CPLX (the
// complex Tucker backward against a real weight: x1, x2, out, g, dx1 and dx2
// complex, ops/clse_einsum.py's _ctucker_bf16_scratch floats) runs them on
// the Rs = 2 Bp stacked rows of ctbw_prep (e1t, e2t (F, K, Rs), gyr (F, Rs,
// Op)), with complex dx partials.
template <bool SOFTMAX, typename WT, int MODE, bool SIGNED = false, bool CPLX = false>
int launch_bwd_bf16(const float* x1, const float* x2, const WT* w, const float* out,
                    const float* g, float* dx1, float* dx2, WT* dw, float* sa, float* sb,
                    float* gy, float* ws, int F, int B, int K1, int K2, int O, int device,
                    void* stream, const float* sga = nullptr, const float* sgb = nullptr,
                    const float* out_sign = nullptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int I = K1 * K2, Bp = (B + 7) / 8 * 8, Op = (O + 7) / 8 * 8;
  // the products' rows: the batch, or the stacked planes (Rs of them)
  const int rows = CPLX ? 2 * Bp : B, Rs = CPLX ? 2 * Bp : Bp, cw = CPLX ? 2 : 1;
  float* e1t = ws;
  float* e2t = e1t + (size_t)F * K1 * Rs;
  auto* gyr = reinterpret_cast<__nv_bfloat16*>(e2t + (size_t)F * K2 * Rs);
  float* part = e2t + (size_t)F * K2 * Rs + (size_t)F * rows * Op / 2;
  if constexpr (CPLX)
    ctbw_prep<MODE><<<dim3(F, Bp / tbw::WARPS), 256, 0, s>>>(
        reinterpret_cast<const float2*>(x1), reinterpret_cast<const float2*>(x2),
        reinterpret_cast<const float2*>(out), reinterpret_cast<const float2*>(g), sa, sb, gyr,
        e1t, e2t, B, K1, K2, O, Op, Rs);
  else
    tbw_prep<MODE, SIGNED><<<dim3(F, cdiv(B, tbw::WARPS)), 256, 0, s>>>(
        x1, x2, out, g, sa, sb, gy, gyr, e1t, e2t, B, K1, K2, O, Op, Bp, out_sign, sga, sgb);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  float* lse = nullptr;
  float* rsum = nullptr;
  if (SOFTMAX) {
    lse = part;
    rsum = part + (size_t)F * O;
    part += 2 * (size_t)F * O;
    tbw_softmax_stats<WT><<<dim3(F, cdiv(O, tbw::WARPS)), 256, 0, s>>>(w, g, gy, lse, rsum, B,
                                                                        O, I);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const bool do_dx = dx1 != nullptr || dx2 != nullptr, do_dw = dw != nullptr;
  if (!do_dx && !do_dw) return 0;
  const int n_ug = static_cast<int>(cdiv(O, tbw::UG)), n_jc = static_cast<int>(cdiv(K2, tbw::JC));
  const int nbt = static_cast<int>(cdiv(rows, tbw::BM)), p1 = n_ug * n_jc;
  float* part1 = p1 > 1 ? part : nullptr;
  float* part2 = n_ug > 1 ? part + (p1 > 1 ? (size_t)cw * p1 * F * B * K1 : 0) : nullptr;
  const bool vec = (K2 * sizeof(WT)) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool stg16 = (K2 * sizeof(WT)) % 16 == 0 && reinterpret_cast<uintptr_t>(dw) % 16 == 0;
  CUtensorMap wmap{}, gmap{}, e1map{}, e2map{};
  if (vec && (err = cirkit::weight_map(&wmap, w, F, K1, K2, O)) != cudaSuccess)
    return static_cast<int>(err);
  {
    const cuuint64_t gd[3] = {(cuuint64_t)O, (cuuint64_t)rows, (cuuint64_t)F};
    const cuuint64_t gs[2] = {(cuuint64_t)Op * 2, (cuuint64_t)rows * Op * 2};
    const cuuint32_t gb[3] = {tbw::UT, tbw::BM, 1};
    const cuuint64_t d1[3] = {(cuuint64_t)rows, (cuuint64_t)K1, (cuuint64_t)F};
    const cuuint64_t s1[2] = {(cuuint64_t)Rs * 4, (cuuint64_t)K1 * Rs * 4};
    const cuuint32_t b1[3] = {tbw::BM, 1, 1};
    const cuuint64_t d2[3] = {(cuuint64_t)rows, (cuuint64_t)K2, (cuuint64_t)F};
    const cuuint64_t s2[2] = {(cuuint64_t)Rs * 4, (cuuint64_t)K2 * Rs * 4};
    const cuuint32_t b2[3] = {32, tbw::JC, 1};
    if ((err = cirkit::tiled_map(&gmap, gyr, 3, gd, gs, gb)) != cudaSuccess ||
        (err = cirkit::tiled_map(&e1map, e1t, 3, d1, s1, b1)) != cudaSuccess ||
        (err = cirkit::tiled_map(&e2map, e2t, 3, d2, s2, b2)) != cudaSuccess)
      return static_cast<int>(err);
  }
  const int flags = (vec ? tbw::VEC : 0) | (stg16 ? tbw::STG16 : 0) |
                    (part1 == nullptr ? tbw::DIRECT1 : 0) | (part2 == nullptr ? tbw::DIRECT2 : 0);
  float* k1 = dx1 == nullptr ? nullptr : part1 != nullptr ? part1 : dx1;
  float* k2 = dx2 == nullptr ? nullptr : part2 != nullptr ? part2 : dx2;
  auto products = [&](int what, int nbt_grid, int nbt_loop) {
    return O > tbw::UT
               ? launch_products<2, SOFTMAX, WT, MODE, CPLX>(
                     w, lse, rsum, k1, k2, dw, wmap, gmap, e1map, e2map, F, rows, K1, K2, O, n_ug,
                     n_jc, nbt_grid, nbt_loop, flags | what, B, s)
               : launch_products<1, SOFTMAX, WT, MODE, CPLX>(
                     w, lse, rsum, k1, k2, dw, wmap, gmap, e1map, e2map, F, rows, K1, K2, O, n_ug,
                     n_jc, nbt_grid, nbt_loop, flags | what, B, s);
  };
  if (do_dx && do_dw && nbt == 1) {
    err = products(tbw::DO_DX | tbw::DO_DW, 1, 1);
  } else {
    if (do_dx) err = products(tbw::DO_DX, nbt, 1);
    if (err == cudaSuccess && do_dw) err = products(tbw::DO_DW, 1, nbt);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* f1 = dx1 != nullptr ? part1 : nullptr;
  const float* f2 = dx2 != nullptr ? part2 : nullptr;
  if (f1 != nullptr || f2 != nullptr) {
    if constexpr (CPLX)
      cirkit::cplx_dx_finish<8><<<dim3(F, cdiv(B, tbw::WARPS)), 256, 0, s>>>(
          reinterpret_cast<const float2*>(x1), reinterpret_cast<const float2*>(x2), sa, sb,
          reinterpret_cast<const float2*>(f1), reinterpret_cast<const float2*>(f2),
          reinterpret_cast<float2*>(dx1), reinterpret_cast<float2*>(dx2), F, B, K1, K2, p1,
          n_ug);
    else
      tbw_dx_finish<SIGNED><<<dim3(F, cdiv(B, tbw::WARPS)), 256, 0, s>>>(
          x1, x2, sa, sb, f1, f2, dx1, dx2, F, B, K1, K2, p1, n_ug, sga, sgb);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The fast-mode instances of the Tucker backward (ops/lse_einsum.py's
// INSTANCES), with the arguments of their f32-grade twins but for the
// weight's gradient, which has the weight's type, and the scratch ws
// (ops/lse_einsum.py's _tucker_bf16_bwd_scratch floats). The build compiles
// this source once for each part (-DCIRKIT_BF16_BWD_PART=0..5;
// ops/_build.py), side by side. A build without the macro holds all of them.
#define TUCKER_BF16_BWD_ENTRIES(SUFFIX, WT, MODE)                                               \
  int lse_bwd_tucker##SUFFIX(const float* x1, const float* x2, const WT* w, const float* out,   \
                             const float* g, float* dx1, float* dx2, WT* dw, float* sa,         \
                             float* sb, float* gy, float* ws, int F, int B, int K1, int K2,     \
                             int O, int device, void* stream) {                                 \
    return launch_bwd_bf16<false, WT, MODE>(x1, x2, w, out, g, dx1, dx2, dw, sa, sb, gy, ws, F, \
                                            B, K1, K2, O, device, stream);                      \
  }                                                                                             \
  int lse_bwd_tucker_softmax##SUFFIX(const float* x1, const float* x2, const WT* theta,         \
                                     const float* out, const float* g, float* dx1, float* dx2,  \
                                     WT* dtheta, float* sa, float* sb, float* gy, float* ws,    \
                                     int F, int B, int K1, int K2, int O, int device,           \
                                     void* stream) {                                            \
    return launch_bwd_bf16<true, WT, MODE>(x1, x2, theta, out, g, dx1, dx2, dtheta, sa, sb, gy, \
                                           ws, F, B, K1, K2, O, device, stream);                \
  }

// The signed instances (ops/slse_einsum.py's slse_tucker2[_softmax] in a
// fast mode): the signed entries' arguments, with the lse entries' scratch
// (gy (F, B, O) and ws), the weight's gradient in the weight's type. They
// run the products of their unsigned twins in the same part.
#define SLSE_BF16_BWD_ENTRIES(SUFFIX, WT, MODE)                                                 \
  int slse_bwd_tucker##SUFFIX(const float* a1, const float* s1, const float* a2,                \
                              const float* s2, const WT* w, const float* oa, const float* os,   \
                              const float* g, float* da1, float* da2, WT* dw, float* sa,        \
                              float* sb, float* gy, float* ws, int F, int B, int K1, int K2,    \
                              int O, int device, void* stream) {                                \
    return launch_bwd_bf16<false, WT, MODE, true>(a1, a2, w, oa, g, da1, da2, dw, sa, sb, gy,   \
                                                  ws, F, B, K1, K2, O, device, stream, s1, s2,  \
                                                  os);                                          \
  }                                                                                             \
  int slse_bwd_tucker_softmax##SUFFIX(const float* a1, const float* s1, const float* a2,        \
                                      const float* s2, const WT* theta, const float* oa,        \
                                      const float* os, const float* g, float* da1, float* da2,  \
                                      WT* dtheta, float* sa, float* sb, float* gy, float* ws,   \
                                      int F, int B, int K1, int K2, int O, int device,          \
                                      void* stream) {                                           \
    return launch_bwd_bf16<true, WT, MODE, true>(a1, a2, theta, oa, g, da1, da2, dtheta, sa, sb,\
                                                 gy, ws, F, B, K1, K2, O, device, stream, s1,   \
                                                 s2, os);                                       \
  }

// The complex instances (ops/clse_einsum.py's clse_tucker2 in complex64
// against a real weight, in a fast mode): clse_bwd_tucker_rw's arguments
// (csrc/lse_einsum_bwd.cu), with ws of _ctucker_bf16_scratch floats.
#define CLSE_BF16_BWD_ENTRY(SUFFIX, MODE)                                                       \
  int clse_bwd_tucker_rw##SUFFIX(const void* x1, const void* x2, const float* w,                \
                                 const void* out, const void* g, void* dx1, void* dx2,          \
                                 float* dw, float* sa, float* sb, float* ws, int F, int B,      \
                                 int K1, int K2, int O, int device, void* stream) {             \
    return launch_bwd_bf16<false, float, MODE, false, true>(                                    \
        static_cast<const float*>(x1), static_cast<const float*>(x2), w,                        \
        static_cast<const float*>(out), static_cast<const float*>(g), static_cast<float*>(dx1), \
        static_cast<float*>(dx2), dw, sa, sb, nullptr, ws, F, B, K1, K2, O, device, stream);    \
  }

// Parts 0-3 hold a weight type and mode each (the lse and signed entries),
// parts 4 and 5 the complex entries of the two modes.
#if !defined(CIRKIT_BF16_BWD_PART) || CIRKIT_BF16_BWD_PART == 0
TUCKER_BF16_BWD_ENTRIES(_fast, float, cirkit::BF16)
SLSE_BF16_BWD_ENTRIES(_fast, float, cirkit::BF16)
#endif
#if !defined(CIRKIT_BF16_BWD_PART) || CIRKIT_BF16_BWD_PART == 1
TUCKER_BF16_BWD_ENTRIES(_sr, float, cirkit::SR)
SLSE_BF16_BWD_ENTRIES(_sr, float, cirkit::SR)
#endif
#if !defined(CIRKIT_BF16_BWD_PART) || CIRKIT_BF16_BWD_PART == 2
TUCKER_BF16_BWD_ENTRIES(_w16_fast, __nv_bfloat16, cirkit::BF16)
SLSE_BF16_BWD_ENTRIES(_w16_fast, __nv_bfloat16, cirkit::BF16)
#endif
#if !defined(CIRKIT_BF16_BWD_PART) || CIRKIT_BF16_BWD_PART == 3
TUCKER_BF16_BWD_ENTRIES(_w16_sr, __nv_bfloat16, cirkit::SR)
SLSE_BF16_BWD_ENTRIES(_w16_sr, __nv_bfloat16, cirkit::SR)
#endif
#if !defined(CIRKIT_BF16_BWD_PART) || CIRKIT_BF16_BWD_PART == 4
CLSE_BF16_BWD_ENTRY(_fast, cirkit::BF16)
#endif
#if !defined(CIRKIT_BF16_BWD_PART) || CIRKIT_BF16_BWD_PART == 5
CLSE_BF16_BWD_ENTRY(_sr, cirkit::SR)
#endif
#undef TUCKER_BF16_BWD_ENTRIES
#undef SLSE_BF16_BWD_ENTRIES
#undef CLSE_BF16_BWD_ENTRY

}  // extern "C"
