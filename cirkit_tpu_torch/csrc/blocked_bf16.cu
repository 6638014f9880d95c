// The bf16-weight and fast-mode blocked dense kernels for Hopper (sm_90a) on
// the bf16 tensor cores: the _w16, _fast, _sr, _w16_fast and _w16_sr
// instances of the blocked dense forward (kernel 3, lse_fwd_blocked*) and
// backward (kernel 4, lse_bwd_blocked*), the dense contractions of width I >=
// ops/lse_einsum.py's WIDE_WIDTH (the K=128 circuits' mixing sums with
// optimize=False). Their float32 and float64 instances are csrc/lse_wide.cu's.
//
// Replaces the bf16-weight and CIRKIT_TPU_FAST configurations of the Pallas
// TPU kernels `_blocked_fwd_kernel` (cirkit_tpu/ops/lse_einsum.py:548) and
// `_blocked_bwd_kernel` (:572), through `_blocked_fwd_call` (:593),
// `_blocked_bwd_call` (:616), `_blocked_p_bwd` (:659) and `_dispatch_blocked`
// (:663-689). Per fold f, with m the clamped row max of x:
//
//   forward:  out[b,o] = log sum_i e[b,i] w[o,i] + m[b], e = exp(x - m),
//             m written out too (kernel 4 reads it), equal to the clamped
//             max of x to the bit in every mode;
//   backward: gy = g exp(m - out) (0 where not finite),
//             dx = e * (gy w),  dw = gy^T e summed over the whole batch,
//             dw written once, in the weight's type.
//
// The rounding points are the plain versions' (ops/lse_einsum.py's
// lse_matmul_blocked_ref, _blocked_fast_e, lse_matmul_bwd_ref): the fast
// forward rounds e to bf16 (ROLE_E) over the row's running max of the chunks
// of KC columns so far, and a float32 weight (ROLE_W); the fast backward
// rounds gy (ROLE_GY), a float32 weight (ROLE_WB) and e for dw (ROLE_EB), and
// multiplies dx by e unrounded; to the nearest (BF16) or by sr_bits of the
// element's flat index in its operand (SR), so a call repeats to the bit. The
// f32-grade instance on a bf16 weight (_w16, MODE F32) takes the JAX
// package's bf16 split (`_dot3`, cirkit_tpu/ops/lse_einsum.py:207), exact
// for the bf16 weight: the forward e_hi w + e_lo w, dx gy_hi w + gy_lo w, dw
// gy_hi e_hi + gy_hi e_lo + gy_lo e_hi, each value's pair hi + lo within
// 2^-17 of it, the missing gy_lo e_lo below 2^-16 of each product. A product
// of two bf16 values is exact in f32, so the tensor cores change only the
// order of the f32 sums.
//
// What bounds them on the H100: at the K=128 dense entry (F=784, B=128, I =
// 16384, O=128) each product is 2.1e11 multiply-adds, 0.43 ms a pass on the
// bf16 tensor cores (989 TFLOP/s), five passes 2.1 ms; the forward moves x
// (6.58 GB) and w (3.29 GB bf16, 6.58 f32): 2.96 or 3.94 ms at 3.35 TB/s,
// the backward x and w in, dx and dw out: 5.92 or 7.88 ms. Every instance is
// bound by its bytes, so the design keeps each operand's bytes crossing
// device memory once and enough copies in flight, and the arithmetic
// (exponentials, rounding, folds) off the copies' path. The earlier
// instances in csrc/lse_wide.cu ran warp-level mma.sync in TF32 (about half
// of wgmma's rate on this card, scripts/mma_peak.py), staged their operands twice through shared
// memory, met at a block barrier every 32 columns, took a separate gy pass
// and wrote dw in f32 for a cast pass.
//
// The forward: a block owns (fold, 128 batch rows, 128 units) and walks I in
// chunks of KC = 64 columns (one 128-byte bf16 row). Its 288 threads are a
// producer warp and two consumer warpgroups of 64 batch rows each. One
// producer thread copies each chunk's x (two 32-column boxes, f32) and w
// (one box as stored: bf16, or two for a float32 weight) by TMA into a ring
// of stages, each completing on its mbarrier; each consumer warp releases a
// stage through another mbarrier, so no barrier of the block runs in the
// loop. A consumer thread reads x at its own rows and columns of wgmma's A
// fragment (rows g, g + 8 of its warp, columns 2t, 2t + 1, 2t + 8, 2t + 9
// of each k16 step), takes the chunk's row max (two shuffles of its quad),
// raises the row's running clamped max, forms and rounds e and hands it to
// wgmma (m64n128k16) as its A operand from registers, so e never returns to
// shared memory; B is the weight tile as TMA copied it (a bf16 weight) or,
// for a float32 one, its bf16 rounding, which the two warpgroups form half
// each into a double-buffered tile and meet at a named barrier. Each chunk's
// products run into registers from zero and are folded into f32 running
// accumulators, acc = acc exp(old max - new max) + chunk, in FMAs: the
// tensor core's own accumulation over all 16384 columns drifted 2.7e-4 in
// log space in the TF32 blocked forward, over 64 columns it does not. Rows
// past B and columns past I, which TMA fills with 0 (and exp(0 - m) is not
// 0), are masked to -inf before the max; a row that is all -inf keeps the
// lowest finite max, stages exp(-inf) = 0 and gives -inf, never NaN.
//
// The backward: a prep pass (bb_prep) writes gy rounded to bf16 (one plane;
// the _w16 instance its split hi, lo: two), rows padded to a multiple of 8
// units so TMA copies them. The products' blocks are persistent, one an SM,
// each walking strips of SN = 128 columns of a fold (blockIdx.x, + grid,
// ...), so a strip's x, w, dx and dw cross device memory once. For each
// strip the producer copies the strip's weights (up to 128 units) into a
// double-buffered slot (a float32 weight: one slot, converted to bf16 by the
// consumers at the strip's start), then each batch tile of BT = 64 rows: x
// (four 32-column boxes) and gy (two 64-unit boxes a plane) into a ring of
// stages. Warpgroup w takes the strip's columns 64 w .. 64 w + 63 for both
// products, so the two warpgroups never wait for each other: s = gy w
// (m64n64k16: gy K-major, w MN-major as stored), dx = e s written from the
// registers (e = exp(x - m) from the staged x, at the thread's s positions);
// e rounded (or split) into the warpgroup's own bf16 tile, then dw += gy^T
// r(e) over the batch tile (m64n64k16 for each unit tile: gy MN-major, so
// the one gy tile serves both products, r(e) MN-major), in registers across
// the batch. At the strip's end dw leaves in the weight's type: bf16 (the
// nearest to the f32 sum) through the warpgroup's e tile as whole 16-byte
// chunks, f32 straight from the registers. More than 128 units take one
// launch per group of 128, the later ones adding their dx to the earlier
// ones' (in launch order: no atomics, so a call repeats to the bit).
//
// What the knock-out builds showed (F=784 B=128 I=16384 O=128, H100 80GB
// HBM3 at 700 W): the forward takes 97% of the time of its copies alone, so
// it is as fast as its TMA stream; the backward's copies alone take 3.3 ms
// (bf16 weight) and its stores' 9.87 GB about 2.7 ms more: reads and writes
// take their turns on the bus rather than overlapping to its peak. The dw
// stores cost their bytes, not their latency: asynchronous TMA stores of dw
// and dx from shared memory (tried) moved no instance by more than the
// noise, so dx and dw leave from the registers and the e tile.
//
// Operands that TMA cannot describe (x with I % 4 != 0, a bf16 weight with
// I % 8 != 0, a base that is not 16-byte aligned) are copied element by
// element by the producer warp's 32 threads into the same layouts (flag VEC
// off); the consumers do not change. Ragged B, I and O are masked. Each
// extern "C" entry selects the given device, launches on the given stream
// and returns the first error of its launches (0 on success).

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
using cirkit::wgmma_64x128_ra;
using cirkit::wgmma_64x64_tb;
using cirkit::wgmma_64x64_tt;
using cirkit::wgmma_commit;
using cirkit::wgmma_fence;
using cirkit::wgmma_wait;

namespace bb {
constexpr int CONS = 256;         // consumer threads: two warpgroups
constexpr int NT = CONS + 32;     // and the producer warp
constexpr int ROW = 128;          // bytes of a tile row (a box's, in the 128-byte swizzle)
constexpr int BM = 128;           // forward: batch rows a block, 64 a warpgroup
constexpr int BN = 128;           // forward: units a block
constexpr int KC = 64;            // forward: columns a chunk (ops/lse_einsum.py's _BLOCKED_KC)
constexpr int BT = 64;            // backward: batch rows a stage
constexpr int SN = 128;           // backward: columns a strip, 64 a warpgroup
constexpr int UG = 128;           // backward: units a launch, two unit tiles of 64
constexpr int TILE = 64 * ROW;    // a box of 64 rows
// the backward's flags
constexpr int DO_DX = 1, DO_DW = 2, VEC = 4, DX_PAIR = 8, DW_VEC = 16, DX_ACC = 32;
}  // namespace bb

inline unsigned cdiv(long long a, long long b) { return static_cast<unsigned>((a + b - 1) / b); }

inline bool aligned(const void* p, uintptr_t n) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % n == 0;
}

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The byte offset of f32 element (r, c) of a tile of ``rows`` rows made of
// boxes of 32 columns (128-byte rows in the 128-byte swizzle: the 16-byte
// chunk k of row r at chunk k ^ (r % 8)), as TMA writes it.
__device__ __forceinline__ uint32_t f32_at(int r, int c, int rows) {
  return (c >> 5) * rows * bb::ROW + r * bb::ROW + ((((c >> 2) ^ r) & 7) << 4) + ((c & 3) << 2);
}

// The same for a bf16 tile of boxes of 64 columns.
__device__ __forceinline__ uint32_t b16_at(int r, int c, int rows) {
  return (c >> 6) * rows * bb::ROW + sw128(r, c & 63);
}

// Two f32 values (flat indices idx, idx + 1 of an operand of ``role``) as
// MODE rounds an operand, packed as a bf16 pair (the first in the low half);
// for the f32-grade split the high parts, with their rounded remainders in
// ``lo``.
template <int MODE>
__device__ __forceinline__ uint32_t round2(float a, float b, unsigned long long idx,
                                           uint32_t role, uint32_t& lo) {
  if constexpr (MODE == cirkit::F32) {
    const uint32_t hi = bf16x2(a, b);
    lo = bf16x2(a - __uint_as_float(hi << 16), b - __uint_as_float(hi & 0xFFFF0000u));
    return hi;
  } else if constexpr (MODE == cirkit::BF16) {
    return bf16x2(a, b);
  } else {
    return (__float_as_uint(round_op<MODE>(a, idx, role)) >> 16) |
           (__float_as_uint(round_op<MODE>(b, idx + 1, role)) & 0xFFFF0000u);
  }
}

// The raw bits of a weight element: a bf16 weight is copied as it is.
template <typename WT>
using Bits = std::conditional_t<sizeof(WT) == 2, unsigned short, uint32_t>;

// The shared-memory base of a kernel, aligned to 1024 bytes (the swizzle's
// period), and its shared address.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (static_cast<uint32_t>(__cvta_generic_to_shared(raw)) & 1023)) & 1023);
}
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --------------------------------------------------------------------------
// The forward
// --------------------------------------------------------------------------

// A forward block on weights of type WT: x's two boxes and the weight's (one
// bf16 box of 64 columns, or two f32 boxes of 32) a stage; the ring's stages;
// for a float32 weight two bf16 tiles of its rounding; the mbarriers.
template <typename WT>
struct FwdCfg {
  static constexpr int XB = bb::BM * bb::KC * 4;
  static constexpr int WB = bb::BN * bb::KC * static_cast<int>(sizeof(WT));
  static constexpr int STAGE = XB + WB;
  static constexpr int NS = sizeof(WT) == 2 ? 4 : 3;
  static constexpr int CONV = sizeof(WT) == 2 ? 0 : 2 * bb::BN * bb::ROW;
  static constexpr size_t SMEM = 1024 + (size_t)NS * STAGE + CONV + 16 * NS;
};

template <typename WT, int MODE>
__global__ void __launch_bounds__(bb::NT, 1)
bb_fwd(const float* __restrict__ x,  // (F, B, I)
       const WT* __restrict__ w,     // (F, O, I)
       float* __restrict__ out,      // (F, B, O)
       float* __restrict__ m_out,    // (F, B): the clamped row max of x
       // x as (F, B, I) in boxes of 32 columns x 128 rows, w as (F, O, I) in
       // boxes of 64 (bf16) or 32 (f32) columns x 128 units; unset without vec
       const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
       int B, int I, int O, int n_bt, int n_ot, bool vec) {
  using C = FwdCfg<WT>;
  constexpr int BM = bb::BM, BN = bb::BN, KC = bb::KC, ROW = bb::ROW;
  constexpr int NS = C::NS, STAGE = C::STAGE, XB = C::XB;
  constexpr bool W16 = sizeof(WT) == 2;
  constexpr bool SPLIT = MODE == cirkit::F32;  // e as a bf16 pair hi + lo
  static_assert(W16 || !SPLIT, "the f32-grade float32-weight instance is blocked_fwd_tc");

  extern __shared__ __align__(16) unsigned char bb_fwd_raw[];
  unsigned char* smem = aligned_smem(bb_fwd_raw);
  unsigned char* conv = smem + NS * STAGE;  // a float32 weight's bf16 tiles [2][BN rows]
  const uint32_t ring_s = saddr(smem), conv_s = ring_s + NS * STAGE;
  // [NS] full mbarriers (the stage's copies), [NS] empty ones (a consumer
  // warp's arrival each)
  const uint32_t full0 = conv_s + C::CONV, empty0 = full0 + 8 * NS;

  // batch tile fastest: the tiles of one fold share its weight through L2
  const int bt = blockIdx.x % n_bt, rest = blockIdx.x / n_bt;
  const int ot = rest % n_ot, f = rest / n_ot;
  const int b0 = bt * BM, o0 = ot * BN;
  const int n_ch = (I + KC - 1) / KC;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int k = 0; k < NS; ++k) {
      mbar_init(full0 + 8 * k, vec ? 1 : 32);
      mbar_init(empty0 + 8 * k, bb::CONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= bb::CONS) {
    // The producer: one thread issues each stage's copies by TMA, or (vec
    // off) the warp's 32 threads copy its elements, zero past the edges.
    const int lane = tid - bb::CONS;
    if (vec && lane != 0) return;
    const float* xf = x + (size_t)f * B * I;
    const Bits<WT>* wf = reinterpret_cast<const Bits<WT>*>(w) + (size_t)f * O * I;
    for (int c = 0; c < n_ch; ++c) {
      const int slot = c % NS;
      const uint32_t bar = full0 + 8 * slot;
      mbar_wait(empty0 + 8 * slot, ((c / NS) & 1) ^ 1);
      if (vec) {
        const uint32_t st = ring_s + slot * STAGE;
        mbar_expect(bar, STAGE);
        tma_load_3d(st, &xmap, c * KC, b0, f, bar);
        tma_load_3d(st + XB / 2, &xmap, c * KC + 32, b0, f, bar);
        tma_load_3d(st + XB, &wmap, c * KC, o0, f, bar);
        if (!W16) tma_load_3d(st + XB + C::WB / 2, &wmap, c * KC + 32, o0, f, bar);
        continue;
      }
      unsigned char* st = smem + slot * STAGE;
      for (int e0 = 0; e0 < BM * KC; e0 += 32 * 8) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = e0 + 32 * u + lane, r = e / KC, col = c * KC + e % KC;
          v[u] = b0 + r < B && col < I ? xf[(size_t)(b0 + r) * I + col] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = e0 + 32 * u + lane;
          *reinterpret_cast<float*>(st + f32_at(e / KC, e % KC, BM)) = v[u];
        }
      }
      for (int e0 = 0; e0 < BN * KC; e0 += 32 * 8) {
        Bits<WT> v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = e0 + 32 * u + lane, r = e / KC, col = c * KC + e % KC;
          v[u] = o0 + r < O && col < I ? wf[(size_t)(o0 + r) * I + col] : Bits<WT>(0);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = e0 + 32 * u + lane;
          const uint32_t at = W16 ? b16_at(e / KC, e % KC, BN) : f32_at(e / KC, e % KC, BN);
          *reinterpret_cast<Bits<WT>*>(st + XB + at) = v[u];
        }
      }
      fence_proxy_async();
      mbar_arrive(bar);
    }
    return;
  }

  // The consumers: warpgroup wg, warp wq in it; rows ra and ra + 8 (h = 0,
  // 1) of the block's batch tile, of A's fragment and of the accumulators.
  const int wg = tid >> 7, tw = tid & 127, wq = tw >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ra = 64 * wg + 16 * wq + g;
  const bool row_in[2] = {b0 + ra < B, b0 + ra + 8 < B};
  const bool rows_edge = b0 + BM > B;

  float acc[64], part[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  // the rows' running clamped maxes: the lowest finite value for an empty prefix
  float rm[2] = {-FLT_MAX, -FLT_MAX};

  for (int c = 0; c < n_ch; ++c) {
    const int slot = c % NS;
    const unsigned char* st = smem + slot * STAGE;
    mbar_wait(full0 + 8 * slot, (c / NS) & 1);
    if constexpr (!W16) {
      // this warpgroup's 64 unit rows of the chunk's float32 weights, rounded
      // (ROLE_W), into converted tile c % 2: rows 64 wg + 16 q + tw / 8,
      // columns 8 (tw % 8) .. + 7
      unsigned char* dst = conv + (c & 1) * BN * ROW;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 64 * wg + 16 * q + (tw >> 3), col = 8 * (tw & 7);
        const float4 u0 = *reinterpret_cast<const float4*>(st + XB + f32_at(r, col, BN));
        const float4 u1 = *reinterpret_cast<const float4*>(st + XB + f32_at(r, col + 4, BN));
        const float v[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
        const unsigned long long idx =
            ((unsigned long long)f * O + o0 + r) * I + (unsigned long long)c * KC + col;
        *reinterpret_cast<uint4*>(dst + sw128(r, col)) =
            pack_bf16x8<MODE>(v, idx, cirkit::ROLE_W);
      }
    }
    // x at this thread's A positions: [h][k16 step][j: + 0 or + 8][pair]
    float xv[2][4][2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 p = *reinterpret_cast<const float2*>(
              st + f32_at(ra + 8 * h, 16 * ks + 8 * j + 2 * t4, BM));
          xv[h][ks][j][0] = p.x;
          xv[h][ks][j][1] = p.y;
        }
    if constexpr (!W16) {  // the stage is read: free it, and meet over the converted tile
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * slot);
      fence_proxy_async();
      named_bar(1, bb::CONS);
    }
    // the chunk's row maxes, masked past B and I; the running maxes raised
    const bool edge = rows_edge || (c + 1) * KC > I;
    float scl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float cm = -INFINITY;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = xv[h][ks][j][e];
            if (edge && (!row_in[h] || c * KC + 16 * ks + 8 * j + 2 * t4 + e >= I)) v = -INFINITY;
            cm = fmaxf(cm, v);
          }
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
      const float mn = fmaxf(rm[h], clamp_max(cm));
      scl[h] = expf(rm[h] - mn);
      rm[h] = mn;
    }
    // e = exp(x - max) as A fragments: register q of step ks holds row h = q
    // % 2, columns 16 ks + 8 (q / 2) + 2 t4, + 1
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = q & 1, j = q >> 1;
        const float e0 = expf(xv[h][ks][j][0] - rm[h]), e1 = expf(xv[h][ks][j][1] - rm[h]);
        const unsigned long long idx = ((unsigned long long)f * B + b0 + ra + 8 * h) * I +
                                       (unsigned long long)c * KC + 16 * ks + 8 * j + 2 * t4;
        ah[ks][q] = round2<MODE>(e0, e1, idx, cirkit::ROLE_E, al[ks][q]);
      }
    const uint64_t db =
        sw128_desc(W16 ? ring_s + slot * STAGE + XB : conv_s + (c & 1) * BN * ROW);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_64x128_ra(part, ah[ks], db + 2 * ks, ks);
    if constexpr (SPLIT)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wgmma_64x128_ra(part, al[ks], db + 2 * ks, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      fence_regs(ah[ks]);
      if (SPLIT) fence_regs(al[ks]);
    }
    if constexpr (W16) {  // the weight tile is read too: free the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * slot);
    }
    // acc = acc exp(old max - new max) + the chunk's sums, in f32 FMAs
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      acc[4 * n] = fmaf(acc[4 * n], scl[0], part[4 * n]);
      acc[4 * n + 1] = fmaf(acc[4 * n + 1], scl[0], part[4 * n + 1]);
      acc[4 * n + 2] = fmaf(acc[4 * n + 2], scl[1], part[4 * n + 2]);
      acc[4 * n + 3] = fmaf(acc[4 * n + 3], scl[1], part[4 * n + 3]);
    }
  }

  // Epilogue: back to log space, masking the ragged batch and unit edges;
  // the row max from the unit tile 0's blocks.
  float* outf = out + (size_t)f * B * O;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_in[h]) continue;
    const int b = b0 + ra + 8 * h;
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = o0 + 8 * n + 2 * t4 + e;
        if (o < O) outf[(size_t)b * O + o] = logf(acc[4 * n + 2 * h + e]) + rm[h];
      }
    if (ot == 0 && t4 == 0) m_out[(size_t)f * B + b] = rm[h];
  }
}

// --------------------------------------------------------------------------
// The backward
// --------------------------------------------------------------------------

// gy = g exp(m - out), zero where not finite, per batch row (a warp each,
// eight rows a block), rounded to bf16 (ROLE_GY at its flat index in (F, B,
// O)) into gyr (F, B, Op); the f32-grade split writes its high part there
// and its rounded remainder into a second plane at gyr + F B Op. Units O ..
// Op - 1 are zero, so every row starts 16-byte aligned, as TMA reads it.
template <int MODE>
__global__ void __launch_bounds__(256)
bb_prep(const float* __restrict__ out, const float* __restrict__ m, const float* __restrict__ g,
        __nv_bfloat16* __restrict__ gyr, int F, int B, int O, int Op) {
  const int lane = threadIdx.x & 31, b = blockIdx.y * 8 + (threadIdx.x >> 5);
  if (b >= B) return;  // warp-uniform
  const size_t row = (size_t)blockIdx.x * B + b, plane = (size_t)F * B * Op;
  const float mb = m[row];
  for (int o = lane; o < Op; o += 32) {
    float v = 0.f;
    if (o < O) {
      const size_t idx = row * O + o;
      v = g[idx] * expf(mb - out[idx]);
      v = isfinite(v) ? v : 0.f;
    }
    if constexpr (MODE == cirkit::F32) {
      const __nv_bfloat16 hi = __float2bfloat16_rn(v);
      gyr[row * Op + o] = hi;
      gyr[plane + row * Op + o] = __float2bfloat16_rn(v - __bfloat162float(hi));
    } else {
      gyr[row * Op + o] = __float2bfloat16_rn(round_op<MODE>(v, row * O + o, cirkit::ROLE_GY));
    }
  }
}

// A backward block on weights of type WT in MODE: P bf16 planes of gy and
// of r(e); a stage holds a batch tile's x (four boxes of 32 columns x 64
// rows) and gy (plane p, unit tile u: box 2 p + u); a weight slot holds a
// strip's weights as stored (bf16: two boxes of 64 columns x 128 units, one
// a warpgroup; f32: four boxes of 32), two slots for bf16, one for f32,
// whose rounding goes to a bf16 tile of each warpgroup's columns; each
// warpgroup's r(e) tile (64 rows x 64 columns, P planes); the ring takes
// what is left, at most three stages.
template <typename WT, int MODE>
struct BwdCfg {
  static constexpr int P = MODE == cirkit::F32 ? 2 : 1;
  static constexpr int XB = bb::BT * bb::SN * 4;
  static constexpr int STAGE = XB + 2 * P * bb::TILE;
  static constexpr bool RAW = sizeof(WT) == 4;
  static constexpr int WSLOT = bb::UG * bb::SN * static_cast<int>(sizeof(WT));
  static constexpr int WS = RAW ? 1 : 2;
  static constexpr int CONV = RAW ? 2 * bb::UG * bb::ROW : 0;
  static constexpr int EB = 2 * P * bb::TILE;
  static constexpr int FIXED = WS * WSLOT + CONV + EB;
  static constexpr int FIT = static_cast<int>((cirkit::MAX_SMEM - 1024 - 256 - FIXED) / STAGE);
  static constexpr int NS = FIT < 3 ? FIT : 3;
  static constexpr size_t SMEM = 1024 + (size_t)NS * STAGE + FIXED + 16 * (NS + WS);
  static_assert(NS >= 2, "the ring needs two stages");
};

template <typename WT, int MODE>
__global__ void __launch_bounds__(bb::NT, 1)
bb_bwd(const float* __restrict__ x,             // (F, B, I)
       const WT* __restrict__ w,                // (F, O, I)
       const float* __restrict__ m,             // (F, B) from the forward
       const __nv_bfloat16* __restrict__ gyr,   // P planes of (F, B, Op) from bb_prep
       float* __restrict__ dx,                  // (F, B, I), or null
       WT* __restrict__ dw,                     // (F, O, I), or null
       // x as (F, B, I) in boxes of 32 columns x 64 rows; w's units u0 ..
       // u0 + Og - 1 as (F, Og, I) in boxes of 64 (bf16) or 32 (f32) columns
       // x 128 units; gyr's as (P, F, B, Og) in boxes of 64 units x 64 rows;
       // unset without VEC
       const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
       const __grid_constant__ CUtensorMap gmap, int F, int B, int I, int O, int Op, int u0,
       int Og, int flags) {
  using C = BwdCfg<WT, MODE>;
  constexpr int BT = bb::BT, SN = bb::SN, UG = bb::UG, ROW = bb::ROW, TILE = bb::TILE;
  constexpr int NS = C::NS, WS = C::WS, STAGE = C::STAGE, XB = C::XB, P = C::P;
  constexpr bool W16 = sizeof(WT) == 2, RAW = C::RAW, SPLIT = MODE == cirkit::F32;
  static_assert(W16 || !SPLIT, "the f32-grade float32-weight instance is blocked_bwd_tc");

  extern __shared__ __align__(16) unsigned char bb_bwd_raw[];
  unsigned char* smem = aligned_smem(bb_bwd_raw);
  const uint32_t sbase = saddr(smem);
  constexpr int WRING = NS * STAGE, CONV = WRING + WS * C::WSLOT, EBUF = CONV + C::CONV;
  constexpr int BARS = EBUF + C::EB;
  // [NS] full and [NS] empty mbarriers of the ring, [WS] of the weight slots
  const uint32_t full0 = sbase + BARS, empty0 = full0 + 8 * NS;
  const uint32_t wfull0 = empty0 + 8 * NS, wempty0 = wfull0 + 8 * WS;

  const bool do_dx = flags & bb::DO_DX, do_dw = flags & bb::DO_DW, vec = flags & bb::VEC;
  const int n_strips = (I + SN - 1) / SN, nbt = (B + BT - 1) / BT;
  const int total = F * n_strips;
  const int nu = Og > 64 ? 2 : 1;  // the launch's unit tiles
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int k = 0; k < NS; ++k) {
      mbar_init(full0 + 8 * k, vec ? 1 : 32);
      mbar_init(empty0 + 8 * k, bb::CONS / 32);
    }
    for (int k = 0; k < WS; ++k) {
      mbar_init(wfull0 + 8 * k, vec ? 1 : 32);
      mbar_init(wempty0 + 8 * k, bb::CONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= bb::CONS) {
    // The producer: for each strip its weights (where dx is wanted), then
    // each batch tile's x and gy, by TMA from one thread, or (VEC off)
    // element by element by the warp's 32 threads, zero past the edges.
    const int lane = tid - bb::CONS;
    if (vec && lane != 0) return;
    int t = 0, k = 0;
    for (int item = blockIdx.x; item < total; item += gridDim.x, ++k) {
      const int f = item / n_strips, c0 = (item - f * n_strips) * SN;
      if (do_dx) {
        const int ws = k % WS;
        const uint32_t bar = wfull0 + 8 * ws;
        mbar_wait(wempty0 + 8 * ws, ((k / WS) & 1) ^ 1);
        if (vec) {
          const uint32_t dst = sbase + WRING + ws * C::WSLOT;
          mbar_expect(bar, C::WSLOT);
#pragma unroll
          for (int q = 0; q < (W16 ? 2 : 4); ++q)
            tma_load_3d(dst + q * UG * ROW, &wmap, c0 + q * (W16 ? 64 : 32), 0, f, bar);
        } else {
          unsigned char* dst = smem + WRING + ws * C::WSLOT;
          const Bits<WT>* wf =
              reinterpret_cast<const Bits<WT>*>(w) + ((size_t)f * O + u0) * I;
          for (int e0 = 0; e0 < UG * SN; e0 += 32 * 8) {
            Bits<WT> v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int e = e0 + 32 * u + lane, r = e / SN, col = c0 + e % SN;
              v[u] = r < Og && col < I ? wf[(size_t)r * I + col] : Bits<WT>(0);
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int e = e0 + 32 * u + lane;
              const uint32_t at = W16 ? b16_at(e / SN, e % SN, UG) : f32_at(e / SN, e % SN, UG);
              *reinterpret_cast<Bits<WT>*>(dst + at) = v[u];
            }
          }
          fence_proxy_async();
          mbar_arrive(bar);
        }
      }
      for (int bt = 0; bt < nbt; ++bt, ++t) {
        const int slot = t % NS, b0 = bt * BT;
        const uint32_t bar = full0 + 8 * slot;
        mbar_wait(empty0 + 8 * slot, ((t / NS) & 1) ^ 1);
        if (vec) {
          const uint32_t st = sbase + slot * STAGE;
          mbar_expect(bar, STAGE);
#pragma unroll
          for (int q = 0; q < 4; ++q) tma_load_3d(st + q * TILE, &xmap, c0 + 32 * q, b0, f, bar);
#pragma unroll
          for (int p = 0; p < P; ++p)
#pragma unroll
            for (int u = 0; u < 2; ++u)
              tma_load_4d(st + XB + (2 * p + u) * TILE, &gmap, 64 * u, b0, f, p, bar);
          continue;
        }
        unsigned char* st = smem + slot * STAGE;
        const float* xf = x + (size_t)f * B * I;
        for (int e0 = 0; e0 < BT * SN; e0 += 32 * 8) {
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int e = e0 + 32 * u + lane, r = e / SN, col = c0 + e % SN;
            v[u] = b0 + r < B && col < I ? xf[(size_t)(b0 + r) * I + col] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int e = e0 + 32 * u + lane;
            *reinterpret_cast<float*>(st + f32_at(e / SN, e % SN, BT)) = v[u];
          }
        }
        for (int e = lane; e < P * BT * UG; e += 32) {
          const int p = e / (BT * UG), r = (e / UG) % BT, o = e % UG;
          const unsigned short v =
              b0 + r < B && o < Og
                  ? reinterpret_cast<const unsigned short*>(
                        gyr)[(size_t)p * F * B * Op + ((size_t)f * B + b0 + r) * Op + u0 + o]
                  : 0;
          *reinterpret_cast<unsigned short*>(st + XB + (2 * p + (o >> 6)) * TILE +
                                             sw128(r, o & 63)) = v;
        }
        fence_proxy_async();
        mbar_arrive(bar);
      }
    }
    return;
  }

  // The consumers: warpgroup wg takes the strip's columns cw .. cw + 63; a
  // thread holds rows ra, ra + 8 (h = 0, 1) of the stage's batch tile in s
  // and dx, units 16 wq + g + 8 h of each unit tile in dw, and columns 8 n
  // + 2 t4, + 1 (n = 0..7) of the warpgroup's.
  const int wg = tid >> 7, tw = tid & 127, wq = tw >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ra = 16 * wq + g, cw = 64 * wg;
  unsigned char* eb = smem + EBUF + wg * P * TILE;  // r(e) [P][64 rows][64 columns]
  const uint32_t eb_s = sbase + EBUF + wg * P * TILE;
  const int bar_wg = 2 + wg;

  float sacc[32], dwacc[2][32];

  // dw of the strip in the weight's type, each unit tile in turn: bf16
  // through the warpgroup's r(e) tile as whole 16-byte chunks of its rows
  // (DW_VEC: every dw row 16-byte aligned) or element by element; f32 from
  // the registers as pairs (DW_VEC) or elements.
  auto epilogue = [&](int f, int c0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u >= nu) break;
      if constexpr (W16) {
        named_bar(bar_wg, 128);  // every warp is done with the r(e) tile
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int n = 0; n < 8; ++n)
            *reinterpret_cast<uint32_t*>(eb + sw128(ra + 8 * h, 8 * n + 2 * t4)) =
                bf16x2(dwacc[u][4 * n + 2 * h], dwacc[u][4 * n + 2 * h + 1]);
        named_bar(bar_wg, 128);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ch = tw + 128 * q, r = ch >> 3, k8 = ch & 7;
          const int o = 64 * u + r, col = c0 + cw + 8 * k8;
          if (o >= Og || col >= I) continue;
          WT* dst = dw + ((size_t)f * O + u0 + o) * I + col;
          const unsigned char* src = eb + sw128(r, 8 * k8);
          if (flags & bb::DW_VEC) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (col + e < I) dst[e] = reinterpret_cast<const WT*>(src)[e];
          }
        }
        named_bar(bar_wg, 128);  // the tile is free for the next unit tile or stage
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = 64 * u + ra + 8 * h;
          if (o >= Og) continue;
          float* drow = reinterpret_cast<float*>(dw) + ((size_t)f * O + u0 + o) * I;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int col = c0 + cw + 8 * n + 2 * t4;
            const float v0 = dwacc[u][4 * n + 2 * h], v1 = dwacc[u][4 * n + 2 * h + 1];
            if ((flags & bb::DW_VEC) && col < I) {  // I even: col + 1 < I too
              *reinterpret_cast<float2*>(drow + col) = make_float2(v0, v1);
            } else {
              if (col < I) drow[col] = v0;
              if (col + 1 < I) drow[col + 1] = v1;
            }
          }
        }
      }
    }
  };

  int t = 0, k = 0;
  for (int item = blockIdx.x; item < total; item += gridDim.x, ++k) {
    const int f = item / n_strips, c0 = (item - f * n_strips) * SN;
    const int ws = k % WS;
    uint32_t w_s = 0;  // the warpgroup's columns of the strip's bf16 weights, rows o
    if (do_dx) {
      mbar_wait(wfull0 + 8 * ws, (k / WS) & 1);
      if constexpr (RAW) {
        // the float32 weights of this warpgroup's columns, rounded (ROLE_WB),
        // into its bf16 tile: rows 16 q + tw / 8, columns 8 (tw % 8) .. + 7
        const unsigned char* src = smem + WRING + ws * C::WSLOT;
        unsigned char* dst = smem + CONV + wg * UG * ROW;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int r = 16 * q + (tw >> 3), col = 8 * (tw & 7);
          const float4 a0 = *reinterpret_cast<const float4*>(src + f32_at(r, cw + col, UG));
          const float4 a1 = *reinterpret_cast<const float4*>(src + f32_at(r, cw + col + 4, UG));
          const float v[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const unsigned long long idx =
              ((unsigned long long)f * O + u0 + r) * I + (unsigned long long)c0 + cw + col;
          *reinterpret_cast<uint4*>(dst + sw128(r, col)) =
              pack_bf16x8<MODE>(v, idx, cirkit::ROLE_WB);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(wempty0 + 8 * ws);
        fence_proxy_async();
        named_bar(bar_wg, 128);
        w_s = sbase + CONV + wg * UG * ROW;
      } else {
        w_s = sbase + WRING + ws * C::WSLOT + wg * UG * ROW;
      }
    }

    for (int bt = 0; bt < nbt; ++bt, ++t) {
      const int slot = t % NS, b0 = bt * BT;
      float mr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = b0 + ra + 8 * h;
        mr[h] = b < B ? m[(size_t)f * B + b] : 0.f;
      }
      mbar_wait(full0 + 8 * slot, (t / NS) & 1);
      const unsigned char* st = smem + slot * STAGE;
      const uint32_t gy_s = sbase + slot * STAGE + XB;

      // s = gy w over the units: gy K-major (the tile's 64 rows), the
      // weights MN-major (rows o, the warpgroup's 64 columns); the split's
      // gy_lo second
      fence_regs(sacc);
      wgmma_fence();
      if (do_dx) {
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              if (u < nu)
                wgmma_64x64_tb(sacc, sw128_desc(gy_s + (2 * p + u) * TILE) + 2 * ks,
                               sw128_desc_mn(w_s + (4 * u + ks) * 2048), (p | u | ks) != 0);
      }
      wgmma_commit();

      // e = exp(x - m) at this thread's s positions, zero past B and I
      const bool edge = b0 + BT > B || c0 + SN > I;
      float ev[2][8][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 p = *reinterpret_cast<const float2*>(
              st + f32_at(ra + 8 * h, cw + 8 * n + 2 * t4, BT));
          const float pv[2] = {p.x, p.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool in = !edge || (b0 + ra + 8 * h < B && c0 + cw + 8 * n + 2 * t4 + e < I);
            ev[h][n][e] = in ? expf(pv[e] - mr[h]) : 0.f;
          }
        }
      if (do_dw) {
        // r(e) (ROLE_EB at its flat index in (F, B, I); the split's hi and lo)
        // into the warpgroup's tile [row][column]
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const unsigned long long idx =
                ((unsigned long long)f * B + b0 + ra + 8 * h) * I + c0 + cw + 8 * n + 2 * t4;
            uint32_t lo = 0;
            const uint32_t hi = round2<MODE>(ev[h][n][0], ev[h][n][1], idx, cirkit::ROLE_EB, lo);
            const uint32_t at = sw128(ra + 8 * h, 8 * n + 2 * t4);
            *reinterpret_cast<uint32_t*>(eb + at) = hi;
            if (SPLIT) *reinterpret_cast<uint32_t*>(eb + TILE + at) = lo;
          }
        fence_proxy_async();
        named_bar(bar_wg, 128);
      }

      // dw += gy^T r(e) over the tile's rows, each unit tile: gy MN-major
      // (rows b, 64 units), r(e) MN-major (rows b, the warpgroup's columns);
      // the split: gy_hi e_hi + gy_hi e_lo + gy_lo e_hi
#pragma unroll
      for (int u = 0; u < 2; ++u) fence_regs(dwacc[u]);
      wgmma_fence();
      if (do_dw) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            if (u < nu) {
              const uint64_t ga = sw128_desc_mn(gy_s + u * TILE + ks * 2048);
              const uint64_t eh = sw128_desc_mn(eb_s + ks * 2048);
              wgmma_64x64_tt(dwacc[u], ga, eh, (ks | bt) != 0);
              if (SPLIT) {
                wgmma_64x64_tt(dwacc[u], ga, sw128_desc_mn(eb_s + TILE + ks * 2048), 1);
                wgmma_64x64_tt(dwacc[u], sw128_desc_mn(gy_s + (2 + u) * TILE + ks * 2048), eh,
                               1);
              }
            }
      }
      wgmma_commit();

      // dx = e s, from the registers (DX_ACC: added to the earlier launches')
      wgmma_wait<1>();
      fence_regs(sacc);
      if (do_dx) {
        float* dxf = dx + (size_t)f * B * I;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int b = b0 + ra + 8 * h;
          if (b >= B) continue;
          float* drow = dxf + (size_t)b * I;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int col = c0 + cw + 8 * n + 2 * t4;
            float v0 = ev[h][n][0] * sacc[4 * n + 2 * h];
            float v1 = ev[h][n][1] * sacc[4 * n + 2 * h + 1];
            if ((flags & bb::DX_PAIR) && col < I) {  // I even: col + 1 < I too
              float2* p = reinterpret_cast<float2*>(drow + col);
              if (flags & bb::DX_ACC) {
                const float2 old = *p;
                v0 += old.x;
                v1 += old.y;
              }
              *p = make_float2(v0, v1);
            } else {
              if (col < I) drow[col] = (flags & bb::DX_ACC) ? drow[col] + v0 : v0;
              if (col + 1 < I) drow[col + 1] = (flags & bb::DX_ACC) ? drow[col + 1] + v1 : v1;
            }
          }
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int u = 0; u < 2; ++u) fence_regs(dwacc[u]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * slot);
    }

    if (do_dw) epilogue(f, c0);
    if (do_dx && !RAW) {  // the strip's weights are read
      __syncwarp();
      if (lane == 0) mbar_arrive(wempty0 + 8 * ws);
    }
  }
}

template <typename WT, int MODE>
int launch_fwd(const float* x, const WT* w, float* out, float* m, int F, int B, int I, int O,
               int device, void* stream) {
  using C = FwdCfg<WT>;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // TMA where every row of x and w starts 16-byte aligned
  const bool vec = I % static_cast<int>(16 / sizeof(WT)) == 0 && aligned(x, 16) && aligned(w, 16);
  CUtensorMap xmap{}, wmap{};
  if (vec) {
    const cuuint64_t es = sizeof(WT);
    const cuuint64_t xd[3] = {(cuuint64_t)I, (cuuint64_t)B, (cuuint64_t)F};
    const cuuint64_t xs[2] = {(cuuint64_t)I * 4, (cuuint64_t)B * I * 4};
    const cuuint32_t xb[3] = {32, bb::BM, 1};
    const cuuint64_t wd[3] = {(cuuint64_t)I, (cuuint64_t)O, (cuuint64_t)F};
    const cuuint64_t wst[2] = {(cuuint64_t)I * es, (cuuint64_t)O * I * es};
    const cuuint32_t wb[3] = {sizeof(WT) == 2 ? 64u : 32u, bb::BN, 1};
    if ((err = cirkit::tiled_map(&xmap, x, 3, xd, xs, xb)) != cudaSuccess ||
        (err = cirkit::tiled_map(&wmap, w, 3, wd, wst, wb)) != cudaSuccess)
      return static_cast<int>(err);
  }
  const long long n_bt = cdiv(B, bb::BM), n_ot = cdiv(O, bb::BN);
  const long long blocks = (long long)F * n_bt * n_ot;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = bb_fwd<WT, MODE>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), bb::NT, C::SMEM, s>>>(
      x, w, out, m, xmap, wmap, B, I, O, static_cast<int>(n_bt), static_cast<int>(n_ot), vec);
  return static_cast<int>(cudaGetLastError());
}

// The prep pass, then the products, one launch per group of 128 units (the
// later ones add to dx). ``ws`` (ops/lse_einsum.py's _blocked_gy_shape):
// P planes of (F, B, Op) bf16, Op = O rounded up to 8.
template <typename WT, int MODE>
int launch_bwd(const float* x, const WT* w, const float* out, const float* m, const float* g,
               float* dx, WT* dw, void* ws, int F, int B, int I, int O, int device,
               void* stream) {
  using C = BwdCfg<WT, MODE>;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Op = (O + 7) / 8 * 8;
  auto* gyr = static_cast<__nv_bfloat16*>(ws);
  bb_prep<MODE><<<dim3(F, cdiv(B, 8)), 256, 0, s>>>(out, m, g, gyr, F, B, O, Op);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (dx == nullptr && dw == nullptr) return 0;
  constexpr bool W16 = sizeof(WT) == 2;
  // TMA copies where every row of x and w starts 16-byte aligned; pairs of
  // dx, 16-byte chunks of a bf16 dw and pairs of an f32 one where their
  // rows are aligned so
  const int es = static_cast<int>(sizeof(WT));
  const bool vec = I % (16 / es) == 0 && aligned(x, 16) && aligned(w, 16);
  const bool dw_vec = W16 ? I % 8 == 0 && aligned(dw, 16) : I % 2 == 0 && aligned(dw, 8);
  const int flags = (dx != nullptr ? bb::DO_DX : 0) | (dw != nullptr ? bb::DO_DW : 0) |
                    (vec ? bb::VEC : 0) | (I % 2 == 0 && aligned(dx, 8) ? bb::DX_PAIR : 0) |
                    (dw_vec ? bb::DW_VEC : 0);
  CUtensorMap xmap{};
  if (vec) {
    const cuuint64_t xd[3] = {(cuuint64_t)I, (cuuint64_t)B, (cuuint64_t)F};
    const cuuint64_t xs[2] = {(cuuint64_t)I * 4, (cuuint64_t)B * I * 4};
    const cuuint32_t xb[3] = {32, bb::BT, 1};
    if ((err = cirkit::tiled_map(&xmap, x, 3, xd, xs, xb)) != cudaSuccess)
      return static_cast<int>(err);
  }
  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  const long long total = (long long)F * cdiv(I, bb::SN);
  if (total >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned grid = static_cast<unsigned>(total < sms ? total : sms);
  auto kernel = bb_bwd<WT, MODE>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int u0 = 0; u0 < O; u0 += bb::UG) {
    const int Og = O - u0 < bb::UG ? O - u0 : bb::UG;
    CUtensorMap wmap{}, gmap{};
    if (vec) {
      const cuuint64_t wd[3] = {(cuuint64_t)I, (cuuint64_t)Og, (cuuint64_t)F};
      const cuuint64_t wst[2] = {(cuuint64_t)I * es, (cuuint64_t)O * I * es};
      const cuuint32_t wb[3] = {W16 ? 64u : 32u, bb::UG, 1};
      const cuuint64_t gd[4] = {(cuuint64_t)Og, (cuuint64_t)B, (cuuint64_t)F, (cuuint64_t)C::P};
      const cuuint64_t gs[3] = {(cuuint64_t)Op * 2, (cuuint64_t)B * Op * 2,
                                (cuuint64_t)F * B * Op * 2};
      const cuuint32_t gb[4] = {64, bb::BT, 1, 1};
      if ((err = cirkit::tiled_map(&wmap, w + (size_t)u0 * I, 3, wd, wst, wb)) != cudaSuccess ||
          (err = cirkit::tiled_map(&gmap, gyr + u0, 4, gd, gs, gb)) != cudaSuccess)
        return static_cast<int>(err);
    }
    kernel<<<grid, bb::NT, C::SMEM, s>>>(x, w, m, gyr, dx, dw, xmap, wmap, gmap, F, B, I, O, Op,
                                         u0, Og, flags | (u0 > 0 ? bb::DX_ACC : 0));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// The bf16-weight and fast-mode instances of the blocked dense forward and
// backward (ops/lse_einsum.py's INSTANCES), with the float entries'
// arguments but for the backward's weight gradient, which has the weight's
// type, and its scratch ``gy`` (P planes of (F, B, Op) bf16). The build
// compiles this source once for each part (-DCIRKIT_BLOCKED_PART=0..4;
// ops/_build.py), side by side: a part an instance. A build without the
// macro holds all of them.
#define BLOCKED_BF16_ENTRIES(SUFFIX, WT, MODE)                                                  \
  int lse_fwd_blocked##SUFFIX(const float* x, const WT* w, float* out, float* m, int F, int B, \
                              int I, int O, int device, void* stream) {                        \
    return launch_fwd<WT, MODE>(x, w, out, m, F, B, I, O, device, stream);                      \
  }                                                                                             \
  int lse_bwd_blocked##SUFFIX(const float* x, const WT* w, const float* out, const float* m,   \
                              const float* g, float* dx, WT* dw, void* gy, int F, int B,       \
                              int I, int O, int device, void* stream) {                        \
    return launch_bwd<WT, MODE>(x, w, out, m, g, dx, dw, gy, F, B, I, O, device, stream);       \
  }

#if !defined(CIRKIT_BLOCKED_PART) || CIRKIT_BLOCKED_PART == 0
BLOCKED_BF16_ENTRIES(_fast, float, cirkit::BF16)
#endif
#if !defined(CIRKIT_BLOCKED_PART) || CIRKIT_BLOCKED_PART == 1
BLOCKED_BF16_ENTRIES(_sr, float, cirkit::SR)
#endif
#if !defined(CIRKIT_BLOCKED_PART) || CIRKIT_BLOCKED_PART == 2
BLOCKED_BF16_ENTRIES(_w16, __nv_bfloat16, cirkit::F32)
#endif
#if !defined(CIRKIT_BLOCKED_PART) || CIRKIT_BLOCKED_PART == 3
BLOCKED_BF16_ENTRIES(_w16_fast, __nv_bfloat16, cirkit::BF16)
#endif
#if !defined(CIRKIT_BLOCKED_PART) || CIRKIT_BLOCKED_PART == 4
BLOCKED_BF16_ENTRIES(_w16_sr, __nv_bfloat16, cirkit::SR)
#endif
#undef BLOCKED_BF16_ENTRIES

}  // extern "C"
