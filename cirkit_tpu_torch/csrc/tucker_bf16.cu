// The fast-mode Tucker forwards for Hopper (sm_90a) on the bf16 tensor cores:
// the _fast, _sr, _w16_fast and _w16_sr instances of the single-pass Tucker
// forward (kernel 1, lse_fwd_tucker[_softmax]*; its float32 and _w16 ones
// are tucker_fwd_tc of csrc/lse_einsum.cu) and of the K1-chunked Tucker
// forward (kernel 5; its float32 and _w16 ones are ct_fwd_tc of
// csrc/lse_wide.cu), one kernel for both, under kernel 1's entries; and
// those of the signed and the complex Tucker forwards (kernels 6' and 10',
// slse_fwd_tucker[_softmax]*, clse_fwd_tucker_rw_fast and _sr; described
// below).
//
// Replaces the CIRKIT_TPU_FAST configurations of the Pallas TPU kernels
// `_fwd_kernel` (Tucker, cirkit_tpu/ops/lse_einsum.py:335) and
// `_ct_fwd_kernel` (:738), which run one bf16 pass (`_fcast`, `_dot1`) with
// f32 accumulation, and of `_s_fwd_kernel` (:938) and `_c_fwd_kernel`
// (:1424) on the Tucker entries. Per fold f, with m_h the clamped row max of x_h:
//
//   out[b,o] = log sum_i e1[b,i] S_i[b,o] + m1[b] + m2[b]   (- log Z_o)
//   S_i[b,o] = sum_j r(e2[b,j]) r(w[o,i*K2+j])
//
// at the port's rounding points (ops/lse_einsum.py): e1 = exp(x1 - m1) in
// f32; r() rounds e2 = exp(x2 - m2) and the weight to bf16, to the nearest
// (BF16) or by sr_bits (SR) of their flat indices in x2 and w; S_i is summed
// in f32 and e1 S_i added in f32. With logits the weight of a tile (below)
// is exp(theta - r_o), r_o the unit's running max over the tiles so far, as
// JAX's `_ct_fwd_kernel` takes it; the unit's accumulators and its
// normalizer Z_o, which sums the unrounded exponentials in f32, shrink by
// exp(old r_o - new r_o) where a tile raises it (ops/lse_einsum.py's
// _tucker_fast_numerators follows the same tiles), so the logits are read
// once. A product of two bf16 values is exact in f32, so the tensor cores
// change only the order of the f32 sums.
//
// What bounds it on the H100: at the K=64 entry (F=784, B=128, K1=K2=O=64)
// the 52.6 GFLOP take 0.053 ms on the bf16 tensor cores and the weight's
// 0.82 GB (f32) or 0.41 GB (bf16) 0.245 or 0.123 ms at 3.35 TB/s; K=128 is
// the same at eight times the size. So at batch 128 the weight's bytes
// bind; at the serving batch of 512 the products come close. mma.sync
// reaches about half the bf16 rate on this card (at most 534 of 989
// TFLOP/s in a loop of independent products on an H100 80GB HBM3 at 700 W,
// scripts/mma_peak.py), so the products run on wgmma.
//
// The design: a block (fold, 64 units, BM batch rows: 128, two blocks an
// SM, up to a batch of 128; else 256, one block of 16 warps, so each
// converted tile serves twice the rows) is BM / 64 warpgroups, each
// computing 64 rows x 64 units with wgmma (m64n64k16, both operands K-major
// bf16 in shared memory in the 128-byte swizzle, f32 accumulators). For
// each chunk of JC = 64 columns j it stages E2 = r(exp(x2 - m2)) once. The
// weight streams through a ring of NS stages of R rows i, each row a (row
// i, chunk) tile of 64 x JC weights copied by one TMA box (zero past the
// edges) that completes on the slot's mbarrier, with x1 at those rows for
// the block's batch rows (cp.async); NS - 1 stages in flight. A bf16 weight
// with linear values is the B operand as copied (rounding a bf16 value
// gives it back; TMA writes it in the 128-byte swizzle); any other goes
// through one convert step (round, or for logits raise r_o, exp(theta -
// r_o), add to Z, round), eight contiguous values a thread, into a
// double-buffered bf16 tile, done for the next stage while the current
// one's products run. For row i the warpgroups contract S_i over the chunk
// (four k16 steps; columns past K2 are zero in both operands) and fold acc
// += e1[b, i] S_i in f32 registers (logits: acc scaled by its unit's factor
// first), e1 = exp(x1 - m1): 64 x 64 FMAs a row against 64 x 64 x 64
// products. Contracting all of a row's columns before the fold keeps the
// plain versions' rounding points, where the outer product r(e1 e2) would
// move them. The blocks run batch tile first, so the batch tiles of one
// fold read its weight from device memory once. Every stage ends at a
// barrier of the block, so a block's products, copies and convert steps
// only partly overlap; a second resident block fills some of the gaps. A
// K2 whose rows are not 16-byte multiples, or a weight that is not 16-byte
// aligned, is read element by element by the convert step instead. Ragged
// B, O, K1 and K2 are masked, K1 padded to a multiple of R.
//
// The same kernel runs the fast modes of the signed Tucker forward (kernel
// 6', SIGNED) and of the complex64 one against a real weight (kernel 10',
// CPLX), at the same rounding points. SIGNED: x1 and x2 are
// log-magnitudes, s1 and s2 their signs; s2 is folded into E2 before it is
// rounded, s1 into e1 = s1 exp(x1 - m1) in f32, and the epilogue writes
// log|y| + shift (less log Z) and sign y, an exact cancellation giving (-inf,
// 0). s1 goes through the ring beside x1 where a convert step hides its
// copies; on a bf16 weight's linear values, where a stage is only its
// products, it is read into registers from L2 as the stage begins, two rows
// i in one load: there the ring's scattered 4-byte copies of s1, which also
// take L1 lines that x1's share, made the kernel 1.43 times the unsigned
// one's time, the loads 1.21; with a convert step the ring gave 1.07-1.20
// (K=64 entry, an H100 80GB HBM3 at 700 W, scripts/sos_fwd_ab.py --tucker).
// CPLX (PyTorch's interleaved complex x1, x2 and out): a
// batch row's planes of r(E2) are rows stacked_at(b) and + 8 of the A tile
// (tc_common.cuh), each plane rounded at its flat index in
// torch.view_as_real's layout of x2, so a block takes BM / 2 batch rows
// (blocks of 256 rows from a batch of 65: at the complex flagship's 128 a
// fold's weight is read and converted once); the thread that holds rows rw
// and rw + 8 holds one batch row's S_re and S_im, and the fold is the complex
// multiply-add acc += e1 S_i with e1 = exp(x1 - m1) (cexp_f32) in f32; the
// epilogue writes log|y| + shift + i atan2(Im y, Re y).
//
// Each extern "C" entry selects the given device, launches on the given
// stream and returns the first error of its launches (0 on success).

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

using cirkit::clamp_max;
using cirkit::cp_async_commit;
using cirkit::cp_async_f32;
using cirkit::cp_async_wait;
using cirkit::fence_proxy_async;
using cirkit::mbar_expect;
using cirkit::mbar_init;
using cirkit::mbar_wait;
using cirkit::pack_bf16x8;
using cirkit::round_op;
using cirkit::sw128;
using cirkit::sw128_desc;
using cirkit::tma_load_4d;
using cirkit::warp_max;
using cirkit::wgmma_64x64;
using cirkit::wgmma_commit;
using cirkit::wgmma_fence;
using cirkit::wgmma_wait;
using cirkit::widen;

namespace tb {
constexpr int BN = 64;      // units a block
constexpr int JC = 64;      // columns j a chunk: one 128-byte bf16 row
constexpr int KS = JC / 16; // k16 steps a chunk
constexpr int ROW = 128;    // bytes of a bf16 tile row
constexpr int TPU = 8;      // threads that convert a unit's row of a tile, 8 values each

// A block of BM batch rows (a warpgroup each 64) on weights of type WT: its
// threads, the blocks resident on an SM, the rows i a stage (R) and the
// ring's stages, a tile's bytes and a stage's (R tiles, then x1 at their
// rows i for the block's rows); and the shared memory: E2's tile, the two
// stages of converted bf16 tiles, the ring, the shifts, the rescale factors
// of two stages, the log-normalizers, the ring's mbarriers, and 1 KB to
// align the tiles to 1024 bytes. BM = 128 keeps two blocks an SM (at most
// 103 KB each, 128 registers a thread), so one block's products overlap the
// other's staging; BM = 256, one block of 16 warps (209 KB for a float32
// weight, 181 KB for bf16).
//
// S1 (the signed instances but on a bf16 weight's linear values) stages s1
// beside x1 (R * BM floats more a stage: 217 KB at BM = 256 on a float32
// weight, 108 KB at BM = 128 on bf16 logits).
template <bool SIGNED, bool SOFTMAX, typename WT>
constexpr bool s1_in_ring = SIGNED && (SOFTMAX || sizeof(WT) == 4);

template <int BM, typename WT, bool S1 = false>
struct Cfg {
  static constexpr int NT = BM / 64 * 128;
  static constexpr int BLOCKS = BM == 128 ? 2 : 1;
  static constexpr int R = BM == 128 && sizeof(WT) == 4 ? 1 : 2;
  static constexpr int NS = BM == 128 ? 3 : sizeof(WT) == 4 ? 4 : 6;
  static constexpr int TILE = BN * JC * static_cast<int>(sizeof(WT));
  static constexpr int STAGE = R * TILE + (S1 ? 2 : 1) * R * BM * 4;
  static constexpr size_t SMEM = (size_t)(BM + 2 * R * BN) * ROW + (size_t)NS * STAGE +
                                 sizeof(float) * ((size_t)2 * BM + (2 * R + 1) * BN) +
                                 sizeof(uint64_t) * NS + 1024;
};
}  // namespace tb

template <int BM, bool SOFTMAX, typename WT, int MODE, bool SIGNED = false, bool CPLX = false>
__global__ void __launch_bounds__(tb::Cfg<BM, WT, tb::s1_in_ring<SIGNED, SOFTMAX, WT>>::NT,
                                  tb::Cfg<BM, WT, tb::s1_in_ring<SIGNED, SOFTMAX, WT>>::BLOCKS)
tucker_fwd_bf16(const float* __restrict__ x1,  // (F, B, K1); CPLX: complex, (re, im) pairs
                const float* __restrict__ x2,  // (F, B, K2); CPLX: complex
                const WT* __restrict__ w,      // (F, O, K1*K2): weights, or logits
                float* __restrict__ out,       // (F, B, O); SIGNED: log|y|; CPLX: complex
                // the weight as (F, O, K1, K2), 64 x 64 boxes of (units, j);
                // unset where ``vec`` is false
                const __grid_constant__ CUtensorMap wmap,
                int B, int K1, int K2, int O, int n_ot, int n_bt, bool vec,
                const float* __restrict__ s1,    // SIGNED: the signs of x1 and x2; else unused
                const float* __restrict__ s2,
                float* __restrict__ out_sign) {  // SIGNED: sign(y) (F, B, O)
  // SIGNED: s1 through the ring beside x1 where a convert step hides the
  // copies; on a bf16 weight's linear values in registers (below)
  constexpr bool S1 = tb::s1_in_ring<SIGNED, SOFTMAX, WT>;
  using C = tb::Cfg<BM, WT, S1>;
  constexpr int BN = tb::BN, JC = tb::JC, KS = tb::KS, R = C::R, ROW = tb::ROW, TPU = tb::TPU;
  constexpr int NT = C::NT, NW = NT / 32, NS = C::NS, STAGE = C::STAGE, TILE = C::TILE;
  constexpr int XQ = (R * BM + NT - 1) / NT;              // x1 copies a thread issues a stage
  constexpr int VQ = BN * TPU / NT;                       // unit rows a thread converts a tile
  // batch rows a block: CPLX stacks each row's two planes in the BM rows
  constexpr int BB = CPLX ? BM / 2 : BM;
  constexpr int CW = CPLX ? 2 : 1;  // floats a value of x1, x2 and out
  // a bf16 weight with linear values is wgmma's operand as copied
  constexpr bool RAW16 = sizeof(WT) == 2 && !SOFTMAX;
  static_assert(MODE != cirkit::F32, "the f32-grade instances are tucker_fwd_tc and ct_fwd_tc");
  static_assert(NS >= 3 && XQ >= 1 && VQ >= 1 && JC == 8 * TPU && JC == 64 && BN == 64,
                "tile: weight_map's boxes");
  static_assert(!(SIGNED && CPLX) && !(CPLX && (SOFTMAX || sizeof(WT) != 4)),
                "CPLX: linear float32 weights, unsigned");

  extern __shared__ __align__(16) unsigned char tb_raw[];
  unsigned char* smem = tb_raw + ((1024 - (static_cast<uint32_t>(
                                              __cvta_generic_to_shared(tb_raw)) & 1023)) & 1023);
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  unsigned char* E2s = smem;                  // [BM] rows: r(E2) of the chunk
  unsigned char* Wt = E2s + BM * ROW;         // [2][R][BN] rows: converted tiles
  unsigned char* ring = Wt + 2 * R * BN * ROW;  // [NS] stages: R tiles, then x1 [R][BM]
  float* m1s = reinterpret_cast<float*>(ring + NS * STAGE);
  float* m2s = m1s + BM;
  float* wscl = m2s + BM;           // SOFTMAX: [2][R][BN], each tile's rescale factors
  float* lsum = wscl + 2 * R * BN;  // SOFTMAX: [BN], each unit's log-normalizer
  // [NS]: each ring slot's mbarrier, which its weights' TMA copies complete
  const uint32_t bar0 = static_cast<uint32_t>(__cvta_generic_to_shared(lsum + BN));
  const uint32_t e2_s = sbase, wt_s = sbase + BM * ROW, ring_s = sbase + (BM + 2 * R * BN) * ROW;

  // batch tile fastest: the tiles of one fold share its weight through L2
  const int bt = blockIdx.x % n_bt;
  const int rest = blockIdx.x / n_bt;
  const int ot = rest % n_ot, f = rest / n_ot;
  const int o0 = ot * BN, b0 = bt * BB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2;                      // the warpgroup: rows 64 wg ..
  const int rw = 64 * wg + 16 * (warp & 3) + g;  // this thread's rows rw, rw + 8
  const int I = K1 * K2;
  const float* x1f = x1 + (size_t)f * B * K1 * CW;
  const float* x2f = x2 + (size_t)f * B * K2 * CW;
  const float* s1f = s1 + (size_t)f * B * K1;  // SIGNED
  const float* s2f = s2 + (size_t)f * B * K2;
  const WT* wf = w + (size_t)f * O * I;

  if (tid == 0) {
    for (int k = 0; k < NS; ++k) mbar_init(bar0 + 8 * k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Prologue: the clamped row maxes of x1 and x2 (CPLX: of their real
  // parts; row warp + NW rr), each warp's loads of all its rows in flight
  // together.
  {
    constexpr int RPW = BB / NW;
    float a[RPW], c[RPW];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) a[rr] = c[rr] = -INFINITY;
    for (int k = lane; k < max(K1, K2); k += 32)
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const int b = b0 + warp + NW * rr;
        if (b < B) {
          if (k < K1) a[rr] = fmaxf(a[rr], x1f[((size_t)b * K1 + k) * CW]);
          if (k < K2) c[rr] = fmaxf(c[rr], x2f[((size_t)b * K2 + k) * CW]);
        }
      }
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const float ma = warp_max(a[rr]), mc = warp_max(c[rr]);
      if (lane == 0) {
        m1s[warp + NW * rr] = clamp_max(ma);
        m2s[warp + NW * rr] = clamp_max(mc);
      }
    }
  }

  // Stage s holds rows i = i0 .. i0 + R - 1 of chunk jc, s = jc K1p / R +
  // i0 / R, K1 padded to K1p rows (the rows past K1 masked).
  const int K1p = (K1 + R - 1) / R * R;
  const int NSt = (K2 + JC - 1) / JC * (K1p / R);
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  float part[VQ], rmax[VQ];  // SOFTMAX: this thread's normalizer shares and running maxes
#pragma unroll
  for (int q = 0; q < VQ; ++q) part[q] = 0.f, rmax[q] = -INFINITY;

  // The loop, for a compile-time choice of the weight's path: DIRECT (a
  // bf16 weight with linear values copied by TMA: wgmma reads the copied
  // stage) or through the convert step, and VEC (TMA copies through the
  // ring) or element by element (the convert step reads device memory
  // itself; x1 goes through the ring by cp.async either way).
  auto run = [&](auto direct_c, auto vec_c) {
    constexpr bool DIRECT = decltype(direct_c)::value, VEC = decltype(vec_c)::value;
    // byte offset of weight (r, c) in a stage's tile: TMA writes a bf16 tile
    // swizzled as wgmma reads it, a float32 one in plain rows
    auto stage_off = [](int r, int c) -> uint32_t {
      if constexpr (sizeof(WT) == 2) {
        return sw128(r, c);
      } else {
        return (r * JC + c) * 4;
      }
    };
    // Copy stage st into ring slot st % NS (zero past the edges): its
    // weights by TMA, one box a row i, completing on the slot's mbarrier;
    // x1 by cp.async.
    auto issue = [&](int st) {
      if (st < NSt) {
        const int t0 = st * R, jc = t0 / K1p, i0 = t0 - jc * K1p;
        unsigned char* slot = ring + (st % NS) * STAGE;
        if (VEC && tid == 0) {
          const uint32_t bar = bar0 + 8 * (st % NS);
          mbar_expect(bar, R * TILE);
#pragma unroll
          for (int rr = 0; rr < R; ++rr)
            tma_load_4d(ring_s + (st % NS) * STAGE + rr * TILE, &wmap, jc * JC, i0 + rr, o0, f,
                        bar);
        }
        float* xs = reinterpret_cast<float*>(slot + R * TILE);
#pragma unroll
        for (int q = 0; q < XQ; ++q) {
          if constexpr (CPLX) {  // float r of row rr: part r % 2 of x1 at batch row r / 2
            const int c = tid + NT * q, rr = c / BM, r = c - rr * BM, b = b0 + (r >> 1);
            const int i = i0 + rr;
            const bool in = b < B && i < K1;
            const size_t k = ((size_t)b * K1 + i) * 2 + (r & 1);
            if (c < R * BM) cp_async_f32(xs + c, in ? x1f + k : x1f, in);
          } else {
            const int c = tid + NT * q, rr = c / BM, r = c - rr * BM, b = b0 + r, i = i0 + rr;
            const bool in = b < B && i < K1;
            if (c < R * BM) cp_async_f32(xs + c, in ? x1f + (size_t)b * K1 + i : x1f, in);
            if constexpr (S1)  // s1 at the same rows, after x1
              if (c < R * BM) cp_async_f32(xs + R * BM + c, in ? s1f + (size_t)b * K1 + i : s1f,
                                           in);
          }
        }
      }
      cp_async_commit();
    };
    // Convert row rr (row i of chunk jc) of stage st into bf16 tile (st % 2,
    // rr): unit row u = tid / 8 + (NT / 8) q of this thread, columns 8 (tid
    // % 8) .. + 7. SOFTMAX: the 8 threads of a unit row raise the unit's
    // running max to the tile's (held in their registers) and stage
    // exp(theta - max); a unit whose logits have all been -inf so far keeps
    // max -inf, factor 1 and shift 0, so exp(-inf) = 0 and no NaN. They
    // shrink their normalizer shares by the factor and add the unrounded
    // exponentials.
    auto convert = [&](int st, int rr, int jc, int i) {
      const int col = TPU * (tid & (TPU - 1));
      const int j = jc * JC + col;
#pragma unroll
      for (int q = 0; q < VQ; ++q) {
        const int r = tid / TPU + (NT / TPU) * q, o = o0 + r;
        const bool row_in = o < O && i < K1;
        float v[8];
        if constexpr (VEC) {
          const unsigned char* src = ring + (st % NS) * STAGE + rr * TILE + stage_off(r, col);
          if constexpr (sizeof(WT) == 4) {
            const float4 u0 = reinterpret_cast<const float4*>(src)[0];
            const float4 u1 = reinterpret_cast<const float4*>(src)[1];
            v[0] = u0.x, v[1] = u0.y, v[2] = u0.z, v[3] = u0.w;
            v[4] = u1.x, v[5] = u1.y, v[6] = u1.z, v[7] = u1.w;
          } else {
            const uint4 u = *reinterpret_cast<const uint4*>(src);
            const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              v[2 * e] = __uint_as_float(wd[e] << 16), v[2 * e + 1] = __uint_as_float(wd[e] & 0xFFFF0000u);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = row_in && j + e < K2 ? widen(wf[(size_t)o * I + (size_t)i * K2 + j + e]) : 0.f;
        }
        if (SOFTMAX) {
          float cm = -INFINITY;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (!(row_in && j + e < K2)) v[e] = -INFINITY;
            cm = fmaxf(cm, v[e]);
          }
#pragma unroll
          for (int d = 1; d < TPU; d <<= 1) cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, d));
          const float mn = fmaxf(rmax[q], cm);
          const float scl = mn == -INFINITY ? 1.f : expf(rmax[q] - mn);
          const float sh = mn == -INFINITY ? 0.f : mn;
          rmax[q] = mn;
          float sum = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            v[e] = expf(v[e] - sh);
            sum += v[e];
          }
          part[q] = fmaf(part[q], scl, sum);
          if ((tid & (TPU - 1)) == 0) wscl[((st & 1) * R + rr) * BN + r] = scl;
        }
        const unsigned long long idx = ((unsigned long long)f * O + o) * I + (size_t)i * K2 + j;
        *reinterpret_cast<uint4*>(Wt + ((st & 1) * R + rr) * BN * ROW + sw128(r, col)) =
            pack_bf16x8<MODE>(v, idx, cirkit::ROLE_W);
      }
    };

#pragma unroll
    for (int s = 0; s < NS - 1; ++s) issue(s);
    __syncthreads();  // the shifts
    if constexpr (!DIRECT) {
      cp_async_wait<NS - 2>();
      if (VEC) mbar_wait(bar0, 0);
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < R; ++rr) convert(0, rr, 0, rr);
    }
    // CPLX: rows rw and rw + 8 are the planes of batch row stacked_row(rw)
    const int ra = CPLX ? cirkit::stacked_row(rw) : rw;
    const float m1a = m1s[ra], m1b = m1s[rw + 8];
    const bool ra_in = b0 + ra < B, rb_in = b0 + rw + 8 < B;

    // SIGNED on a bf16 weight's linear values: s1 of this thread's two batch
    // rows at a stage's rows i, read into registers from L2 (ld.global.cg,
    // so x1's lines keep L1) as the stage begins, in flight while it lands
    // and its products run; a stage's two rows in one 8-byte load where they
    // are aligned so (R = 2, K1 even, s1 8-byte aligned)
    const bool s1_pairs = SIGNED && R == 2 && K1 % 2 == 0 &&
                          reinterpret_cast<uintptr_t>(s1) % 8 == 0;
    for (int t = 0, jc = 0, i = 0; t < NSt; ++t) {
      float sa[R], sb[R];  // SIGNED && !S1
      if constexpr (SIGNED && !S1) {
        const float* pa = s1f + (size_t)(b0 + rw) * K1 + i;
        const float* pb = pa + (size_t)8 * K1;
        if (R == 2 && s1_pairs && i + 1 < K1) {
          const float2 va = ra_in ? __ldcg(reinterpret_cast<const float2*>(pa)) : float2{};
          const float2 vb = rb_in ? __ldcg(reinterpret_cast<const float2*>(pb)) : float2{};
          sa[0] = va.x, sa[R - 1] = va.y, sb[0] = vb.x, sb[R - 1] = vb.y;
        } else {
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {
            const bool row = i + rr < K1;
            sa[rr] = ra_in && row ? __ldcg(pa + rr) : 0.f;
            sb[rr] = rb_in && row ? __ldcg(pb + rr) : 0.f;
          }
        }
      }
      // stage t (DIRECT) or t + 1 (converted) has landed; every warp is
      // done with stage t - 1 and with the slot issued next
      cp_async_wait<DIRECT ? NS - 2 : NS - 3>();
      if (VEC) {
        const int ws = DIRECT ? t : t + 1;
        if (ws < NSt) mbar_wait(bar0 + 8 * (ws % NS), (ws / NS) & 1);
      }
      fence_proxy_async();
      __syncthreads();
      issue(t + NS - 1);
      if (i == 0) {  // r(E2) of the chunk, as bf16
        const int j0 = jc * JC;
        if constexpr (CPLX) {
          // a batch row's planes at stacked rows, each rounded at its flat
          // index in torch.view_as_real's layout of x2 (2 k and 2 k + 1)
          const float2* c2f = reinterpret_cast<const float2*>(x2f);
#pragma unroll
          for (int q = 0; q < BB * (JC / 8) / NT; ++q) {
            const int c8 = tid + NT * q, r = c8 / (JC / 8), col = 8 * (c8 % (JC / 8)), b = b0 + r;
            float re[8], im[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int j = j0 + col + e;
              re[e] = im[e] = 0.f;
              if (b < B && j < K2) {
                const float2 z = c2f[(size_t)b * K2 + j];
                cirkit::cexp_f32(z.x - m2s[r], z.y, &re[e], &im[e]);
              }
            }
            const unsigned long long idx = 2 * (((unsigned long long)f * B + b) * K2 + j0 + col);
            const int sr = cirkit::stacked_at(r);
            *reinterpret_cast<uint4*>(E2s + sw128(sr, col)) =
                pack_bf16x8<MODE>(re, idx, cirkit::ROLE_E, 2);
            *reinterpret_cast<uint4*>(E2s + sw128(sr + 8, col)) =
                pack_bf16x8<MODE>(im, idx + 1, cirkit::ROLE_E, 2);
          }
        } else {
#pragma unroll
          for (int q = 0; q < BM * (JC / 8) / NT; ++q) {
            const int c8 = tid + NT * q, r = c8 / (JC / 8), col = 8 * (c8 % (JC / 8)), b = b0 + r;
            float v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int j = j0 + col + e;
              if constexpr (SIGNED) {  // s2 folded in before the rounding
                v[e] = b < B && j < K2
                           ? s2f[(size_t)b * K2 + j] * expf(x2f[(size_t)b * K2 + j] - m2s[r])
                           : 0.f;
              } else {
                v[e] = b < B && j < K2 ? expf(x2f[(size_t)b * K2 + j] - m2s[r]) : 0.f;
              }
            }
            const unsigned long long idx = ((unsigned long long)f * B + b) * K2 + j0 + col;
            *reinterpret_cast<uint4*>(E2s + sw128(r, col)) =
                pack_bf16x8<MODE>(v, idx, cirkit::ROLE_E);
          }
        }
        fence_proxy_async();
        __syncthreads();
      }
      // the next stage's rows, for its convert step
      const bool wrap = i + R == K1p;
      const int njc = wrap ? jc + 1 : jc, ni = wrap ? 0 : i + R;
      const float* xs = reinterpret_cast<const float*>(ring + (t % NS) * STAGE + R * TILE);

#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        // S_i = r(E2) r(W_i)^T over the chunk (columns past K2 are zero in
        // both), the next stage's row rr converted meanwhile, then acc +=
        // e1[:, i] S_i
        const uint32_t tile_s =
            DIRECT ? ring_s + (t % NS) * STAGE + rr * TILE : wt_s + ((t & 1) * R + rr) * BN * ROW;
        const uint64_t da = sw128_desc(e2_s + wg * 64 * ROW), db = sw128_desc(tile_s);
        float s[32];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) wgmma_64x64(s, da + 2 * ks, db + 2 * ks, ks);
        wgmma_commit();
        if constexpr (!DIRECT) convert(t + 1, rr, njc, ni + rr);
        const bool row = i + rr < K1;
        if constexpr (CPLX) {
          // rows rw and rw + 8 of the tile are S_re and S_im of batch row
          // ra: acc += e1 S_i as complex numbers, the real part in the first
          // row's registers
          float er = 0.f, ei = 0.f;
          if (ra_in && row) {
            const float2 z = reinterpret_cast<const float2*>(xs)[rr * BB + ra];
            cirkit::cexp_f32(z.x - m1a, z.y, &er, &ei);
          }
          wgmma_wait<0>();
#pragma unroll
          for (int n8 = 0; n8 < 8; ++n8) {
            float* a = acc + 4 * n8;
            const float* sv = s + 4 * n8;
            a[0] = fmaf(er, sv[0], fmaf(-ei, sv[2], a[0]));
            a[1] = fmaf(er, sv[1], fmaf(-ei, sv[3], a[1]));
            a[2] = fmaf(er, sv[2], fmaf(ei, sv[0], a[2]));
            a[3] = fmaf(er, sv[3], fmaf(ei, sv[1], a[3]));
          }
          continue;
        }
        float ea, eb;
        if constexpr (SIGNED) {  // e1 = s1 exp(x1 - m1)
          float s1a, s1b;
          if constexpr (S1) {
            s1a = xs[R * BM + rr * BM + rw];
            s1b = xs[R * BM + rr * BM + rw + 8];
          } else {
            s1a = sa[rr];
            s1b = sb[rr];
          }
          ea = ra_in && row ? s1a * expf(xs[rr * BM + rw] - m1a) : 0.f;
          eb = rb_in && row ? s1b * expf(xs[rr * BM + rw + 8] - m1b) : 0.f;
        } else {
          ea = ra_in && row ? expf(xs[rr * BM + rw] - m1a) : 0.f;
          eb = rb_in && row ? expf(xs[rr * BM + rw + 8] - m1b) : 0.f;
        }
        wgmma_wait<0>();
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const float2 sc = SOFTMAX ? *reinterpret_cast<const float2*>(
                                          &wscl[((t & 1) * R + rr) * BN + 8 * n8 + 2 * t4])
                                    : make_float2(1.f, 1.f);
          float* a = acc + 4 * n8;
          const float* sv = s + 4 * n8;
          a[0] = fmaf(ea, sv[0], SOFTMAX ? a[0] * sc.x : a[0]);
          a[1] = fmaf(ea, sv[1], SOFTMAX ? a[1] * sc.y : a[1]);
          a[2] = fmaf(eb, sv[2], SOFTMAX ? a[2] * sc.x : a[2]);
          a[3] = fmaf(eb, sv[3], SOFTMAX ? a[3] * sc.y : a[3]);
        }
      }
      i = ni, jc = njc;
    }
    cp_async_wait<0>();
  };
  using Yes = std::true_type;
  using No = std::false_type;
  if (!vec) {
    run(No{}, No{});
  } else if constexpr (RAW16) {
    run(Yes{}, Yes{});
  } else {
    run(No{}, Yes{});
  }

  if (SOFTMAX) {
    // Each unit's normalizer: the 8 threads that converted its rows add
    // their shares by a fixed butterfly.
#pragma unroll
    for (int q = 0; q < VQ; ++q) {
      float p = part[q];
#pragma unroll
      for (int d = 1; d < TPU; d <<= 1) p += __shfl_xor_sync(0xffffffffu, p, d);
      if ((tid & (TPU - 1)) == 0) lsum[tid / TPU + (NT / TPU) * q] = logf(p);
    }
    __syncthreads();
  }

  // Epilogue: back to log space, masking the ragged batch and unit edges.
  float* outf = out + (size_t)f * B * O;
  if constexpr (CPLX) {  // log|y| + shift + i atan2(Im y, Re y); y = 0 gives (-inf, 0)
    const int r = cirkit::stacked_row(rw), b = b0 + r;
    if (b >= B) return;
    float2* outc = reinterpret_cast<float2*>(out) + (size_t)f * B * O;
    const float shift = m1s[r] + m2s[r];
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = o0 + 8 * n8 + 2 * t4 + e;
        const float re = acc[4 * n8 + e], im = acc[4 * n8 + 2 + e];
        if (o < O) outc[(size_t)b * O + o] = make_float2(logf(hypotf(re, im)) + shift,
                                                        atan2f(im, re));
      }
    return;
  }
  if constexpr (SIGNED) {  // (log|y| + shift, sign y); y = 0 gives (-inf, 0)
    // a thread's two adjacent units in one 8-byte store to each output where
    // O is even (o is even) and both outputs 8-byte aligned
    float* signf = out_sign + (size_t)f * B * O;
    const bool pairs = O % 2 == 0 && (reinterpret_cast<uintptr_t>(out) |
                                      reinterpret_cast<uintptr_t>(out_sign)) % 8 == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw + 8 * h, b = b0 + r;
      if (b >= B) continue;
      const float shift = m1s[r] + m2s[r];
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const int c = 8 * n8 + 2 * t4, o = o0 + c;
        float y[2], sg[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[4 * n8 + 2 * h + e];
          y[e] = logf(fabsf(v));
          if (SOFTMAX) y[e] -= lsum[c + e];
          y[e] += shift;
          sg[e] = (v > 0.f) - (v < 0.f);
        }
        const size_t k = (size_t)b * O + o;
        if (pairs && o < O) {
          *reinterpret_cast<float2*>(outf + k) = make_float2(y[0], y[1]);
          *reinterpret_cast<float2*>(signf + k) = make_float2(sg[0], sg[1]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (o + e < O) outf[k + e] = y[e], signf[k + e] = sg[e];
        }
      }
    }
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw + 8 * h, b = b0 + r;
    if (b >= B) continue;
    const float shift = m1s[r] + m2s[r];
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n8 + 2 * t4 + e, o = o0 + c;
        float y = logf(acc[4 * n8 + 2 * h + e]);
        if (SOFTMAX) y -= lsum[c];
        if (o < O) outf[(size_t)b * O + o] = y + shift;
      }
  }
}

template <int BM, bool SOFTMAX, typename WT, int MODE, bool SIGNED, bool CPLX>
int launch_blocks(const float* x1, const float* x2, const WT* w, float* out,
                  const CUtensorMap& wmap, bool vec, int F, int B, int K1, int K2, int O,
                  const float* s1, const float* s2, float* out_sign, cudaStream_t s) {
  using C = tb::Cfg<BM, WT, tb::s1_in_ring<SIGNED, SOFTMAX, WT>>;
  constexpr int BB = CPLX ? BM / 2 : BM;
  const long long n_ot = (O + tb::BN - 1) / tb::BN, n_bt = (B + BB - 1) / BB;
  const long long blocks = (long long)F * n_ot * n_bt;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = tucker_fwd_bf16<BM, SOFTMAX, WT, MODE, SIGNED, CPLX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), C::NT, C::SMEM, s>>>(
      x1, x2, w, out, wmap, B, K1, K2, O, static_cast<int>(n_ot), static_cast<int>(n_bt), vec,
      s1, s2, out_sign);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of 128 rows up to a batch of 128, of 256 past it, where each
// converted tile then serves twice the rows (CPLX: stacked rows, two a batch
// row, so blocks of 256 from a batch of 65: at the complex flagship's 128 a
// fold's weight is read and converted once). The weight goes through TMA
// where every row segment of K2 weights starts 16-byte aligned (a bf16 tile
// in the 128-byte swizzle), else the convert step reads it.
template <bool SOFTMAX, typename WT, int MODE, bool SIGNED = false, bool CPLX = false>
int launch_bf16(const float* x1, const float* x2, const WT* w, float* out, int F, int B, int K1,
                int K2, int O, int device, void* stream, const float* s1 = nullptr,
                const float* s2 = nullptr, float* out_sign = nullptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (K2 * sizeof(WT)) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  CUtensorMap wmap{};
  if (vec && (err = cirkit::weight_map(&wmap, w, F, K1, K2, O)) != cudaSuccess)
    return static_cast<int>(err);
  return (CPLX ? 2 * B : B) <= 128
             ? launch_blocks<128, SOFTMAX, WT, MODE, SIGNED, CPLX>(
                   x1, x2, w, out, wmap, vec, F, B, K1, K2, O, s1, s2, out_sign, s)
             : launch_blocks<256, SOFTMAX, WT, MODE, SIGNED, CPLX>(
                   x1, x2, w, out, wmap, vec, F, B, K1, K2, O, s1, s2, out_sign, s);
}

}  // namespace

extern "C" {

// The fast-mode instances of the Tucker forwards (ops/lse_einsum.py's
// INSTANCES), with the arguments of their f32-grade twins; the K1-chunked
// forward's fast instances (kernel 5) launch these entries too. The build
// compiles this source once for each part (-DCIRKIT_BF16_PART=0..8;
// ops/_build.py), side by side: parts 0-3 for each weight type and mode of
// these, 4-7 of the signed ones, 8 the complex ones. A build without the
// macro holds all of them.
#define TUCKER_BF16_ENTRIES(SUFFIX, WT, MODE)                                                   \
  int lse_fwd_tucker##SUFFIX(const float* x1, const float* x2, const WT* w, float* out, int F,  \
                             int B, int K1, int K2, int O, int device, void* stream) {          \
    return launch_bf16<false, WT, MODE>(x1, x2, w, out, F, B, K1, K2, O, device, stream);       \
  }                                                                                             \
  int lse_fwd_tucker_softmax##SUFFIX(const float* x1, const float* x2, const WT* theta,         \
                                     float* out, int F, int B, int K1, int K2, int O,           \
                                     int device, void* stream) {                                \
    return launch_bf16<true, WT, MODE>(x1, x2, theta, out, F, B, K1, K2, O, device, stream);    \
  }

#if !defined(CIRKIT_BF16_PART) || CIRKIT_BF16_PART == 0
TUCKER_BF16_ENTRIES(_fast, float, cirkit::BF16)
#endif
#if !defined(CIRKIT_BF16_PART) || CIRKIT_BF16_PART == 1
TUCKER_BF16_ENTRIES(_sr, float, cirkit::SR)
#endif
#if !defined(CIRKIT_BF16_PART) || CIRKIT_BF16_PART == 2
TUCKER_BF16_ENTRIES(_w16_fast, __nv_bfloat16, cirkit::BF16)
#endif
#if !defined(CIRKIT_BF16_PART) || CIRKIT_BF16_PART == 3
TUCKER_BF16_ENTRIES(_w16_sr, __nv_bfloat16, cirkit::SR)
#endif
#undef TUCKER_BF16_ENTRIES

// The fast-mode instances of the signed Tucker forwards (kernel 6',
// ops/slse_einsum.py), with the arguments of their f32-grade twins in
// csrc/lse_einsum.cu: parts 4-7, a part for each weight type and mode.
#define SLSE_BF16_ENTRIES(SUFFIX, WT, MODE)                                                     \
  int slse_fwd_tucker##SUFFIX(const float* a1, const float* s1, const float* a2,                \
                              const float* s2, const WT* w, float* oa, float* os, int F, int B, \
                              int K1, int K2, int O, int device, void* stream) {                \
    return launch_bf16<false, WT, MODE, true>(a1, a2, w, oa, F, B, K1, K2, O, device, stream,   \
                                              s1, s2, os);                                      \
  }                                                                                             \
  int slse_fwd_tucker_softmax##SUFFIX(const float* a1, const float* s1, const float* a2,        \
                                      const float* s2, const WT* theta, float* oa, float* os,   \
                                      int F, int B, int K1, int K2, int O, int device,          \
                                      void* stream) {                                           \
    return launch_bf16<true, WT, MODE, true>(a1, a2, theta, oa, F, B, K1, K2, O, device,        \
                                             stream, s1, s2, os);                               \
  }

#if !defined(CIRKIT_BF16_PART) || CIRKIT_BF16_PART == 4
SLSE_BF16_ENTRIES(_fast, float, cirkit::BF16)
#endif
#if !defined(CIRKIT_BF16_PART) || CIRKIT_BF16_PART == 5
SLSE_BF16_ENTRIES(_sr, float, cirkit::SR)
#endif
#if !defined(CIRKIT_BF16_PART) || CIRKIT_BF16_PART == 6
SLSE_BF16_ENTRIES(_w16_fast, __nv_bfloat16, cirkit::BF16)
#endif
#if !defined(CIRKIT_BF16_PART) || CIRKIT_BF16_PART == 7
SLSE_BF16_ENTRIES(_w16_sr, __nv_bfloat16, cirkit::SR)
#endif
#undef SLSE_BF16_ENTRIES

// The fast-mode instances of the complex64 Tucker forward against a real
// weight (kernel 10', ops/clse_einsum.py's fwd_entry), with the arguments of
// clse_fwd_tucker_rw (csrc/lse_einsum.cu): part 8.
#if !defined(CIRKIT_BF16_PART) || CIRKIT_BF16_PART == 8
int clse_fwd_tucker_rw_fast(const void* x1, const void* x2, const float* w, void* out, int F,
                            int B, int K1, int K2, int O, int device, void* stream) {
  return launch_bf16<false, float, cirkit::BF16, false, true>(
      static_cast<const float*>(x1), static_cast<const float*>(x2), w, static_cast<float*>(out),
      F, B, K1, K2, O, device, stream);
}
int clse_fwd_tucker_rw_sr(const void* x1, const void* x2, const float* w, void* out, int F,
                          int B, int K1, int K2, int O, int device, void* stream) {
  return launch_bf16<false, float, cirkit::SR, false, true>(
      static_cast<const float*>(x1), static_cast<const float*>(x2), w, static_cast<float*>(out),
      F, B, K1, K2, O, device, stream);
}
#endif

}  // extern "C"
