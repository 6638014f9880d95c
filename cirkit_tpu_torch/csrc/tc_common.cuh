// Tensor-core primitives shared by the float32 kernels that run their sums
// of products as 3xTF32 warp-level mma.sync.m16n8k8 (csrc/lse_einsum_bwd.cu
// section 6, csrc/lse_wide.cu): the TF32 split of an f32 operand into a
// high part and its rounded remainder, the mma itself, the fragment loop of
// section 6 (operands staged as f32, split as the warps read them), the
// 3xTF32 product of fragments split once when they were staged (high and low
// parts in planes of their own, so each fragment register is loaded where
// the mma reads it, with no moves between registers), asynchronous copies
// to shared memory, and accumulator zeroing; and the bf16 wgmma of the fast
// modes' Tucker forwards and backward and of the bf16-weight and fast-mode
// blocked dense kernels with its shared-memory layout, the TMA copies and
// the mbarriers they complete on (csrc/tucker_bf16.cu,
// csrc/tucker_bf16_bwd.cu, csrc/blocked_bf16.cu).
//
// A fragment of m16n8k8 with g = lane / 4, t = lane % 4: A (16 x 8, rows
// m, columns k) holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B
// (8 x 8, rows k, columns n) holds (t, g), (t + 4, g); the accumulator
// (16 x 8) holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "lse_common.cuh"

namespace cirkit {

// The speed modes of the float32 kernels (CIRKIT_TPU_FAST, read by the
// Python wrappers): f32-grade 3xTF32, or one pass over operands rounded to
// bf16, to the nearest (BF16) or stochastically (SR): on the bf16 tensor
// cores in the Tucker forwards (csrc/tucker_bf16.cu), one TF32 pass in the
// other tensor-core kernels. A product of two bf16 values is exact in TF32,
// so either pass is bf16 x bf16 with f32 accumulation.
enum Mode : int { F32 = 0, BF16 = 1, SR = 2 };
// The operand roles of SR's bits (ops/lse_einsum.py's ROLE_*): the forward's
// exponentials and weights, the backward's gy, weights and exponentials.
enum Role : uint32_t { ROLE_E = 0, ROLE_W = 1, ROLE_GY = 2, ROLE_WB = 3, ROLE_EB = 4 };

// SR's 16 random bits for the element at flat index ``idx`` of an operand of
// ``role``: a murmur3 finalizer over both halves of the index and the role,
// stateless, so a call repeats bit for bit (ops/lse_einsum.py's sr_bits).
__device__ __forceinline__ uint32_t sr_bits(unsigned long long idx, uint32_t role) {
  uint32_t h = static_cast<uint32_t>(idx) * 0x9E3779B1u +
               static_cast<uint32_t>(idx >> 32) * 0x85EBCA77u + (role + 1u) * 0xC2B2AE3Du;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h >> 16;
}

// v rounded to bf16 as MODE rounds an operand, kept f32: to the nearest even
// (BF16), or (SR) with sr_bits added below the bf16 cut of the f32 pattern
// and the low 16 bits cut (Hopper has no cvt.rs to bf16).
template <int MODE>
__device__ __forceinline__ float round_op(float v, unsigned long long idx, uint32_t role) {
  if constexpr (MODE == BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else if constexpr (MODE == SR) {
    return __uint_as_float((__float_as_uint(v) + sr_bits(idx, role)) & 0xFFFF0000u);
  } else {
    return v;
  }
}

// round_op for a kernel's scalar type T: the f32-grade mode (the only one of
// the double instances) leaves v as it is, with no use of the index.
template <int MODE, typename T>
__device__ __forceinline__ T round_t(T v, unsigned long long idx, uint32_t role) {
  if constexpr (MODE == F32) {
    return v;
  } else {
    return round_op<MODE>(v, idx, role);
  }
}

// The exponential of an operand a fast mode rounds: the accurate expf, so the
// rounded value is the plain version's (torch.exp); the fast one elsewhere.
template <int MODE>
__device__ __forceinline__ float mode_exp(float x) {
  return MODE == F32 ? fast_exp(x) : expf(x);
}

// The complex Tucker backward against a real weight runs real products over
// stacked planes: batch row b's real plane at row stacked_at(b) = 16 (b / 8)
// + b % 8 and its imaginary plane 8 rows below, so that the accumulator rows
// g and g + 8 that a thread holds in mma.sync's and wgmma's fragments are one
// batch row's two planes; stacked_row(s) is the batch row of stacked row s.
__host__ __device__ __forceinline__ int stacked_at(int b) { return 16 * (b >> 3) + (b & 7); }
__host__ __device__ __forceinline__ int stacked_row(int s) { return ((s >> 4) << 3) | (s & 7); }

// exp(re) (cos im + i sin im) with the accurate expf and sincosf (the plain
// versions' torch.exp, cos and sin); re = -inf gives 0.
__device__ __forceinline__ void cexp_f32(float re, float im, float* er, float* ei) {
  const float mag = expf(re);
  float sn, cs;
  sincosf(im, &sn, &cs);
  *er = mag * cs;
  *ei = mag * sn;
}

// dx = conj(e) (the sum of the n complex partial planes of the dx sums, in
// plane order; plane p of input h at (p F B + row) K + k) for both inputs of a
// complex Tucker backward (a null part skips one), conj(e) = exp(conj(x) - m)
// with the row shifts sa, sb; a warp per batch row, eight rows a block. The
// finish of the complex Tucker backward's partial dx on the tensor cores
// (csrc/lse_einsum_bwd.cu's launch_cbwd_tc, csrc/tucker_bf16_bwd.cu's CPLX
// products); a template, so that each source holds its own instance.
template <int ROWS = 8>
__global__ void __launch_bounds__(32 * ROWS)
cplx_dx_finish(const float2* __restrict__ x1, const float2* __restrict__ x2,
               const float* __restrict__ sa, const float* __restrict__ sb,
               const float2* __restrict__ part1, const float2* __restrict__ part2,
               float2* __restrict__ dx1, float2* __restrict__ dx2, int F, int B, int K1, int K2,
               int n1, int n2) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y * ROWS + (threadIdx.x >> 5);
  if (b >= B) return;
  const size_t row = (size_t)blockIdx.x * B + b, plane = (size_t)F * B;
  const float2* xs[2] = {x1, x2};
  const float2* parts[2] = {part1, part2};
  float2* dxs[2] = {dx1, dx2};
  const float ms[2] = {sa[row], sb[row]};
  const int ks[2] = {K1, K2}, ns[2] = {n1, n2};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (parts[h] == nullptr || dxs[h] == nullptr) continue;
    const int K = ks[h];
    for (int k = lane; k < K; k += 32) {
      float ar = 0.f, ai = 0.f;
      for (int p = 0; p < ns[h]; ++p) {
        const float2 v = parts[h][(p * plane + row) * K + k];
        ar += v.x, ai += v.y;
      }
      const float2 z = xs[h][row * K + k];
      float er, ei;  // conj(e)
      cexp_f32(z.x - ms[h], -z.y, &er, &ei);
      dxs[h][row * K + k] = make_float2(er * ar - ei * ai, er * ai + ei * ar);
    }
  }
}

// An operand that mma_k8 reads as it is staged.
struct Unrounded {
  __device__ __forceinline__ float operator()(int, int, float v) const { return v; }
};

namespace tc {
constexpr int BK = 16;   // contraction chunk staged in shared memory (two k-steps of 8)
constexpr int PAD = 8;   // row strides of 8 mod 32 words: a fragment load hits 32 banks
constexpr int WT = 32;   // a warp's output tile, WT x WT: 2 x 4 mma tiles of 16 x 8
constexpr int MT = WT / 16;
constexpr int NT = WT / 8;
}  // namespace tc

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (lo the rounded remainder).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The bf16 tensor cores through wgmma (the fast modes' Tucker forwards,
// csrc/tucker_bf16.cu). Operands are K-major bf16 tiles of 128-byte rows
// (64 values) in shared memory, in the 128-byte swizzle: the 16-byte chunk
// c of row r sits at chunk c ^ (r % 8) of its row, each tile 1024-byte
// aligned. sw128 is the byte offset of element (r, c) in such a tile.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1);
}

// wgmma's matrix descriptor of such a tile at shared address ``saddr``: the
// 8-row groups 1024 bytes apart (SBO), the 128-byte swizzle; the k16 slice
// s of the tile is the descriptor plus 2 s (32 bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The descriptor of such a tile read MN-major (wgmma's transposed operand,
// 16-bit types only): its rows are the contraction index k, its 64 columns
// the rows of A or the columns of B (one swizzle atom wide), the 8-row
// groups of k 1024 bytes apart; the k16 slice s starts 2048 s bytes in.
// Both offsets are set to 1024 bytes, since with one atom across only the
// k groups' is read.
__device__ __forceinline__ uint64_t sw128_desc_mn(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (the warpgroup's 64 x 64 f32 tile) = a b, plus d where ``acc``: A 64 x
// 16 and B 16 x 64 from their descriptors. Warp w of the warpgroup holds
// rows 16 w + g and 16 w + g + 8 (g = lane / 4), d[4 n + 0..1] at columns
// 8 n + 2 t, + 1 of the first and d[4 n + 2..3] of the second (t = lane %
// 4), as mma_tf32's accumulator for each n-tile of 8.
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64) = a b, plus d where ``acc``, with B read MN-major
// (sw128_desc_mn): A 64 x 16 K-major, B 16 x 64 from a tile whose rows are k.
__device__ __forceinline__ void wgmma_64x64_tb(float (&d)[32], uint64_t da, uint64_t db,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 32) = a b, plus d where ``acc``, with A read MN-major
// (sw128_desc_mn: a tile whose rows are k and whose 64 columns are A's
// rows) and B 16 x 32 K-major. Warp w of the warpgroup holds rows 16 w + g
// and 16 w + g + 8, d[4 n + 0..1] and d[4 n + 2..3] at columns 8 n + 2 t, + 1.
__device__ __forceinline__ void wgmma_64x32_ta(float (&d)[16], uint64_t da, uint64_t db,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64) = a b, plus d where ``acc``, with both operands read MN-major
// (sw128_desc_mn): A from a tile whose rows are k and whose 64 columns are
// A's rows, B from a tile whose rows are k and whose 64 columns are B's.
__device__ __forceinline__ void wgmma_64x64_tt(float (&d)[32], uint64_t da, uint64_t db,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (the warpgroup's 64 x 128 f32 tile) = a b, plus d where ``acc``: A 64 x
// 16 from registers, B 16 x 128 K-major from its descriptor. Warp w of the
// warpgroup passes rows 16 w + g and 16 w + g + 8 of A as mma.m16n8k16's A
// fragment (g = lane / 4, t = lane % 4): a[0] the first row's columns 2t,
// 2t + 1, a[1] the second row's, a[2] and a[3] the same at 2t + 8, 2t + 9.
// d as wgmma_64x64's, for n-tiles 0..15. The registers of ``a`` must hold
// their values until the wgmma_wait that retires this product.
__device__ __forceinline__ void wgmma_64x128_ra(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// Registers that an asynchronous wgmma writes (or reads), pinned: reads of
// them are not moved above the wgmma_wait that precedes this, nor their
// last use below it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) asm volatile("" : "+f"(d[k])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) asm volatile("" : "+r"(d[k])::"memory");
}

// wgmma's ordering: the fence before a batch (its registers were touched by
// other instructions), the commit of a group, the wait until at most N
// groups are pending;
// and the proxy fence that makes this thread's shared-memory writes (stores
// and completed cp.async copies) visible to wgmma's reads after a barrier.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Two f32 values rounded to the nearest bf16, as a pair (the first in the
// low half): one instruction.
__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Eight f32 values rounded as MODE rounds an operand (flat indices idx, idx
// + step, ... of role ``role``), packed as eight bf16 (the first in the low
// half); the nearest rounding by pairs, which needs no index.
template <int MODE>
__device__ __forceinline__ uint4 pack_bf16x8(const float (&v)[8], unsigned long long idx,
                                             uint32_t role, unsigned long long step = 1) {
  if constexpr (MODE == BF16) {
    return make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]), bf16x2(v[4], v[5]),
                      bf16x2(v[6], v[7]));
  } else {
    uint32_t h[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      h[e] = __float_as_uint(round_op<MODE>(v[e], idx + e * step, role)) >> 16;
    return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                      h[6] | (h[7] << 16));
  }
}

// The shared-memory mbarrier at ``bar``: set up for one arrival (or
// ``count``); a plain arrival; the arrival that expects ``bytes`` of TMA
// copies; a wait for phase ``parity``, which traps after some 8 seconds (2^34
// cycles), so a fault that loses an arrival ends the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

// The TMA copy of the box of ``map`` at coordinates (c0, c1, c2[, c3]),
// innermost first, to shared address ``dst``, completing on ``bar``.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// cuTensorMapEncodeTiled of libcuda, reached through the runtime's entry
// point query (no link to libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// The tensor map of a ``rank``-dimensional array of element type T at
// ``base`` (dims and box innermost first, the strides of the outer dims in
// bytes, each a multiple of 16), its boxes zero past the edges; a box of
// 128-byte rows in the 128-byte swizzle (wgmma's layout for bf16), any other
// in plain rows.
template <typename T>
inline cudaError_t tiled_map(CUtensorMap* map, const T* base, int rank, const cuuint64_t* dims,
                             const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled encode;
  const cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const bool swizzle = box[0] * sizeof(T) == 128;
  const cuuint32_t steps[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      rank, const_cast<T*>(base), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of a Tucker weight (F, O, K1*K2) of element type WT, seen
// as (F, O, K1, K2): boxes of 64 units x 64 columns j of one row i (a bf16
// box in the 128-byte swizzle, a float32 one in plain rows). Every row of K2
// weights must start 16-byte aligned.
template <typename WT>
inline cudaError_t weight_map(CUtensorMap* map, const WT* w, int F, int K1, int K2, int O) {
  const cuuint64_t es = sizeof(WT);
  const cuuint64_t dims[4] = {(cuuint64_t)K2, (cuuint64_t)K1, (cuuint64_t)O, (cuuint64_t)F};
  const cuuint64_t strides[3] = {K2 * es, (cuuint64_t)K1 * K2 * es, (cuuint64_t)O * K1 * K2 * es};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  return tiled_map(map, w, 4, dims, strides, box);
}

// acc += A B over the 8 contraction rows k..k+7 of a staged chunk, 3xTF32:
// As[k][m] holds A (rows m), k-major, or with AROW As[m][k], row-major, and
// Bs[k][n] holds B, k-major; the warp's tile starts at row wm, column wn.
// B's rows k + t and k + t + 4 (t = lane % 4) are read as they are (BMODE
// 0), scaled by s0 and s1 (1), or as exp(B - s0) and exp(B - s1) (2).
// Fragment (mt, nt, r) holds row wm + 16 mt + g + 8 (r >> 1), column wn +
// 8 nt + 2 t + (r & 1), with g = lane / 4.
//
// A_SPLIT and B_SPLIT say which operands are split: an operand exact in
// TF32 (a bf16 weight, or one the fast modes rounded to bf16) has a low part
// of 0, and the products with it are dropped: 3xTF32 where both are split,
// two products where one is, one where neither is. B's elements may be
// stored as BT (float, or bf16 widened as read). ``ra(m, k, v)`` and
// ``rb(k, n, v)`` round the operands formed here (the fast modes; the
// staging coordinates of the element) before the products.
template <int AS, int BS, int BMODE = 0, bool AROW = false, bool A_SPLIT = true,
          bool B_SPLIT = true, typename BT = float, class RA = Unrounded, class RB = Unrounded>
__device__ __forceinline__ void mma_k8(const float (*As)[AS], const BT (*Bs)[BS], int k,
                                       int wm, int wn, int lane, float s0, float s1,
                                       float (&acc)[tc::MT][tc::NT][4], RA ra = RA(),
                                       RB rb = RB()) {
  constexpr int MT = tc::MT, NT = tc::NT;
  const int g = lane >> 2, t = lane & 3;
  auto a = [&](int m, int kk) { return ra(m, kk, AROW ? As[m][kk] : As[kk][m]); };
  auto b = [&](int kk, int c, float sh) {
    const float v = widen(Bs[kk][c]);
    return rb(kk, c, BMODE == 1 ? v * sh : BMODE == 2 ? fast_exp(v - sh) : v);
  };
  uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = wm + mt * 16 + g;
    if (!A_SPLIT) {
      ahi[mt][0] = to_tf32(a(r, k + t));
      ahi[mt][1] = to_tf32(a(r + 8, k + t));
      ahi[mt][2] = to_tf32(a(r, k + t + 4));
      ahi[mt][3] = to_tf32(a(r + 8, k + t + 4));
    } else {
      split_tf32(a(r, k + t), ahi[mt][0], alo[mt][0]);
      split_tf32(a(r + 8, k + t), ahi[mt][1], alo[mt][1]);
      split_tf32(a(r, k + t + 4), ahi[mt][2], alo[mt][2]);
      split_tf32(a(r + 8, k + t + 4), ahi[mt][3], alo[mt][3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    uint32_t bhi[2], blo[2];
    const int c = wn + nt * 8 + g;
    if (B_SPLIT) {
      split_tf32(b(k + t, c, s0), bhi[0], blo[0]);
      split_tf32(b(k + t + 4, c, s1), bhi[1], blo[1]);
    } else {
      bhi[0] = to_tf32(b(k + t, c, s0));
      bhi[1] = to_tf32(b(k + t + 4, c, s1));
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {  // the small products first
      if (A_SPLIT) mma_tf32(acc[mt][nt], alo[mt], bhi);
      if (B_SPLIT) mma_tf32(acc[mt][nt], ahi[mt], blo);
      mma_tf32(acc[mt][nt], ahi[mt], bhi);
    }
  }
}

// Asynchronous copies global -> shared (cp.async) of one float or of four
// (16-byte aligned at both ends), zero-filled where ``pred`` is false (``src``
// must still be a valid address), committed in groups and waited for by
// group.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_f32x4(float* dst, const float* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void zero_acc(float (&acc)[tc::MT][tc::NT][4]) {
#pragma unroll
  for (int mt = 0; mt < tc::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < tc::NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
}

// d += a b in 3xTF32 from split fragments, the small products first. The
// high and low parts of each operand come from separate planes in shared
// memory, so every fragment register is loaded where the mma reads it.
__device__ __forceinline__ void mma3_tf32(float (&d)[4], const uint32_t (&ahi)[4],
                                          const uint32_t (&alo)[4], const uint32_t (&bhi)[2],
                                          const uint32_t (&blo)[2]) {
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

// The four values of v split as split_tf32 does: their high parts and their
// low parts, each as four 32-bit words.
__device__ __forceinline__ void split_tf32x4(const float4& v, uint4& hi, uint4& lo) {
  split_tf32(v.x, hi.x, lo.x);
  split_tf32(v.y, hi.y, lo.y);
  split_tf32(v.z, hi.z, lo.z);
  split_tf32(v.w, hi.w, lo.w);
}

}  // namespace cirkit
