// Max-product and routing kernels of the arity-2 Tucker layer for Hopper
// (sm_90a): the upward max-plus contraction of MAP and the downward choice
// of one composite index per (fold, row) for MAP and sampling.
//
// Replaces two Pallas TPU kernels of cirkit_tpu/ops/lse_einsum.py:
//
//   tropical_tucker: `_tropical_kernel` (dispatched by `tropical_tucker2`)
//     out[f,b,o] = max_m lw[f,o,m] + x1[f,b,m/K2] + x2[f,b,m%K2]
//     lw = log_softmax(theta) over m (log_weights) or log(w) (linear weights)
//
//   route_tucker: `_route_kernel` (dispatched by `route_tucker2`)
//     out[f,b] = argmax_m s[m] (max kind), or a draw from softmax(s) (sample
//     kind; the TPU kernel draws it by Gumbel-max),
//     s[m] = (x1[f,b,m/K2] + x2[f,b,m%K2]) + lw[f, sel[f,b], m]
//     lw = the raw logits (log_weights: a row constant cannot change the
//     choice) or log(w).
//
// Neither carries the TPU's workarounds: no bf16 three-term splits, no 0/1
// selector matmuls, no indices in f32, no -1e30 floors (in f32 with no split
// a -inf score simply loses), and any K1, K2, O >= 1 and ragged batch.
//
// tropical_tucker is the max-plus twin of the forward kernel (lse_einsum.cu):
// a block of 256 threads covers (fold, 64 output units, 128 batch rows) and
// a range of the composite index m, each thread holding an 8x4 tile of
// running maxima in registers. There is no tensor-core form of (max, +), so
// it runs on the f32 cores: an FADD and an FMNMX per term, bound by
// instruction issue (26 G terms at the flagship's largest entry, F=784,
// B=128, O=64, M=4096), not by its 822 MB of logits read once per batch
// tile. What keeps it near that bound:
//   - the grid evens out the SMs at every fold count: where the fold, unit
//     and batch tiles would leave SMs idle or unevenly loaded (the
//     flagship's Tucker entries have F = 784, 392, ..., 2), m is split into
//     S ranges of whole chunks (S from ops/routing.py's _trop_splits; one
//     block keeps an SM busy), each block writing its partial max to an
//     (S, F, B, O) scratch that `tropical_finish` reduces. Max is exact, so
//     with linear weights a split result equals the unsplit one bit for bit;
//   - the loop: the composite x1[i] + x2[j] and the log weights are staged
//     16 columns (8 in double) at a time into one of two shared tiles while
//     the other is reduced, one barrier per chunk; the next chunk's loads
//     are issued into registers before the current chunk's reduction and
//     consumed after it; (i, j) steps with the column, no division; where
//     K2 allows (VEC), a thread stages 8 neighbouring columns of one batch
//     row (x1 once, x2 in 16-byte reads) and 4 of one unit's weights (one
//     16-byte read), so staging costs a tenth of the loop's instructions;
//   - the softmax normalizer of each logits row is kept while staging (a
//     running max and sum of exp per unit, merged across the threads that
//     stage a unit's columns), not in a prologue that reads the row again;
//     with a split, `tropical_lse` merges the splits' pairs by log-sum-exp.
//     It is subtracted after the max. A unit whose logits are all -inf
//     gives -inf.
//
// route_tucker gives a team of 1 to 8 warps to each (fold, row) (the wrapper
// picks the team so that few rows still fill the card), stages the row's x1
// and x2 in shared memory, reads the selected weight row four columns at a
// time and walks (i, j) with no division; where K1 and K2 are multiples of
// 4 and the row is aligned (QUAD), a group of four columns is one 16-byte
// read of the weights, coalesced across the warp, and one of x2. The max
// kind keeps the best (score, index) pair with the lower index winning a
// tie (jnp.argmax's first match); a row whose scores are all -inf or NaN
// gives index 0. The sample kind draws by the inverse CDF: each lane keeps
// a running max and sum of exp over its columns (in float32 the fast base-2
// exponential), the team takes the row's max, the lanes' sums in that scale
// and their prefix; one uniform u per (fold, row), from one Philox4x32-10
// call keyed by the 64-bit seed with counter (row, fold), gives the target
// u S; the lane whose share of the prefix holds it is rescanned by its
// warp, in the order it summed its columns, and the first column whose
// running sum reaches the target is returned (past the total by rounding:
// the lane's last column with mass; a column of -inf or NaN score, zero
// mass, is never returned). The law is softmax(s), as the TPU kernel's
// Gumbel-max; the f32 sum truncates the far tail near 2^-24 of the mass. A
// selected weight row is 16 KB at the flagship, read from L2 (a fold's rows
// fit) once per (fold, row): bound by the bytes of the rows the selection
// reads.
//
// Both kernels are templates over their scalar type T, float or double (the
// entries with _f64); a double tropical block is alone on its SM and stages
// 8 columns a chunk. The route's Philox bits give 24 bits of uniform in
// float, 53 in double. Their weight type WT is T, or bf16 beside float (the
// _w16 entries: the serving store's logits or weights, as the TPU kernels
// take a bf16 th): the kernels read th as stored (8-byte loads of four
// values where the float instance makes 16-byte ones) and widen each value
// exactly before any arithmetic, so every sum, max and comparison is the
// float instance's on the widened th, and the results equal its run on the
// widened weights to the bit. There is no fast mode: the TPU kernels run
// their three-term split in every mode.
//
// Each extern "C" entry selects the given device, launches on the given
// stream and returns cudaGetLastError() of the launches (0 on success).

#include <cfloat>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "lse_common.cuh"

namespace {

// ------------------------------------------------------------------------
// tropical_tucker
// ------------------------------------------------------------------------

constexpr int BM = 128;  // batch rows per block
constexpr int BN = 64;   // output units per block
constexpr int TM = 8;    // batch rows per thread
constexpr int TN = 4;    // output units per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int AS = BM + 4;  // padded strides keep float4 reads aligned
constexpr int BS = BN + 4;

// Composite columns staged per chunk, and the blocks an SM holds: two double
// buffers of 8 double columns stay under 48 KB of static shared memory.
template <typename T>
struct Trop;
template <>
struct Trop<float> {
  static constexpr int BK = 16, MIN_BLOCKS = 2;
};
template <>
struct Trop<double> {
  static constexpr int BK = 8, MIN_BLOCKS = 1;
};

// Two running (max, sum) pairs merged by log-sum-exp; (-inf, 0) is empty.
template <typename T>
__device__ __forceinline__ void stats_merge(T& mx, T& sum, T mx2, T sum2) {
  const T m = cirkit::max_t(mx, mx2);
  if (m == -INFINITY) return;
  sum = sum * cirkit::fast_exp(mx - m) + sum2 * cirkit::fast_exp(mx2 - m);
  mx = m;
}

// The log normalizer of a merged pair; 0 for a unit with no mass, whose max
// is -inf already.
template <typename T>
__device__ __forceinline__ T stats_lse(T mx, T sum) {
  return sum > T(0) ? mx + cirkit::log_t(sum) : T(0);
}

// Several logits of one unit into its running (max, sum of exp(v - max)):
// the group's max first, so the sum is rescaled at most once a group.
template <int N, typename T>
__device__ __forceinline__ void stats_add_n(const T* v, T& mx, T& sum) {
  T gm = v[0];
#pragma unroll
  for (int c = 1; c < N; ++c) gm = cirkit::max_t(gm, v[c]);
  if (gm > mx) {
    sum *= cirkit::fast_exp(mx - gm);
    mx = gm;
  }
  if (mx > -INFINITY)
#pragma unroll
    for (int c = 0; c < N; ++c) sum += cirkit::fast_exp(v[c] - mx);
}

// N neighbouring values from 16-byte aligned device memory (N a multiple of
// 16 bytes; bf16: four values a load, 8-byte aligned, widened).
template <int N>
__device__ __forceinline__ void load_n(const float* p, float* v) {
#pragma unroll
  for (int c = 0; c < N; c += 4) cirkit::load4(p + c, v + c);
}
template <int N>
__device__ __forceinline__ void load_n(const double* p, double* v) {
#pragma unroll
  for (int c = 0; c < N; c += 2) {
    const double2 t = *reinterpret_cast<const double2*>(p + c);
    v[c] = t.x, v[c + 1] = t.y;
  }
}
template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float* v) {
#pragma unroll
  for (int c = 0; c < N; c += 4) {
    const float4 t = cirkit::load_w4(p + c);
    v[c] = t.x, v[c + 1] = t.y, v[c + 2] = t.z, v[c + 3] = t.w;
  }
}

// grid (F * S, ceil(O / BN), ceil(B / BM)): block (f, split) reduces the
// composite columns [split * span, min(M, (split + 1) * span)). With S = 1
// it writes out (minus the normalizer); else its partial max to part
// (S, F, B, O) and, from the first batch tile, its logits' running pairs to
// stats (2, S, F, O): maxima, then sums.
//
// Staging. VEC (K2 a multiple of A_COLS, x2 and th 16-byte aligned): a
// thread stages A_COLS neighbouring columns of one batch row, x1[b, i] once
// and x2[b, j .. j + A_COLS) in 16-byte reads (one i, since K2 is a
// multiple of A_COLS), and W_COLS neighbouring columns of one unit's row in
// one or two 16-byte reads, whose running (max, sum) it keeps alone.
// Otherwise thread tid stages column tid % BK of the rows and units
// tid / BK + n * (THREADS / BK), element by element.
template <typename T, bool LOGW, bool VEC, typename WT = T>
__global__ void __launch_bounds__(THREADS, Trop<T>::MIN_BLOCKS)
tropical_tucker_kernel(const T* __restrict__ x1,   // (F,B,K1)
                       const T* __restrict__ x2,   // (F,B,K2)
                       const WT* __restrict__ th,  // (F,O,K1*K2) logits or weights
                       T* __restrict__ out,       // (F,B,O)
                       T* __restrict__ part, T* __restrict__ stats, int F, int B, int K1,
                       int K2, int O, int S, int span) {
  constexpr int BK = Trop<T>::BK;
  constexpr int RSTEP = THREADS / BK;  // element map: rows (units) a pass covers
  constexpr int A_PER = VEC ? 1 : BM / RSTEP;
  constexpr int W_PER = VEC ? 1 : BN / RSTEP;
  constexpr int A_COLS = VEC ? BK * BM / THREADS : 1;  // vector map: columns a thread stages
  constexpr int W_COLS = VEC ? BK * BN / THREADS : 1;
  constexpr int A_THR = BK / A_COLS;  // threads a batch row (unit) takes
  constexpr int W_THR = BK / W_COLS;
  __shared__ __align__(16) T As[2][BK][AS];  // composite x1[i] + x2[j], k-major
  __shared__ __align__(16) T Bs[2][BK][BS];  // logits or log weights, k-major
  __shared__ T lse[BN];                      // S = 1 with logits: row normalizers

  const int M = K1 * K2;
  const int f = blockIdx.x / S;
  const int split = blockIdx.x - f * S;
  const int o0 = blockIdx.y * BN;
  const int b0 = blockIdx.z * BM;
  const int tid = threadIdx.x;
  const long long k_begin = (long long)split * span;
  const int k_end = (int)(k_begin + span < M ? k_begin + span : M);
  const int nchunks = k_begin < k_end ? (int)((k_end - k_begin + BK - 1) / BK) : 0;

  const T* x1f = x1 + (size_t)f * B * K1;
  const T* x2f = x2 + (size_t)f * B * K2;
  const WT* thf = th + (size_t)f * O * M;

  // Staging coordinates: the first row (unit) and column this thread stages.
  const int arow = VEC ? tid / A_THR : tid / BK;
  const int acol = VEC ? tid % A_THR * A_COLS : tid % BK;
  const int wrow = VEC ? tid / W_THR : tid / BK;
  const int wcol = VEC ? tid % W_THR * W_COLS : tid % BK;
  int ka = (int)k_begin + acol;  // the staged composite column and its (i, j)
  int ci = ka / K2;
  int cj = ka - ci * K2;
  int kw = (int)k_begin + wcol;  // the staged weight column
  const int di = BK / K2;
  const int dj = BK - di * K2;

  T r1[A_PER], r2[A_PER * A_COLS], rw[W_PER * W_COLS];  // the next chunk's loads
  T smx[W_PER], ssum[W_PER];  // logits: running (max, sum) per unit
#pragma unroll
  for (int n = 0; n < W_PER; ++n) smx[n] = -INFINITY, ssum[n] = T(0);

  auto load = [&]() {
#pragma unroll
    for (int n = 0; n < A_PER; ++n) {
      const int b = b0 + arow + n * RSTEP;
      const bool ok = ka < k_end && b < B;
      r1[n] = ok ? x1f[(size_t)b * K1 + ci] : -INFINITY;
      if constexpr (VEC) {
        if (ok)
          load_n<A_COLS>(x2f + (size_t)b * K2 + cj, r2);
        else
#pragma unroll
          for (int c = 0; c < A_COLS; ++c) r2[c] = T(0);
      } else {
        r2[n] = ok ? x2f[(size_t)b * K2 + cj] : T(0);
      }
    }
#pragma unroll
    for (int n = 0; n < W_PER; ++n) {
      const int o = o0 + wrow + n * RSTEP;
      const bool ok = kw < k_end && o < O;
      if constexpr (VEC) {
        if (ok)
          load_n<W_COLS>(thf + (size_t)o * M + kw, rw);
        else
#pragma unroll
          for (int c = 0; c < W_COLS; ++c) rw[c] = LOGW ? -INFINITY : T(0);
      } else {
        rw[n] = ok ? cirkit::widen(thf[(size_t)o * M + kw]) : (LOGW ? -INFINITY : T(0));
      }
    }
  };
  // the loaded values are used only here, after the current chunk's
  // reduction, so their latency hides behind it
  auto store = [&](int buf) {
#pragma unroll
    for (int n = 0; n < A_PER; ++n)
#pragma unroll
      for (int c = 0; c < A_COLS; ++c)
        As[buf][acol + c][arow + n * RSTEP] = r1[n] + r2[n * A_COLS + c];
    if (LOGW) {
      if constexpr (VEC)
        stats_add_n<W_COLS>(rw, smx[0], ssum[0]);
      else
#pragma unroll
        for (int n = 0; n < W_PER; ++n) stats_add_n<1>(rw + n, smx[n], ssum[n]);
    }
#pragma unroll
    for (int n = 0; n < W_PER; ++n)
#pragma unroll
      for (int c = 0; c < W_COLS; ++c) {
        const T w = rw[n * W_COLS + c];
        // log(0) = -inf: a zero weight never wins
        Bs[buf][wcol + c][wrow + n * RSTEP] = LOGW ? w : cirkit::log_t(w);
      }
  };
  auto advance = [&]() {
    ka += BK;
    kw += BK;
    ci += di;
    cj += dj;
    if (cj >= K2) {
      cj -= K2;
      ++ci;
    }
  };

  const int tx = tid % (BN / TN);  // output-unit group
  const int ty = tid / (BN / TN);  // batch-row group
  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = -INFINITY;

  load();
  store(0);
  __syncthreads();
  for (int c = 0; c < nchunks; ++c) {
    const int cur = c & 1;
    const bool more = c + 1 < nchunks;
    if (more) {
      advance();
      load();
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[TM], bb[TN];
      cirkit::load4(&As[cur][kk][ty * TM], a);
      cirkit::load4(&As[cur][kk][ty * TM + 4], a + 4);
      cirkit::load4(&Bs[cur][kk][tx * TN], bb);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = cirkit::max_t(acc[i][j], a[i] + bb[j]);
    }
    if (more) store(cur ^ 1);
    __syncthreads();  // one barrier a chunk: the other buffer is written and this one read
  }

  // the W_THR threads that staged a unit's columns are neighbouring lanes
  constexpr int SHARERS = VEC ? W_THR : BK;
  if (LOGW) {
#pragma unroll
    for (int n = 0; n < W_PER; ++n)
#pragma unroll
      for (int d = SHARERS / 2; d > 0; d >>= 1) {
        const T m2 = __shfl_xor_sync(0xffffffffu, smx[n], d);
        const T s2 = __shfl_xor_sync(0xffffffffu, ssum[n], d);
        stats_merge(smx[n], ssum[n], m2, s2);
      }
  }
  const bool stats_writer = tid % SHARERS == 0;

  if (S == 1) {
    if (LOGW) {
      if (stats_writer)
#pragma unroll
        for (int n = 0; n < W_PER; ++n) lse[wrow + n * RSTEP] = stats_lse(smx[n], ssum[n]);
      __syncthreads();
    }
    T* outf = out + (size_t)f * B * O;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int b = b0 + ty * TM + i;
      if (b >= B) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = tx * TN + j;
        const int o = o0 + c;
        if (o < O) outf[(size_t)b * O + o] = LOGW ? acc[i][j] - lse[c] : acc[i][j];
      }
    }
    return;
  }
  T* partf = part + ((size_t)split * F + f) * B * O;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = b0 + ty * TM + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = o0 + tx * TN + j;
      if (o < O) partf[(size_t)b * O + o] = acc[i][j];
    }
  }
  if (LOGW && blockIdx.z == 0 && stats_writer) {
#pragma unroll
    for (int n = 0; n < W_PER; ++n) {
      const int o = o0 + wrow + n * RSTEP;
      if (o >= O) continue;
      const size_t at = ((size_t)split * F + f) * O + o;
      stats[at] = smx[n];
      stats[(size_t)S * F * O + at] = ssum[n];
    }
  }
}

// The split's normalizers (logits): the log-sum-exp merge of the splits'
// pairs of unit (f, o), written over the first split's max, which only this
// thread reads. One thread a (f, o).
template <typename T>
__global__ void __launch_bounds__(256)
tropical_lse(T* __restrict__ stats, int F, int O, int S) {
  const long long fo = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)F * O;
  if (fo >= n) return;
  T mx = -INFINITY, sum = T(0);
  for (int s = 0; s < S; ++s) stats_merge(mx, sum, stats[s * n + fo], stats[(S + s) * n + fo]);
  stats[fo] = stats_lse(mx, sum);
}

// The split's second pass: out[f,b,o] = max_s part[s,f,b,o], minus the
// unit's normalizer (tropical_lse) with logits. Block (32, 8): 32 output
// units, and 8 / G rows of G groups of splits each; grid
// (ceil(F B / (8 / G)), ceil(O / 32)).
template <typename T, bool LOGW>
__global__ void __launch_bounds__(256)
tropical_finish(const T* __restrict__ part, const T* __restrict__ lse, T* __restrict__ out,
                int F, int B, int O, int S, int G) {
  __shared__ T sh_acc[8][32];
  const int y = threadIdx.y;
  const int g = y % G;
  const long long row = (long long)blockIdx.x * (8 / G) + y / G;  // f * B + b
  const int o = blockIdx.y * 32 + threadIdx.x;
  const bool live = row < (long long)F * B && o < O;
  const size_t plane = (size_t)F * B * O;
  T acc = -INFINITY;
  if (live) {
    const T* p = part + (size_t)row * O + o;
#pragma unroll 4
    for (int s = g; s < S; s += G) acc = cirkit::max_t(acc, p[s * plane]);
  }
  sh_acc[y][threadIdx.x] = acc;
  __syncthreads();
  if (!live || g != 0) return;
  for (int h = 1; h < G; ++h) acc = cirkit::max_t(acc, sh_acc[y + h][threadIdx.x]);
  out[(size_t)row * O + o] = LOGW ? acc - lse[(row / B) * O + o] : acc;
}

// ------------------------------------------------------------------------
// route_tucker
// ------------------------------------------------------------------------

// Philox4x32-10 (Salmon et al., SC'11): four 32-bit words from a 128-bit
// counter and a 64-bit key.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = c.x * 0xD2511F53u, hi0 = __umulhi(c.x, 0xD2511F53u);
    const uint32_t lo1 = c.z * 0xCD9E8D57u, hi1 = __umulhi(c.z, 0xCD9E8D57u);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// A uniform in [0, 1) from Philox words: 24 bits in float, 53 in double.
__device__ __forceinline__ float uniform01(uint4 r, float) {
  return (float)(r.x >> 8) * 5.9604644775390625e-08f;
}
__device__ __forceinline__ double uniform01(uint4 r, double) {
  return (double)(((unsigned long long)(r.x >> 5) << 26) | (r.y >> 6)) *
         1.1102230246251565e-16;
}

// The better of two (score, index) pairs: the larger score, the lower index
// on a tie.
template <typename T>
__device__ __forceinline__ bool better(T s, int m, T best, int bi) {
  return s > best || (s == best && m < bi);
}

__device__ __forceinline__ float lowest(float) { return -FLT_MAX; }
__device__ __forceinline__ double lowest(double) { return -DBL_MAX; }

constexpr int ROUTE_THREADS = 256;
constexpr int ROUTE_WARPS = ROUTE_THREADS / 32;

// The scores of the four columns m0 .. m0 + 3 of a row, (x1[i] + x2[j]) + lw
// as route_scores adds them, with (i, j) the pair of column m0 and wg the
// weight row at m0. QUAD (K1 and K2 multiples of 4, the weight row 16-byte
// aligned): the four columns share i, and the weights and x2[j .. j + 3]
// are one aligned read each. Otherwise element by element, columns past M
// scoring -inf.
template <typename T, bool LOGW, bool QUAD, typename WT = T>
__device__ __forceinline__ void group_scores(const WT* __restrict__ wg, const T* xa, const T* xb,
                                             int m0, int M, int K1, int K2, int i, int j,
                                             T* s) {
  if (QUAD) {
    T wv[4], b4[4];
    load_n<4>(wg, wv);
    cirkit::load4(xb + j, b4);
    const T a = xa[i];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r] = (a + b4[r]) + (LOGW ? wv[r] : cirkit::log_t(wv[r]));
    return;
  }
  T a = xa[i];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const bool in = m0 + r < M;
    const T w = in ? cirkit::widen(wg[r]) : T(0);
    const T lw = LOGW ? w : cirkit::log_t(w);
    s[r] = in ? (a + xb[j]) + lw : -INFINITY;
    if (r < 3 && ++j == K2) {
      j = 0;
      ++i;
      a = i < K1 ? xa[i] : T(0);
    }
  }
}

// exp(v - mx), given mx and mxl = mx log2(e): in float one FFMA and the
// fast base-2 exponential (MUFU); 0 for v = -inf.
__device__ __forceinline__ float exp_from(float v, float, float mxl) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(fmaf(v, 1.4426950408889634f, -mxl)));
  return y;
}
__device__ __forceinline__ double exp_from(double v, double mx, double) { return exp(v - mx); }
__device__ __forceinline__ float log2e_times(float v) { return v * 1.4426950408889634f; }
__device__ __forceinline__ double log2e_times(double v) { return v; }

template <typename T>
__device__ __forceinline__ T warp_incl_scan(T v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// A block of 8 warps takes 8 / TW rows (f, b), a team of TW warps each.
template <typename T, bool LOGW, bool SAMPLE, bool QUAD, typename WT = T>
__global__ void __launch_bounds__(ROUTE_THREADS)
route_tucker_kernel(const T* __restrict__ x1,         // (F,B,K1)
                    const T* __restrict__ x2,         // (F,B,K2)
                    const WT* __restrict__ th,        // (F,O,K1*K2)
                    const int64_t* __restrict__ sel,  // (F,B) selected unit
                    int64_t* __restrict__ out,        // (F,B) composite index
                    int F, int B, int K1, int K2, int O, int TW, uint32_t seed_lo,
                    uint32_t seed_hi) {
  extern __shared__ __align__(16) unsigned char route_smem[];
  __shared__ T sh_max[ROUTE_WARPS], sh_tot[ROUTE_WARPS];
  __shared__ int sh_idx[ROUTE_WARPS];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int team = warp / TW;
  const int wt = warp - team * TW;  // the warp within its team
  const int tl = wt * 32 + lane;    // the lane within its team
  const int NT = 32 * TW;
  const int tw0 = team * TW;  // the team's first warp
  const long long row = (long long)blockIdx.x * (ROUTE_WARPS / TW) + team;
  const bool live = row < (long long)F * B;
  const int M = K1 * K2;
  const int NG = (M + 3) / 4;  // groups of four columns

  T* xa = reinterpret_cast<T*>(route_smem) + (size_t)team * (K1 + K2);
  T* xb = xa + K1;
  const WT* w = th;
  int f = 0, b = 0;
  if (live) {
    f = (int)(row / B);
    b = (int)(row - (long long)f * B);
    long long o = sel[row];
    o = o < 0 ? 0 : (o >= O ? O - 1 : o);  // the caller masks rows with sel < 0
    w = th + ((size_t)f * O + (size_t)o) * M;
    for (int t = tl; t < K1; t += NT) xa[t] = x1[(size_t)row * K1 + t];
    for (int t = tl; t < K2; t += NT) xb[t] = x2[(size_t)row * K2 + t];
  }
  __syncthreads();

  // Pass 1: lane tl takes the groups tl, tl + NT, ...; (i, j) of its
  // group's first column steps by 4 NT columns.
  const int g_end = live ? NG : 0;
  int i = (4 * tl) / K2;
  int j = 4 * tl - i * K2;
  const int si = (4 * NT) / K2;
  const int sj = 4 * NT - si * K2;
  T best = -INFINITY;  // max: the lane's best pair
  int bi = INT_MAX;
  // sample: the running max (and its log2(e) multiple) and sum of exp
  T mx = lowest(T(0)), mxl = lowest(T(0)), sum = T(0);
  const WT* wg = w + 4 * tl;
  for (int g = tl; g < g_end; g += NT, wg += 4 * NT) {
    T s[4];
    group_scores<T, LOGW, QUAD, WT>(wg, xa, xb, 4 * g, M, K1, K2, i, j, s);
    if (SAMPLE) {
      T v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r] = cirkit::max_t(s[r], T(-INFINITY));  // NaN: no mass
      const T gm = cirkit::max_t(cirkit::max_t(v[0], v[1]), cirkit::max_t(v[2], v[3]));
      if (gm > mx) {  // the sum rescaled at most once a group
        const T gml = log2e_times(gm);
        sum = sum > T(0) ? sum * exp_from(mx, gm, gml) : T(0);
        mx = gm;
        mxl = gml;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) sum += exp_from(v[r], mx, mxl);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (s[r] > best) {  // columns rise within a lane: a tie keeps the first
          best = s[r];
          bi = 4 * g + r;
        }
    }
    i += si;
    j += sj;
    if (j >= K2) {
      j -= K2;
      ++i;
    }
  }

  if (!SAMPLE) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const T os = __shfl_xor_sync(0xffffffffu, best, d);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, d);
      if (better(os, oi, best, bi)) {
        best = os;
        bi = oi;
      }
    }
    if (lane == 0) {
      sh_max[warp] = best;
      sh_idx[warp] = bi;
    }
    __syncthreads();
    if (live && wt == 0 && lane == 0) {
      for (int h = 1; h < TW; ++h)
        if (better(sh_max[tw0 + h], sh_idx[tw0 + h], best, bi)) {
          best = sh_max[tw0 + h];
          bi = sh_idx[tw0 + h];
        }
      out[row] = bi == INT_MAX ? 0 : bi;  // INT_MAX: every score -inf or NaN
    }
    return;
  }

  // The row's max, each lane's sum in its scale, and their prefix over the
  // team's lanes.
  T big = cirkit::warp_max(mx);
  if (lane == 0) sh_max[warp] = big;
  __syncthreads();
  big = lowest(T(0));
  for (int h = 0; h < TW; ++h) big = cirkit::max_t(big, sh_max[tw0 + h]);
  const T wl = sum * cirkit::fast_exp(mx - big);
  T P = warp_incl_scan(wl, lane);
  if (lane == 31) sh_tot[warp] = P;
  __syncthreads();
  T off = T(0), total = T(0);
  for (int h = 0; h < TW; ++h) {
    const T t = sh_tot[tw0 + h];
    if (h < wt) off += t;
    total += t;
  }
  P += off;
  T target = T(0);
  if (live) {
    const uint4 bits = philox4x32_10(make_uint4((uint32_t)b, (uint32_t)f, 0u, 0u), seed_lo,
                                     seed_hi);
    target = uniform01(bits, T(0)) * total;
  }
  // the first lane with mass whose prefix reaches the target
  const unsigned hit = __ballot_sync(0xffffffffu, live && wl > T(0) && P >= target);
  if (lane == 0) sh_idx[warp] = hit ? wt * 32 + __ffs(hit) - 1 : INT_MAX;
  __syncthreads();
  int pick = INT_MAX;
  for (int h = 0; h < TW; ++h) pick = min(pick, sh_idx[tw0 + h]);
  if (!live) return;
  if (pick == INT_MAX) {  // no mass: every score -inf or NaN
    if (wt == 0 && lane == 0) out[row] = 0;
    return;
  }
  if (wt != pick / 32) return;

  // Rescan lane `pick`'s groups in the order it summed them, 32 at a time
  // (one a lane), against the target in that lane's own scale.
  const int src = pick & 31;
  const T pmx = __shfl_sync(0xffffffffu, mx, src);
  const T pmxl = __shfl_sync(0xffffffffu, mxl, src);
  const T pw = __shfl_sync(0xffffffffu, wl, src);
  const T pP = __shfl_sync(0xffffffffu, P, src);
  const T tau = (target - (pP - pw)) / cirkit::fast_exp(pmx - big);
  T base = T(0);
  int ans = -1, last = -1;
  for (long long t0 = 0; 4 * (pick + (long long)NT * t0) < M; t0 += 32) {
    const long long gl = pick + (long long)NT * (t0 + lane);
    T e[4] = {T(0), T(0), T(0), T(0)};
    T gs = T(0);
    if (4 * gl < M) {
      const int g = (int)gl;
      const int gi = (4 * g) / K2;
      T s[4];
      group_scores<T, LOGW, QUAD, WT>(w + 4 * g, xa, xb, 4 * g, M, K1, K2, gi, 4 * g - gi * K2,
                                      s);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        e[r] = exp_from(cirkit::max_t(s[r], T(-INFINITY)), pmx, pmxl);
        gs += e[r];
        if (e[r] > T(0)) last = 4 * g + r;
      }
    }
    const T inc = warp_incl_scan(gs, lane);
    const unsigned h = __ballot_sync(0xffffffffu, gs > T(0) && base + inc >= tau);
    if (h) {
      const int hl = __ffs(h) - 1;
      int m = -1;
      if (lane == hl) {
        T c = base + inc - gs;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          c += e[r];
          if (e[r] > T(0)) {
            m = 4 * (int)gl + r;
            if (c >= tau) break;
          }
        }
      }
      ans = __shfl_sync(0xffffffffu, m, hl);
      break;
    }
    base += __shfl_sync(0xffffffffu, inc, 31);
  }
  if (ans < 0) {  // the target past the rescanned total: the lane's last column with mass
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, d));
    ans = last;
  }
  if (lane == 0) out[row] = ans;
}

// The columns a thread of the vector staging map reads at once from x2: the
// VEC instances need K2 a multiple of it.
template <typename T>
constexpr int vec_cols() {
  return Trop<T>::BK * BM / THREADS;
}

template <typename T, bool LOGW, bool VEC, typename WT>
void launch_tropical_grid(const T* x1, const T* x2, const WT* th, T* out, T* part, T* stats,
                          int F, int B, int K1, int K2, int O, int S, int span,
                          cudaStream_t st) {
  const dim3 grid((unsigned)F * S, (O + BN - 1) / BN, (B + BM - 1) / BM);
  tropical_tucker_kernel<T, LOGW, VEC, WT><<<grid, THREADS, 0, st>>>(
      x1, x2, th, out, part, stats, F, B, K1, K2, O, S, span);
}

// The alignment of th that the vector loads need: 16 bytes, 8 for bf16.
template <typename WT>
constexpr uintptr_t th_align() {
  return sizeof(WT) == 2 ? 8 : 16;
}

template <typename T, bool LOGW, typename WT = T>
int launch_tropical(const T* x1, const T* x2, const WT* th, T* out, T* part, T* stats, int F,
                    int B, int K1, int K2, int O, int S, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  constexpr int BK = Trop<T>::BK;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = K1 * K2;
  const int chunks = (M + BK - 1) / BK;
  const int span = (chunks + S - 1) / S * BK;
  const bool vec = K2 % vec_cols<T>() == 0 && reinterpret_cast<uintptr_t>(x2) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(th) % th_align<WT>() == 0;
  if (vec)
    launch_tropical_grid<T, LOGW, true, WT>(x1, x2, th, out, part, stats, F, B, K1, K2, O, S,
                                            span, st);
  else
    launch_tropical_grid<T, LOGW, false, WT>(x1, x2, th, out, part, stats, F, B, K1, K2, O, S,
                                             span, st);
  if (S > 1) {
    if (LOGW) {
      const long long n = (long long)F * O;
      tropical_lse<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(stats, F, O, S);
    }
    const int G = S >= 8 ? 8 : (S >= 4 ? 4 : (S >= 2 ? 2 : 1));
    const long long rows = (long long)F * B;
    const int per = 8 / G;
    const dim3 fgrid((unsigned)((rows + per - 1) / per), (O + 31) / 32);
    tropical_finish<T, LOGW><<<fgrid, dim3(32, 8), 0, st>>>(part, stats, out, F, B, O, S, G);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool LOGW, bool SAMPLE, bool QUAD, typename WT>
int launch_route_grid(const T* x1, const T* x2, const WT* th, const int64_t* sel, int64_t* out,
                      int F, int B, int K1, int K2, int O, unsigned long long seed, int TW,
                      size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(route_tucker_kernel<T, LOGW, SAMPLE, QUAD, WT>,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                  static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  const long long rows = (long long)F * B;
  const int teams = ROUTE_WARPS / TW;
  const unsigned blocks = (unsigned)((rows + teams - 1) / teams);
  route_tucker_kernel<T, LOGW, SAMPLE, QUAD, WT><<<blocks, ROUTE_THREADS, smem, st>>>(
      x1, x2, th, sel, out, F, B, K1, K2, O, TW, (uint32_t)(seed & 0xffffffffull),
      (uint32_t)(seed >> 32));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool LOGW, bool SAMPLE, typename WT = T>
int launch_route(const T* x1, const T* x2, const WT* th, const int64_t* sel, int64_t* out, int F,
                 int B, int K1, int K2, int O, unsigned long long seed, int TW, int device,
                 void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (TW != 1 && TW != 2 && TW != 4 && TW != 8) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)(ROUTE_WARPS / TW) * (K1 + K2) * sizeof(T);
  if (smem > cirkit::MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool quad = K1 % 4 == 0 && K2 % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(th) % th_align<WT>() == 0;
  return quad ? launch_route_grid<T, LOGW, SAMPLE, true, WT>(x1, x2, th, sel, out, F, B, K1, K2,
                                                             O, seed, TW, smem, st)
              : launch_route_grid<T, LOGW, SAMPLE, false, WT>(x1, x2, th, sel, out, F, B, K1, K2,
                                                              O, seed, TW, smem, st);
}

}  // namespace

extern "C" {

// Each entry exists for float (the plain name) and for double (_f64), and
// for float activations beside a bf16 th (_w16).
// tropical_tucker: part (S, F, B, O) and stats (2, S, F, O) are scratch for
// S > 1 (stats only with logits), unused (may be null) for S = 1.
// route_tucker: team = warps a row (1, 2, 4 or 8).
#define TUCKER_ROUTE_ENTRIES(SUFFIX, T, WT)                                                    \
  int tropical_tucker##SUFFIX(const T* x1, const T* x2, const WT* th, T* out, T* part,         \
                              T* stats, int F, int B, int K1, int K2, int O, int S,            \
                              int log_weights, int device, void* stream) {                     \
    return log_weights ? launch_tropical<T, true, WT>(x1, x2, th, out, part, stats, F, B, K1,  \
                                                      K2, O, S, device, stream)                \
                       : launch_tropical<T, false, WT>(x1, x2, th, out, part, stats, F, B, K1, \
                                                       K2, O, S, device, stream);              \
  }                                                                                            \
  int route_tucker##SUFFIX(const T* x1, const T* x2, const WT* th, const int64_t* sel,         \
                           int64_t* out, int F, int B, int K1, int K2, int O, int log_weights, \
                           int sample, unsigned long long seed, int team, int device,          \
                           void* stream) {                                                     \
    if (log_weights)                                                                           \
      return sample ? launch_route<T, true, true, WT>(x1, x2, th, sel, out, F, B, K1, K2, O,   \
                                                      seed, team, device, stream)              \
                    : launch_route<T, true, false, WT>(x1, x2, th, sel, out, F, B, K1, K2, O,  \
                                                       seed, team, device, stream);            \
    return sample ? launch_route<T, false, true, WT>(x1, x2, th, sel, out, F, B, K1, K2, O,    \
                                                     seed, team, device, stream)               \
                  : launch_route<T, false, false, WT>(x1, x2, th, sel, out, F, B, K1, K2, O,   \
                                                      seed, team, device, stream);             \
  }

TUCKER_ROUTE_ENTRIES(, float, float)
TUCKER_ROUTE_ENTRIES(_f64, double, double)
TUCKER_ROUTE_ENTRIES(_w16, float, __nv_bfloat16)
#undef TUCKER_ROUTE_ENTRIES

}  // extern "C"
