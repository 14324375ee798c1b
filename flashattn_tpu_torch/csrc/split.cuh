// Split precision for the f32 kernels (flash_fwd.cu, flash_bwd_f32.cu,
// kv8_flash.cu, wo_matmul.cu, paged_attention.cu):
// an f32 operand is cut into three bf16 pieces and a product of two such
// operands is the sum of the six bf16 x bf16 products of order <= 2, on
// the wgmma tensor cores with f32 accumulators.
//
// The split truncates: b0 = x with its low 16 bits cleared (x rounded
// toward zero to bf16), then b1 the same of x - b0, then b2 = x - b0 - b1.
// Each difference is exact in f32, each piece holds at most 8 significant
// bits, so x = b0 + b1 + b2 exactly (24 bits, an f32's mantissa) for every
// finite x down to 2^-110, and the three pieces share x's sign.  A product
// keeps b0 b0, b0 b1, b1 b0, b0 b2, b2 b0 and b1 b1 and drops the terms of
// order 3 and 4, below 2^-23 of |a| |b|: the rounding of an f32 FMA chain.
// A non-finite x keeps its value in b0 and zeros in b1 and b2.  The pieces
// of the other operand multiply b0 then; a zero piece there (an exactly
// representable value) would make 0 * inf = NaN where f32 gives +-inf.  A
// NaN needs nothing (it stays NaN); for a +-inf the split pass of the
// wgmma flash kernels raises a flag, on which they step aside for the
// warp-level kernels below (C17), and the warp-level tiles (those kernels,
// the paged tiles of paged_attention.cu) zero the non-finite entries of a
// b0 before its products with the other operand's b1 and b2 (finite_part,
// sanitize), while the b0 b0 product keeps them.
//
// The pieces of the wgmma kernels' f32 inputs are made once a call by
// split_kernel, one pass over each input (read 4 bytes, write 6 an
// element): planes [3][n] of bf16 that they load with cp.async like their
// bf16 inputs.  A score or gradient tile's own f32 values (P, dS) are split
// in registers into the A operand of the next product (split3).  The
// warp-level kernels split their staged f32 tiles into planes in shared
// memory instead (the last section).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {
namespace sp {

constexpr int NP = 3;   // bf16 pieces of an f32 operand

// The (A piece, B piece) pairs of a product in the order they are summed,
// pr = 0..5.  The tensor cores round each k16 step's sum toward zero to
// f32, one ulp of the accumulator at most, always the same way: so the
// small terms go first, (2, 0), (0, 2), (1, 1), (1, 0), (0, 1), and b0 b0
// last, and each tile's product sums from zero in registers of its own
// before an f32 add (rounded to nearest) takes it into the running
// accumulator (promote); a chain of hundreds of steps into one accumulator
// drifts by hundreds of ulps.  kSafe: (0, 2), (1, 1), (0, 1), (0, 0), then
// (2, 0) and (1, 0), which read B's b0 with A's lower pieces and so come
// after sanitize where B holds a +-inf.
template <bool kSafe>
__host__ __device__ constexpr int pair_a(int pr) {
  return kSafe ? (pr == 4 ? 2 : pr == 1 || pr == 5 ? 1 : 0) : (pr == 0 ? 2 : pr == 2 || pr == 3 ? 1 : 0);
}
template <bool kSafe>
__host__ __device__ constexpr int pair_b(int pr) {
  return kSafe ? (pr == 0 ? 2 : pr == 1 || pr == 2 ? 1 : 0) : (pr == 1 ? 2 : pr == 2 || pr == 4 ? 1 : 0);
}

__device__ __forceinline__ float trunc_bf16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
}

// x = b0 + b1 + b2 (see the header note)
__device__ __forceinline__ void split3(float x, float& b0, float& b1, float& b2) {
  if (!isfinite(x)) {
    b0 = x;
    b1 = b2 = 0.f;
    return;
  }
  b0 = trunc_bf16(x);
  const float r = x - b0;
  b1 = trunc_bf16(r);
  b2 = r - b1;
}

// Two f32 values as three packed bf16 pairs, pieces 0..2 (the lower column
// in the low half, as hop::pack_bf16).
__device__ __forceinline__ void split_pair(float lo, float hi, uint32_t& p0, uint32_t& p1,
                                           uint32_t& p2) {
  float a0, a1, a2, c0, c1, c2;
  split3(lo, a0, a1, a2);
  split3(hi, c0, c1, c2);
  p0 = hop::pack_bf16(a0, c0);
  p1 = hop::pack_bf16(a1, c1);
  p2 = hop::pack_bf16(a2, c2);
}

// Up to four f32 tensors split in one launch: tensor t's pieces go to
// dst[t][p * n[t] + i] (its elements scaled by scale[t] in f32 first, as
// the forward folds sm_scale * log2(e) into q), and *flag[t] becomes 1
// where one of its elements is +-inf (flag[t] may be null).  n[t] is a
// multiple of 4 and both pointers 16-byte aligned.
struct SplitJobs {
  const float* src[4];
  __nv_bfloat16* dst[4];
  long long n[4];
  float scale[4];
  int* flag[4];
};

__global__ void __launch_bounds__(256) split_kernel(SplitJobs jobs) {
  const int t = blockIdx.y;
  const float4* src = reinterpret_cast<const float4*>(jobs.src[t]);
  const long long n = jobs.n[t], n4 = n / 4;
  const float scale = jobs.scale[t];
  uint2* d0 = reinterpret_cast<uint2*>(jobs.dst[t]);
  uint2* d1 = reinterpret_cast<uint2*>(jobs.dst[t] + n);
  uint2* d2 = reinterpret_cast<uint2*>(jobs.dst[t] + 2 * n);
  bool inf = false;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n4; i += gridDim.x * 256ll) {
    float4 x = src[i];
    if (scale != 1.f) {
      x.x = __fmul_rn(x.x, scale);
      x.y = __fmul_rn(x.y, scale);
      x.z = __fmul_rn(x.z, scale);
      x.w = __fmul_rn(x.w, scale);
    }
    inf |= isinf(x.x) || isinf(x.y) || isinf(x.z) || isinf(x.w);
    uint2 a, b, c;
    split_pair(x.x, x.y, a.x, b.x, c.x);
    split_pair(x.z, x.w, a.y, b.y, c.y);
    d0[i] = a;
    d1[i] = b;
    d2[i] = c;
  }
  if (inf && jobs.flag[t] != nullptr) atomicOr(jobs.flag[t], 1);
}

inline cudaError_t split(const SplitJobs& jobs, int count, cudaStream_t stream) {
  long long most = 0;
  for (int t = 0; t < count; ++t) most = jobs.n[t] > most ? jobs.n[t] : most;
  const long long blocks = (most / 4 + 255) / 256;
  if (blocks == 0) return cudaSuccess;
  dim3 grid(unsigned(blocks < 1056 ? blocks : 1056), count);   // 8 a streaming multiprocessor
  split_kernel<<<grid, 256, 0, stream>>>(jobs);
  return cudaGetLastError();
}

// d (64 x 64) += the pairs [P0, P1) of A's piece i (64 rows at a) times B's
// piece j (64 rows at b) transposed, both K-major, contracted over D: tiles
// of SW-byte swizzled rows in regions of SW / 2 columns, a_region (b_region)
// bytes apart; the pieces a_plane (b_plane) bytes apart.  kSwap: the pair
// (j, i) instead, so that S^T = K Q^T sums the same products in the same
// order as S = Q K^T.
template <int D, int SW, bool kSafe, int P0, int P1, bool kSwap = false>
__device__ __forceinline__ void ss_pairs(float (&d)[32], uint32_t a, uint32_t a_plane,
                                         uint32_t a_region, uint32_t b, uint32_t b_plane,
                                         uint32_t b_region) {
  constexpr int CPR = SW / 2;
#pragma unroll
  for (int pr = P0; pr < P1; ++pr) {
    const int i = kSwap ? pair_b<kSafe>(pr) : pair_a<kSafe>(pr);
    const int j = kSwap ? pair_a<kSafe>(pr) : pair_b<kSafe>(pr);
    const uint32_t aa = a + i * a_plane, bb = b + j * b_plane;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t region = ks * 16 / CPR, off = (ks * 16 % CPR) * 2;
      hop::wgmma_ss<0>(d, hop::desc<SW>(aa + region * a_region + off, 16, 8 * SW),
                       hop::desc<SW>(bb + region * b_region + off, 16, 8 * SW), 1);
    }
  }
}

// acc (64 x N) += the pairs [P0, P1) of A's piece i (64 x 64 over the
// contraction: bf16 pairs in the accumulator layout, a[i][4 kc .. 4 kc + 3]
// the k16 step kc) times B's piece j: N columns of the 64-row tile at b
// (SW-byte swizzled rows, regions of SW / 2 columns 64 SW bytes apart, the
// pieces b_plane bytes apart), read MN-major (the transpose bit set).
template <int N, int SW, bool kSafe, int P0, int P1>
__device__ __forceinline__ void rs_pairs(float (&acc)[N / 2], const uint32_t (&a)[NP][16],
                                         uint32_t b, uint32_t b_plane) {
#pragma unroll
  for (int pr = P0; pr < P1; ++pr) {
    const int i = pair_a<kSafe>(pr);
    const uint32_t bb = b + pair_b<kSafe>(pr) * b_plane;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t ak[4] = {a[i][4 * kc], a[i][4 * kc + 1], a[i][4 * kc + 2], a[i][4 * kc + 3]};
      hop::wgmma_rs<1>(acc, ak, hop::desc<SW>(bb + kc * 16 * SW, 64 * SW, 8 * SW), 1);
    }
  }
}

// The NP pieces of a 64 x 64 f32 tile in the accumulator layout
// (x[4j + 2hh + e]), as the A operand of rs_pairs.
__device__ __forceinline__ void split_tile(uint32_t (&a)[NP][16], const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      split_pair(x[4 * j + 2 * hh], x[4 * j + 2 * hh + 1], a[0][2 * j + hh], a[1][2 * j + hh],
                 a[2][2 * j + hh]);
}

// Zero the non-finite bf16 values of a plane of `bytes` bytes in shared
// memory (all of the block's threads), so that its products with the A
// operand's lower pieces cannot make 0 * inf.
template <int THREADS>
__device__ __forceinline__ void sanitize(uint8_t* plane, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += THREADS) {
    uint4 v = reinterpret_cast<uint4*>(plane)[i];
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((w[e] & 0x7F80u) == 0x7F80u) w[e] &= 0xFFFF0000u;
      if ((w[e] & 0x7F800000u) == 0x7F800000u) w[e] &= 0x0000FFFFu;
    }
    reinterpret_cast<uint4*>(plane)[i] = v;
  }
}

__device__ __forceinline__ float4 scale4_rn(float4 v, float s) {
  return make_float4(__fmul_rn(v.x, s), __fmul_rn(v.y, s), __fmul_rn(v.z, s), __fmul_rn(v.w, s));
}
__device__ __forceinline__ float elem4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// A bf16 pair with its non-finite halves zeroed (sanitize in registers).
__device__ __forceinline__ uint32_t finite_part(uint32_t w) {
  if ((w & 0x7F80u) == 0x7F80u) w &= 0xFFFF0000u;
  if ((w & 0x7F800000u) == 0x7F800000u) w &= 0x0000FFFFu;
  return w;
}

// -- warp-level split products (mma.sync) ------------------------------------
//
// The f32 flash kernels sized to the rows (flash_fwd.cu, flash_bwd_f32.cu) run
// mma.sync m16n8k16 on tiles of 16 rows a warp.  They stage their f32
// inputs as stored (cp.async, no split pass in device memory), and the
// block splits each staged tile once into three bf16 planes of padded rows
// (split_rows; ROW = D * 2 + 16 bytes, hop::frag_a's padding), from which
// every warp reads its fragments by ldmatrix, a plane at a time (frags_a,
// frags_b2, frags_b2t: the layouts of hop::frag_a, frag_b2, frag_b2t).
// A b0 fragment's non-finite halves are zeroed in registers for its
// products with the other operand's lower pieces (finite_part).  mma6
// sums a product's six pieces in pair_a<false>'s order; the HMMAs are not
// volatile, so the compiler interleaves independent n-tiles.

// d += a b, one mma.sync m16n8k16 (hop::mma_16816's fragments), free to be
// scheduled among other independent ones.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [0, rows) of an f32 tile staged as padded rows (D floats and 16
// bytes a row, hop::load_rows_padded<D * 4>) into NP planes of bf16 rows
// of ROW = D * 2 + 16 bytes, `plane` bytes apart, each value times `scale`
// in f32 first (q's sm_scale log2(e)).  All of the block's threads.
template <int D>
__device__ __forceinline__ void split_rows(uint8_t* planes, int plane, const uint8_t* src,
                                           int rows, float scale) {
  constexpr int U = D / 4;   // 16-byte f32 units a row
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * U; i += blockDim.x) {
    const int r = i / U, u = i % U;
    float4 x = *reinterpret_cast<const float4*>(src + r * (D * 4 + 16) + 16 * u);
    if (scale != 1.f) x = scale4_rn(x, scale);
    uint2 w[NP];
    split_pair(x.x, x.y, w[0].x, w[1].x, w[2].x);
    split_pair(x.z, x.w, w[0].y, w[1].y, w[2].y);
    uint8_t* dst = planes + r * (D * 2 + 16) + 8 * u;
#pragma unroll
    for (int p = 0; p < NP; ++p) *reinterpret_cast<uint2*>(dst + p * plane) = w[p];
  }
}

// One of a block's direct loads into planes (split_rows_ldg): rows [0,
// rows) of a row-major (., d) f32 matrix at src, rows at or past
// rows_valid and columns d..D - 1 zero, into NP planes of padded bf16 rows (`plane` bytes
// apart), each value times `scale` in f32 first.
struct RowsJob {
  const float* src;
  int rows_valid, rows;
  uint8_t* planes;
  int plane;
  float scale;
};

// split_rows_ldg's body; kFull: d == D, known at compile time.
template <int D, int NJOB, bool kFull>
__device__ __forceinline__ void split_rows_ldg_d(const RowsJob (&jobs)[NJOB], int d_) {
  constexpr int U = D / 4, K = 4;
  const int d = kFull ? D : d_;
  int most = 0;
#pragma unroll
  for (int j = 0; j < NJOB; ++j) most = max(most, jobs[j].rows * U);
  for (int base = threadIdx.x; base < most; base += K * blockDim.x) {
    float4 x[NJOB][K];
#pragma unroll
    for (int j = 0; j < NJOB; ++j)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = base + k * blockDim.x, r = i / U;
        x[j][k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < jobs[j].rows * U && r < jobs[j].rows_valid && (kFull || 4 * (i % U) < d))
          x[j][k] = *reinterpret_cast<const float4*>(jobs[j].src + size_t(r) * d + 4 * (i % U));
      }
#pragma unroll
    for (int j = 0; j < NJOB; ++j)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = base + k * blockDim.x;
        if (i >= jobs[j].rows * U) continue;
        float4 v = x[j][k];
        if (jobs[j].scale != 1.f) v = scale4_rn(v, jobs[j].scale);
        uint2 w[NP];
        split_pair(v.x, v.y, w[0].x, w[1].x, w[2].x);
        split_pair(v.z, v.w, w[0].y, w[1].y, w[2].y);
        uint8_t* dst = jobs[j].planes + (i / U) * (D * 2 + 16) + 8 * (i % U);
#pragma unroll
        for (int p = 0; p < NP; ++p) *reinterpret_cast<uint2*>(dst + p * jobs[j].plane) = w[p];
      }
  }
}

// The jobs' rows loaded straight into registers and split into their
// planes by the block's threads: four 16-byte loads a thread of every job
// in flight together, then their splits (split_rows' layout).  For the
// operands a block reads once at its start (no staging in shared memory).
// d: the rows' head dim (a multiple of 8, at most D).
template <int D, int NJOB>
__device__ __forceinline__ void split_rows_ldg(const RowsJob (&jobs)[NJOB], int d = D) {
  if (d == D)
    split_rows_ldg_d<D, NJOB, true>(jobs, d);
  else
    split_rows_ldg_d<D, NJOB, false>(jobs, d);
}

// The pieces of an A fragment (hop::frag_a of each plane at `planes`,
// `plane` bytes apart) and f: the b0 fragment with its non-finite halves
// zeroed.
__device__ __forceinline__ void frags_a(uint32_t (&a)[NP][4], uint32_t (&f)[4], uint32_t planes,
                                        int plane, int row, int m0, int k0, int lane) {
#pragma unroll
  for (int p = 0; p < NP; ++p) hop::frag_a(a[p], planes + p * plane, row, m0, k0, lane);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = finite_part(a[0][i]);
}
// The pieces of two n-tiles' B fragments ([0..1] n-tile n0 / 8, [2..3] the
// next) of a tile stored N-major (hop::frag_b2: K for Q K^T).
__device__ __forceinline__ void frags_b2(uint32_t (&b)[NP][4], uint32_t (&f)[4], uint32_t planes,
                                         int plane, int row, int n0, int k0, int lane) {
#pragma unroll
  for (int p = 0; p < NP; ++p) hop::frag_b2(b[p], planes + p * plane, row, n0, k0, lane);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = finite_part(b[0][i]);
}
// The same of a tile stored K-major (hop::frag_b2t: V for P V).
__device__ __forceinline__ void frags_b2t(uint32_t (&b)[NP][4], uint32_t (&f)[4], uint32_t planes,
                                          int plane, int row, int k0, int n0, int lane) {
#pragma unroll
  for (int p = 0; p < NP; ++p) hop::frag_b2t(b[p], planes + p * plane, row, k0, n0, lane);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = finite_part(b[0][i]);
}

// The A operand's pieces of k16 step kc from a 16-row tile of f32 values in
// the accumulator layout (c[j][2hh + e]: row g + 8hh, column 8j + 2t + e;
// P or dS of a score tile), n-tiles 2kc and 2kc + 1.
template <int NJ>
__device__ __forceinline__ void frag_a_acc(uint32_t (&a)[NP][4], uint32_t (&f)[4],
                                           const float (&c)[NJ][4], int kc) {
  split_pair(c[2 * kc][0], c[2 * kc][1], a[0][0], a[1][0], a[2][0]);
  split_pair(c[2 * kc][2], c[2 * kc][3], a[0][1], a[1][1], a[2][1]);
  split_pair(c[2 * kc + 1][0], c[2 * kc + 1][1], a[0][2], a[1][2], a[2][2]);
  split_pair(c[2 * kc + 1][2], c[2 * kc + 1][3], a[0][3], a[1][3], a[2][3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = finite_part(a[0][i]);
}

// The six products of one m16n8k16 step against n-tile h (0 or 1) of the
// B pieces b (frags_b2 / frags_b2t), in pair_a<false>'s order: the five
// small ones into lo, b0 b0 into hi (one accumulator when lo and hi are
// the same array); each b0 meets the other operand's lower pieces as its
// finite part (af, bf).  kSwap: A holds the pieces of the side that is B
// in the product whose order is kept (S^T = K Q^T, the pairs (j, i)), so
// that S^T sums S's products in S's order.
template <bool kSwap>
__device__ __forceinline__ void mma6(float (&lo)[4], float (&hi)[4], const uint32_t (&a)[NP][4],
                                     const uint32_t (&af)[4], const uint32_t (&b)[NP][4],
                                     const uint32_t (&bf)[4], int h) {
  const int x = 2 * h, y = 2 * h + 1;
  if (kSwap) {
    mma(lo, af, b[2][x], b[2][y]);     // (2, 0)
    mma(lo, a[2], bf[x], bf[y]);       // (0, 2)
    mma(lo, a[1], b[1][x], b[1][y]);   // (1, 1)
    mma(lo, af, b[1][x], b[1][y]);     // (1, 0)
    mma(lo, a[1], bf[x], bf[y]);       // (0, 1)
  } else {
    mma(lo, a[2], bf[x], bf[y]);       // (2, 0)
    mma(lo, af, b[2][x], b[2][y]);     // (0, 2)
    mma(lo, a[1], b[1][x], b[1][y]);   // (1, 1)
    mma(lo, a[1], bf[x], bf[y]);       // (1, 0)
    mma(lo, af, b[1][x], b[1][y]);     // (0, 1)
  }
  mma(hi, a[0], b[0][x], b[0][y]);     // (0, 0)
}

// acc[2 n2 + h] += the 16 rows of A (pieces a, finite part af) times the
// two n-tiles of b (frags_b2t), each n-tile's six products summed from
// zero and then added in f32.
template <int ND>
__device__ __forceinline__ void mma6_add(float (&acc)[ND][4], int n2, const uint32_t (&a)[NP][4],
                                         const uint32_t (&af)[4], const uint32_t (&b)[NP][4],
                                         const uint32_t (&bf)[4]) {
  float t[2][4] = {};
  mma6<false>(t[0], t[0], a, af, b, bf, 0);
  mma6<false>(t[1], t[1], a, af, b, bf, 1);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[2 * n2 + h][i] += t[h][i];
}

// A product tile of a warp's 16 rows: s (16 x 8 NJ) = the rows m0.. of A's
// planes (at a, `a_plane` bytes apart) times the 8 NJ rows of B's planes
// (at b) transposed, both stored with the contraction along their rows (Q
// and K for S = Q K^T; K and Q for S^T, kSwap; dO and V for dP).  kTwo:
// the five small products of each k16 step into one accumulator, b0 b0
// into another, added in f32 at the end (S: the forward and both backward
// kernels take S from here, so the backward's S and S^T are the forward's
// bit for bit); else one accumulator (dP).  Straight-line code: the n-tiles'
// chains of dependent products interleave.
template <int D, int NJ, bool kSwap, bool kTwo>
__device__ __forceinline__ void tile_product(float (&s)[NJ][4], uint32_t a, int a_plane, int m0,
                                             uint32_t b, int b_plane, int lane) {
  constexpr int ROW = D * 2 + 16;
  float lo[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = lo[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t fa[NP][4], ff[4];
    frags_a(fa, ff, a, a_plane, ROW, m0, 16 * ks, lane);
#pragma unroll
    for (int j2 = 0; j2 < NJ / 2; ++j2) {
      uint32_t fb[NP][4], fbf[4];
      frags_b2(fb, fbf, b, b_plane, ROW, 16 * j2, 16 * ks, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (kTwo)
          mma6<kSwap>(lo[2 * j2 + h], s[2 * j2 + h], fa, ff, fb, fbf, h);
        else
          mma6<kSwap>(s[2 * j2 + h], s[2 * j2 + h], fa, ff, fb, fbf, h);
      }
    }
  }
  if (kTwo) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = __fadd_rn(lo[j][e], s[j][e]);
  }
}

// acc (16 x D) += x (16 x 8 NJ in the accumulator layout: P, dS or their
// transposes) times the 8 NJ rows of the planes at b read across them (V,
// K, dO or Q: frags_b2t), chunk by chunk, each n-tile's six products
// summed from zero and then added in f32.
template <int D, int NJ>
__device__ __forceinline__ void acc_product(float (&acc)[D / 8][4], const float (&x)[NJ][4],
                                            uint32_t b, int b_plane, int lane) {
#pragma unroll
  for (int kc = 0; kc < NJ / 2; ++kc) {
    uint32_t pa[NP][4], pf[4];
    frag_a_acc<NJ>(pa, pf, x, kc);
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t vb[NP][4], vf[4];
      frags_b2t(vb, vf, b, b_plane, D * 2 + 16, 16 * kc, 16 * n2, lane);
      mma6_add<D / 8>(acc, n2, pa, pf, vb, vf);
    }
  }
}

// Rows [0, n) of a warp's 16-row product acc[nd][2hh + e] (row g + 8hh,
// column 8 nd + 2t + e) times mul[hh] to dst: its columns below d (a
// multiple of 8, at most D), rows d floats apart.
template <int D>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[D / 8][4],
                                           const float (&mul)[2], int n, int lane, int d = D) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = g + 8 * hh;
    if (r >= n) continue;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      if (8 * nd < d)
        *reinterpret_cast<float2*>(dst + size_t(r) * d + 8 * nd + 2 * t) =
            make_float2(acc[nd][2 * hh] * mul[hh], acc[nd][2 * hh + 1] * mul[hh]);
  }
}

}  // namespace sp
}  // namespace
