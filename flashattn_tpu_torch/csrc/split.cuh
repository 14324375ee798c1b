// Split precision for the f32 kernels (flash_fwd.cu, flash_bwd.cu,
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
// NaN needs nothing (it stays NaN); for a +-inf the split pass raises a
// flag, on which the flash kernels step aside for their CUDA-core twins
// (C17), and the paged tiles (paged_attention.cu) zero the non-finite
// entries of a b0 before its products with the other operand's b1 and b2
// (sanitize, in shared memory or in registers).
//
// The pieces of a kernel's f32 inputs are made once a call by
// split_kernel, one pass over each input (read 4 bytes, write 6 an
// element): planes [3][n] of bf16 that the flash kernels load with
// cp.async like their bf16 inputs.  A score or gradient tile's own f32
// values (P, dS) are split in registers into the A operand of the next
// product (split3).

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

}  // namespace sp
}  // namespace
