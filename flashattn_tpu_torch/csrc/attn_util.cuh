// Helpers shared by the attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_bwd_f32.cu, kv8_flash.cu, paged_attention.cu): the dense masks' key intervals, row
// reductions over lanes, a correctly rounded division by a shared divisor,
// a store of f32 or bf16, and the opt-in to more than 48 KB of dynamic
// shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace fa {

constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The key interval [lo, hi) that query row R of a dense (non-paged)
// attention sees: keys below kv_len (n_kv, or the row's length when
// smaller), at or before R when causal (top-left aligned), and after
// R - window when window > 0.  The flash forward and both backward kernels
// take their masks from here, so they agree by construction on causal,
// window, varlen, cross attention (n_q != n_kv) and rows with no live key.
__device__ __forceinline__ void dense_bounds(int R, int kv_len, int causal,
                                             int window, int& lo, int& hi) {
  hi = causal ? min(kv_len, R + 1) : kv_len;
  lo = window > 0 ? max(0, R - window + 1) : 0;
}

template <int CG> __device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = CG / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
template <int CG> __device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = CG / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// x / b rounded to nearest (the bits of __fdiv_rn) from y = __frcp_rn(b),
// for many x over one b: q = x y, then q + (x - b q) y, the remainder exact
// by an FMA.  With y within half an ulp of 1 / b and q within one ulp of
// x / b this rounds correctly (Markstein's theorem; normal results): three
// instructions where __fdiv_rn takes a call with a slow-path check.
__device__ __forceinline__ float div_rn(float x, float b, float y) {
  const float q = __fmul_rn(x, y);
  return __fmaf_rn(__fmaf_rn(-q, b, x), y, q);
}

// Opt a kernel in to more than 48 KB of dynamic shared memory once.
template <class K> inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

// allow_smem for each kernel given (the instances of one kernel template),
// stopping at the first error.
template <class... K> inline cudaError_t allow_smem_all(size_t bytes, K... kernels) {
  cudaError_t e = cudaSuccess;
  ((e = e != cudaSuccess ? e : allow_smem(kernels, bytes)), ...);
  return e;
}

}  // namespace fa
