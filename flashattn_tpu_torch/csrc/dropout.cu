// Fused inverted dropout: out = keep ? x / div : 0, with div = 1 - rate
// rounded to x's dtype (JAX divides by the weakly typed 1.0 - rate, which
// takes the array's dtype: bf16(0.9) = 0.8984375) and keep = bits >=
// threshold, threshold =
// min(floor(rate * 2^32), 2^32 - 1) (the rule of _keep in
// flashattn_tpu/ops/dropout.py).  The same launch with the same seed is the
// backward: dropout is its own adjoint, and the mask is regenerated rather
// than saved.
//
// Replaces the TPU kernel flashattn_tpu/ops/dropout.py::_mask_scale_kernel
// (launched by _grid_call through _mask_scale and _dropout_p), which draws
// its bits from the TPU's in-core generator seeded per row block.
//
// Random bits: Philox4x32-10 keyed by the whole 64-bit seed (philox.cuh).
// Element i takes word i % 4 of the block at counter i / 4.  The bits
// depend on the element index alone, not on the launch shape, and
// ops/dropout.py computes the same bits with integer tensor ops, so the
// kernel and its plain version give bit-identical masks.
//
// What bounds it on the H100: bytes (x read once, out written once: 134 MB
// at (16384, 2048) bf16, 0.040 ms at 3.35 TB/s) with Philox's ten rounds
// of integer multiplies and the IEEE division close behind (~0.03 ms of
// issue at that shape).  So it is fast only if loads are in flight while
// the rounds run.  Design: a thread takes groups of 8 elements (one
// 16-byte access in bf16, two in f32: Philox blocks 2j and 2j + 1), two
// groups an iteration of a grid-stride loop (four ran 4% slower), and
// issues both groups' loads before either group's Philox rounds, so the
// memory latency hides under the integer work; the grid is sized to fill
// the card once.  42 registers in bf16, 58 in f32 (-Xptxas -v).  A
// base that is not 16-byte aligned is handled in the same launch: a scalar
// head runs up to the first aligned element (the wrapper gives out the
// same offset from a 16-byte boundary as x), the groups then start at an
// element e0 with e0 % 4 = S, a template constant (S > 0 draws three
// Philox blocks for a group), and a scalar tail takes the last
// (n - head) % 8.  The division stays an IEEE f32 division (__fdiv_rn,
// never a reciprocal) rounded once to the output dtype, so the result is
// bit for bit the plain version's and JAX's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "vec16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // groups of 8 a thread has in flight at once

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float keep_or_zero(float v, uint32_t bits, uint32_t threshold,
                                              float div) {
  return bits >= threshold ? __fdiv_rn(v, div) : 0.f;
}

// The Philox words of elements e0 .. e0 + 7, e0 % 4 == S.
template <int S>
__device__ __forceinline__ void group_bits(long long e0, unsigned long long seed,
                                           uint32_t (&bits)[8]) {
  constexpr int kBlocks = S == 0 ? 2 : 3;
  uint32_t w[4 * kBlocks];
#pragma unroll
  for (int b = 0; b < kBlocks; ++b) {
    const uint4 r = fa::philox_block(e0 / 4 + b, seed);
    w[4 * b] = r.x;
    w[4 * b + 1] = r.y;
    w[4 * b + 2] = r.z;
    w[4 * b + 3] = r.w;
  }
#pragma unroll
  for (int l = 0; l < 8; ++l) bits[l] = w[S + l];
}

template <typename T>
__device__ __forceinline__ void scalar(const T* x, T* out, long long i,
                                       unsigned long long seed, uint32_t threshold,
                                       float div) {
  const uint4 r = fa::philox_block(i / 4, seed);
  const int l = int(i % 4);
  const uint32_t bits = l == 0 ? r.x : l == 1 ? r.y : l == 2 ? r.z : r.w;
  put(out + i, keep_or_zero(to_f(x[i]), bits, threshold, div));
}

// Elements [0, head) and [head + 8 * groups, n) one at a time; the groups
// of 8 from element head, whose address is 16-byte aligned in x and out.
template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ out, long long n, long long head,
               long long groups, unsigned long long seed, uint32_t threshold, float div) {
  constexpr int V = fa::kVec<T>, kLoads = 8 / V;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tail = head + 8 * groups;
  for (long long i = tid; i < head; i += stride) scalar(x, out, i, seed, threshold, div);
  for (long long i = tail + tid; i < n; i += stride) scalar(x, out, i, seed, threshold, div);

  const T* xb = x + head;
  T* ob = out + head;
  for (long long g = tid; g < groups; g += kUnroll * stride) {
    uint4 v[kUnroll][kLoads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (g + u * stride < groups)
#pragma unroll
        for (int q = 0; q < kLoads; ++q) v[u][q] = fa::load16(xb + 8 * (g + u * stride) + q * V);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long gu = g + u * stride;
      if (gu < groups) {
        uint32_t bits[8];
        group_bits<S>(head + 8 * gu, seed, bits);
        float f[8];
#pragma unroll
        for (int q = 0; q < kLoads; ++q) fa::unpack16<T>(v[u][q], f + q * V);
#pragma unroll
        for (int l = 0; l < 8; ++l) f[l] = keep_or_zero(f[l], bits[l], threshold, div);
#pragma unroll
        for (int q = 0; q < kLoads; ++q) fa::store16(ob + 8 * gu + q * V, fa::pack16<T>(f + q * V));
      }
    }
  }
}

template <typename T, int S>
cudaError_t launch_s(const T* x, T* out, long long n, long long head, long long groups,
                     unsigned long long seed, uint32_t threshold, float div,
                     cudaStream_t stream) {
  static int per_sm = 0;
  long long slots = 0;
  const cudaError_t e = fa::resident_blocks(dropout_kernel<T, S>, kThreads, &per_sm, &slots);
  if (e != cudaSuccess) return e;
  const long long want = ((n + 7) / 8 + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const int grid = int(want < slots ? want : slots);
  dropout_kernel<T, S><<<grid, kThreads, 0, stream>>>(x, out, n, head, groups, seed,
                                                      threshold, div);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xp, void* outp, long long n, unsigned long long seed,
                   uint32_t threshold, float div, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xp);
  T* out = static_cast<T*>(outp);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(xp) % 16;
  // x and out must sit alike against 16-byte boundaries for the groups;
  // otherwise every element takes the scalar path
  long long head = n;
  if (xa == reinterpret_cast<uintptr_t>(outp) % 16 && xa % sizeof(T) == 0) {
    const long long to_aligned = (long long)((16 - xa) % 16 / sizeof(T));
    head = to_aligned < n ? to_aligned : n;
  }
  const long long groups = (n - head) / 8;
  switch (head % 4) {
    case 0: return launch_s<T, 0>(x, out, n, head, groups, seed, threshold, div, stream);
    case 1: return launch_s<T, 1>(x, out, n, head, groups, seed, threshold, div, stream);
    case 2: return launch_s<T, 2>(x, out, n, head, groups, seed, threshold, div, stream);
    default: return launch_s<T, 3>(x, out, n, head, groups, seed, threshold, div, stream);
  }
}

}  // namespace

// x, out: n contiguous elements; dtype codes 0 = float32, 1 = bfloat16;
// div: what a kept value is divided by (1 for unscaled dropout).
extern "C" int fa_dropout(const void* x, void* out, long long n,
                          unsigned long long seed, unsigned int threshold,
                          float div, int dtype, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, out, n, seed, threshold, div, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, out, n, seed, threshold, div, st);
  return int(cudaErrorInvalidValue);
}
