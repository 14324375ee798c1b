// Per-row int8 quantization with stochastic rounding: for each row of x
// (n, h), scale = absmax / 127 (1 for a zero row, f32) and
// q = clip(floor(x / scale + u), -127, 127) with u = (bits >> 9) * 2^-23
// uniform on [0, 1), so E[q * scale] = x.
//
// Replaces the TPU kernel flashattn_tpu/ops/quant.py::_stochastic_quant_kernel
// (wrapper quantize_int8_stochastic), which draws u from the TPU's in-core
// generator seeded per call.  Here the bits are Philox4x32-10 keyed by the
// 64-bit seed with element i = row * h + col taking word i % 4 of the block
// at counter i / 4 (philox.cuh, the stream of the dropout kernel), and
// ops/quant.py::quantize_int8_stochastic_reference computes the same bits
// with integer tensor ops, so the kernel and its plain version agree bit
// for bit.  They cannot agree with the JAX package, whose CPU path draws
// jax.random noise.
//
// What bounds it on the H100: bytes (x read once, one byte written per
// element: 0.030 ms at (32768, 1024) bf16) with Philox's integer
// multiplies and the IEEE division x / scale close behind; measured, the
// instructions set the pace (PERF.md row 16: without its Philox rounds the
// kernel runs in ~2/3 of its time, without its loads in nearly all of it).
// Design (h % 8 == 0, the vector path): L lanes of a warp own a row (L the
// least power of two with 4 L groups of 8 covering the row, at most 32; a
// warp holds 32 / L rows), each lane up to 4 groups of 8 elements, read
// once into registers in 16-byte loads (two in f32), all issued before
// any arithmetic.  The row's absmax is an xor-shuffle reduction over its L
// lanes: no shared memory, no barrier.  Each group then draws its two
// Philox blocks (elements e0 .. e0 + 7, e0 % 8 == 0), quantizes from the
// registers (no conversion instructions: quantize8) and leaves in one
// 8-byte store.  A row wider than 4 x 32 groups (h > 1024) takes its
// absmax in a first walk and reads x again, from L2, to quantize.  Other h
// (or a base off 16 bytes) take the generic kernel: one block per row, a
// block reduction, then whole Philox blocks of four elements (a block may
// straddle two rows: each row's block uses the words of its own elements).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "vec16.cuh"

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(NT)
stochastic_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                        float* __restrict__ scales, int h,
                        unsigned long long seed) {
  __shared__ float warp_max[NT / 32];
  const long long base = (long long)blockIdx.x * h;
  const T* xr = x + base;

  float amax = 0.f;
  for (int c = threadIdx.x; c < h; c += NT) amax = fmaxf(amax, fabsf(to_f(xr[c])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float s = amax == 0.f ? 1.f : amax / 127.f;
  if (threadIdx.x == 0) scales[blockIdx.x] = s;

  const long long j0 = base / 4, j1 = (base + h - 1) / 4;
  for (long long j = j0 + threadIdx.x; j <= j1; j += NT) {
    const uint4 r = fa::philox_block(j, seed);
    const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const long long i = 4 * j + l;
      if (i < base || i >= base + h) continue;
      const float u = float(bits[l] >> 9) * (1.f / 8388608.f);
      const float v = floorf(to_f(x[i]) / s + u);
      q[i] = int8_t(fminf(fmaxf(v, -127.f), 127.f));
    }
  }
}

constexpr int kGroups = 4;   // groups of 8 a lane holds in registers

// q of one group of 8 from its values, the row's scale and the group's
// Philox words: floor(x / s + u) clipped to [-127, 127], packed in 8 bytes,
// with x / s the IEEE quotient and u = (bits >> 9) 2^-23.  Nothing here
// runs on the conversion pipe (a quarter of the FP32 rate): u is 1.m - 1
// built from the bits, and floor(t) for |t| < 2^22 is the low bits of
// t + 1.5 * 2^23 rounded down, read as an integer.
__device__ __forceinline__ uint2 quantize8(const float (&f)[8], float s, const uint32_t* bits) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float u = __fsub_rn(__uint_as_float((bits[k] >> 9) | 0x3f800000u), 1.f);
    const float t = __fadd_rn(__fdiv_rn(f[k], s), u);
    int v = __float_as_int(__fadd_rd(t, 12582912.f)) - 0x4B400000;
    v = max(-127, min(127, v));
    w[k / 4] |= uint32_t(v & 0xff) << (8 * (k % 4));
  }
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ void group_words(long long e0, unsigned long long seed,
                                            uint32_t (&bits)[8]) {
  const uint4 a = fa::philox_block(e0 >> 2, seed), b = fa::philox_block((e0 >> 2) + 1, seed);
  bits[0] = a.x, bits[1] = a.y, bits[2] = a.z, bits[3] = a.w;
  bits[4] = b.x, bits[5] = b.y, bits[6] = b.z, bits[7] = b.w;
}

__device__ __forceinline__ float amax8(const float* f, float m) {
#pragma unroll
  for (int k = 0; k < 8; ++k) m = fmaxf(m, fabsf(f[k]));
  return m;
}

// The vector path: rows of h % 8 == 0 elements, L lanes a row.
template <typename T>
__global__ void __launch_bounds__(NT)
stochastic_quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                             float* __restrict__ scales, long long n, int h, int L,
                             unsigned long long seed) {
  constexpr int V = fa::kVec<T>, kLoads = 8 / V;
  const int lane = threadIdx.x % 32, sl = lane % L;
  const long long row =
      ((long long)blockIdx.x * (NT / 32) + threadIdx.x / 32) * (32 / L) + lane / L;
  const bool valid = row < n;
  const int groups = h / 8;
  const T* xr = x + row * h;
  const long long e_row = row * h;

  float amax = 0.f, f[8];
  if (groups <= kGroups * L) {
    uint4 raw[kGroups][kLoads];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int gi = sl + g * L;
      if (valid && gi < groups)
#pragma unroll
        for (int k = 0; k < kLoads; ++k) raw[g][k] = fa::load16(xr + gi * 8 + k * V);
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      if (valid && sl + g * L < groups) {
#pragma unroll
        for (int k = 0; k < kLoads; ++k) fa::unpack16<T>(raw[g][k], f + k * V);
        amax = amax8(f, amax);
      }
    }
    for (int off = L / 2; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = amax == 0.f ? 1.f : amax / 127.f;
    if (valid && sl == 0) scales[row] = s;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int gi = sl + g * L;
      if (valid && gi < groups) {
        uint32_t bits[8];
        group_words(e_row + gi * 8, seed, bits);
#pragma unroll
        for (int k = 0; k < kLoads; ++k) fa::unpack16<T>(raw[g][k], f + k * V);
        *reinterpret_cast<uint2*>(q + e_row + gi * 8) = quantize8(f, s, bits);
      }
    }
    return;
  }
  // a wide row: the absmax walk, then the quantizing walk (x again, from L2)
  for (int gi = sl; valid && gi < groups; gi += L) {
#pragma unroll
    for (int k = 0; k < kLoads; ++k) fa::unpack16<T>(fa::load16(xr + gi * 8 + k * V), f + k * V);
    amax = amax8(f, amax);
  }
  for (int off = L / 2; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = amax == 0.f ? 1.f : amax / 127.f;
  if (valid && sl == 0) scales[row] = s;
  for (int gi = sl; valid && gi < groups; gi += L) {
    uint32_t bits[8];
    group_words(e_row + gi * 8, seed, bits);
#pragma unroll
    for (int k = 0; k < kLoads; ++k) fa::unpack16<T>(fa::load16(xr + gi * 8 + k * V), f + k * V);
    *reinterpret_cast<uint2*>(q + e_row + gi * 8) = quantize8(f, s, bits);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* q, float* scales, int n, int h,
                   unsigned long long seed, cudaStream_t st) {
  const bool vec = h % 8 == 0 && fa::aligned16(x) && fa::aligned16(q);
  if (!vec) {
    stochastic_quant_kernel<T><<<n, NT, 0, st>>>(static_cast<const T*>(x),
                                                 static_cast<int8_t*>(q), scales, h, seed);
    return cudaGetLastError();
  }
  const int groups = h / 8;
  int L = 1;
  while (L < 32 && kGroups * L < groups) L *= 2;
  const long long rows_per_block = (long long)(NT / 32) * (32 / L);
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  stochastic_quant_rows_kernel<T><<<unsigned(blocks), NT, 0, st>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), scales, n, h, L, seed);
  return cudaGetLastError();
}

}  // namespace

// x (n, h) row-major in dtype (0 = float32, 1 = bfloat16); q (n, h) int8;
// scales (n,) f32.
extern "C" int fa_stochastic_quant(const void* x, void* q, void* scales, int n, int h,
                                   unsigned long long seed, int dtype, void* stream) {
  if (n == 0 || h == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = static_cast<float*>(scales);
  if (dtype == 0) return launch<float>(x, q, s, n, h, seed, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, q, s, n, h, seed, st);
  return int(cudaErrorInvalidValue);
}
