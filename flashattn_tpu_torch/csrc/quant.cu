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
// What bounds it on the H100: bytes (x read twice, once for the absmax and
// once to quantize, the second time mostly from L2; one byte written per
// element) with Philox's integer multiplies close behind.  Design: one
// block per row; a block reduction gives the row's absmax, then each
// thread takes whole Philox blocks of four elements (a block may straddle
// two rows: each row's block uses the words of its own elements).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

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

template <typename T>
cudaError_t launch(const void* x, void* q, float* scales, int n, int h,
                   unsigned long long seed, cudaStream_t st) {
  stochastic_quant_kernel<T><<<n, NT, 0, st>>>(static_cast<const T*>(x),
                                               static_cast<int8_t*>(q), scales, h,
                                               seed);
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
