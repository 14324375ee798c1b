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
// What bounds it on the H100: bytes (x read once, out written once) with
// Philox's ten rounds of integer multiplies close behind.  Design: one
// thread per Philox block of four elements, a grid-stride loop, an IEEE f32
// division (__fdiv_rn, never a reciprocal) rounded once to the output
// dtype, so the result is bit for bit the plain version's and JAX's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(256)
dropout_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
               unsigned long long seed, uint32_t threshold, float div) {
  const long long blocks4 = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < blocks4;
       j += stride) {
    const uint4 r = fa::philox_block(j, seed);
    const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const long long i = 4 * j + l;
      if (i < n) put(out + i, bits[l] >= threshold ? __fdiv_rn(to_f(x[i]), div) : 0.f);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, long long n, unsigned long long seed,
                   uint32_t threshold, float div, cudaStream_t stream) {
  const long long blocks4 = (n + 3) / 4;
  const long long want = (blocks4 + 255) / 256;
  const int grid = int(want < 132 * 32 ? want : 132 * 32);
  dropout_kernel<T><<<grid, 256, 0, stream>>>(static_cast<const T*>(x),
                                              static_cast<T*>(out), n, seed,
                                              threshold, div);
  return cudaGetLastError();
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
