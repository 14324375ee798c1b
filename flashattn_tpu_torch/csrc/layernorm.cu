// Fused LayerNorm forward: y = (x - mean) * rstd * gamma + beta over the
// last dim, with the per-row mean and rstd (f32) kept as residuals.
//
// Replaces the TPU kernel flashattn_tpu/ops/layernorm.py::_ln_fwd_kernel
// (wrapper _ln_fwd), which normalises a VMEM block of rows per grid step.
//
// What bounds it on the H100: bytes.  A row is read and written once from
// HBM (2 bytes an element each way in bf16), and the arithmetic is a few
// operations an element.  Design: one warp per row, statistics in f32 with
// a two-pass (mean, then centred variance) reduction by warp shuffles, so
// no shared memory and no block barrier; the second and third passes over
// the row hit L1.  Any hidden size works (strided loop, no envelope).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

constexpr int kRowsPerBlock = 8;  // one warp per row

template <typename T, typename P>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
layernorm_fwd_kernel(const T* __restrict__ x, const P* __restrict__ gamma,
                     const P* __restrict__ beta, T* __restrict__ y,
                     float* __restrict__ mean_out, float* __restrict__ rstd_out,
                     int n, int h, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;  // whole warp leaves together
  const T* xr = x + size_t(row) * h;
  T* yr = y + size_t(row) * h;

  float s = 0.f;
  for (int c = lane; c < h; c += 32) s += to_f(xr[c]);
  const float mean = warp_sum(s) / h;
  float ss = 0.f;
  for (int c = lane; c < h; c += 32) {
    const float d = to_f(xr[c]) - mean;
    ss += d * d;
  }
  const float rstd = rsqrtf(warp_sum(ss) / h + eps);
  for (int c = lane; c < h; c += 32)
    put(yr + c, (to_f(xr[c]) - mean) * rstd * to_f(gamma[c]) + to_f(beta[c]));
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T, typename P>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y,
                   void* mean, void* rstd, int n, int h, float eps,
                   cudaStream_t stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  layernorm_fwd_kernel<T, P><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const P*>(gamma),
      static_cast<const P*>(beta), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), n, h, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x/y share one, gamma/beta another).
extern "C" int fa_layernorm_fwd(const void* x, const void* gamma, const void* beta,
                                void* y, void* mean, void* rstd, int n, int h,
                                float eps, int x_dtype, int p_dtype, void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && p_dtype == 0)
    return launch<float, float>(x, gamma, beta, y, mean, rstd, n, h, eps, st);
  if (x_dtype == 0 && p_dtype == 1)
    return launch<float, __nv_bfloat16>(x, gamma, beta, y, mean, rstd, n, h, eps, st);
  if (x_dtype == 1 && p_dtype == 0)
    return launch<__nv_bfloat16, float>(x, gamma, beta, y, mean, rstd, n, h, eps, st);
  if (x_dtype == 1 && p_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, mean, rstd, n, h,
                                                 eps, st);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
