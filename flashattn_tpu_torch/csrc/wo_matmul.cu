// Weight-only quantized matmul: y = cast_T((x @ W_payload) * scales), with
// x (M, K) in f32 or bf16, W (K, N) an int8 or fp8 (e4m3) payload and one
// f32 scale per output column; the product accumulates in f32.
//
// Replaces the TPU kernel flashattn_tpu/ops/quant.py::_wo_matmul_kernel
// (wrapper int8_weight_only_matmul), which converts each weight tile to
// x's dtype in VMEM, accumulates the dot in f32 over the K grid axis and
// applies the per-column scale once at the end.  Both payload types are
// exact in bf16 and f32, so converting a weight to f32 here gives the same
// value as converting it to x's dtype.  The JAX wrapper falls back to
// x @ dequantize(W) at shapes its tiling does not divide; this kernel takes
// every M, N and K.
//
// What bounds it on the H100: at decode (M = 4) the weight bytes (one per
// element, the point of quantizing: half of bf16's), at prefill (M in the
// tens of thousands) the multiply-adds, which this simple version issues on
// the CUDA cores in f32 (no mma/wgmma yet) — bound by FP32 issue and
// shared-memory reads.  Design: a block owns a BM x 64 tile of y (BM = 64,
// or 16 when M is small so that decode wastes fewer rows); it walks K in
// steps of 32, staging the x tile and the weight tile in shared memory as
// f32 (the weights are dequantized there, so W never exists at full
// precision in HBM), and each of its 256 threads keeps a (BM / 16) x 4
// block of sums in registers.  The scale multiplies once, in the epilogue.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64, BK = 32, NT = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return float(v); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 v) { return float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, typename W, int BM>
__global__ void __launch_bounds__(NT)
wo_matmul_kernel(const T* __restrict__ x, const W* __restrict__ w,
                 const float* __restrict__ scales, T* __restrict__ y, int M, int N,
                 int K) {
  constexpr int TM = BM / 16;         // rows per thread
  constexpr int TN = 4;               // columns per thread
  __shared__ __align__(16) float xs[BK][BM + 4];   // x tile, k-major
  __shared__ __align__(16) float ws[BK][BN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK, m = m0 + r, k = k0 + c;
      xs[c][r] = (m < M && k < K) ? to_f(x[size_t(m) * K + k]) : 0.f;
    }
    for (int i = threadIdx.x; i < BK * BN; i += NT) {
      const int r = i / BN, c = i % BN, k = k0 + r, n = n0 + c;
      ws[r][c] = (k < K && n < N) ? to_f(w[size_t(k) * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      if constexpr (TM == 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
        a[0] = a4.x; a[1] = a4.y; a[2] = a4.z; a[3] = a4.w;
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
      }
      const float4 b4 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + tx * 4 + j;
    if (n >= N) continue;
    const float s = scales[n];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i;
      if (m < M) put(y + size_t(m) * N + n, acc[i][j] * s);
    }
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, const float* scales, void* y, int M,
                   int N, int K, cudaStream_t st) {
  const unsigned gx = (N + BN - 1) / BN;
  if (M <= 16) {
    wo_matmul_kernel<T, W, 16><<<dim3(gx, (M + 15) / 16), NT, 0, st>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), scales,
        static_cast<T*>(y), M, N, K);
  } else {
    wo_matmul_kernel<T, W, 64><<<dim3(gx, (M + 63) / 64), NT, 0, st>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), scales,
        static_cast<T*>(y), M, N, K);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_payload(int payload, const void* x, const void* w,
                             const float* scales, void* y, int M, int N, int K,
                             cudaStream_t st) {
  if (payload == 2) return launch<T, int8_t>(x, w, scales, y, M, N, K, st);
  if (payload == 3) return launch<T, __nv_fp8_e4m3>(x, w, scales, y, M, N, K, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (M, K), y (M, N) row-major in dtype (0 = float32, 1 = bfloat16); w
// (K, N) row-major payload (2 = int8, 3 = float8 e4m3); scales (N,) f32.
extern "C" int fa_wo_matmul(const void* x, const void* w, const void* scales, void* y,
                            int M, int N, int K, int dtype, int payload,
                            void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scales);
  if (dtype == 0) return dispatch_payload<float>(payload, x, w, s, y, M, N, K, st);
  if (dtype == 1)
    return dispatch_payload<__nv_bfloat16>(payload, x, w, s, y, M, N, K, st);
  return int(cudaErrorInvalidValue);
}
