// 16-byte accesses of f32 and bf16 tensors: a uint4 holds 4 floats or 8
// bf16 values, widened to and rounded from f32 (round to nearest even, as
// __float2bfloat16).  Used by the bandwidth kernels (layernorm.cu,
// dropout.cu, softmax.cu), whose vector paths need 16-byte aligned bases;
// with the grid those kernels size to the card (resident_blocks).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

template <typename T>
constexpr int kVec = 16 / sizeof(T);  // values in 16 bytes

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// One 32-bit word of T values as floats (1 f32, or 2 bf16: low half first).
__device__ __forceinline__ void unpack_word(uint32_t w, float* f, float) {
  f[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack_word(uint32_t w, float* f, __nv_bfloat16) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack_word(const float* f, float) {
  return __float_as_uint(f[0]);
}
__device__ __forceinline__ uint32_t pack_word(const float* f, __nv_bfloat16) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16(f[0]))) |
         (uint32_t(__bfloat16_as_ushort(__float2bfloat16(f[1]))) << 16);
}

// `words` 32-bit words of T as floats: f holds words * 4 / sizeof(T).
template <typename T, int kWords>
__device__ __forceinline__ void unpack(const uint32_t* w, float* f) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) unpack_word(w[i], f + i * (4 / sizeof(T)), T());
}

template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  unpack<T, 4>(w, f);
}

template <typename T>
__device__ __forceinline__ uint4 pack16(const float* f) {
  constexpr int e = 4 / sizeof(T);
  return make_uint4(pack_word(f, T()), pack_word(f + e, T()), pack_word(f + 2 * e, T()),
                    pack_word(f + 3 * e, T()));
}

// Blocks of `kernel` at `threads` a block that the current device holds at
// once (SMs x resident blocks an SM, at least 1): the grid of a kernel whose
// blocks walk their work.  *per_sm caches the kernel's occupancy (a static
// of its launcher, 0 before the first call); the SM count is cached per
// device.
template <typename Kernel>
inline cudaError_t resident_blocks(Kernel kernel, int threads, int* per_sm, long long* blocks) {
  if (*per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, 0);
    if (e != cudaSuccess) return e;
  }
  static int sms_by_device[64] = {0};
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && sms_by_device[dev] > 0) {
    sms = sms_by_device[dev];
  } else {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (dev < 64) sms_by_device[dev] = sms;
  }
  *blocks = (long long)sms * (*per_sm > 0 ? *per_sm : 1);
  return cudaSuccess;
}

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

}  // namespace fa
