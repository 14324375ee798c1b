// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011), the counter-based generator of the dropout and stochastic
// quantisation kernels.  Both key it with the whole 64-bit seed (low word,
// high word) and give element i word i % 4 of the block at counter i / 4
// (64 bits in the first two counter words, the other two 0), so the bits
// depend on the element index alone.  ops/dropout.py::philox4x32 computes
// the same function with integer tensor ops.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The four words of Philox block j (elements 4j .. 4j + 3) under `seed`.
__device__ __forceinline__ uint4 philox_block(long long j, unsigned long long seed) {
  return philox4x32_10(
      make_uint4(uint32_t(j), uint32_t((unsigned long long)j >> 32), 0u, 0u),
      make_uint2(uint32_t(seed), uint32_t(seed >> 32)));
}

}  // namespace fa
