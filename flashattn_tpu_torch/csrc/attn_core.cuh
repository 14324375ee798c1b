// The CUDA-core online-softmax attention tile of the f32 flash forward
// below F32_TC_MIN_KV keys.
//
// One thread block owns BM query rows and walks the key positions it can
// see in tiles of BN = 64.  Each row r attends the half-open key interval
// [lo_r, hi_r); the callers differ only in how they load and address keys
// and compute those intervals (the `Src` policy below), so causal, window,
// varlen and chunk-causal masks are all one comparison per score, and
// int8 / fp8 payloads with per-token scales are one multiply as a K or V
// row is staged.
//
// What bounds it on the H100: this is the simple CUDA-core (FMA) version.
// Q, K and V tiles are staged in shared memory as f32 and every thread
// computes a TR x TC block of scores with float4 shared-memory reads, so a
// step is bound by shared-memory bandwidth and FP32 issue rather than HBM.
// It serves the f32 flash forward over walks of fewer than F32_TC_MIN_KV
// keys (longer ones run split precision on the tensor cores, flash_fwd.cu;
// single-pass TF32 would break the 1e-4 gates); the bf16 flash forward
// and paged attention (either q dtype) have their own tensor-core kernels
// (flash_fwd.cu, paged_attention.cu, on hopper.cuh and split.cuh), as
// kv8_flash.cu has for every q dtype.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace fa {

constexpr int BN = 64;              // key positions per tile
constexpr float LN2 = 0.6931471805599453f;

// Thread layout for a BM-row tile: RG row groups x CG column groups, with
// CG <= 32 so the threads sharing a row are consecutive lanes of one warp
// (row reductions are xor shuffles).
template <int BM> struct Layout;
template <> struct Layout<64> { static constexpr int RG = 16, CG = 16; };

template <int BM> constexpr int threads() {
  return Layout<BM>::RG * Layout<BM>::CG;
}

template <int D, int BM> constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(BM) * (D + 4) + 2 * size_t(BN) * (D + 4) + size_t(BM) * (BN + 4));
}

// Load four consecutive elements as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&raw.x);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&raw.y);
  float2 fa = __bfloat1622float2(a);
  float2 fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

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

// Src is a policy with:
//   int n_rows;                         valid query rows of this tile
//   int kv_cap;                         key positions >= kv_cap read as 0
//   float4 q4(int r, int c, float scale_log2);   q[r][c..c+3] pre-scaled, r < n_rows
//   void bounds(int r, int& lo, int& hi);   r < n_rows
//   float4 k4(int pos, int c); float4 v4(int pos, int c);   K/V[pos][c..c+3]
//     as f32, 0 <= pos < kv_cap
//   T* o_row(int r);  float* lse_row(int r) (nullptr when not wanted)
// scale_log2 = sm_scale * log2(e) is folded into q as it is staged, so the
// softmax runs in exp2 and lse is converted back to natural log.
template <typename T, int D, int BM, class Src>
__device__ void attend(const Src& src, float scale_log2, float* smem) {
  constexpr int RG = Layout<BM>::RG, CG = Layout<BM>::CG;
  constexpr int NT = RG * CG;
  constexpr int TR = BM / RG;       // rows per thread
  constexpr int TC = BN / CG;       // score columns per thread
  constexpr int CPT = D / CG;       // output columns per thread
  constexpr int DS = D + 4;         // padded row strides (floats)
  constexpr int PS = BN + 4;
  static_assert(TR >= 1 && TC >= 1 && CPT >= 1, "tile layout");

  float* q_s = smem;
  float* k_s = q_s + BM * DS;
  float* v_s = k_s + BN * DS;
  float* p_s = v_s + BN * DS;

  const int t = threadIdx.x;
  const int rg = t / CG, cg = t % CG;

  // Stage the (pre-scaled) query tile; rows past n_rows are zero.
  for (int i = t; i < BM * D / 4; i += NT) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < src.n_rows) v = src.q4(r, c, scale_log2);
    *reinterpret_cast<float4*>(q_s + r * DS + c) = v;
  }

  // Per-row key intervals for this thread's rows; the block's walk covers
  // the union of every row's interval.
  int lo[TR], hi[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = rg + RG * i;
    lo[i] = 0; hi[i] = 0;
    if (r < src.n_rows) src.bounds(r, lo[i], hi[i]);
  }
  int walk_lo = 1 << 30, walk_hi = 0;
  for (int r = 0; r < src.n_rows; ++r) {
    int a, b;
    src.bounds(r, a, b);
    if (a < b) { walk_lo = min(walk_lo, a); walk_hi = max(walk_hi, b); }
  }

  float m[TR], l[TR], acc[TR][CPT];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = -INFINITY; l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[i][e] = 0.f;
  }

  const int start = walk_hi > walk_lo ? (walk_lo / BN) * BN : 0;
  for (int kt = start; kt < walk_hi; kt += BN) {
    __syncthreads();  // previous tile's readers are done with k_s/v_s/p_s
    for (int i = t; i < BN * D / 4; i += NT) {
      const int kr = i / (D / 4), c = (i % (D / 4)) * 4;
      const int pos = kt + kr;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (pos < src.kv_cap) {
        kv = src.k4(pos, c);
        vv = src.v4(pos, c);
      }
      *reinterpret_cast<float4*>(k_s + kr * DS + c) = kv;
      *reinterpret_cast<float4*>(v_s + kr * DS + c) = vv;
    }
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < D; dd += 4) {
      float4 qv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (rg + RG * i) * DS + dd);
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(k_s + (cg + CG * j) * DS + dd);
#pragma unroll
        for (int i = 0; i < TR; ++i)
          s[i][j] += qv[i].x * kv.x + qv[i].y * kv.y + qv[i].z * kv.z +
                     qv[i].w * kv.w;
      }
    }

    // Mask, online-softmax update, and P to shared memory.
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int pos = kt + cg + CG * j;
        if (pos < lo[i] || pos >= hi[i]) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max<CG>(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = exp2f(s[i][j] - m_use);
        sum += p;
        p_s[(rg + RG * i) * PS + cg + CG * j] = p;
      }
      sum = row_sum<CG>(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < CPT; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
      float p[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) p[i] = p_s[(rg + RG * i) * PS + kk];
#pragma unroll
      for (int e = 0; e < CPT; ++e) {
        const float v = v_s[kk * DS + cg + CG * e];
#pragma unroll
        for (int i = 0; i < TR; ++i) acc[i][e] += p[i] * v;
      }
    }
  }

  // A row with no live key (empty interval) writes o = 0 and lse = -inf.
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = rg + RG * i;
    if (r >= src.n_rows) continue;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
    T* o = src.o_row(r);
#pragma unroll
    for (int e = 0; e < CPT; ++e) store1(o + cg + CG * e, acc[i][e] * inv);
    float* lse = src.lse_row(r);
    if (lse != nullptr && cg == 0)
      *lse = l[i] == 0.f ? -INFINITY : m[i] * LN2 + logf(l[i]);
  }
}

// Opt a kernel in to more than 48 KB of dynamic shared memory once.
template <class K> inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

}  // namespace fa
