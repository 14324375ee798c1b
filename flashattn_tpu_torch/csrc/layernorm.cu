// Fused LayerNorm forward and backward.  The forward: y = (x - mean) * rstd
// * gamma + beta over the last dim, with the per-row mean and rstd (f32)
// kept as residuals; the backward is described above its kernels below.
//
// Replaces the TPU kernel flashattn_tpu/ops/layernorm.py::_ln_fwd_kernel
// (wrapper _ln_fwd), which normalises a VMEM block of rows per grid step.
//
// What bounds it on the H100: bytes.  A row is read and written once from
// HBM (2 bytes an element each way in bf16), and the arithmetic is a few
// operations an element.  The 16-byte path (layernorm_fwd_vec_kernel, the
// backward's layout) reads each row once: a row group of G warps owns a
// row, each lane holding C 16-byte chunks of x in registers, all loads
// issued before any is used; the mean, then the centred variance, from the
// registers (the arithmetic order of _ln_fwd_kernel: mean = sum / h, var =
// sum((x - mean)^2) / h, rstd = rsqrt(var + eps), y = (x - mean) * rstd *
// gamma + beta), by warp shuffles and, for G > 1, the group's warps through
// shared memory in warp order behind the group's own named barrier; y
// stored from the registers with 16-byte stores, mean and rstd by the
// group's first lane.  gamma and beta are read once per lane, with 16-byte
// loads in their own dtype (two per chunk for f32 beside bf16 x), and kept
// in registers while the lane's group walks its rows: the grid is sized to
// the card (SMs x resident blocks).  G and C as the backward picks them (G
// <= 8 warps, C <= 4 chunks: h up to 8192 bf16, 4096 f32).  Registers
// (nvcc -Xptxas -v, sm_90a, no spills): bf16 x and gamma at G 4, C 2 (the
// train rows, 2048) 59, at G 2, C 2 (1024) 59, at G 8, C 4 104; with f32
// gamma 61 and 108; f32 x and gamma 48 (C 2) and 76 (C 4).  The
// generic path (layernorm_fwd_kernel: one warp a row, scalar accesses, the
// second and third passes over the row from L1) takes any h and any
// alignment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

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

// Backward: dx = rstd * (dy*gamma - mean_h(dy*gamma) - xhat * mean_h(dy*gamma*xhat)),
// dgamma = sum_rows(dy * xhat), dbeta = sum_rows(dy), xhat = (x - mean) * rstd
// (the formulas of flashattn_tpu/ops/layernorm.py:88-91), all in f32.
//
// Replaces the TPU kernel _ln_bwd_kernel (wrapper _ln_bwd), whose grid runs
// in order and accumulates dgamma/dbeta in one revisited block.  Blocks run
// in no order on the card, so the column sums take two launches instead:
// the row kernel writes each block's partial sums into a (blocks, h) f32
// scratch, and layernorm_colsum_kernel adds the partials per column in a
// fixed order.  Deterministic, no atomics.
//
// What bounds it on the H100: bytes (x and dy read once, dx written once:
// 201 MB at (16384, 2048) bf16, 0.060 ms at 3.35 TB/s); a few operations
// an element.  The vector path (layernorm_bwd_vec_kernel) reads each row
// once from HBM: a row group of G warps owns a row, each lane holding C
// 16-byte chunks of x and of dy in registers, all loads issued before any
// is used; both row means come from warp shuffles (and, for G > 1, the
// group's warps' sums through shared memory in warp order, behind a
// named barrier of the group alone); dx is written from the registers with
// 16-byte stores.  Each lane keeps its columns' dgamma/dbeta partials in
// f32 registers over every row its group walks.  The grid is sized to the
// card (SMs x resident blocks), each block a contiguous range of rows, so
// the partial scratch is a few MB; at the end a block adds its row groups'
// partials in group order through shared memory.  C is 2 where G <= 8
// covers the row (h up to 512 chunks: 4096 bf16, 2048 f32), else 4 (up to
// 8192 bf16, 4096 f32), with a masked last chunk.  Registers (nvcc -Xptxas
// -v, sm_90a, no spills): at (16384, 2048) bf16, G = 4 and C = 2, 100
// registers, two blocks an SM (C = 4 with G = 2 took 161 registers, one
// block an SM, and ran 5% slower; capping it at 128 spilled); f32, G = 8
// and C = 2, 80 registers; C = 4 at G = 8, 164.  The generic path
// (layernorm_bwd_kernel: any h, any alignment, 64 rows a block, scalar
// accesses, the second read of a row from L2) serves the rest.
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kMaxChunks = 4;  // 16-byte chunks of x (and of dy) a lane holds
constexpr int kBwdRows = 64;  // rows per block of the generic path

// kWords 32-bit words from a 16-byte (kWords % 4 == 0) or 8-byte aligned p.
template <int kWords>
__device__ __forceinline__ void load_words(const void* p, uint32_t* w) {
  if constexpr (kWords % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kWords / 4; ++q) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[q];
      w[4 * q] = u.x;
      w[4 * q + 1] = u.y;
      w[4 * q + 2] = u.z;
      w[4 * q + 3] = u.w;
    }
  } else {
    static_assert(kWords == 2, "8 or 16k bytes");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  }
}

__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <typename T, typename P, int G, int C>
__global__ void __launch_bounds__(kBwdThreads)
layernorm_fwd_vec_kernel(const T* __restrict__ x, const P* __restrict__ gamma,
                         const P* __restrict__ beta, T* __restrict__ y,
                         float* __restrict__ mean_out, float* __restrict__ rstd_out, int n,
                         int h, float eps) {
  constexpr int V = fa::kVec<T>;                 // values in a chunk
  constexpr int GW = V * int(sizeof(P)) / 4;     // words of gamma (or beta) a chunk
  constexpr int R = kBwdWarps / G;               // row groups in a block
  __shared__ float red[2][kBwdWarps];            // a warp's sum, then its sum of squares

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / G, wg = warp % G;
  const int nv = h / V;
  // chunk k of this lane: 16-byte vector (k * G + wg) * 32 + lane of the row
  int vec[C];
  bool live[C];
  uint32_t gw[C][GW], bw[C][GW];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    vec[k] = (k * G + wg) * 32 + lane;
    live[k] = vec[k] < nv;
    if (live[k]) {
      load_words<GW>(gamma + size_t(vec[k]) * V, gw[k]);
      load_words<GW>(beta + size_t(vec[k]) * V, bw[k]);
    }
  }

  for (int row = blockIdx.x * R + grp; row < n; row += gridDim.x * R) {
    const size_t base = size_t(row) * h;
    uint4 xv[C];
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (live[k]) xv[k] = fa::load16(x + base + size_t(vec[k]) * V);

    float s = 0.f;
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (live[k]) {
        float xf[V];
        fa::unpack16<T>(xv[k], xf);
#pragma unroll
        for (int j = 0; j < V; ++j) s += xf[j];
      }
    s = warp_sum(s);
    if constexpr (G > 1) {
      if (lane == 0) red[0][warp] = s;
      group_sync(1 + grp, 32 * G);
      s = 0.f;
#pragma unroll
      for (int i = 0; i < G; ++i) s += red[0][grp * G + i];
    }
    const float mean = s / h;

    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (live[k]) {
        float xf[V];
        fa::unpack16<T>(xv[k], xf);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = xf[j] - mean;
          ss += d * d;
        }
      }
    ss = warp_sum(ss);
    if constexpr (G > 1) {
      if (lane == 0) red[1][warp] = ss;
      group_sync(1 + grp, 32 * G);
      ss = 0.f;
#pragma unroll
      for (int i = 0; i < G; ++i) ss += red[1][grp * G + i];
    }
    const float rstd = rsqrtf(ss / h + eps);

#pragma unroll
    for (int k = 0; k < C; ++k)
      if (live[k]) {
        float xf[V], gf[V], bf[V];
        fa::unpack16<T>(xv[k], xf);
        fa::unpack<P, GW>(gw[k], gf);
        fa::unpack<P, GW>(bw[k], bf);
#pragma unroll
        for (int j = 0; j < V; ++j) xf[j] = (xf[j] - mean) * rstd * gf[j] + bf[j];
        fa::store16(y + base + size_t(vec[k]) * V, fa::pack16<T>(xf));
      }
    if (wg == 0 && lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

template <typename T, typename P, int G, int C>
cudaError_t launch_fwd_vec(const void* x, const void* gamma, const void* beta, void* y,
                           void* mean, void* rstd, int n, int h, float eps,
                           cudaStream_t stream) {
  static int per_sm = 0;
  long long resident = 0;
  const cudaError_t e = fa::resident_blocks(layernorm_fwd_vec_kernel<T, P, G, C>, kBwdThreads,
                                            &per_sm, &resident);
  if (e != cudaSuccess) return e;
  constexpr int R = kBwdWarps / G;
  const long long want = (n + R - 1) / R;
  const int blocks = int(want < resident ? want : resident);
  layernorm_fwd_vec_kernel<T, P, G, C><<<blocks, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const P*>(gamma), static_cast<const P*>(beta),
      static_cast<T*>(y), static_cast<float*>(mean), static_cast<float*>(rstd), n, h, eps);
  return cudaGetLastError();
}

// The 16-byte path when h is whole chunks (at most 1024: 8192 bf16, 4096
// f32) and x, y, gamma and beta are 16-byte aligned; the generic one else.
// G and C as the backward picks them.
template <typename T, typename P>
cudaError_t run_fwd(const void* x, const void* gamma, const void* beta, void* y, void* mean,
                    void* rstd, int n, int h, float eps, cudaStream_t st) {
  constexpr int V = fa::kVec<T>;
  const int nv = h / V;
  const bool vec = h % V == 0 && nv <= 32 * kBwdWarps * kMaxChunks && fa::aligned16(x) &&
                   fa::aligned16(y) && fa::aligned16(gamma) && fa::aligned16(beta);
  if (!vec) return launch<T, P>(x, gamma, beta, y, mean, rstd, n, h, eps, st);
  if (nv <= 32) return launch_fwd_vec<T, P, 1, 1>(x, gamma, beta, y, mean, rstd, n, h, eps, st);
  if (nv <= 64) return launch_fwd_vec<T, P, 1, 2>(x, gamma, beta, y, mean, rstd, n, h, eps, st);
  if (nv <= 128) return launch_fwd_vec<T, P, 2, 2>(x, gamma, beta, y, mean, rstd, n, h, eps, st);
  if (nv <= 256) return launch_fwd_vec<T, P, 4, 2>(x, gamma, beta, y, mean, rstd, n, h, eps, st);
  if (nv <= 512) return launch_fwd_vec<T, P, 8, 2>(x, gamma, beta, y, mean, rstd, n, h, eps, st);
  return launch_fwd_vec<T, P, 8, 4>(x, gamma, beta, y, mean, rstd, n, h, eps, st);
}

template <typename T, typename P, int G, int C>
__global__ void __launch_bounds__(kBwdThreads)
layernorm_bwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const float* __restrict__ mean, const float* __restrict__ rstd,
                         const P* __restrict__ gamma, T* __restrict__ dx,
                         float* __restrict__ dg_part, float* __restrict__ db_part, int n,
                         int h, int rows_per_block) {
  constexpr int V = fa::kVec<T>;                 // values in a chunk
  constexpr int GW = V * int(sizeof(P)) / 4;     // words of gamma a chunk
  constexpr int R = kBwdWarps / G;               // row groups in a block
  constexpr int kCols = 32 * G * C * V;          // columns a row group covers
  __shared__ float2 red[2][kBwdWarps];           // a warp's two row sums, by parity
  __shared__ __align__(16) float acc[R > 1 ? 2 * kCols : 4];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / G, wg = warp % G;
  const int nv = h / V;
  // chunk k of this lane: 16-byte vector (k * G + wg) * 32 + lane of the row
  int vec[C];
  bool live[C];
  uint32_t gw[C][GW];
  float dg[C][V], db[C][V];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    vec[k] = (k * G + wg) * 32 + lane;
    live[k] = vec[k] < nv;
    if (live[k]) load_words<GW>(gamma + size_t(vec[k]) * V, gw[k]);
#pragma unroll
    for (int j = 0; j < V; ++j) dg[k][j] = db[k][j] = 0.f;
  }

  const int row_end = min(n, (blockIdx.x + 1) * rows_per_block);
  int parity = 0;
  for (int row = blockIdx.x * rows_per_block + grp; row < row_end; row += R) {
    const size_t base = size_t(row) * h;
    uint4 xv[C], dv[C];
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (live[k]) {
        xv[k] = fa::load16(x + base + size_t(vec[k]) * V);
        dv[k] = fa::load16(dy + base + size_t(vec[k]) * V);
      }
    const float mu = mean[row], rs = rstd[row];

    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (live[k]) {
        float xf[V], df[V], gf[V];
        fa::unpack16<T>(xv[k], xf);
        fa::unpack16<T>(dv[k], df);
        fa::unpack<P, GW>(gw[k], gf);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xh = (xf[j] - mu) * rs, g = df[j] * gf[j];
          s1 += g;
          s2 += g * xh;
          dg[k][j] += df[j] * xh;
          db[k][j] += df[j];
        }
      }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if constexpr (G > 1) {
      if (lane == 0) red[parity][warp] = make_float2(s1, s2);
      group_sync(1 + grp, 32 * G);
      s1 = s2 = 0.f;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float2 p = red[parity][grp * G + i];
        s1 += p.x;
        s2 += p.y;
      }
      parity ^= 1;
    }
    const float m1 = s1 / h, m2 = s2 / h;

#pragma unroll
    for (int k = 0; k < C; ++k)
      if (live[k]) {
        float xf[V], df[V], gf[V];
        fa::unpack16<T>(xv[k], xf);
        fa::unpack16<T>(dv[k], df);
        fa::unpack<P, GW>(gw[k], gf);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xh = (xf[j] - mu) * rs;
          xf[j] = rs * (df[j] * gf[j] - m1 - xh * m2);
        }
        fa::store16(dx + base + size_t(vec[k]) * V, fa::pack16<T>(xf));
      }
  }

  // The block's partials: row group 0's, plus 1's, ... in order; the last
  // group writes the block's (h,) rows of the scratch.
  float* dgp = dg_part + size_t(blockIdx.x) * h;
  float* dbp = db_part + size_t(blockIdx.x) * h;
#pragma unroll 1
  for (int g = 0; g < R; ++g) {
    if (grp == g) {
#pragma unroll
      for (int k = 0; k < C; ++k)
        if (live[k]) {
          const int c0 = vec[k] * V;
#pragma unroll
          for (int q = 0; q < V / 4; ++q) {
            float4 a = make_float4(dg[k][4 * q], dg[k][4 * q + 1], dg[k][4 * q + 2],
                                   dg[k][4 * q + 3]);
            float4 b = make_float4(db[k][4 * q], db[k][4 * q + 1], db[k][4 * q + 2],
                                   db[k][4 * q + 3]);
            float4* sa = reinterpret_cast<float4*>(acc + c0 + 4 * q);
            float4* sb = reinterpret_cast<float4*>(acc + kCols + c0 + 4 * q);
            if (g > 0) {
              const float4 pa = *sa, pb = *sb;
              a = make_float4(pa.x + a.x, pa.y + a.y, pa.z + a.z, pa.w + a.w);
              b = make_float4(pb.x + b.x, pb.y + b.y, pb.z + b.z, pb.w + b.w);
            }
            if (g == R - 1) {
              *reinterpret_cast<float4*>(dgp + c0 + 4 * q) = a;
              *reinterpret_cast<float4*>(dbp + c0 + 4 * q) = b;
            } else {
              *sa = a;
              *sb = b;
            }
          }
        }
    }
    if (g < R - 1) __syncthreads();
  }
}

// The generic path: any h and alignment.  A block first takes the two row
// means of its 64 rows, one warp per row, then walks its rows again
// column-major (thread per column, rows in order), writing dx and summing
// the columns; the second read of its rows mostly hits L2.  Rows past n are
// never read, so they cannot enter the column sums.
template <typename T, typename P>
__global__ void __launch_bounds__(kBwdThreads)
layernorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ mean, const float* __restrict__ rstd,
                     const P* __restrict__ gamma, T* __restrict__ dx,
                     float* __restrict__ dg_part, float* __restrict__ db_part, int n,
                     int h) {
  __shared__ float m1_s[kBwdRows], m2_s[kBwdRows], mean_s[kBwdRows], rstd_s[kBwdRows];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kBwdRows;
  const int rows = min(kBwdRows, n - row0);

  for (int r = warp; r < rows; r += kBwdWarps) {
    const int row = row0 + r;
    const float mu = mean[row], rs = rstd[row];
    const T* xr = x + size_t(row) * h;
    const T* dyr = dy + size_t(row) * h;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < h; c += 32) {
      const float g = to_f(dyr[c]) * to_f(gamma[c]);
      s1 += g;
      s2 += g * (to_f(xr[c]) - mu) * rs;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      m1_s[r] = s1 / h;
      m2_s[r] = s2 / h;
      mean_s[r] = mu;
      rstd_s[r] = rs;
    }
  }
  __syncthreads();

  for (int c = threadIdx.x; c < h; c += blockDim.x) {
    const float gc = to_f(gamma[c]);
    float dg = 0.f, db = 0.f;
    for (int r = 0; r < rows; ++r) {
      const size_t at = size_t(row0 + r) * h + c;
      const float d = to_f(dy[at]);
      const float xh = (to_f(x[at]) - mean_s[r]) * rstd_s[r];
      put(dx + at, rstd_s[r] * (d * gc - m1_s[r] - xh * m2_s[r]));
      dg += d * xh;
      db += d;
    }
    dg_part[size_t(blockIdx.x) * h + c] = dg;
    db_part[size_t(blockIdx.x) * h + c] = db;
  }
}

// dgamma/dbeta = the partials summed per column: 32 columns x 32 row groups
// per block, each group in row order, then the 32 groups in order.
template <typename P>
__global__ void __launch_bounds__(1024)
layernorm_colsum_kernel(const float* __restrict__ dg_part,
                        const float* __restrict__ db_part, P* __restrict__ dg,
                        P* __restrict__ db, int parts, int h) {
  __shared__ float sg[32][33], sb[32][33];
  const int cx = threadIdx.x % 32, ry = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + cx;
  float g = 0.f, b = 0.f;
  if (c < h) {
#pragma unroll 4
    for (int p = ry; p < parts; p += 32) {
      g += dg_part[size_t(p) * h + c];
      b += db_part[size_t(p) * h + c];
    }
  }
  sg[ry][cx] = g;
  sb[ry][cx] = b;
  __syncthreads();
  if (ry == 0 && c < h) {
    float gs = 0.f, bs = 0.f;
    for (int k = 0; k < 32; ++k) {
      gs += sg[k][cx];
      bs += sb[k][cx];
    }
    put(dg + c, gs);
    put(db + c, bs);
  }
}

struct BwdArgs {
  const void *x, *dy, *mean, *rstd, *gamma;
  void *dx, *dg_part, *db_part, *dg, *db;
  int n, h;
  int parts;  // partial rows the scratch holds (in), or the launch writes (plan)
  cudaStream_t stream;
};

// The vector path with G warps a row and C chunks a lane: rows per block
// so that the grid fills the card once; plan_only sets a.parts to the grid.
template <typename T, typename P, int G, int C>
cudaError_t run_vec(BwdArgs& a, bool plan_only) {
  static int per_sm = 0;
  long long resident = 0;
  const cudaError_t e = fa::resident_blocks(layernorm_bwd_vec_kernel<T, P, G, C>, kBwdThreads,
                                            &per_sm, &resident);
  if (e != cudaSuccess) return e;
  constexpr int R = kBwdWarps / G;
  const int slots = int(resident);
  const int rows = (((a.n + slots - 1) / slots) + R - 1) / R * R;
  const int blocks = a.n == 0 ? 0 : (a.n + rows - 1) / rows;
  if (plan_only) {
    a.parts = blocks;
    return cudaSuccess;
  }
  if (blocks > a.parts) return cudaErrorInvalidValue;
  if (blocks > 0)
    layernorm_bwd_vec_kernel<T, P, G, C><<<blocks, kBwdThreads, 0, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.dy),
        static_cast<const float*>(a.mean), static_cast<const float*>(a.rstd),
        static_cast<const P*>(a.gamma), static_cast<T*>(a.dx),
        static_cast<float*>(a.dg_part), static_cast<float*>(a.db_part), a.n, a.h, rows);
  a.parts = blocks;
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t run_generic(BwdArgs& a, bool plan_only) {
  const int blocks = (a.n + kBwdRows - 1) / kBwdRows;
  if (plan_only) {
    a.parts = blocks;
    return cudaSuccess;
  }
  if (blocks > a.parts) return cudaErrorInvalidValue;
  if (blocks > 0)
    layernorm_bwd_kernel<T, P><<<blocks, kBwdThreads, 0, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.dy),
        static_cast<const float*>(a.mean), static_cast<const float*>(a.rstd),
        static_cast<const P*>(a.gamma), static_cast<T*>(a.dx),
        static_cast<float*>(a.dg_part), static_cast<float*>(a.db_part), a.n, a.h);
  a.parts = blocks;
  return cudaGetLastError();
}

// The row kernel (vector path when h is whole chunks, within C <= 4 and
// G <= 8, and x, dy, dx and gamma are 16-byte aligned; else generic), then
// the column sums; or, with plan_only, only the number of partial rows.
template <typename T, typename P>
cudaError_t run_bwd(BwdArgs& a, bool plan_only) {
  constexpr int V = fa::kVec<T>;
  const int nv = a.h / V;
  const bool vec = a.h % V == 0 && nv <= 32 * kBwdWarps * kMaxChunks &&
                   fa::aligned16(a.x) && fa::aligned16(a.dy) && fa::aligned16(a.dx) &&
                   fa::aligned16(a.gamma);
  cudaError_t e;
  if (!vec) e = run_generic<T, P>(a, plan_only);
  else if (nv <= 32) e = run_vec<T, P, 1, 1>(a, plan_only);
  else if (nv <= 64) e = run_vec<T, P, 1, 2>(a, plan_only);
  else if (nv <= 128) e = run_vec<T, P, 2, 2>(a, plan_only);
  else if (nv <= 256) e = run_vec<T, P, 4, 2>(a, plan_only);
  else if (nv <= 512) e = run_vec<T, P, 8, 2>(a, plan_only);
  else e = run_vec<T, P, 8, 4>(a, plan_only);
  if (e != cudaSuccess || plan_only) return e;
  layernorm_colsum_kernel<P><<<(a.h + 31) / 32, 1024, 0, a.stream>>>(
      static_cast<const float*>(a.dg_part), static_cast<const float*>(a.db_part),
      static_cast<P*>(a.dg), static_cast<P*>(a.db), a.parts, a.h);
  return cudaGetLastError();
}

cudaError_t bwd_dispatch(BwdArgs& a, int x_dtype, int p_dtype, bool plan_only) {
  if (x_dtype == 0 && p_dtype == 0) return run_bwd<float, float>(a, plan_only);
  if (x_dtype == 0 && p_dtype == 1) return run_bwd<float, __nv_bfloat16>(a, plan_only);
  if (x_dtype == 1 && p_dtype == 0) return run_bwd<__nv_bfloat16, float>(a, plan_only);
  if (x_dtype == 1 && p_dtype == 1)
    return run_bwd<__nv_bfloat16, __nv_bfloat16>(a, plan_only);
  return cudaErrorInvalidValue;
}

}  // namespace

// The number of (h,) f32 partial rows fa_layernorm_bwd writes into each of
// dg_part and db_part for these arguments (its row kernel's block count),
// or minus a CUDA error code.  Launches nothing.
extern "C" int fa_layernorm_bwd_parts(const void* x, const void* dy, const void* gamma,
                                      const void* dx, int n, int h, int x_dtype,
                                      int p_dtype) {
  BwdArgs a{x, dy, nullptr, nullptr, gamma, const_cast<void*>(dx), nullptr, nullptr,
            nullptr, nullptr, n, h, 0, nullptr};
  const cudaError_t e = bwd_dispatch(a, x_dtype, p_dtype, true);
  return e == cudaSuccess ? a.parts : -int(e);
}

// x, dy, dx (n, h); mean, rstd (n,) f32; gamma, dg, db (h,); dg_part and
// db_part f32 scratch of (parts, h) each, parts at least what
// fa_layernorm_bwd_parts returns for the same pointers and sizes.  Same
// dtype codes as below.
extern "C" int fa_layernorm_bwd(const void* x, const void* dy, const void* mean,
                                const void* rstd, const void* gamma, void* dx,
                                void* dg_part, void* db_part, void* dg, void* db,
                                int n, int h, int parts, int x_dtype, int p_dtype,
                                void* stream) {
  if (h == 0) return 0;
  BwdArgs a{x, dy, mean, rstd, gamma, dx, dg_part, db_part, dg, db, n, h, parts,
            static_cast<cudaStream_t>(stream)};
  return int(bwd_dispatch(a, x_dtype, p_dtype, false));
}

// dtype codes: 0 = float32, 1 = bfloat16 (x/y share one, gamma/beta another).
extern "C" int fa_layernorm_fwd(const void* x, const void* gamma, const void* beta,
                                void* y, void* mean, void* rstd, int n, int h,
                                float eps, int x_dtype, int p_dtype, void* stream) {
  if (n == 0 || h == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && p_dtype == 0)
    return run_fwd<float, float>(x, gamma, beta, y, mean, rstd, n, h, eps, st);
  if (x_dtype == 0 && p_dtype == 1)
    return run_fwd<float, __nv_bfloat16>(x, gamma, beta, y, mean, rstd, n, h, eps, st);
  if (x_dtype == 1 && p_dtype == 0)
    return run_fwd<__nv_bfloat16, float>(x, gamma, beta, y, mean, rstd, n, h, eps, st);
  if (x_dtype == 1 && p_dtype == 1)
    return run_fwd<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, mean, rstd, n, h, eps,
                                                 st);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
