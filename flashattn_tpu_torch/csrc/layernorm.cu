// Fused LayerNorm forward and backward.  The forward: y = (x - mean) * rstd
// * gamma + beta over the last dim, with the per-row mean and rstd (f32)
// kept as residuals; the backward is described above its kernels below.
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

// Backward: dx = rstd * (dy*gamma - mean_h(dy*gamma) - xhat * mean_h(dy*gamma*xhat)),
// dgamma = sum_rows(dy * xhat), dbeta = sum_rows(dy), xhat = (x - mean) * rstd
// (the formulas of flashattn_tpu/ops/layernorm.py:88-91).
//
// Replaces the TPU kernel _ln_bwd_kernel (wrapper _ln_bwd), whose grid runs
// in order and accumulates dgamma/dbeta in one revisited block.  Blocks run
// in no order on the card, so the column sums take two launches instead:
// layernorm_bwd_kernel writes each block's partial sums over its 64 rows
// into a (row blocks, h) f32 scratch, and layernorm_colsum_kernel adds the
// partials per column in a fixed order.  Deterministic, no atomics.
//
// What bounds it: bytes (read x and dy, write dx).  A block first takes the
// two row means of its 64 rows, one warp per row, then walks its rows
// again column-major (thread per column, rows in order), writing dx and
// summing the columns; the second read of its rows mostly hits L2.  Rows
// past n are never read, so they cannot enter the column sums.
constexpr int kBwdRows = 64;

template <typename T, typename P>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
layernorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ mean, const float* __restrict__ rstd,
                     const P* __restrict__ gamma, T* __restrict__ dx,
                     float* __restrict__ dg_part, float* __restrict__ db_part, int n,
                     int h) {
  __shared__ float m1_s[kBwdRows], m2_s[kBwdRows], mean_s[kBwdRows], rstd_s[kBwdRows];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kBwdRows;
  const int rows = min(kBwdRows, n - row0);

  for (int r = warp; r < rows; r += kRowsPerBlock) {
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

// dgamma/dbeta = the partials summed per column: 32 columns x 8 row groups
// per block, each group in row order, then the 8 groups in order.
template <typename P>
__global__ void __launch_bounds__(256)
layernorm_colsum_kernel(const float* __restrict__ dg_part,
                        const float* __restrict__ db_part, P* __restrict__ dg,
                        P* __restrict__ db, int parts, int h) {
  __shared__ float sg[8][33], sb[8][33];
  const int cx = threadIdx.x % 32, ry = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + cx;
  float g = 0.f, b = 0.f;
  if (c < h)
    for (int p = ry; p < parts; p += 8) {
      g += dg_part[size_t(p) * h + c];
      b += db_part[size_t(p) * h + c];
    }
  sg[ry][cx] = g;
  sb[ry][cx] = b;
  __syncthreads();
  if (ry == 0 && c < h) {
    float gs = 0.f, bs = 0.f;
    for (int k = 0; k < 8; ++k) {
      gs += sg[k][cx];
      bs += sb[k][cx];
    }
    put(dg + c, gs);
    put(db + c, bs);
  }
}

template <typename T, typename P>
cudaError_t launch_bwd(const void* x, const void* dy, const void* mean,
                       const void* rstd, const void* gamma, void* dx, void* dg_part,
                       void* db_part, void* dg, void* db, int n, int h,
                       cudaStream_t stream) {
  const int parts = (n + kBwdRows - 1) / kBwdRows;
  if (parts > 0) {
    layernorm_bwd_kernel<T, P><<<parts, 32 * kRowsPerBlock, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy),
        static_cast<const float*>(mean), static_cast<const float*>(rstd),
        static_cast<const P*>(gamma), static_cast<T*>(dx),
        static_cast<float*>(dg_part), static_cast<float*>(db_part), n, h);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  layernorm_colsum_kernel<P><<<(h + 31) / 32, 256, 0, stream>>>(
      static_cast<const float*>(dg_part), static_cast<const float*>(db_part),
      static_cast<P*>(dg), static_cast<P*>(db), parts, h);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx (n, h); mean, rstd (n,) f32; gamma, dg, db (h,); dg_part and
// db_part f32 scratch of (ceil(n / 64), h).  Same dtype codes as below.
extern "C" int fa_layernorm_bwd(const void* x, const void* dy, const void* mean,
                                const void* rstd, const void* gamma, void* dx,
                                void* dg_part, void* db_part, void* dg, void* db,
                                int n, int h, int x_dtype, int p_dtype, void* stream) {
  if (h == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && p_dtype == 0)
    return launch_bwd<float, float>(x, dy, mean, rstd, gamma, dx, dg_part, db_part,
                                    dg, db, n, h, st);
  if (x_dtype == 0 && p_dtype == 1)
    return launch_bwd<float, __nv_bfloat16>(x, dy, mean, rstd, gamma, dx, dg_part,
                                            db_part, dg, db, n, h, st);
  if (x_dtype == 1 && p_dtype == 0)
    return launch_bwd<__nv_bfloat16, float>(x, dy, mean, rstd, gamma, dx, dg_part,
                                            db_part, dg, db, n, h, st);
  if (x_dtype == 1 && p_dtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, dy, mean, rstd, gamma, dx,
                                                    dg_part, db_part, dg, db, n, h, st);
  return int(cudaErrorInvalidValue);
}

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
