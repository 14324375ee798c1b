// Fused dropout with bias, residual or activation, forward and backward, over
// x viewed as (n, d) with a bias of (d,):
//
//   res-bias forward:  out = r + keep(x + b) / div
//   act-bias forward:  out = keep(act(x + b)) / div, act = GELU-tanh or ReLU
//   res-bias backward: dx = keep(g) / div, db = sum_rows(dx) (dr = g, no launch)
//   act-bias backward: dx = keep(g) / div * act'(x + b), db = sum_rows(dx)
//
// div = 1 - rate, rounded as the TPU kernels' weakly typed 1.0 - rate
// meets it: to the input dtype T in the res-bias forward, which like
// _res_bias_kernel rounds x + b to T, the quotient to T and r + it to T;
// to f32 in the act-bias variant and both backwards, which compute in f32
// after rounding x + b to T (flashattn_tpu/ops/dropout.py:87-90, :95, :113,
// :133-135).  The wrapper passes div; the bias comes in and db goes out as
// f32 (the wrapper casts).  The keep mask is the stream of the plain dropout (dropout.cu):
// element i of the flattened row-major array takes word i % 4 of the
// Philox4x32-10 block at counter i / 4, keyed by the 64-bit seed, and keeps
// when that word >= threshold.  The backward regenerates it; nothing is
// saved.  Any d works.
//
// Replaces the TPU kernels flashattn_tpu/ops/dropout.py::_res_bias_kernel,
// _act_bias_kernel, _mask_colsum_kernel and _act_bias_bwd_kernel (all
// launched through _grid_call), whose grid runs in order and accumulates db
// in one revisited (1, d) block.  Blocks run in no order on the card, so db
// takes two launches instead, as the LayerNorm backward's dgamma does:
// each block writes the column sums of its 64 rows into an f32
// (row blocks, d) scratch, and a column-sum launch adds them per column in a
// fixed order.  Deterministic, no atomics.
//
// What bounds it on the H100: bytes (x, and r or g, read once; out or dx
// written once), with Philox's ten rounds of integer multiplies behind.
// Design: a block owns 64 rows x 1024 columns; each thread owns 4
// consecutive columns, keeps their bias (and its db partial sums) in
// registers, and walks the 64 rows.  When d % 4 == 0 the thread's 4
// elements are exactly one Philox block and one vector load; otherwise they
// straddle at most two blocks and load one by one.  The res-bias arithmetic
// uses round-to-nearest intrinsics (__fadd_rn, __fdiv_rn: no fused
// multiply-add, no reciprocal), so it is bit for bit the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kRows = 64;      // rows per block: one db partial per column
constexpr int kThreads = 256;  // 4 columns a thread: 1024 columns a block
constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2 / pi)

enum Op { kResFwd = 0, kActFwd = 1, kResBwd = 2, kActBwd = 3 };
enum Act { kGelu = 0, kRelu = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// v rounded to T and back (the identity for f32)
template <typename T> __device__ __forceinline__ float round_t(float v) { return v; }
template <> __device__ __forceinline__ float round_t<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// four consecutive elements at a 4-element-aligned index
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

template <int ACT>
__device__ __forceinline__ float act_fwd(float u) {
  if constexpr (ACT == kGelu)
    return 0.5f * u * (1.f + tanhf(kGeluC * (u + 0.044715f * (u * u * u))));
  return fmaxf(u, 0.f);
}

template <int ACT>
__device__ __forceinline__ float act_grad(float u) {
  if constexpr (ACT == kGelu) {
    const float t = tanhf(kGeluC * (u + 0.044715f * (u * u * u)));
    return 0.5f * (1.f + t) + 0.5f * u * (1.f - t * t) * kGeluC * (1.f + 0.134145f * u * u);
  }
  return u > 0.f ? 1.f : 0.f;
}

// a: x (forward) or g (backward); x2: x for the act-bias backward; r: the
// residual of the res-bias forward; out: out or dx; part: (row blocks, d)
// f32 partial column sums of dx (backward only).
template <typename T, int OP, int ACT, bool kAligned>
__global__ void __launch_bounds__(kThreads)
dropout_bias_kernel(const T* __restrict__ a, const T* __restrict__ x2,
                    const float* __restrict__ bias, const T* __restrict__ r,
                    T* __restrict__ out, float* __restrict__ part, long long n, int d,
                    unsigned long long seed, uint32_t threshold, float div) {
  const int c0 = (blockIdx.y * kThreads + threadIdx.x) * 4;
  if (c0 >= d) return;
  const int cols = min(4, d - c0);
  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = int(min((long long)kRows, n - row0));
  constexpr bool kBwd = OP == kResBwd || OP == kActBwd;

  float b[4] = {0.f, 0.f, 0.f, 0.f}, acc[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (OP != kResBwd)
    for (int k = 0; k < cols; ++k) b[k] = bias[c0 + k];

  for (int rr = 0; rr < rows; ++rr) {
    const long long base = (row0 + rr) * d + c0;
    uint32_t bits[4];
    float av[4] = {}, xv[4] = {}, rv[4] = {}, y[4];
    if constexpr (kAligned) {  // d % 4 == 0: base % 4 == 0, one Philox block
      const uint4 w = fa::philox_block(base >> 2, seed);
      bits[0] = w.x, bits[1] = w.y, bits[2] = w.z, bits[3] = w.w;
      load4(a + base, av);
      if constexpr (OP == kActBwd) load4(x2 + base, xv);
      if constexpr (OP == kResFwd) load4(r + base, rv);
    } else {
      const long long j0 = base >> 2;
      const uint4 w0 = fa::philox_block(j0, seed);
      const uint4 w1 = ((base + cols - 1) >> 2) != j0 ? fa::philox_block(j0 + 1, seed) : w0;
      const uint32_t words[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      for (int k = 0; k < 4; ++k) {
        bits[k] = words[int((base & 3) + k) & 7];
        if (k < cols) {
          av[k] = to_f(a[base + k]);
          if constexpr (OP == kActBwd) xv[k] = to_f(x2[base + k]);
          if constexpr (OP == kResFwd) rv[k] = to_f(r[base + k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool keep = bits[k] >= threshold;
      if constexpr (OP == kResFwd) {
        const float u = round_t<T>(__fadd_rn(av[k], b[k]));
        y[k] = __fadd_rn(rv[k], keep ? round_t<T>(__fdiv_rn(u, div)) : 0.f);
      } else if constexpr (OP == kActFwd) {
        y[k] = keep ? __fdiv_rn(act_fwd<ACT>(round_t<T>(__fadd_rn(av[k], b[k]))), div) : 0.f;
      } else if constexpr (OP == kResBwd) {
        y[k] = keep ? __fdiv_rn(av[k], div) : 0.f;
      } else {
        y[k] = keep ? __fdiv_rn(av[k], div) * act_grad<ACT>(round_t<T>(__fadd_rn(xv[k], b[k])))
                    : 0.f;
      }
      if constexpr (kBwd) acc[k] += k < cols ? y[k] : 0.f;
    }
    if constexpr (kAligned) {
      store4(out + base, y);
    } else {
      for (int k = 0; k < cols; ++k) put(out + base + k, y[k]);
    }
  }
  if constexpr (kBwd)
    for (int k = 0; k < cols; ++k) part[(long long)blockIdx.x * d + c0 + k] = acc[k];
}

// db = the partials summed per column: 32 columns x 8 row groups per block,
// each group in row order, then the 8 groups in order.
__global__ void __launch_bounds__(256)
dropout_colsum_kernel(const float* __restrict__ part, float* __restrict__ db, int parts, int d) {
  __shared__ float sp[8][33];
  const int cx = threadIdx.x % 32, ry = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + cx;
  float s = 0.f;
  if (c < d)
    for (int p = ry; p < parts; p += 8) s += part[(long long)p * d + c];
  sp[ry][cx] = s;
  __syncthreads();
  if (ry == 0 && c < d) {
    float t = 0.f;
    for (int k = 0; k < 8; ++k) t += sp[k][cx];
    db[c] = t;
  }
}

template <typename T, int OP, int ACT>
cudaError_t launch(const void* a, const void* x2, const void* bias, const void* r, void* out,
                   void* part, void* db, long long n, int d, unsigned long long seed,
                   uint32_t threshold, float div, cudaStream_t st) {
  const long long parts = (n + kRows - 1) / kRows;
  if (parts > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(unsigned(parts), unsigned((d + 4 * kThreads - 1) / (4 * kThreads)));
  const T* ap = static_cast<const T*>(a);
  const T* xp = static_cast<const T*>(x2);
  const float* bp = static_cast<const float*>(bias);
  const T* rp = static_cast<const T*>(r);
  T* op = static_cast<T*>(out);
  float* pp = static_cast<float*>(part);
  if (parts > 0) {
    if (d % 4 == 0)
      dropout_bias_kernel<T, OP, ACT, true><<<grid, kThreads, 0, st>>>(
          ap, xp, bp, rp, op, pp, n, d, seed, threshold, div);
    else
      dropout_bias_kernel<T, OP, ACT, false><<<grid, kThreads, 0, st>>>(
          ap, xp, bp, rp, op, pp, n, d, seed, threshold, div);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (OP == kResBwd || OP == kActBwd) {
    dropout_colsum_kernel<<<(d + 31) / 32, 256, 0, st>>>(pp, static_cast<float*>(db), int(parts), d);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

template <int OP, int ACT>
int dispatch(const void* a, const void* x2, const void* bias, const void* r, void* out,
             void* part, void* db, long long n, int d, unsigned long long seed,
             unsigned int threshold, float div, int dtype, void* stream) {
  if (d <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, OP, ACT>(a, x2, bias, r, out, part, db, n, d, seed, threshold,
                                  div, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, OP, ACT>(a, x2, bias, r, out, part, db, n, d, seed,
                                          threshold, div, st);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// Forward (backward = 0): a = x, r = residual, out (n, d); part, db unused.
// Backward (backward = 1): a = g, out = dx (n, d); part f32 (ceil(n / 64), d)
// scratch, db f32 (d,).  bias f32 (d,).  dtype: 0 = float32, 1 = bfloat16
// (a, r and out share it).  Every (n, d) array contiguous, 16-byte aligned.
extern "C" int fa_dropout_res_bias(const void* a, const void* bias, const void* r, void* out,
                                   void* part, void* db, long long n, int d,
                                   unsigned long long seed, unsigned int threshold,
                                   float div, int backward, int dtype, void* stream) {
  if (backward)
    return dispatch<kResBwd, kGelu>(a, nullptr, bias, r, out, part, db, n, d, seed, threshold,
                                    div, dtype, stream);
  return dispatch<kResFwd, kGelu>(a, nullptr, bias, r, out, part, db, n, d, seed, threshold,
                                  div, dtype, stream);
}

// Forward (backward = 0): a = x, out (n, d).  Backward (backward = 1): a = g,
// x = the forward's x, out = dx; part and db as above.  act: 0 = GELU (tanh
// approximation), 1 = ReLU.
extern "C" int fa_dropout_act_bias(const void* a, const void* x, const void* bias, void* out,
                                   void* part, void* db, long long n, int d,
                                   unsigned long long seed, unsigned int threshold,
                                   float div, int act, int backward, int dtype,
                                   void* stream) {
  if (act != kGelu && act != kRelu) return int(cudaErrorInvalidValue);
  if (backward)
    return act == kGelu ? dispatch<kActBwd, kGelu>(a, x, bias, nullptr, out, part, db, n, d,
                                                   seed, threshold, div, dtype, stream)
                        : dispatch<kActBwd, kRelu>(a, x, bias, nullptr, out, part, db, n, d,
                                                   seed, threshold, div, dtype, stream);
  return act == kGelu ? dispatch<kActFwd, kGelu>(a, x, bias, nullptr, out, part, db, n, d,
                                                 seed, threshold, div, dtype, stream)
                      : dispatch<kActFwd, kRelu>(a, x, bias, nullptr, out, part, db, n, d,
                                                 seed, threshold, div, dtype, stream);
}
