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
// written once), with Philox's ten rounds of integer multiplies close
// behind: act-bias at (16384, 8192) draws 33.5 M Philox blocks.  So it is
// fast only if loads are in flight while the rounds run, the design of
// dropout.cu.  A thread owns a group of 8 consecutive columns (one 16-byte
// access of each operand in bf16, two in f32; two Philox blocks), keeps
// their bias and db partial sums in registers, and walks rows with a
// stride of the grid's row lanes, two rows at a time, the next two rows'
// loads issued before this pair's Philox rounds (a register double
// buffer).  Issue is the other limit: the division by 1 - rate runs as a
// multiply by its reciprocal and one correction with the exact residual
// (div8, the IEEE quotient), and GELU in bf16 takes the MUFU
// tanh.  A block holds
// min(256, d / 8) column groups and 256 / that row lanes; the grid holds
// the column blocks times as many row blocks as fill the card once (the
// kernel's resident blocks: SMs x blocks an SM), so there are
// lanes = row blocks x row lanes a block db partial rows
// (fa_dropout_bias_lanes), summed per column in a fixed order by the
// second launch.  d % 8 != 0 (or a base off 16 bytes) takes the same
// walk one element at a time, drawing a third Philox block where a group
// straddles three.  The res-bias arithmetic uses round-to-nearest
// intrinsics (__fadd_rn, __fdiv_rn: no fused multiply-add, no
// reciprocal), so it is bit for bit the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "vec16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;     // rows a thread has in flight at once
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

// tanh for GELU: the accurate tanhf in f32; where the result rounds to bf16,
// the MUFU approximation (one instruction, relative error about 2^-11, a
// sixteenth of a bf16 ulp), as the accurate one costs more issue than the
// kernel's bytes take at (16384, 8192).
template <typename T> __device__ __forceinline__ float tanh_t(float x) { return tanhf(x); }
template <> __device__ __forceinline__ float tanh_t<__nv_bfloat16>(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int ACT>
__device__ __forceinline__ float act_fwd(float u) {
  if constexpr (ACT == kGelu)
    return 0.5f * u * (1.f + tanh_t<T>(kGeluC * (u + 0.044715f * (u * u * u))));
  return fmaxf(u, 0.f);
}

template <typename T, int ACT>
__device__ __forceinline__ float act_grad(float u) {
  if constexpr (ACT == kGelu) {
    const float t = tanh_t<T>(kGeluC * (u + 0.044715f * (u * u * u)));
    return 0.5f * (1.f + t) + 0.5f * u * (1.f - t * t) * kGeluC * (1.f + 0.134145f * u * u);
  }
  return u > 0.f ? 1.f : 0.f;
}

// Eight quotients a[k] / b rounded to nearest, the IEEE quotients
// __fdiv_rn gives, from rb = 1 / b (an IEEE division, once per b): q =
// a rb, then one correction with the exact residual r = a - b q
// (Markstein's step, the last of the division's own sequence; r == 0 means
// q is exact, which also keeps the sign of a zero), three or four
// instructions a quotient instead of the division's sequence, whose
// range check sends zeros down its slow path.  Correctly rounded while a
// and b stay far from the subnormal and overflow ranges: b_ok (b in
// [2^-100, 2^100], checked once by the caller) and every nonzero |a[k]| in
// [2^-100, 2^100]; otherwise the eight take __fdiv_rn.
__device__ __forceinline__ void div8(float (&q)[8], const float (&a)[8], float b, float rb,
                                     bool b_ok) {
  bool ok = b_ok;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float aa = fabsf(a[k]);
    ok &= aa == 0.f || (aa >= 0x1p-100f && aa <= 0x1p100f);
  }
  if (ok) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float q0 = __fmul_rn(a[k], rb);
      const float r = __fmaf_rn(-q0, b, a[k]);
      q[k] = r == 0.f ? q0 : __fmaf_rn(r, rb, q0);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) q[k] = __fdiv_rn(a[k], b);
  }
}

// Whether div8 may divide by b on its fast path.
__device__ __forceinline__ bool div_by_ok(float b) {
  return b >= 0x1p-100f && b <= 0x1p100f;
}

// The 8 values of a group: one (bf16) or two (f32) 16-byte loads when kVec,
// else element by element (0 past d).
template <typename T, bool kVec>
struct Group {
  static constexpr int V = fa::kVec<T>, kLoads = 8 / V;
  uint4 raw[kLoads];
  float f[8];
  __device__ __forceinline__ void load(const T* p, int cols) {
    if constexpr (kVec) {
#pragma unroll
      for (int q = 0; q < kLoads; ++q) raw[q] = fa::load16(p + q * V);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) f[k] = k < cols ? to_f(p[k]) : 0.f;
    }
  }
  __device__ __forceinline__ void unpack() {
    if constexpr (kVec)
#pragma unroll
      for (int q = 0; q < kLoads; ++q) fa::unpack16<T>(raw[q], f + q * V);
  }
};

// The Philox words of elements e0 .. e0 + 7: two blocks when e0 % 4 == 0
// (kVec: d % 8 == 0), else three.
template <bool kVec>
__device__ __forceinline__ void group_bits(long long e0, unsigned long long seed,
                                           uint32_t (&bits)[8]) {
  const long long j0 = e0 >> 2;
  const uint4 w0 = fa::philox_block(j0, seed), w1 = fa::philox_block(j0 + 1, seed);
  if constexpr (kVec) {
    const uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) bits[k] = w[k];
  } else {
    const int s = int(e0 & 3);
    const uint4 w2 = s ? fa::philox_block(j0 + 2, seed) : w1;
    const uint32_t w[12] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y,
                            w1.z, w1.w, w2.x, w2.y, w2.z, w2.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) bits[k] = w[s + k];
  }
}

// a: x (forward) or g (backward); x2: x for the act-bias backward; r: the
// residual of the res-bias forward; out: out or dx; part: (lanes, d) f32
// partial column sums of dx (backward only).  bc column groups of 8 a
// block, kThreads / bc row lanes a block, `lanes` row lanes in the grid.
template <typename T, int OP, int ACT, bool kVec>
__global__ void __launch_bounds__(kThreads)
dropout_bias_kernel(const T* __restrict__ a, const T* __restrict__ x2,
                    const float* __restrict__ bias, const T* __restrict__ r,
                    T* __restrict__ out, float* __restrict__ part, long long n, int d, int bc,
                    int lanes, unsigned long long seed, uint32_t threshold, float div) {
  constexpr bool kBwd = OP == kResBwd || OP == kActBwd;
  constexpr bool kX2 = OP == kActBwd, kR = OP == kResFwd;
  const int br = kThreads / bc;
  if (int(threadIdx.x) >= bc * br) return;
  const int c0 = (blockIdx.x * bc + threadIdx.x % bc) * 8;
  if (c0 >= d) return;
  const int cols = min(8, d - c0);
  const int lane = blockIdx.y * br + threadIdx.x / bc;

  float b[8], acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    b[k] = OP != kResBwd && k < cols ? bias[c0 + k] : 0.f;
    acc[k] = 0.f;
  }
  // x / div as __fdiv_rn gives it, by the reciprocal and one correction
  // (div8)
  const float rdiv = 1.f / div;
  const bool fast = div_by_ok(div);
  using G = Group<T, kVec>;
  // kUnroll rows from r0 (a stride of `lanes` apart) into (a_, x_, r_)
  auto load = [&](long long r0, G (&a_)[kUnroll], G (&x_)[kUnroll], G (&r_)[kUnroll]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long ru = r0 + (long long)u * lanes;
      if (ru < n) {
        const long long base = ru * d + c0;
        a_[u].load(a + base, cols);
        if constexpr (kX2) x_[u].load(x2 + base, cols);
        if constexpr (kR) r_[u].load(r + base, cols);
      }
    }
  };
  auto process = [&](long long r0, G (&a_)[kUnroll], G (&x_)[kUnroll], G (&r_)[kUnroll]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long ru = r0 + (long long)u * lanes;
      if (ru >= n) continue;
      const long long base = ru * d + c0;
      uint32_t bits[8];
      group_bits<kVec>(base, seed, bits);
      a_[u].unpack();
      if constexpr (kX2) x_[u].unpack();
      if constexpr (kR) r_[u].unpack();
      // the numerators, their quotients by div, then the result
      float num[8], q[8], y[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if constexpr (OP == kResFwd)
          num[k] = round_t<T>(__fadd_rn(a_[u].f[k], b[k]));
        else if constexpr (OP == kActFwd)
          num[k] = act_fwd<T, ACT>(round_t<T>(__fadd_rn(a_[u].f[k], b[k])));
        else
          num[k] = a_[u].f[k];
      }
      div8(q, num, div, rdiv, fast);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool keep = bits[k] >= threshold;
        if constexpr (OP == kResFwd)
          y[k] = __fadd_rn(r_[u].f[k], keep ? round_t<T>(q[k]) : 0.f);
        else if constexpr (OP == kActBwd)
          y[k] = keep ? q[k] * act_grad<T, ACT>(round_t<T>(__fadd_rn(x_[u].f[k], b[k]))) : 0.f;
        else
          y[k] = keep ? q[k] : 0.f;
        if constexpr (kBwd) acc[k] += k < cols ? y[k] : 0.f;
      }
      if constexpr (kVec) {
        constexpr int V = fa::kVec<T>;
#pragma unroll
        for (int q = 0; q < 8 / V; ++q) fa::store16(out + base + q * V, fa::pack16<T>(y + q * V));
      } else {
        for (int k = 0; k < cols; ++k) put(out + base + k, y[k]);
      }
    }
  };
  // two sets of kUnroll rows: the next set's loads are in flight while this
  // set's Philox rounds and arithmetic run
  const long long step = (long long)kUnroll * lanes;
  G a0[kUnroll], x0[kUnroll], r0[kUnroll], a1[kUnroll], x1[kUnroll], r1[kUnroll];
  load(lane, a0, x0, r0);
  for (long long row = lane; row < n; row += 2 * step) {
    load(row + step, a1, x1, r1);
    process(row, a0, x0, r0);
    load(row + 2 * step, a0, x0, r0);
    process(row + step, a1, x1, r1);
  }
  if constexpr (kBwd)
    for (int k = 0; k < cols; ++k) part[(long long)lane * d + c0 + k] = acc[k];
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

// The launch shape of a kernel instance: column groups a block (bc),
// grid (gx column blocks, gy row blocks) and row lanes (the db partial
// rows).  gy fills the card once with gx * gy blocks, or gives each lane a
// row when n is small.
struct Plan {
  int bc, gx, gy, lanes;
};

template <typename T, int OP, int ACT, bool kVec>
cudaError_t plan(long long n, int d, Plan* p) {
  static int per_sm = 0;
  long long slots = 0;
  const cudaError_t e =
      fa::resident_blocks(dropout_bias_kernel<T, OP, ACT, kVec>, kThreads, &per_sm, &slots);
  if (e != cudaSuccess) return e;
  const int groups = (d + 7) / 8;
  p->bc = groups < kThreads ? groups : kThreads;
  const int br = kThreads / p->bc;
  p->gx = (groups + p->bc - 1) / p->bc;
  long long gy = slots / p->gx;
  const long long need = (n + br - 1) / br;
  gy = gy < need ? gy : need;
  p->gy = int(gy > 0 ? gy : 1);
  p->lanes = p->gy * br;
  return cudaSuccess;
}

// The row lanes (db partial rows) of a launch on (n, d), 16-byte aligned
// bases: d % 8 == 0 takes the vector kernel.
template <typename T, int OP, int ACT>
cudaError_t lanes_of(long long n, int d, int* lanes) {
  Plan p;
  const cudaError_t e = d % 8 == 0 ? plan<T, OP, ACT, true>(n, d, &p)
                                   : plan<T, OP, ACT, false>(n, d, &p);
  *lanes = p.lanes;
  return e;
}

template <typename T, int OP, int ACT, bool kVec>
cudaError_t launch_v(const void* a, const void* x2, const void* bias, const void* r,
                     void* out, void* part, void* db, long long n, int d,
                     unsigned long long seed, uint32_t threshold, float div, cudaStream_t st) {
  Plan p;
  cudaError_t e = plan<T, OP, ACT, kVec>(n, d, &p);
  if (e != cudaSuccess) return e;
  float* pp = static_cast<float*>(part);
  if (n > 0) {
    dropout_bias_kernel<T, OP, ACT, kVec><<<dim3(p.gx, p.gy), kThreads, 0, st>>>(
        static_cast<const T*>(a), static_cast<const T*>(x2), static_cast<const float*>(bias),
        static_cast<const T*>(r), static_cast<T*>(out), pp, n, d, p.bc, p.lanes, seed,
        threshold, div);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (OP == kResBwd || OP == kActBwd) {
    dropout_colsum_kernel<<<(d + 31) / 32, 256, 0, st>>>(pp, static_cast<float*>(db),
                                                         n > 0 ? p.lanes : 0, d);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

template <typename T, int OP, int ACT>
cudaError_t launch(const void* a, const void* x2, const void* bias, const void* r, void* out,
                   void* part, void* db, long long n, int d, unsigned long long seed,
                   uint32_t threshold, float div, cudaStream_t st) {
  if (d % 8 == 0)
    return launch_v<T, OP, ACT, true>(a, x2, bias, r, out, part, db, n, d, seed, threshold,
                                      div, st);
  return launch_v<T, OP, ACT, false>(a, x2, bias, r, out, part, db, n, d, seed, threshold,
                                     div, st);
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

template <int OP, int ACT>
int lanes_dtype(long long n, int d, int dtype) {
  int lanes = 0;
  const cudaError_t e = dtype == 0   ? lanes_of<float, OP, ACT>(n, d, &lanes)
                        : dtype == 1 ? lanes_of<__nv_bfloat16, OP, ACT>(n, d, &lanes)
                                     : cudaErrorInvalidValue;
  return e != cudaSuccess ? -int(e) : lanes;
}

}  // namespace

// The db partial rows of a backward launch on (n, d) (the `part` scratch
// is (lanes, d) f32): res-bias (act < 0) or act-bias with act (0 GELU, 1
// ReLU); minus a CUDA error code on failure.  Launches nothing.
extern "C" int fa_dropout_bias_lanes(long long n, int d, int act, int dtype) {
  if (d <= 0) return 0;
  if (act < 0) return lanes_dtype<kResBwd, kGelu>(n, d, dtype);
  if (act == kGelu) return lanes_dtype<kActBwd, kGelu>(n, d, dtype);
  if (act == kRelu) return lanes_dtype<kActBwd, kRelu>(n, d, dtype);
  return -int(cudaErrorInvalidValue);
}

// Forward (backward = 0): a = x, r = residual, out (n, d); part, db unused.
// Backward (backward = 1): a = g, out = dx (n, d); part f32 (lanes, d)
// scratch (fa_dropout_bias_lanes), db f32 (d,).  bias f32 (d,).  dtype:
// 0 = float32, 1 = bfloat16 (a, r and out share it).  Every (n, d) array contiguous, 16-byte aligned.
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
