// Fused attention softmax, forward and backward, over (B, H, F, T) scores.
//
// Forward: out = softmax(x [+ mask], -1) with f32 arithmetic and the output
// in x's dtype.  The additive mask is f32 and broadcast as (B|1, H|1, F|1, T)
// through zero strides, never materialised.  `causal` REPLACES every entry
// with col > row (absolute indices, aligned top-left) by DEFAULT_MASK_VALUE,
// whatever x and the mask held there (flashattn_tpu/ops/softmax.py:44-48).
// Backward: dinp = out * (dout - sum_row(dout * out)), f32 accumulation, the
// output in out's dtype (softmax.py:55-59).
//
// Replaces the TPU kernels flashattn_tpu/ops/softmax.py::_softmax_fwd_kernel
// and _softmax_fwd_nomask_kernel (launched by _fwd_impl) and
// _softmax_bwd_kernel (launched by _attn_softmax_vjp_bwd), which hold a
// (block_rows, T) VMEM tile per grid step.
//
// What bounds it on the H100: bytes.  The forward reads x (and the mask) and
// writes out once, the backward reads out and dout and writes dinp, with a
// few operations an element.  Design: one block per row.  The forward takes
// max and sum in ONE online pass (each thread keeps a running (max, sum),
// merged by warp shuffles and then across warps in a fixed order) and then
// writes in a second pass whose reads mostly hit L1/L2; the backward takes
// the row dot, then writes.  Rows whose length is a multiple of the vector
// width use 16-byte loads; other rows (any T) take the scalar path.  Under
// `causal` the entries past the diagonal are known without reading them:
// they enter the row's (max, sum) as a count of DEFAULT_MASK_VALUE entries
// and are written as the constant exp(DEFAULT_MASK_VALUE - max) / sum
// (0 in practice), so a causal row reads only its live prefix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

// ops/_utils.py::DEFAULT_MASK_VALUE (-0.7 x f32 max, computed in double and
// rounded to f32, as torch rounds the Python float)
constexpr float kMaskValue = float(-0.7 * 3.4028234663852886e38);
constexpr int kMaxThreads = 256;

// V consecutive elements as f32; V is 1, or a multiple of 16 bytes' worth
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (V == 1) {
    v[0] = *p;
  } else {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + k);
      v[k] = f.x;
      v[k + 1] = f.y;
      v[k + 2] = f.z;
      v[k + 3] = f.w;
    }
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (V == 1) {
    v[0] = __bfloat162float(*p);
  } else {
#pragma unroll
    for (int k = 0; k < V; k += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + k);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        v[k + 2 * j] = f.x;
        v[k + 2 * j + 1] = f.y;
      }
    }
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (V == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int k = 0; k < V; k += 4)
      *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 1) {
    *p = __float2bfloat16(v[0]);
  } else {
#pragma unroll
    for (int k = 0; k < V; k += 8) {
      uint4 u;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h[j] = __floats2bfloat162_rn(v[k + 2 * j], v[k + 2 * j + 1]);
      *reinterpret_cast<uint4*>(p + k) = u;
    }
  }
}

// (m, s) <- the merge of two partial softmax states: max, and sum of
// exp(x - max).  An empty state is (-FLT_MAX, 0), which merges without NaN.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// The row's (max, sum) from every thread's partial state, the same in every
// thread: warp shuffles, then the warps' states merged in warp order.
__device__ __forceinline__ void block_merge(float& m, float& s) {
  __shared__ float sm[kMaxThreads / 32], ss[kMaxThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    merge(m, s, __shfl_xor_sync(0xffffffffu, m, off), __shfl_xor_sync(0xffffffffu, s, off));
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  if (threadIdx.x % 32 == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  m = sm[0];
  s = ss[0];
  for (int w = 1; w < warps; ++w) merge(m, s, sm[w], ss[w]);
}

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float sv[kMaxThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  if (threadIdx.x % 32 == 0) sv[warp] = v;
  __syncthreads();
  v = sv[0];
  for (int w = 1; w < warps; ++w) v += sv[w];
  return v;
}

// One block per row of x viewed as (rows, T), rows = B * H * F.  V elements a
// load (V divides T when V > 1).  msb/msh/msf: the mask's strides over B, H,
// F in elements, 0 on a broadcast dim; its T stride is 1.
template <typename T, int V, bool kCausal, bool kMask>
__global__ void __launch_bounds__(kMaxThreads)
softmax_fwd_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                   T* __restrict__ out, int H, int F, int Tn, long long msb, long long msh,
                   long long msf) {
  const long long row = blockIdx.x;
  const int f = int(row % F);
  const long long bh = row / F;
  const T* xr = x + row * Tn;
  T* orow = out + row * Tn;
  const float* mr = nullptr;
  if constexpr (kMask) mr = mask + (bh / H) * msb + (bh % H) * msh + f * msf;
  const int live = kCausal ? min(f + 1, Tn) : Tn;  // columns that are read

  float m = -FLT_MAX, s = 0.f;
  const int live_vecs = (live + V - 1) / V;
  for (int vi = threadIdx.x; vi < live_vecs; vi += blockDim.x) {
    float v[V];
    load_vec<V>(xr + vi * V, v);
    if constexpr (kMask) {
      float mk[V];
      load_vec<V>(mr + vi * V, mk);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] += mk[k];
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (kCausal && vi * V + k >= live) continue;
      if (v[k] > m) {
        s = s * expf(m - v[k]) + 1.f;
        m = v[k];
      } else {
        s += expf(v[k] - m);
      }
    }
  }
  block_merge(m, s);
  if (kCausal && live < Tn) merge(m, s, kMaskValue, float(Tn - live));
  const float masked = kCausal ? expf(kMaskValue - m) / s : 0.f;

  for (int vi = threadIdx.x; vi < Tn / V; vi += blockDim.x) {
    float v[V];
    const int c0 = vi * V;
    if (kCausal && c0 >= live) {
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = masked;
    } else {
      load_vec<V>(xr + c0, v);
      if constexpr (kMask) {
        float mk[V];
        load_vec<V>(mr + c0, mk);
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] += mk[k];
      }
#pragma unroll
      for (int k = 0; k < V; ++k)
        v[k] = (!kCausal || c0 + k < live) ? expf(v[k] - m) / s : masked;
    }
    store_vec<V>(orow + c0, v);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
softmax_bwd_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                   T* __restrict__ dinp, int Tn) {
  const long long row = blockIdx.x;
  const T* o = out + row * Tn;
  const T* g = dout + row * Tn;
  T* d = dinp + row * Tn;
  float dot = 0.f;
  for (int vi = threadIdx.x; vi < Tn / V; vi += blockDim.x) {
    float ov[V], gv[V];
    load_vec<V>(o + vi * V, ov);
    load_vec<V>(g + vi * V, gv);
#pragma unroll
    for (int k = 0; k < V; ++k) dot += ov[k] * gv[k];
  }
  dot = block_sum(dot);
  for (int vi = threadIdx.x; vi < Tn / V; vi += blockDim.x) {
    float ov[V], gv[V];
    load_vec<V>(o + vi * V, ov);
    load_vec<V>(g + vi * V, gv);
#pragma unroll
    for (int k = 0; k < V; ++k) ov[k] = ov[k] * (gv[k] - dot);
    store_vec<V>(d + vi * V, ov);
  }
}

// Threads per row: enough warps to cover the row's loads once, at most 256.
int threads_for(int loads) {
  int t = (loads + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

template <typename T, int V>
cudaError_t launch_fwd_v(const void* x, const void* mask, void* out, long long rows, int H,
                         int F, int Tn, long long msb, long long msh, long long msf,
                         bool causal, cudaStream_t st) {
  const int threads = threads_for(Tn / V);
  const T* xp = static_cast<const T*>(x);
  const float* mp = static_cast<const float*>(mask);
  T* op = static_cast<T*>(out);
  if (causal && mask)
    softmax_fwd_kernel<T, V, true, true><<<unsigned(rows), threads, 0, st>>>(xp, mp, op, H, F, Tn, msb, msh, msf);
  else if (causal)
    softmax_fwd_kernel<T, V, true, false><<<unsigned(rows), threads, 0, st>>>(xp, mp, op, H, F, Tn, msb, msh, msf);
  else if (mask)
    softmax_fwd_kernel<T, V, false, true><<<unsigned(rows), threads, 0, st>>>(xp, mp, op, H, F, Tn, msb, msh, msf);
  else
    softmax_fwd_kernel<T, V, false, false><<<unsigned(rows), threads, 0, st>>>(xp, mp, op, H, F, Tn, msb, msh, msf);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* mask, void* out, long long rows, int H, int F,
                       int Tn, long long msb, long long msh, long long msf, bool causal,
                       cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (Tn % V == 0)
    return launch_fwd_v<T, V>(x, mask, out, rows, H, F, Tn, msb, msh, msf, causal, st);
  return launch_fwd_v<T, 1>(x, mask, out, rows, H, F, Tn, msb, msh, msf, causal, st);
}

template <typename T>
cudaError_t launch_bwd(const void* out, const void* dout, void* dinp, long long rows, int Tn,
                       cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const T* o = static_cast<const T*>(out);
  const T* g = static_cast<const T*>(dout);
  T* d = static_cast<T*>(dinp);
  if (Tn % V == 0)
    softmax_bwd_kernel<T, V><<<unsigned(rows), threads_for(Tn / V), 0, st>>>(o, g, d, Tn);
  else
    softmax_bwd_kernel<T, 1><<<unsigned(rows), threads_for(Tn), 0, st>>>(o, g, d, Tn);
  return cudaGetLastError();
}

}  // namespace

// x, out: (rows, T) contiguous, rows = B * H * F, 16-byte aligned; mask: f32
// with T contiguous and strides msb/msh/msf (0 on broadcast dims), or null.
// dtype codes: 0 = float32, 1 = bfloat16.
extern "C" int fa_softmax_fwd(const void* x, const void* mask, void* out, long long rows, int H,
                              int F, int Tn, long long msb, long long msh, long long msf,
                              int causal, int dtype, void* stream) {
  if (rows <= 0 || Tn <= 0) return 0;
  if (rows > 0x7fffffffLL) return int(cudaErrorInvalidValue);  // one block a row
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(x, mask, out, rows, H, F, Tn, msb, msh, msf, causal != 0, st);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, mask, out, rows, H, F, Tn, msb, msh, msf, causal != 0,
                                     st);
  return int(cudaErrorInvalidValue);
}

// out, dout, dinp: (rows, T) contiguous and 16-byte aligned, one dtype.
extern "C" int fa_softmax_bwd(const void* out, const void* dout, void* dinp, long long rows,
                              int Tn, int dtype, void* stream) {
  if (rows <= 0 || Tn <= 0) return 0;
  if (rows > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(out, dout, dinp, rows, Tn, st);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(out, dout, dinp, rows, Tn, st);
  return int(cudaErrorInvalidValue);
}
