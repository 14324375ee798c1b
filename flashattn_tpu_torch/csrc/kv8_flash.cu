// Flash-attention forward over a quantized KV cache: o = softmax(q k^T *
// sm_scale) v and lse (natural log), where K = k_payload * k_scale and
// V = v_payload * v_scale with int8 or fp8 (e4m3) payloads and one f32
// scale per (batch, kv head, token).
//
// Replaces the TPU kernels in flashattn_tpu/ops/quant.py:
//   _kv8_fwd_kernel (wrapper flash_attention_kv_int8), the grid schedule:
//     causal or not, cross attention (n_q != n_kv);
//   _kv8_loop_kernel (wrapper _kv8_flash_loop), the q-major causal loop
//     schedule with GQA;
//   _kv8_subrow_kernel (wrapper _kv8_flash_subrow), the causal schedule with
//     the whole quantized row resident;
// all three compute one function, and one kernel computes it at every
// shape.
//
// Numerics (those of the three TPU kernels): q is pre-scaled by
// sm_scale * log2(e) in q's dtype.  With int8 payloads q is then quantized
// per row to int8 (absmax / 127, round half to even), as the TPU kernels do
// before their int8 x int8 scores dot; fp8 payloads keep q at full
// precision.  Scores and the softmax run in f32 (exp2); K and V rows are
// dequantized in f32 as they are staged.  Causal is top-left aligned
// (key c <= row R).  GQA: q head h reads kv head h / (h_q / h_kv).  The
// Python wrapper transcodes fp8 payloads to int8 at the TPU subrow
// envelope (requantize_fp8_to_int8), as the JAX dispatcher does, so the
// function is the same at every shape.
//
// What bounds it on the H100: like the flash forward (attn_core.cuh) this
// is the FMA tile core, bound by FP32 issue and shared-memory reads, not by
// HBM, whose bytes (1-byte K/V plus scales) the quantization halves.
// Design: one block owns (batch * head, 64 query rows) and walks only the
// key tiles its rows can see; the int8 q rows are quantized once per block
// in shared memory.

#include <type_traits>

#include "attn_core.cuh"

namespace {

template <typename T, typename P, int D>
struct Kv8Src {
  static constexpr bool kQuantQ = std::is_same<P, int8_t>::value;
  const T* q; const P* k; const P* v; const float* ks; const float* vs;
  T* o; float* lse;
  int n_rows, kv_cap;
  int row0;            // first query row of this tile
  int causal;

  // the pre-scaled q rounds to T (q * scale in q's dtype)
  __device__ float4 q4(int r, int c, float scale) const {
    return fa::round4<T>(fa::scale4(fa::load4(q + size_t(r) * D + c), scale));
  }
  __device__ float4 k4(int pos, int c) const {
    return fa::scale4(fa::load4(k + size_t(pos) * D + c), ks[pos]);
  }
  __device__ float4 v4(int pos, int c) const {
    return fa::scale4(fa::load4(v + size_t(pos) * D + c), vs[pos]);
  }
  __device__ T* o_row(int r) const { return o + size_t(r) * D; }
  __device__ float* lse_row(int r) const { return lse + r; }
  __device__ void bounds(int r, int& lo, int& hi) const {
    fa::dense_bounds(row0 + r, kv_cap, causal, 0, lo, hi);
  }
};

struct Args {
  const void* q; const void* k; const void* v; const float* ks; const float* vs;
  void* o; float* lse;
  int h, h_kv, n_q, n_kv, causal;
  float scale_log2;
};

template <typename T, typename P, int D>
__global__ void __launch_bounds__(fa::threads<64>())
kv8_flash_kernel(Args a) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;
  const int b = bh / a.h, hq = bh % a.h;
  const int hk = hq / (a.h / a.h_kv);
  const int row0 = blockIdx.y * 64;
  const size_t kv_head = (size_t(b) * a.h_kv + hk) * size_t(a.n_kv);

  Kv8Src<T, P, D> src;
  src.q = static_cast<const T*>(a.q) + (size_t(bh) * a.n_q + row0) * D;
  src.o = static_cast<T*>(a.o) + (size_t(bh) * a.n_q + row0) * D;
  src.lse = a.lse + size_t(bh) * a.n_q + row0;
  src.k = static_cast<const P*>(a.k) + kv_head * D;
  src.v = static_cast<const P*>(a.v) + kv_head * D;
  src.ks = a.ks + kv_head;
  src.vs = a.vs + kv_head;
  src.n_rows = min(64, a.n_q - row0);
  src.kv_cap = a.n_kv;
  src.row0 = row0;
  src.causal = a.causal;
  fa::attend<T, D, 64>(src, a.scale_log2, smem);
}

template <typename T, typename P, int D>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  constexpr size_t smem = fa::smem_bytes<D, 64>();
  auto kernel = kv8_flash_kernel<T, P, D>;
  static cudaError_t opted = fa::allow_smem(kernel, smem);
  if (opted != cudaSuccess) return opted;
  dim3 grid(b * a.h, (a.n_q + 63) / 64);
  kernel<<<grid, fa::threads<64>(), smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t dispatch_d(int d, const Args& a, int b, cudaStream_t st) {
  switch (d) {
    case 32: return launch<T, P, 32>(a, b, st);
    case 64: return launch<T, P, 64>(a, b, st);
    case 128: return launch<T, P, 128>(a, b, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_payload(int payload, int d, const Args& a, int b,
                             cudaStream_t st) {
  if (payload == 2) return dispatch_d<T, int8_t>(d, a, b, st);
  if (payload == 3) return dispatch_d<T, __nv_fp8_e4m3>(d, a, b, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (b, h, n_q, d); k, v (b, h_kv, n_kv, d) payloads; k_scales, v_scales
// (b, h_kv, n_kv) f32; o like q; lse (b, h, n_q) f32.  scale_log2 is
// sm_scale * log2(e) rounded to q's dtype.  dtype codes: 0 = float32,
// 1 = bfloat16 (q, o); payload 2 = int8, 3 = float8 e4m3.
extern "C" int fa_kv8_flash(const void* q, const void* k, const void* v,
                            const void* k_scales, const void* v_scales, void* o,
                            void* lse, int b, int h, int h_kv, int n_q, int n_kv,
                            int d, int causal, float scale_log2, int dtype,
                            int payload, void* stream) {
  if (b == 0 || h == 0 || n_q == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{q, k, v, static_cast<const float*>(k_scales),
         static_cast<const float*>(v_scales), o, static_cast<float*>(lse),
         h, h_kv, n_q, n_kv, causal, scale_log2};
  if (dtype == 0) return dispatch_payload<float>(payload, d, a, b, st);
  if (dtype == 1) return dispatch_payload<__nv_bfloat16>(payload, d, a, b, st);
  return int(cudaErrorInvalidValue);
}
