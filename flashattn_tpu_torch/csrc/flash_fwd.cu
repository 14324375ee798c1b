// Flash-attention forward: o = softmax(q k^T * sm_scale) v without the
// score matrix in HBM, plus lse (natural log) per query row.
//
// Replaces the TPU kernels in flashattn_tpu/ops/flash_attention.py:
//   _fwd_subrow_varlen_kernel (wrapper _flash_fwd_subrow_varlen), the
//     causal varlen forward of batched prefill;
//   _fwd_kernel (wrapper _flash_fwd), the grid FA-2 forward with causal,
//     sliding window, kv_lengths, GQA and cross-attention;
// and computes the same function as the dense causal schedules
// _fwd_subrow_kernel / _fwd_loop_kernel when no lengths are given.
//
// Semantics (those of _reference_fwd_with_lse): row R of q attends key c
// when c < n_kv, c < kv_lengths[b] (if given), c <= R (causal, top-left
// aligned) and c > R - window (if window > 0).  Padding rows past a
// length still attend the valid prefix.  A row with no live key gives
// o = 0 and lse = -inf.  GQA: q head h reads kv head h / (h_q / h_kv).
//
// What bounds it on the H100 and the design: see attn_core.cuh.  One block
// owns (batch*head, 64 query rows) and walks only the key tiles its rows
// can see (causal and length bound on the right, window on the left), so
// causal prefill does about half the work of the dense product.

#include "attn_core.cuh"

namespace {

template <typename T, int D>
struct DenseSrc {
  static constexpr bool kQuantQ = false;
  const T* q; const T* k; const T* v; T* o; float* lse;
  int n_rows, kv_cap;
  int row0;            // first query row of this tile
  int kv_len;          // keys visible to every row (min of n_kv, length)
  int causal, window;

  __device__ float4 q4(int r, int c, float scale) const {
    return fa::scale4(fa::load4(q + size_t(r) * D + c), scale);
  }
  __device__ float4 k4(int pos, int c) const { return fa::load4(k + size_t(pos) * D + c); }
  __device__ float4 v4(int pos, int c) const { return fa::load4(v + size_t(pos) * D + c); }
  __device__ T* o_row(int r) const { return o + size_t(r) * D; }
  __device__ float* lse_row(int r) const { return lse + r; }
  __device__ void bounds(int r, int& lo, int& hi) const {
    fa::dense_bounds(row0 + r, kv_len, causal, window, lo, hi);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(fa::threads<64>())
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_lengths,
                 T* __restrict__ o, float* __restrict__ lse, int h, int h_kv,
                 int n_q, int n_kv, int causal, int window, float scale_log2) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;
  const int b = bh / h, hq = bh % h;
  const int hk = hq / (h / h_kv);
  const int row0 = blockIdx.y * 64;

  DenseSrc<T, D> src;
  src.q = q + (size_t(bh) * n_q + row0) * D;
  src.o = o + (size_t(bh) * n_q + row0) * D;
  src.lse = lse + size_t(bh) * n_q + row0;
  src.k = k + (size_t(b) * h_kv + hk) * size_t(n_kv) * D;
  src.v = v + (size_t(b) * h_kv + hk) * size_t(n_kv) * D;
  src.n_rows = min(64, n_q - row0);
  src.kv_cap = n_kv;
  src.row0 = row0;
  src.kv_len = kv_lengths != nullptr ? min(n_kv, max(kv_lengths[b], 0)) : n_kv;
  src.causal = causal;
  src.window = window;
  fa::attend<T, D, 64>(src, scale_log2, smem);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lens,
                   void* o, float* lse, int b, int h, int h_kv, int n_q, int n_kv,
                   int causal, int window, float scale_log2, cudaStream_t stream) {
  constexpr size_t smem = fa::smem_bytes<D, 64>();
  auto kernel = flash_fwd_kernel<T, D>;
  static cudaError_t opted = fa::allow_smem(kernel, smem);
  if (opted != cudaSuccess) return opted;
  dim3 grid(b * h, (n_q + 63) / 64);
  kernel<<<grid, fa::threads<64>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lens, static_cast<T*>(o), lse, h, h_kv, n_q, n_kv, causal, window, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       const int* lens, void* o, float* lse, int b, int h, int h_kv,
                       int n_q, int n_kv, int causal, int window, float scale_log2,
                       cudaStream_t st) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, causal, window, scale_log2, st);
    case 64: return launch<T, 64>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, causal, window, scale_log2, st);
    case 128: return launch<T, 128>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, causal, window, scale_log2, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, h, n_q, d); k, v (b, h_kv, n_kv, d); o like q; lse (b, h, n_q) f32.
// kv_lengths (b,) int32 or null; window <= 0 means none.
// dtype codes: 0 = float32, 1 = bfloat16.
extern "C" int fa_flash_fwd(const void* q, const void* k, const void* v,
                            const void* kv_lengths, void* o, void* lse, int b,
                            int h, int h_kv, int n_q, int n_kv, int d, int causal,
                            int window, float scale_log2, int dtype, void* stream) {
  if (b == 0 || h == 0 || n_q == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_lengths);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, lens, o, l, b, h, h_kv, n_q, n_kv, causal,
                             window, scale_log2, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, lens, o, l, b, h, h_kv, n_q, n_kv,
                                     causal, window, scale_log2, st);
  return int(cudaErrorInvalidValue);
}
