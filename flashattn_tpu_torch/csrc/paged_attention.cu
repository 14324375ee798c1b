// Paged attention: decode (and chunked-prefill extend) of `chunk` query
// tokens per sequence against a KV history kept in fixed-size pages, in
// q's dtype or quantized (int8 / fp8 e4m3 payloads with per-token f32
// scales).
//
// Replaces the TPU kernels in flashattn_tpu/ops/paged_attention.py:
//   _paged_dma_body / _paged_dma_kernel (wrapper _paged_attention_pipelined),
//     the double-buffered page walk used at head_dim % 128 == 0, with its
//     quantized branches (scale pages streamed beside the payloads, K scale
//     on the scores, V scale folded into p);
//   _paged_kernel (wrapper paged_attention), the (batch, page-slot) grid
//     used for smaller head dims, quantized branches included.
//
// Semantics: q arrives as (b, h_kv, rows, d) with rows = group * chunk in
// (group, chunk) order, so row r is chunk token j = r % chunk at position
// base + j, base = lengths[b] - chunk.  It attends positions
// pos < base + j + 1 (and pos >= base + j + 1 - window if window > 0).
// Key position pos lives at (page_indices[b, pos / page], pos % page), so
// any page size works.  The walk covers the pages
// [0, min(cdiv(len, page), pages_per_seq)): a chunked-prefill wave whose
// padding pushes len past the table's capacity reads no column past it.
// A quantized pool holds K = payload * k_scale per token (and V alike):
// the kernel dequantizes each K/V row in f32 as it stages it, which is the
// oracle's order (paged_attention_reference dequantizes the pages in f32);
// the TPU kernel instead rescales the scores by the K scale and rounds
// p * v_scale to q's dtype before its PV dot.
//
// What bounds it on the H100: at decode (one row per kv head) the floor is
// HBM bytes, the K/V history read once per (sequence, kv head) — half of
// bf16's for a quantized pool, plus 8 bytes of scales per token; an extend
// wave of 2K rows is compute-bound like prefill.  Design: one block per
// (b, kv head, tile of rows), with the row tile (4, 16 or 64) picked from
// the row count so a decode block does not compute 64 rows of which one is
// real, and a 2K-row extend wave is spread over 32 blocks per (b, kv head).
// The tile core is shared with the flash forward (attn_core.cuh).  This
// simple version walks each sequence's keys in one block, so decode has
// only b * h_kv blocks and is bound by that parallelism (far below HBM
// bandwidth at small batch); splitting the key walk across blocks with a
// merge pass (split-K) is the known next step.

#include <type_traits>

#include "attn_core.cuh"

namespace {

// T: q / out dtype; P: page payload dtype (T for an unquantized pool,
// int8_t or __nv_fp8_e4m3 for a quantized one, which carries scales).
template <typename T, typename P, int D>
struct PagedSrc {
  static constexpr bool kQuantQ = false;
  static constexpr bool kScaled = !std::is_same<P, T>::value;
  const T* q; const P* k_pages; const P* v_pages; T* o;
  const float* k_scales; const float* v_scales;   // (n_pages, page) of this head
  const int* table;     // this sequence's page-table row
  int n_rows, kv_cap;
  int row0, chunk, base, window;
  int page_size, n_pages;

  // token slot of a position: page * page_size + offset
  __device__ size_t slot(int pos) const {
    int page = table[pos / page_size];
    page = min(max(page, 0), n_pages - 1);
    return size_t(page) * page_size + pos % page_size;
  }
  __device__ float4 q4(int r, int c, float scale) const {
    return fa::scale4(fa::load4(q + size_t(r) * D + c), scale);
  }
  __device__ float4 k4(int pos, int c) const {
    const size_t s = slot(pos);
    const float4 v = fa::load4(k_pages + s * D + c);
    if constexpr (kScaled) return fa::scale4(v, k_scales[s]);
    return v;
  }
  __device__ float4 v4(int pos, int c) const {
    const size_t s = slot(pos);
    const float4 v = fa::load4(v_pages + s * D + c);
    if constexpr (kScaled) return fa::scale4(v, v_scales[s]);
    return v;
  }
  __device__ T* o_row(int r) const { return o + size_t(r) * D; }
  __device__ float* lse_row(int) const { return nullptr; }
  __device__ void bounds(int r, int& lo, int& hi) const {
    const int end = base + (row0 + r) % chunk + 1;
    hi = min(end, kv_cap);
    lo = window > 0 ? max(0, end - window) : 0;
  }
};

struct Args {
  const void* q; const void* kp; const void* vp;
  const float* ks; const float* vs;
  const int* lens; const int* table; void* out;
  int b, h_kv, rows, chunk, n_pages, page_size, pages_per_seq, window;
  float scale_log2;
};

template <typename T, typename P, int D, int BM>
__global__ void __launch_bounds__(fa::threads<BM>())
paged_kernel(Args a) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * BM;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int len = a.lens[b];
  const int walk_pages =
      min((max(len, 0) + a.page_size - 1) / a.page_size, a.pages_per_seq);

  PagedSrc<T, P, D> src;
  const size_t head = (size_t(b) * a.h_kv + hk) * a.rows + row0;
  const size_t pool = size_t(hk) * a.n_pages * a.page_size;   // tokens per head
  src.q = static_cast<const T*>(a.q) + head * D;
  src.o = static_cast<T*>(a.out) + head * D;
  src.k_pages = static_cast<const P*>(a.kp) + pool * D;
  src.v_pages = static_cast<const P*>(a.vp) + pool * D;
  src.k_scales = a.ks == nullptr ? nullptr : a.ks + pool;
  src.v_scales = a.vs == nullptr ? nullptr : a.vs + pool;
  src.table = a.table + size_t(b) * a.pages_per_seq;
  src.n_rows = min(BM, a.rows - row0);
  src.kv_cap = walk_pages * a.page_size;
  src.row0 = row0;
  src.chunk = a.chunk;
  src.base = len - a.chunk;
  src.window = a.window;
  src.page_size = a.page_size;
  src.n_pages = a.n_pages;
  fa::attend<T, D, BM>(src, a.scale_log2, smem);
}

template <typename T, typename P, int D, int BM>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = fa::smem_bytes<D, BM>();
  auto kernel = paged_kernel<T, P, D, BM>;
  static cudaError_t opted = fa::allow_smem(kernel, smem);
  if (opted != cudaSuccess) return opted;
  dim3 grid((a.rows + BM - 1) / BM, a.h_kv, a.b);
  kernel<<<grid, fa::threads<BM>(), smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename P, int D>
cudaError_t dispatch_bm(const Args& a, cudaStream_t st) {
  if (a.rows <= 4) return launch<T, P, D, 4>(a, st);
  if (a.rows <= 16) return launch<T, P, D, 16>(a, st);
  return launch<T, P, D, 64>(a, st);
}

template <typename T, typename P>
cudaError_t dispatch_d(int d, const Args& a, cudaStream_t st) {
  switch (d) {
    case 32: return dispatch_bm<T, P, 32>(a, st);
    case 64: return dispatch_bm<T, P, 64>(a, st);
    case 128: return dispatch_bm<T, P, 128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// page_dtype == dtype: unquantized; 2 = int8, 3 = fp8 e4m3 (scales needed)
template <typename T>
cudaError_t dispatch_pages(int page_dtype, int dtype, int d, const Args& a,
                           cudaStream_t st) {
  if (page_dtype == dtype) return dispatch_d<T, T>(d, a, st);
  if (a.ks == nullptr || a.vs == nullptr) return cudaErrorInvalidValue;
  if (page_dtype == 2) return dispatch_d<T, int8_t>(d, a, st);
  if (page_dtype == 3) return dispatch_d<T, __nv_fp8_e4m3>(d, a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (b, h_kv, rows, d) with rows = group * chunk in (group, chunk) order;
// k_pages, v_pages (h_kv, n_pages, page_size, d); k_scales, v_scales
// (h_kv, n_pages, page_size) f32 for a quantized pool, else null; lengths
// (b,) int32 counting the chunk; page_indices (b, pages_per_seq) int32; out
// like q.  window <= 0 means none.  dtype codes: 0 = float32, 1 = bfloat16
// (q and out), 2 = int8, 3 = float8 e4m3 (page payloads).
extern "C" int fa_paged_attention(const void* q, const void* k_pages,
                                  const void* v_pages, const void* k_scales,
                                  const void* v_scales, const void* lengths,
                                  const void* page_indices, void* out, int b,
                                  int h_kv, int rows, int chunk, int n_pages,
                                  int page_size, int pages_per_seq, int d,
                                  int window, float scale_log2, int dtype,
                                  int page_dtype, void* stream) {
  if (b == 0 || h_kv == 0 || rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{q, k_pages, v_pages, static_cast<const float*>(k_scales),
         static_cast<const float*>(v_scales), static_cast<const int*>(lengths),
         static_cast<const int*>(page_indices), out, b, h_kv, rows, chunk, n_pages,
         page_size, pages_per_seq, window, scale_log2};
  if (dtype == 0) return dispatch_pages<float>(page_dtype, dtype, d, a, st);
  if (dtype == 1) return dispatch_pages<__nv_bfloat16>(page_dtype, dtype, d, a, st);
  return int(cudaErrorInvalidValue);
}
