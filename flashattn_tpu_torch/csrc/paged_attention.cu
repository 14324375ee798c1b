// Paged attention: decode (and chunked-prefill extend) of `chunk` query
// tokens per sequence against a KV history kept in fixed-size pages.
//
// Replaces the TPU kernels in flashattn_tpu/ops/paged_attention.py:
//   _paged_dma_body / _paged_dma_kernel (wrapper _paged_attention_pipelined),
//     the double-buffered page walk used at head_dim % 128 == 0;
//   _paged_kernel (wrapper paged_attention), the (batch, page-slot) grid
//     used for smaller head dims.
//
// Semantics: q arrives as (b, h_kv, rows, d) with rows = group * chunk in
// (group, chunk) order, so row r is chunk token j = r % chunk at position
// base + j, base = lengths[b] - chunk.  It attends positions
// pos < base + j + 1 (and pos >= base + j + 1 - window if window > 0).
// Key position pos lives at (page_indices[b, pos / page], pos % page), so
// any page size works.  The walk covers the pages
// [0, min(cdiv(len, page), pages_per_seq)): a chunked-prefill wave whose
// padding pushes len past the table's capacity reads no column past it.
//
// What bounds it on the H100: at decode (one row per kv head) the floor is
// HBM bytes, the K/V history read once per (sequence, kv head); an extend
// wave of 2K rows is compute-bound like prefill.  Design: one block per
// (b, kv head, tile of rows), with the row tile (4, 16 or 64) picked from
// the row count so a decode block does not compute 64 rows of which one is
// real, and a 2K-row extend wave is spread over 32 blocks per (b, kv head).
// The tile core is shared with the flash forward (attn_core.cuh).  This
// simple version walks each sequence's keys in one block, so decode has
// only b * h_kv blocks and is bound by that parallelism (far below HBM
// bandwidth at small batch); splitting the key walk across blocks with a
// merge pass (split-K) is the known next step.

#include "attn_core.cuh"

namespace {

template <typename T, int D>
struct PagedSrc {
  const T* q; const T* k_pages; const T* v_pages; T* o;
  const int* table;     // this sequence's page-table row
  int n_rows, kv_cap;
  int row0, chunk, base, window;
  int page_size, n_pages;

  __device__ const T* q_row(int r) const { return q + size_t(r) * D; }
  __device__ size_t slot(int pos) const {
    int page = table[pos / page_size];
    page = min(max(page, 0), n_pages - 1);
    return (size_t(page) * page_size + pos % page_size) * D;
  }
  __device__ const T* k_row(int pos) const { return k_pages + slot(pos); }
  __device__ const T* v_row(int pos) const { return v_pages + slot(pos); }
  __device__ T* o_row(int r) const { return o + size_t(r) * D; }
  __device__ float* lse_row(int) const { return nullptr; }
  __device__ void bounds(int r, int& lo, int& hi) const {
    const int end = base + (row0 + r) % chunk + 1;
    hi = min(end, kv_cap);
    lo = window > 0 ? max(0, end - window) : 0;
  }
};

template <typename T, int D, int BM>
__global__ void __launch_bounds__(fa::threads<BM>())
paged_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
             const T* __restrict__ v_pages, const int* __restrict__ lengths,
             const int* __restrict__ page_indices, T* __restrict__ out, int h_kv,
             int rows, int chunk, int n_pages, int page_size, int pages_per_seq,
             int window, float scale_log2) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * BM;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int len = lengths[b];
  const int walk_pages = min((max(len, 0) + page_size - 1) / page_size, pages_per_seq);

  PagedSrc<T, D> src;
  const size_t head = (size_t(b) * h_kv + hk) * rows + row0;
  src.q = q + head * D;
  src.o = out + head * D;
  src.k_pages = k_pages + size_t(hk) * n_pages * page_size * D;
  src.v_pages = v_pages + size_t(hk) * n_pages * page_size * D;
  src.table = page_indices + size_t(b) * pages_per_seq;
  src.n_rows = min(BM, rows - row0);
  src.kv_cap = walk_pages * page_size;
  src.row0 = row0;
  src.chunk = chunk;
  src.base = len - chunk;
  src.window = window;
  src.page_size = page_size;
  src.n_pages = n_pages;
  fa::attend<T, D, BM>(src, scale_log2, smem);
}

template <typename T, int D, int BM>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* lens,
                   const int* table, void* out, int b, int h_kv, int rows, int chunk,
                   int n_pages, int page_size, int pages_per_seq, int window,
                   float scale_log2, cudaStream_t stream) {
  constexpr size_t smem = fa::smem_bytes<D, BM>();
  auto kernel = paged_kernel<T, D, BM>;
  static cudaError_t opted = fa::allow_smem(kernel, smem);
  if (opted != cudaSuccess) return opted;
  dim3 grid((rows + BM - 1) / BM, h_kv, b);
  kernel<<<grid, fa::threads<BM>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      lens, table, static_cast<T*>(out), h_kv, rows, chunk, n_pages, page_size,
      pages_per_seq, window, scale_log2);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_bm(const void* q, const void* kp, const void* vp,
                        const int* lens, const int* table, void* out, int b,
                        int h_kv, int rows, int chunk, int n_pages, int page_size,
                        int pages_per_seq, int window, float scale_log2,
                        cudaStream_t st) {
  if (rows <= 4)
    return launch<T, D, 4>(q, kp, vp, lens, table, out, b, h_kv, rows, chunk, n_pages,
                           page_size, pages_per_seq, window, scale_log2, st);
  if (rows <= 16)
    return launch<T, D, 16>(q, kp, vp, lens, table, out, b, h_kv, rows, chunk, n_pages,
                            page_size, pages_per_seq, window, scale_log2, st);
  return launch<T, D, 64>(q, kp, vp, lens, table, out, b, h_kv, rows, chunk, n_pages,
                          page_size, pages_per_seq, window, scale_log2, st);
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* kp, const void* vp,
                       const int* lens, const int* table, void* out, int b, int h_kv,
                       int rows, int chunk, int n_pages, int page_size,
                       int pages_per_seq, int window, float scale_log2,
                       cudaStream_t st) {
  switch (d) {
    case 32: return dispatch_bm<T, 32>(q, kp, vp, lens, table, out, b, h_kv, rows, chunk, n_pages, page_size, pages_per_seq, window, scale_log2, st);
    case 64: return dispatch_bm<T, 64>(q, kp, vp, lens, table, out, b, h_kv, rows, chunk, n_pages, page_size, pages_per_seq, window, scale_log2, st);
    case 128: return dispatch_bm<T, 128>(q, kp, vp, lens, table, out, b, h_kv, rows, chunk, n_pages, page_size, pages_per_seq, window, scale_log2, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, h_kv, rows, d) with rows = group * chunk in (group, chunk) order;
// k_pages, v_pages (h_kv, n_pages, page_size, d); lengths (b,) int32 counting
// the chunk; page_indices (b, pages_per_seq) int32; out like q.
// window <= 0 means none.  dtype codes: 0 = float32, 1 = bfloat16.
extern "C" int fa_paged_attention(const void* q, const void* k_pages,
                                  const void* v_pages, const void* lengths,
                                  const void* page_indices, void* out, int b,
                                  int h_kv, int rows, int chunk, int n_pages,
                                  int page_size, int pages_per_seq, int d,
                                  int window, float scale_log2, int dtype,
                                  void* stream) {
  if (b == 0 || h_kv == 0 || rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  const int* table = static_cast<const int*>(page_indices);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k_pages, v_pages, lens, table, out, b, h_kv, rows,
                             chunk, n_pages, page_size, pages_per_seq, window,
                             scale_log2, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k_pages, v_pages, lens, table, out, b, h_kv,
                                     rows, chunk, n_pages, page_size, pages_per_seq,
                                     window, scale_log2, st);
  return int(cudaErrorInvalidValue);
}
