// Flash-attention forward: o = softmax(q k^T * sm_scale) v without the
// score matrix in HBM, plus lse (natural log) per query row.
//
// Replaces the TPU kernels in flashattn_tpu/ops/flash_attention.py:
//   _fwd_subrow_varlen_kernel (wrapper _flash_fwd_subrow_varlen), the
//     causal varlen forward of batched prefill;
//   _fwd_kernel (wrapper _flash_fwd), the grid FA-2 forward with causal,
//     sliding window, kv_lengths, GQA and cross-attention;
// and computes the same function as the dense causal schedules
// _fwd_subrow_kernel / _fwd_loop_kernel / _fwd_twolevel_kernel when no
// lengths are given.
//
// Semantics (those of _reference_fwd_with_lse): row R of q attends key c
// when c < n_kv, c < kv_lengths[b] (if given), c <= R (causal, top-left
// aligned) and c > R - window (if window > 0).  Padding rows past a
// length still attend the valid prefix.  A row with no live key gives
// o = 0 and lse = -inf.  GQA: q head h reads kv head h / (h_q / h_kv).
//
// bf16 (head dim 32, 64 or 128) runs a tensor-core kernel.  What bounds it
// on the H100 is the two products (4 d flops per live (row, key) pair at
// 989 TF/s), the softmax's exponentials behind them.  A block owns 128
// query rows of one (batch, head): two consumer warpgroups of 64 rows.  Q
// is loaded once into shared memory; K and V tiles of 128 keys stream
// through a double-buffered ring in bf16 (cp.async, zero fill past n_kv),
// the next tile's copy overlapping this tile's math, in the swizzled
// layout of hopper.cuh.  S = Q K^T is a wgmma (both K-major) into 64 f32
// registers a thread; the online softmax runs on that fragment in exp2
// with sm_scale * log2(e) applied to the scores; P is rounded to bf16 in
// registers and is the A operand of the P V wgmma (V MN-major, the
// transpose bit set), which accumulates O in f32 registers.  The block
// walks only the key tiles its rows can see (causal and length bound on
// the right, window on the left; the last row tiles start first, having
// the longest walks); only tiles that cut some row's interval are masked.
// The epilogue writes lse (f32, (b, h, n_q)) and o (bf16, staged in
// shared memory and stored in whole rows), which flash_bwd.cu reads.
// Rounding P to bf16 before the PV product (the plain version rounds p
// after normalising) moves o by about one bf16 ulp of p, inside the bf16
// gate.

// f32 keeps the CUDA-core kernel of attn_core.cuh (fa::attend): TF32
// tensor cores would break the f32 gates of the training path.  One block
// owns (batch*head, 64 query rows) there and walks the same key tiles.

#include "attn_core.cuh"
#include "hopper.cuh"

namespace {

// -- f32: the CUDA-core tile ---------------------------------------------------

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

// -- bf16: the tensor-core tile ----------------------------------------------------

using bf16 = __nv_bfloat16;

template <int D>
struct Tc {
  static constexpr int BM = 128, BN = 128, THREADS = 256;
  static constexpr int SW = D >= 64 ? 128 : 64;   // bytes of a swizzled row
  static constexpr int CPR = SW / 2;              // bf16 columns a region row holds
  static constexpr int Q_BYTES = BM * D * 2, KV_BYTES = BN * D * 2;
  static constexpr size_t SMEM = 1024 + Q_BYTES + 4 * size_t(KV_BYTES);
};

template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const bf16* src, const bf16* base,
                                          int rows_valid, int rows) {
  hop::load_tile<D * 2, Tc<D>::SW, Tc<D>::THREADS>(dst, src, base, rows_valid, rows);
}

template <int D>
__global__ void __launch_bounds__(Tc<D>::THREADS, 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ kv_lengths,
                    bf16* __restrict__ o, float* __restrict__ lse, int h, int h_kv, int n_q,
                    int n_kv, int causal, int window, float scale_log2) {
  using C = Tc<D>;
  constexpr int BN = C::BN, SW = C::SW, CPR = C::CPR;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* kvs = qs + C::Q_BYTES;   // K0, V0, K1, V1

  const int bh = blockIdx.x, b = bh / h, hq = bh % h, hk = hq / (h / h_kv);
  const int row0 = (gridDim.y - 1 - blockIdx.y) * C::BM;
  const int n_rows = min(C::BM, n_q - row0);
  const bf16* qp = q + size_t(bh) * n_q * D;
  const bf16* kp = k + (size_t(b) * h_kv + hk) * size_t(n_kv) * D;
  const bf16* vp = v + (size_t(b) * h_kv + hk) * size_t(n_kv) * D;
  const int kv_len = kv_lengths != nullptr ? min(n_kv, max(kv_lengths[b], 0)) : n_kv;

  // Both bounds of dense_bounds grow with the row, so the block's walk is
  // [lo(first row), hi(last row)) and a tile is inside every row's
  // interval when it lies in [lo(last row), hi(first row)).
  int walk_lo, walk_hi, all_lo, all_hi;
  fa::dense_bounds(row0, kv_len, causal, window, walk_lo, all_hi);
  fa::dense_bounds(row0 + n_rows - 1, kv_len, causal, window, all_lo, walk_hi);
  const int start = walk_hi > walk_lo ? (walk_lo / BN) * BN : 0;
  const int end = walk_hi > walk_lo ? walk_hi : 0;

  const int wg = threadIdx.x / 128, lt = threadIdx.x % 128;
  const int lane = lt % 32, quad = lane % 4;
  const int rl = wg * 64 + (lt / 32) * 16 + lane / 4;   // local row of h = 0 (+8: h = 1)
  int lo[2], hi[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    fa::dense_bounds(row0 + rl + 8 * hh, kv_len, causal, window, lo[hh], hi[hh]);

  load_tile<D>(qs, qp + size_t(row0) * D, qp, n_rows, C::BM);
  if (start < end) {
    load_tile<D>(kvs, kp + size_t(start) * D, kp, n_kv - start, BN);
    load_tile<D>(kvs + C::KV_BYTES, vp + size_t(start) * D, vp, n_kv - start, BN);
  }
  hop::cp_async_commit();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // l: this thread's columns

  const uint32_t q_addr = hop::smem_u32(qs) + wg * 64 * SW;
  int buf = 0;
  for (int kt = start; kt < end; kt += BN, buf ^= 1) {
    hop::cp_async_wait<0>();
    hop::fence_async_smem();
    __syncthreads();   // tile kt has landed everywhere; buffer buf ^ 1 is free
    if (kt + BN < end) {
      uint8_t* nk = kvs + (buf ^ 1) * 2 * C::KV_BYTES;
      load_tile<D>(nk, kp + size_t(kt + BN) * D, kp, n_kv - kt - BN, BN);
      load_tile<D>(nk + C::KV_BYTES, vp + size_t(kt + BN) * D, vp, n_kv - kt - BN, BN);
    }
    hop::cp_async_commit();
    const uint32_t k_addr = hop::smem_u32(kvs + buf * 2 * C::KV_BYTES);
    const uint32_t v_addr = k_addr + C::KV_BYTES;

    // S = Q K^T: 64 rows x 128 keys a warpgroup, contracted over D
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    hop::fence_regs(s);
    hop::wg_arrive();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t region = ks * 16 / CPR, off = (ks * 16 % CPR) * 2;
      hop::wgmma_ss<0>(s, hop::desc<SW>(q_addr + region * C::BM * SW + off, 16, 8 * SW),
                       hop::desc<SW>(k_addr + region * BN * SW + off, 16, 8 * SW), 1);
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(s);

    // online softmax on the fragment: s[4j + 2hh + e] is row rl + 8hh,
    // key kt + 8j + 2 quad + e
    const bool full = kt >= all_lo && kt + BN <= all_hi;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[4 * j + 2 * hh + e] * scale_log2;
          if (!full) {
            const int c = kt + 8 * j + 2 * quad + e;
            if (c < lo[hh] || c >= hi[hh]) x = -INFINITY;
          }
          s[4 * j + 2 * hh + e] = x;
          mx[hh] = fmaxf(mx[hh], x);
        }
    float m_use[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      m_use[hh] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[hh] - m_use[hh]);
      m[hh] = m_new;
      l[hh] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 2 * hh] *= alpha;
        acc[4 * j + 2 * hh + 1] *= alpha;
      }
    }
    uint32_t p[BN / 4];   // P in bf16 pairs: p[2j + hh] = row hh's keys 8j + 2 quad + {0, 1}
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float p0 = exp2f(s[4 * j + 2 * hh] - m_use[hh]);
        const float p1 = exp2f(s[4 * j + 2 * hh + 1] - m_use[hh]);
        l[hh] += p0 + p1;
        p[2 * j + hh] = hop::pack_bf16(p0, p1);
      }

    // O += P V: P from registers (16 keys a step), V MN-major
    hop::fence_regs(acc);
    hop::wg_arrive();
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      const uint32_t a[4] = {p[4 * kc], p[4 * kc + 1], p[4 * kc + 2], p[4 * kc + 3]};
      hop::wgmma_rs<1>(acc, a, hop::desc<SW>(v_addr + kc * 16 * SW, BN * SW, 8 * SW), 1);
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(acc);
  }
  hop::cp_async_wait<0>();

  // epilogue: the row sums over the quad, then o = acc / l and lse.  o is
  // staged in shared memory (the K/V ring is free; rows padded by 16 bytes,
  // so the fragment's writes hit 32 banks) and leaves in whole rows of
  // 16-byte stores, not eight rows of 16 bytes a warp instruction.
  __syncthreads();   // both warpgroups' last wgmmas are done with Q, K and V
  constexpr int OS = D * 2 + 16;   // bytes of a staged row
  static_assert(C::BM * OS <= 4 * C::KV_BYTES, "the staged tile fits in the K/V ring");
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt_ = l[hh];
    lt_ += __shfl_xor_sync(0xffffffffu, lt_, 1);
    lt_ += __shfl_xor_sync(0xffffffffu, lt_, 2);
    const int r = rl + 8 * hh, row = row0 + r;
    const float inv = lt_ == 0.f ? 0.f : 1.f / lt_;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(kvs + r * OS + 2 * (8 * j + 2 * quad)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh] * inv, acc[4 * j + 2 * hh + 1] * inv);
    if (quad == 0 && row < n_q)
      lse[size_t(bh) * n_q + row] = lt_ == 0.f ? -INFINITY : m[hh] * fa::LN2 + logf(lt_);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_rows * (D / 8); i += C::THREADS) {
    const int r = i / (D / 8), c = i % (D / 8) * 8;
    *reinterpret_cast<uint4*>(o + (size_t(bh) * n_q + row0 + r) * D + c) =
        *reinterpret_cast<const uint4*>(kvs + r * OS + 2 * c);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const int* lens, void* o,
                      float* lse, int b, int h, int h_kv, int n_q, int n_kv, int causal,
                      int window, float scale_log2, cudaStream_t stream) {
  auto kernel = flash_fwd_tc_kernel<D>;
  static cudaError_t opted = fa::allow_smem(kernel, Tc<D>::SMEM);
  if (opted != cudaSuccess) return opted;
  dim3 grid(b * h, (n_q + Tc<D>::BM - 1) / Tc<D>::BM);
  kernel<<<grid, Tc<D>::THREADS, Tc<D>::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      lens, static_cast<bf16*>(o), lse, h, h_kv, n_q, n_kv, causal, window, scale_log2);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(int d, const void* q, const void* k, const void* v, const int* lens,
                         void* o, float* lse, int b, int h, int h_kv, int n_q, int n_kv,
                         int causal, int window, float scale_log2, cudaStream_t st) {
  switch (d) {
    case 32: return launch<float, 32>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, causal, window, scale_log2, st);
    case 64: return launch<float, 64>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, causal, window, scale_log2, st);
    case 128: return launch<float, 128>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, causal, window, scale_log2, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bf16(int d, const void* q, const void* k, const void* v, const int* lens,
                          void* o, float* lse, int b, int h, int h_kv, int n_q, int n_kv,
                          int causal, int window, float scale_log2, cudaStream_t st) {
  switch (d) {
    case 32: return launch_tc<32>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, causal, window, scale_log2, st);
    case 64: return launch_tc<64>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, causal, window, scale_log2, st);
    case 128: return launch_tc<128>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, causal, window, scale_log2, st);
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
    return dispatch_f32(d, q, k, v, lens, o, l, b, h, h_kv, n_q, n_kv, causal, window,
                        scale_log2, st);
  if (dtype == 1)
    return dispatch_bf16(d, q, k, v, lens, o, l, b, h, h_kv, n_q, n_kv, causal, window,
                         scale_log2, st);
  return int(cudaErrorInvalidValue);
}
