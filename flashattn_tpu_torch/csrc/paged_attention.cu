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
// Semantics (those TPU kernels', held by ops/paged_attention.py::
// paged_attention_plain): q arrives as (b, h_kv, rows, d) with rows =
// group * chunk in (group, chunk) order, so row r is chunk token
// j = r % chunk at position base + j, base = lengths[b] - chunk; it sees
// positions pos < base + j + 1 (and pos >= base + j + 1 - window if
// window > 0).  Key position pos lives at (page_indices[b, pos / page],
// pos % page), so any page size works.  A sequence walks the pages
// [p0, n): n = min(cdiv(len, page), pages_per_seq) (a chunked-prefill
// wave's padding can push len past the table), p0 the first page the
// window reaches.  JAX's rounding order: q * (scale * log2 e) rounded to
// q's dtype; scores in f32 from operands in q's dtype (an int8 / fp8
// payload widens exactly, unscaled), times the key's K scale; the softmax
// in exp2; p times the key's V scale, rounded to q's dtype before the PV
// product; acc in f32, times 1 / l at the end.  A key that the walk
// visits but a row does not see scores -1e30, as in JAX: a row with no
// live key among the visited pages averages their V, as JAX's does, and
// such a key's V row still enters the P V product with p = 0 (a NaN row
// in a masked slot of a visited page makes the output NaN in both, for
// every row of the wave: the marks and the poison pass below carry that to
// the row tiles whose own pages do not hold the slot, C15).
//
// What bounds it on the H100.  At decode (rows <= 16) the HBM bytes: the
// K/V history read once per (sequence, kv head), half of it for a
// quantized pool plus 8 bytes of scales a token; the operations are tiny.
// A wide extend wave (2048 rows) is bound by its two products on the
// tensor cores (4 d flops per live (row, key) pair at 989 TF/s).  Measured
// on the card, a quantized pool's decode is bound by widening its payloads
// (instructions), not by its halved bytes.
//
// Design: split-K over the walk.  A block takes a run of split_pages whole
// pages [p0 + s * split_pages, ...) of one (sequence, kv head) (and a tile
// of rows), so a decode at B4 Hkv8 over 8K histories runs 16 splits of 4
// pages, 512 blocks, instead of one block per (sequence, kv head) that
// walked the whole history alone.  The host picks split_pages
// (ops/paged_attention.py::split_plan): a grid of row tiles that fills two
// waves of the card takes one split; a smaller one about four waves of
// splits of at least 512 keys.  A block whose run is past its sequence's
// walk writes an empty partial.  With more than one split each block
// writes its unnormalised (acc, m, l) in f32 to a workspace (b, h_kv,
// n_splits, rows, d + 2), and paged_merge_kernel (a block of four warps a
// row) combines them in a fixed order (no atomics: two calls agree bit for
// bit) and writes o; with one split the block writes o itself.  q and o
// keep the caller's (b, chunk, h_q, d) layout.  Three tiles, by q's dtype
// and the row count:
//   bf16, rows <= 16 (every decode, GQA groups up to 16, short chunks):
//     paged_decode_kernel, four warps, each an independent stream over
//     every fourth chunk of 16 keys through a cp.async ring of its own
//     (two stages for a bf16 pool, three for a quantized one, whose chunk
//     is half the bytes: three blocks an SM either way; 16 bytes a copy,
//     the page table read a chunk ahead, zero fill outside the run), so
//     the loop has no block barrier.  The 16 rows are one mma.sync
//     m16n8k16 tile: Q in registers, S = Q K^T with the contraction
//     permuted alike in Q's and K's fragments so that a lane reads d / 4
//     contiguous values of a K row, the online softmax on the fragment, P
//     rounded to bf16 in registers as the A operand of P V, V by
//     ldmatrix.trans.  A quantized payload widens to exact bf16 pairs in
//     registers as the fragments are built (int8 by an f32 exponent trick,
//     fp8 by one cvt a pair; V's lanes own contiguous columns for it).  The
//     warps' states merge through shared memory at the end.
//   bf16, rows > 16 (chunk 64, chunked-prefill waves): paged_extend_kernel,
//     the bf16 flash forward's wgmma tile (flash_fwd.cu) over a paged
//     source: 128 query rows, two consumer warpgroups, K/V tiles of 128
//     keys through a double-buffered cp.async ring (one page-table read a
//     tile when a page holds whole tiles, one a row otherwise; issued while
//     the S wgmma runs; quantized payloads staged as bytes and widened to
//     bf16 in shared memory), the last row tiles first, masks only on the
//     tiles that cut a row's interval, P rounded to bf16 in registers as
//     the A operand of the PV wgmma.
//   f32 (any rows): the FMA tile of attn_core.cuh (fa::attend) under the
//     same split grid, bounds clipped to the split, writing partials
//     through its paged hooks; no TF32, so the f32 gates stay 1e-4.
// The online softmax's max is per chunk of 16 keys, per 128- or 64-key
// tile, and per split, where JAX's runs page by page: p rounds to bf16
// against another max now and then, about one bf16 ulp of p.

#include <climits>
#include <type_traits>

#include "attn_core.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kMasked = -1e30f;   // JAX's mask value for a visited key

struct Args {
  const void* q; const void* kp; const void* vp;
  const float* ks; const float* vs;
  const int* lens; const int* table; void* out; float* ws;
  int b, h_kv, rows, chunk, n_pages, page_size, pages_per_seq, window;
  int split_pages, n_splits;
  float scale_log2;
};

// A sequence's walk and the part of it one split takes, in key positions.
struct Walk {
  int base;              // position of chunk row 0
  int seq_lo, seq_hi;    // the walk [p0 * page, n * page)
  int lo, hi;            // the split's pages; lo >= hi: none
};

__device__ __forceinline__ Walk make_walk(const Args& a, int b, int s) {
  const int len = a.lens[b];
  Walk w;
  w.base = len - a.chunk;
  const int n = min((max(len, 0) + a.page_size - 1) / a.page_size, a.pages_per_seq);
  const int p0 = a.window > 0 ? max(w.base + 1 - a.window, 0) / a.page_size : 0;
  w.seq_lo = p0 * a.page_size;
  w.seq_hi = n * a.page_size;
  const int s0 = p0 + s * a.split_pages;
  w.lo = s0 * a.page_size;
  w.hi = min(s0 + a.split_pages, n) * a.page_size;
  return w;
}

// Row R's live keys [lo, hi) (before the split's clip).
__device__ __forceinline__ void row_bounds(const Args& a, const Walk& w, int R, int& lo,
                                           int& hi) {
  hi = w.base + R % a.chunk + 1;
  lo = a.window > 0 ? hi - a.window : INT_MIN / 2;
}

// The rows [R0, R1) of (group, chunk) order cover a run of j = R % chunk,
// or every j when it wraps: [jmin, jmax].
__device__ __forceinline__ void chunk_span(const Args& a, int R0, int R1, int& jmin,
                                           int& jmax) {
  jmin = 0;
  jmax = a.chunk - 1;
  if (R1 - R0 < a.chunk) {
    const int j0 = R0 % a.chunk, j1 = (R1 - 1) % a.chunk;
    if (j1 >= j0) { jmin = j0; jmax = j1; }
  }
}

// The keys a block of rows [R0, R1) visits in its split: the whole pages
// that hold the hull of the rows' live keys, or the whole split when some
// row sees no key of the walk (it then averages every visited key, as in
// JAX).  JAX's page walk multiplies every V row of a page it reads by its
// p, 0 for a key the row does not see, so a NaN row in such a slot (a page
// holding positions past a model's table) reaches the output: the block
// reads whole pages for it.  A row tile of a wave wider than one tile
// leaves out pages that JAX's walk reads for the whole wave; the poison
// pass (paged_poison_kernel) gives their non-finite V values' effect.  The
// rows' bounds grow with j, so the hull's ends and the rows with no key
// are at the run's ends.
__device__ __forceinline__ void block_range(const Args& a, const Walk& w, int R0, int R1,
                                            int& lo, int& hi) {
  lo = hi = 0;
  if (w.lo >= w.hi || R1 <= R0) return;
  int jmin, jmax;
  chunk_span(a, R0, R1, jmin, jmax);
  int lo0, hi0, lo1, hi1;
  row_bounds(a, w, jmin, lo0, hi0);
  row_bounds(a, w, jmax, lo1, hi1);
  const bool dead = min(hi0, w.seq_hi) <= max(lo0, w.seq_lo) ||
                    min(hi1, w.seq_hi) <= max(lo1, w.seq_lo);
  if (dead) { lo = w.lo; hi = w.hi; return; }
  lo = max(w.lo, lo0) / a.page_size * a.page_size;
  hi = min(w.hi, (hi1 + a.page_size - 1) / a.page_size * a.page_size);
  if (lo >= hi) lo = hi = 0;
}

// The score of key pos that row [rlo, rhi) of split [w.lo, w.hi) does not
// see: -1e30 inside the split's pages, -inf outside (another split's).
__device__ __forceinline__ float masked(const Walk& w, int pos) {
  return pos >= w.lo && pos < w.hi ? kMasked : -INFINITY;
}

__device__ __forceinline__ size_t slot_of(const Args& a, const int* tab, int pos) {
  int page = tab[pos / a.page_size];
  page = min(max(page, 0), a.n_pages - 1);
  return size_t(page) * a.page_size + pos % a.page_size;
}

// Offset of query row r of (sequence b, kv head hk) in q and out, which
// keep the caller's layout (b, chunk, h_kv * group, d): row r = g * chunk
// + j is chunk token j of q head hk * group + g.
__device__ __forceinline__ size_t q_off(const Args& a, int b, int hk, int r, int D) {
  const int group = a.rows / a.chunk, g = r / a.chunk, j = r % a.chunk;
  return ((size_t(b) * a.chunk + j) * (a.h_kv * group) + size_t(hk) * group + g) * D;
}

// The partial (acc[D], m, l) of row r of split s.
__device__ __forceinline__ float* partial(const Args& a, int b, int hk, int s, int r, int D) {
  return a.ws + ((size_t(b * a.h_kv + hk) * a.n_splits + s) * a.rows + r) * size_t(D + 2);
}

// -- bf16, rows <= 16: the split-K decode tile (mma.sync) ----------------------------

template <typename P, int D>
struct Dec {
  static constexpr bool kQuant = !std::is_same<P, bf16>::value;
  // a quantized chunk is half a bf16 one: a deeper ring keeps as many
  // bytes in flight in the same shared memory
  // rings of 2 (bf16) or 3 (quantized: half the bytes a chunk) chunks of
  // 16 keys: three blocks an SM in either case
  static constexpr int WARPS = 4, THREADS = 32 * WARPS, KC = 16, STAGES = kQuant ? 3 : 2;
  static constexpr int NT = D / 8;                            // n-tiles of P V
  static constexpr int ROW = D * int(sizeof(P)) + 16;         // a staged key row, padded
  static constexpr int STAGE = 2 * KC * ROW + (kQuant ? 2 * KC * 4 : 0);
  static constexpr int WARP_BYTES = STAGES * STAGE;
  static constexpr int MERGE = (WARPS * 16 * D + 2 * WARPS * 16) * 4;
  static constexpr size_t SMEM = size_t(WARPS * WARP_BYTES > MERGE ? WARPS * WARP_BYTES : MERGE);
  // d of accumulator column n of n-tile nd: bf16 V is read by ldmatrix in
  // its own layout; a quantized V is converted from bytes, each lane group
  // g reading the NT contiguous columns [g NT, g NT + NT) it accumulates
  __device__ static constexpr int dcol(int nd, int n) { return kQuant ? n * NT + nd : nd * 8 + n; }
};

// Pair k (bytes 2k, 2k + 1) of the four 8-bit payloads in w as an exact
// bf16 pair, the lower byte in the low half, with few conversion-unit
// instructions.  int8: the byte x ^ 0x80 under the f32 exponent of 2^23 is
// 2^23 + 128 + x, so one subtraction leaves x, and the upper half of an f32
// that bf16 holds exactly is that bf16.  fp8 e4m3: one cvt to an f16 pair
// (exact), then to f32 and the same upper halves.
template <int K>
__device__ __forceinline__ uint32_t widen2(uint32_t w, int8_t) {
  const uint32_t u = w ^ 0x80808080u;
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + 2 * K)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441 + 2 * K)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
template <int K>
__device__ __forceinline__ uint32_t widen2(uint32_t w, __nv_fp8_e4m3) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w >> (16 * K)), __NV_E4M3);
  const float2 f = __half22float2(__half2(h));
  return __byte_perm(__float_as_uint(f.x), __float_as_uint(f.y), 0x7632);
}

template <int BYTES>
__device__ __forceinline__ void lds(uint32_t* dst, const uint8_t* src) {
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else {
    *dst = *reinterpret_cast<const uint32_t*>(src);
  }
}

// A block takes one split of one (sequence, kv head); its four warps each
// stream every fourth chunk of 16 keys of the block's range through their
// own cp.async ring (the lanes look up the chunk's page slots one chunk
// ahead), so the loop needs no block barrier.  The contraction dim is
// permuted alike in Q's and K's fragments so that lane (g, t) reads the
// D / 4 contiguous values [t D / 4, ...) of its key rows.
template <typename P, int D>
__global__ void __launch_bounds__(Dec<P, D>::THREADS)
paged_decode_kernel(Args a) {
  using C = Dec<P, D>;
  constexpr int KC = C::KC, S = C::STAGES, NT = C::NT, KQ = D / 4;
  constexpr int KBYTES = KQ * int(sizeof(P)), VBYTES = NT * int(sizeof(P));
  extern __shared__ uint8_t smem_raw[];   // 16-byte aligned, as cp.async and ldmatrix need
  uint8_t* smem = smem_raw;
  const int s = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const Walk w = make_walk(a, b, s);
  const int n_rows = a.rows;
  int klo, khi;
  block_range(a, w, 0, n_rows, klo, khi);
  const int k0 = (klo / KC) * KC;
  const int n_chunks = khi > klo ? (khi - k0 + KC - 1) / KC : 0;
  const int my_n = n_chunks > warp ? (n_chunks - warp + C::WARPS - 1) / C::WARPS : 0;

  const bf16* qp = static_cast<const bf16*>(a.q);
  const size_t pool = size_t(hk) * a.n_pages * a.page_size;   // tokens before this head
  const uint8_t* kpool = static_cast<const uint8_t*>(a.kp) + pool * D * sizeof(P);
  const uint8_t* vpool = static_cast<const uint8_t*>(a.vp) + pool * D * sizeof(P);
  const float* kspool = C::kQuant ? a.ks + pool : nullptr;
  const float* vspool = C::kQuant ? a.vs + pool : nullptr;
  const int* tab = a.table + size_t(b) * a.pages_per_seq;
  uint8_t* mine = smem + warp * C::WARP_BYTES;

  // the page slot of key (lane % KC) of chunk i, or -1 outside the range
  auto slot_for = [&](int i) -> long long {
    const int pos = k0 + (warp + C::WARPS * i) * KC + lane % KC;
    return i < my_n && pos >= klo && pos < khi ? (long long)slot_of(a, tab, pos) : -1;
  };
  auto load = [&](int st, long long my_slot) {
    uint8_t* dst = mine + st * C::STAGE;
    constexpr int CPR = D * int(sizeof(P)) / 16;   // 16-byte copies a row
    for (int i = lane; i < KC * CPR; i += 32) {
      const int r = i / CPR, c = i % CPR;
      const long long sl = __shfl_sync(0xffffffffu, my_slot, r);
      const bool ok = sl >= 0;
      const size_t off = ok ? size_t(sl) * D * sizeof(P) + c * 16 : 0;
      hop::cp_async<16>(hop::smem_u32(dst + r * C::ROW + c * 16), kpool + off, ok);
      hop::cp_async<16>(hop::smem_u32(dst + (KC + r) * C::ROW + c * 16), vpool + off, ok);
    }
    if constexpr (C::kQuant) {
      float* scl = reinterpret_cast<float*>(dst + 2 * KC * C::ROW);
#pragma unroll
      for (int j = lane; j < 2 * KC; j += 32) {
        const long long sl = __shfl_sync(0xffffffffu, my_slot, j % KC);
        hop::cp_async<4>(hop::smem_u32(scl + j), (j < KC ? kspool : vspool) +
                                                     (sl >= 0 ? size_t(sl) : 0), sl >= 0);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < my_n) load(i, slot_for(i));
    hop::cp_async_commit();
  }
  long long next_slot = slot_for(S - 1);

  // Q fragments, prescaled: q * scale_log2 rounded to bf16 (scale_log2 is
  // bf16 already, so the product is exact before its one rounding);
  // qf[ks][i] holds row g + 8 (i & 1), d = t KQ + 4 ks + 2 (i >> 1) + {0, 1}
  uint32_t qf[D / 16][4];
  const bf16* qrow[2] = {qp + q_off(a, b, hk, g, D), qp + q_off(a, b, hk, g + 8, D)};
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i & 1), col = t * KQ + 4 * ks + 2 * (i >> 1);
      float x0 = 0.f, x1 = 0.f;
      if (row < n_rows) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(qrow[i & 1] + col);
        x0 = __bfloat162float(__float2bfloat16(__low2float(v) * a.scale_log2));
        x1 = __bfloat162float(__float2bfloat16(__high2float(v) * a.scale_log2));
      }
      qf[ks][i] = hop::pack_bf16(x0, x1);
    }
  int rlo[2], rhi[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int R = g + 8 * hh;
    if (R < n_rows) {
      row_bounds(a, w, R, rlo[hh], rhi[hh]);
      rlo[hh] = max(rlo[hh], w.lo);
      rhi[hh] = min(rhi[hh], w.hi);
    } else {
      rlo[hh] = 0; rhi[hh] = 0;
    }
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // l: this thread's columns
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < my_n; ++i) {
    hop::cp_async_wait<S - 2>();
    __syncwarp();   // chunk i has landed for every lane; stage (i - 1) % S is free
    if (i + S - 1 < my_n) load((i + S - 1) % S, next_slot);
    hop::cp_async_commit();
    next_slot = slot_for(i + S);   // its latency hides behind this chunk's math
    const uint8_t* kt = mine + (i % S) * C::STAGE;
    const uint8_t* vt = kt + KC * C::ROW;
    const float* scl = reinterpret_cast<const float*>(kt + 2 * KC * C::ROW);

    // S = Q K^T over 16 keys: two n-tiles of 8, K row nt * 8 + g
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      uint32_t kw[KBYTES / 4];
      lds<KBYTES>(kw, kt + (nt * 8 + g) * C::ROW + t * KBYTES);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t b0, b1;
        if constexpr (C::kQuant) {
          b0 = widen2<0>(kw[ks], P());
          b1 = widen2<1>(kw[ks], P());
        } else {
          b0 = kw[2 * ks];
          b1 = kw[2 * ks + 1];
        }
        hop::mma_16816(sc[nt], qf[ks], b0, b1);
      }
    }

    // scores (x K scale), mask, online softmax: sc[nt][2 hh + e] is row
    // g + 8 hh, key kc + 8 nt + 2 t + e
    const int kc = k0 + (warp + C::WARPS * i) * KC;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = nt * 8 + 2 * t + e, pos = kc + key;
          float x = sc[nt][2 * hh + e];
          if constexpr (C::kQuant) x *= scl[key];
          if (pos < rlo[hh] || pos >= rhi[hh]) x = masked(w, pos);
          sc[nt][2 * hh + e] = x;
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
      for (int j = 0; j < NT; ++j) {
        acc[j][2 * hh] *= alpha;
        acc[j][2 * hh + 1] *= alpha;
      }
    }
    uint32_t pa[4];   // P as the A fragment: keys 0-7 (pa[0], pa[1]), 8-15 (pa[2], pa[3])
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float p0 = exp2f(sc[nt][2 * hh] - m_use[hh]);
        float p1 = exp2f(sc[nt][2 * hh + 1] - m_use[hh]);
        l[hh] += p0 + p1;
        if constexpr (C::kQuant) {
          p0 *= scl[KC + nt * 8 + 2 * t];
          p1 *= scl[KC + nt * 8 + 2 * t + 1];
        }
        pa[2 * nt + hh] = hop::pack_bf16(p0, p1);
      }

    // O += P V
    if constexpr (C::kQuant) {
      // V rows 2t, 2t + 1, 2t + 8, 2t + 9 at columns [g NT, g NT + NT)
      uint32_t vw[4][VBYTES / 4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        lds<VBYTES>(vw[q], vt + (2 * t + (q & 1) + 8 * (q >> 1)) * C::ROW + g * VBYTES);
      // bytes nd of rows (2t, 2t + 1) and (2t + 8, 2t + 9) side by side,
      // four n-tiles a word
#pragma unroll
      for (int q = 0; q < NT / 4; ++q) {
        const uint32_t lo01 = __byte_perm(vw[0][q], vw[1][q], 0x5140);
        const uint32_t hi01 = __byte_perm(vw[0][q], vw[1][q], 0x7362);
        const uint32_t lo89 = __byte_perm(vw[2][q], vw[3][q], 0x5140);
        const uint32_t hi89 = __byte_perm(vw[2][q], vw[3][q], 0x7362);
        hop::mma_16816(acc[4 * q], pa, widen2<0>(lo01, P()), widen2<0>(lo89, P()));
        hop::mma_16816(acc[4 * q + 1], pa, widen2<1>(lo01, P()), widen2<1>(lo89, P()));
        hop::mma_16816(acc[4 * q + 2], pa, widen2<0>(hi01, P()), widen2<0>(hi89, P()));
        hop::mma_16816(acc[4 * q + 3], pa, widen2<1>(hi01, P()), widen2<1>(hi89, P()));
      }
    } else {
      // B fragments by ldmatrix.trans, two n-tiles a load
      const int mat = lane / 8;
      const uint32_t v_addr =
          hop::smem_u32(vt + ((mat & 1) * 8 + lane % 8) * C::ROW + (mat >> 1) * 16);
#pragma unroll
      for (int nd = 0; nd < NT; nd += 2) {
        uint32_t vb[4];
        hop::ldmatrix_x4_trans(vb, v_addr + nd * 16);
        hop::mma_16816(acc[nd], pa, vb[0], vb[1]);
        hop::mma_16816(acc[nd + 1], pa, vb[2], vb[3]);
      }
    }
  }
  hop::cp_async_wait<0>();

  // merge the warps' states in shared memory (the rings are free), then
  // write o (one split) or the split's partial
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);            // [WARPS][16][D]
  float* mred = red + C::WARPS * 16 * D;                   // [WARPS][16]
  float* lred = mred + C::WARPS * 16;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = g + 8 * hh;
    if (t == 0) {
      mred[warp * 16 + r] = m[hh];
      lred[warp * 16 + r] = l[hh];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        red[(warp * 16 + r) * D + C::dcol(j, 2 * t + e)] = acc[j][2 * hh + e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_rows * D; i += C::THREADS) {
    const int r = i / D, c = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int v = 0; v < C::WARPS; ++v) M = fmaxf(M, mred[v * 16 + r]);
    const float Mu = M == -INFINITY ? 0.f : M;
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int v = 0; v < C::WARPS; ++v) {
      const float wt = exp2f(mred[v * 16 + r] - Mu);
      L += wt * lred[v * 16 + r];
      A += wt * red[(v * 16 + r) * D + c];
    }
    if (a.n_splits == 1) {
      static_cast<bf16*>(a.out)[q_off(a, b, hk, r, D) + c] =
          __float2bfloat16(A * (L == 0.f ? 1.f : 1.f / L));
    } else {
      float* pr = partial(a, b, hk, s, r, D);
      pr[c] = A;
      if (c == 0) { pr[D] = M; pr[D + 1] = L; }
    }
  }
}

// -- bf16, rows > 16: the paged wgmma extend tile ------------------------------------

template <typename P, int D>
struct Ext {
  static constexpr bool kQuant = !std::is_same<P, bf16>::value;
  static constexpr int BM = 128, BN = 128, THREADS = 256;
  static constexpr int SW = D >= 64 ? 128 : 64;   // bytes of a swizzled bf16 row
  static constexpr int CPR = SW / 2;              // bf16 columns a region row holds
  static constexpr int SW8 = D;                   // a staged payload row: D bytes
  static constexpr int Q_BYTES = BM * D * 2, TILE16 = BN * D * 2;
  static constexpr int STAGE = BN * D * int(sizeof(P));   // a K or V tile as staged
  static constexpr size_t SMEM = 1024 + Q_BYTES + 4 * size_t(STAGE) +
                                 (kQuant ? 2 * size_t(TILE16) + 4 * BN * sizeof(float) : 0);
};

// K and V rows [kt, kt + BN) of the paged pool into swizzled tiles (the
// flash forward's layout, payload bytes swizzled by D for a quantized
// pool); keys outside [klo, khi) are zero.  A page of a multiple of BN
// keys holds the whole tile (kt is a multiple of BN): one page-table read;
// otherwise one a row.
template <typename P, int D>
__device__ __forceinline__ void load_kv(const Args& a, uint8_t* kdst, uint8_t* vdst,
                                        const uint8_t* kpool, const uint8_t* vpool,
                                        const int* tab, int kt, int klo, int khi) {
  using C = Ext<P, D>;
  constexpr int ROW = D * int(sizeof(P)), SWZ = C::kQuant ? C::SW8 : C::SW;
  constexpr int CH = ROW / 16, RC = SWZ / 16;
  const bool whole = a.page_size % C::BN == 0;
  const size_t tile_slot = whole ? slot_of(a, tab, kt) : 0;
  for (int i = threadIdx.x; i < C::BN * CH; i += C::THREADS) {
    const int r = i / CH, c = i % CH, pos = kt + r;
    const bool ok = pos >= klo && pos < khi;
    const size_t off =
        ok ? (whole ? tile_slot + r : slot_of(a, tab, pos)) * ROW + c * 16 : 0;
    const uint32_t d = (c / RC) * (C::BN * SWZ) + hop::swz<SWZ>(r * SWZ + (c % RC) * 16);
    hop::cp_async<16>(hop::smem_u32(kdst + d), kpool + off, ok);
    hop::cp_async<16>(hop::smem_u32(vdst + d), vpool + off, ok);
  }
}

// A staged payload tile (rows of D bytes, swizzled by D) to the bf16 tile
// read by wgmma, unscaled (exact).
template <typename P, int D>
__device__ __forceinline__ void widen_tile(uint8_t* dst, const uint8_t* stage) {
  using C = Ext<P, D>;
  for (int i = threadIdx.x; i < C::BN * D / 16; i += C::THREADS) {
    const int r = i / (D / 16), c0 = i % (D / 16) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(stage + hop::swz<C::SW8>(r * C::SW8 + c0));
    const uint32_t* words = reinterpret_cast<const uint32_t*>(&raw);
    uint4 out[2];
    uint32_t* o = reinterpret_cast<uint32_t*>(out);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[2 * e] = widen2<0>(words[e], P());
      o[2 * e + 1] = widen2<1>(words[e], P());
    }
    uint8_t* region = dst + (c0 / C::CPR) * (C::BN * C::SW);
    const int cb = (c0 % C::CPR) * 2;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<uint4*>(region + hop::swz<C::SW>(r * C::SW + cb + 16 * hf)) = out[hf];
  }
}

template <typename P, int D>
__global__ void __launch_bounds__(Ext<P, D>::THREADS, 1)
paged_extend_kernel(Args a, int row_tiles) {
  using C = Ext<P, D>;
  constexpr int BN = C::BN, SW = C::SW, CPR = C::CPR;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = qs + C::Q_BYTES;                  // K0, V0, K1, V1 (as staged)
  uint8_t* k16 = ring + 4 * C::STAGE;               // quantized: the widened K, V
  uint8_t* v16 = k16 + C::TILE16;
  float* scl = reinterpret_cast<float*>(v16 + C::TILE16);   // [buf][ks | vs]

  // (b, kv head) vary fastest and the last row tiles come first: in a
  // causal wave theirs are the longest walks
  const int tile = row_tiles - 1 - blockIdx.z % row_tiles, s = blockIdx.z / row_tiles;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int row0 = tile * C::BM;
  const int n_rows = min(C::BM, a.rows - row0);
  const Walk w = make_walk(a, b, s);
  int klo, khi;
  block_range(a, w, row0, row0 + n_rows, klo, khi);
  const int start = (klo / BN) * BN, end = khi;
  // every row of the block sees the keys [all_lo, all_hi) of the split:
  // tiles inside it need no mask
  int all_lo, all_hi;
  {
    int jmin, jmax, lo_, hi_;
    chunk_span(a, row0, row0 + n_rows, jmin, jmax);
    row_bounds(a, w, jmin, lo_, all_hi);
    row_bounds(a, w, jmax, all_lo, hi_);
    all_lo = max(all_lo, w.lo);
    all_hi = min(all_hi, w.hi);
  }

  const bf16* qp = static_cast<const bf16*>(a.q);
  const size_t pool = size_t(hk) * a.n_pages * a.page_size;
  const uint8_t* kpool = static_cast<const uint8_t*>(a.kp) + pool * D * sizeof(P);
  const uint8_t* vpool = static_cast<const uint8_t*>(a.vp) + pool * D * sizeof(P);
  const float* kspool = C::kQuant ? a.ks + pool : nullptr;
  const float* vspool = C::kQuant ? a.vs + pool : nullptr;
  const int* tab = a.table + size_t(b) * a.pages_per_seq;

  auto load = [&](int kt, int buf) {
    uint8_t* kd = ring + buf * 2 * C::STAGE;
    load_kv<P, D>(a, kd, kd + C::STAGE, kpool, vpool, tab, kt, klo, khi);
    if constexpr (C::kQuant) {
      const int i = threadIdx.x, pos = kt + i % BN;
      const bool ok = pos >= klo && pos < khi;
      const size_t sl = ok ? slot_of(a, tab, pos) : 0;
      hop::cp_async<4>(hop::smem_u32(scl + buf * 2 * BN + i), (i < BN ? kspool : vspool) + sl,
                       ok);
    }
  };
  if (start < end) load(start, 0);
  hop::cp_async_commit();

  // prologue: q * scale_log2 rounded to bf16 into a swizzled K-major tile,
  // 8 columns (16 bytes) a work item
  for (int i = threadIdx.x; i < C::BM * D / 8; i += C::THREADS) {
    const int r = i / (D / 8), c = i % (D / 8) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < n_rows) {
      v = *reinterpret_cast<const uint4*>(qp + q_off(a, b, hk, row0 + r, D) + c);
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        h[e] = __floats2bfloat162_rn(f.x * a.scale_log2, f.y * a.scale_log2);
      }
    }
    *reinterpret_cast<uint4*>(qs + (c / CPR) * (C::BM * SW) +
                              hop::swz<SW>(r * SW + (c % CPR) * 2)) = v;
  }

  const int wg = threadIdx.x / 128, lt = threadIdx.x % 128;
  const int lane = lt % 32, quad = lane % 4;
  const int rl = wg * 64 + (lt / 32) * 16 + lane / 4;   // local row of hh = 0 (+8: hh = 1)
  const bool wg_live = wg * 64 < n_rows;
  int lo[2], hi[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rl + 8 * hh;
    if (r < n_rows) {
      row_bounds(a, w, row0 + r, lo[hh], hi[hh]);
      lo[hh] = max(lo[hh], w.lo);
      hi[hh] = min(hi[hh], w.hi);
    } else {
      lo[hh] = hi[hh] = 0;
    }
  }

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
    uint8_t* kd = ring + buf * 2 * C::STAGE;
    uint32_t k_addr = hop::smem_u32(kd), v_addr = k_addr + C::STAGE;
    const float* ks_s = scl + buf * 2 * BN;
    if constexpr (C::kQuant) {
      widen_tile<P, D>(k16, kd);
      widen_tile<P, D>(v16, kd + C::STAGE);
      hop::fence_async_smem();
      __syncthreads();   // the widened tiles are complete
      k_addr = hop::smem_u32(k16);
      v_addr = hop::smem_u32(v16);
    }

    // S = Q K^T: 64 rows x 128 keys a warpgroup, contracted over D; the
    // next tile's copies (their page-table reads first) are issued while
    // it runs
    float sc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    if (wg_live) {
      hop::fence_regs(sc);
      hop::wg_arrive();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t region = ks * 16 / CPR, off = (ks * 16 % CPR) * 2;
        hop::wgmma_ss<0>(sc, hop::desc<SW>(q_addr + region * C::BM * SW + off, 16, 8 * SW),
                         hop::desc<SW>(k_addr + region * BN * SW + off, 16, 8 * SW), 1);
      }
      hop::wg_commit();
    }
    if (kt + BN < end) load(kt + BN, buf ^ 1);
    hop::cp_async_commit();
    if (!wg_live) continue;
    hop::wg_wait<0>();
    hop::fence_regs(sc);

    // sc[4j + 2hh + e] is row rl + 8hh, key kt + 8j + 2 quad + e
    const bool full = kt >= all_lo && kt + BN <= all_hi;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * j + 2 * quad + e, pos = kt + key;
          float x = sc[4 * j + 2 * hh + e];
          if constexpr (C::kQuant) x *= ks_s[key];
          if (!full && (pos < lo[hh] || pos >= hi[hh])) x = masked(w, pos);
          sc[4 * j + 2 * hh + e] = x;
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
        float p0 = exp2f(sc[4 * j + 2 * hh] - m_use[hh]);
        float p1 = exp2f(sc[4 * j + 2 * hh + 1] - m_use[hh]);
        l[hh] += p0 + p1;
        if constexpr (C::kQuant) {
          p0 *= ks_s[BN + 8 * j + 2 * quad];
          p1 *= ks_s[BN + 8 * j + 2 * quad + 1];
        }
        p[2 * j + hh] = hop::pack_bf16(p0, p1);
      }

    // O += P V: P from registers (16 keys a step), V MN-major
    hop::fence_regs(acc);
    hop::wg_arrive();
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      const uint32_t pa[4] = {p[4 * kc], p[4 * kc + 1], p[4 * kc + 2], p[4 * kc + 3]};
      hop::wgmma_rs<1>(acc, pa, hop::desc<SW>(v_addr + kc * 16 * SW, BN * SW, 8 * SW), 1);
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(acc);
  }
  hop::cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  if (a.n_splits > 1) {   // the split's partial, straight from the fragment
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rl + 8 * hh;
      if (r >= n_rows) continue;
      float* pr = partial(a, b, hk, s, row0 + r, D);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(pr + 8 * j + 2 * quad) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      if (quad == 0) { pr[D] = m[hh]; pr[D + 1] = l[hh]; }
    }
    return;
  }
  // o = acc / l, staged in shared memory (the ring is free; rows padded by
  // 16 bytes) and stored in whole rows
  __syncthreads();   // both warpgroups' last wgmmas are done with the tiles
  constexpr int OS = D * 2 + 16;
  static_assert(C::BM * OS <= (C::kQuant ? 2 * C::TILE16 : 4 * C::STAGE), "staged o fits");
  uint8_t* os = C::kQuant ? k16 : ring;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rl + 8 * hh;
    const float inv = l[hh] == 0.f ? 1.f : 1.f / l[hh];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(os + r * OS + 2 * (8 * j + 2 * quad)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh] * inv, acc[4 * j + 2 * hh + 1] * inv);
  }
  __syncthreads();
  bf16* o = static_cast<bf16*>(a.out);
  for (int i = threadIdx.x; i < n_rows * (D / 8); i += C::THREADS) {
    const int r = i / (D / 8), c = i % (D / 8) * 8;
    *reinterpret_cast<uint4*>(o + q_off(a, b, hk, row0 + r, D) + c) =
        *reinterpret_cast<const uint4*>(os + r * OS + 2 * c);
  }
}

// -- f32: the FMA tile of attn_core.cuh under the split grid ----------------------------

template <typename P, int D>
struct PagedSrc {
  static constexpr bool kScaled = !std::is_same<P, float>::value;
  const float* q; const P* k_pages; const P* v_pages; float* o;
  const float* k_scales; const float* v_scales;   // (n_pages, page) of this head
  Args a; const int* table;                        // this sequence's page-table row
  Walk w;
  int n_rows, kv_cap, row0, b, hk, s;

  __device__ size_t slot(int pos) const { return slot_of(a, table, pos); }
  __device__ float4 q4(int r, int c, float scale) const {
    return fa::scale4(fa::load4(q + q_off(a, b, hk, row0 + r, D) + c), scale);
  }
  __device__ float4 k4(int pos, int c) const {
    const size_t sl = slot(pos);
    const float4 v = fa::load4(k_pages + sl * D + c);
    if constexpr (kScaled) return fa::scale4(v, k_scales[sl]);
    return v;
  }
  __device__ float4 v4(int pos, int c) const {
    const size_t sl = slot(pos);
    const float4 v = fa::load4(v_pages + sl * D + c);
    if constexpr (kScaled) return fa::scale4(v, v_scales[sl]);
    return v;
  }
  __device__ float* o_row(int r) const { return o + q_off(a, b, hk, row0 + r, D); }
  __device__ float* lse_row(int) const { return nullptr; }
  __device__ void bounds(int r, int& lo, int& hi) const {
    row_bounds(a, w, row0 + r, lo, hi);
    lo = max(lo, w.lo);
    hi = min(hi, w.hi);
  }
  __device__ void walk(int& lo, int& hi) const {
    block_range(a, w, row0, row0 + n_rows, lo, hi);
  }
  __device__ float mask_value(int pos) const { return masked(w, pos); }
  __device__ float* partial_row(int r) const {
    return a.n_splits > 1 ? partial(a, b, hk, s, row0 + r, D) : nullptr;
  }
};

template <typename P, int D, int BM>
__global__ void __launch_bounds__(fa::threads<BM>())
paged_fma_kernel(Args a, int row_tiles) {
  extern __shared__ uint8_t smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int tile = blockIdx.z % row_tiles, s = blockIdx.z / row_tiles;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int row0 = tile * BM;
  PagedSrc<P, D> src;
  const size_t pool = size_t(hk) * a.n_pages * a.page_size;   // tokens before this head
  src.q = static_cast<const float*>(a.q);
  src.o = static_cast<float*>(a.out);
  src.k_pages = static_cast<const P*>(a.kp) + pool * D;
  src.v_pages = static_cast<const P*>(a.vp) + pool * D;
  src.k_scales = a.ks == nullptr ? nullptr : a.ks + pool;
  src.v_scales = a.vs == nullptr ? nullptr : a.vs + pool;
  src.a = a;
  src.table = a.table + size_t(b) * a.pages_per_seq;
  src.w = make_walk(a, b, s);
  src.n_rows = min(BM, a.rows - row0);
  src.kv_cap = max(src.w.seq_hi, 0);
  src.row0 = row0;
  src.b = b; src.hk = hk; src.s = s;
  fa::attend<float, D, BM>(src, a.scale_log2, smem);
}

// -- the pages a row tile leaves out (C15) --------------------------------------------
//
// JAX's walk takes every row of the wave at each page it visits, and a key
// that a row does not see enters the row's P V product with p = 0.  So a
// non-finite V element anywhere in a visited page makes that column NaN
// for every row of the wave (0 * NaN, 0 * inf), and a non-finite V scale
// of a quantized pool every column (p * vs is NaN before the dot).  A row
// tile of a wave wider than one tile reads only the pages of its own hull
// (reading the whole walk cost the 2048-row extend wave 75%), and the
// pages it leaves out could tell only through such values.  Two passes
// restore JAX's function, launched only for such a wave:
//   paged_nonfinite_kernel, before the split kernel: one block of 128
//     threads a (page slot of the walk, kv head, sequence) marks the
//     columns whose V holds a non-finite value (bit c % 32 of word c / 32)
//     and a non-finite V scale (bit 0 of word D / 32), 16-byte loads, each
//     thread always on the same 16 bytes of a row.  Bound by the bytes of
//     V over the walk (an int8 pool: its scales alone; an int8 payload is
//     always finite).
//   paged_poison_kernel, after the split kernel and the merge: one block a
//     (kv head, sequence, row tile) ORs the marks of the walk's pages
//     outside the tile's hull and writes NaN into those columns of the
//     tile's rows (nothing when no mark is set: it reads the marks only).

template <int D> __host__ __device__ constexpr int nf_words() { return D / 32 + 1; }

// Bit e: element e of 16 bytes of payload P is not finite (never for int8).
template <typename P>
__device__ __forceinline__ uint32_t nonfinite_bits(const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t bits = 0;
  if constexpr (std::is_same<P, float>::value) {
#pragma unroll
    for (int e = 0; e < 4; ++e) bits |= uint32_t((w[e] & 0x7F800000u) == 0x7F800000u) << e;
  } else if constexpr (std::is_same<P, bf16>::value) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      bits |= uint32_t(((w[e / 2] >> (16 * (e % 2))) & 0x7F80u) == 0x7F80u) << e;
  } else if constexpr (std::is_same<P, __nv_fp8_e4m3>::value) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      bits |= uint32_t(((w[e / 4] >> (8 * (e % 4))) & 0x7Fu) == 0x7Fu) << e;
  }
  return bits;
}

template <typename P, int D>
__global__ void __launch_bounds__(128) paged_nonfinite_kernel(Args a, uint32_t* nf) {
  constexpr int W = nf_words<D>(), EPC = 16 / int(sizeof(P)), CH = D / EPC;
  constexpr int ROW = D * int(sizeof(P));
  static_assert(128 % CH == 0, "a thread keeps to one 16 bytes of a row");
  __shared__ uint32_t words[W];
  const int i = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  if (threadIdx.x < W) words[threadIdx.x] = 0;
  __syncthreads();
  const Walk w = make_walk(a, b, 0);
  const int page = a.page_size;
  if (i * page >= w.seq_lo && i * page < w.seq_hi) {
    const int pid = min(max(a.table[size_t(b) * a.pages_per_seq + i], 0), a.n_pages - 1);
    const size_t first = (size_t(hk) * a.n_pages + pid) * page;   // the page's first slot
    if constexpr (!std::is_same<P, int8_t>::value) {
      const int c = threadIdx.x % CH;
      const uint8_t* vp = static_cast<const uint8_t*>(a.vp) + first * ROW + c * 16;
      uint32_t bits = 0;
#pragma unroll 4
      for (int r = threadIdx.x / CH; r < page; r += 128 / CH)
        bits |= nonfinite_bits<P>(*reinterpret_cast<const uint4*>(vp + size_t(r) * ROW));
      if (bits) atomicOr(&words[c * EPC / 32], bits << (c * EPC % 32));
    }
    if (a.vs != nullptr)
      for (int r = threadIdx.x; r < page; r += 128)
        if (!isfinite(a.vs[first + r])) atomicOr(&words[W - 1], 1u);
  }
  __syncthreads();
  if (threadIdx.x < W)
    nf[((size_t(b) * a.h_kv + hk) * a.pages_per_seq + i) * W + threadIdx.x] = words[threadIdx.x];
}

template <typename T, int D>
__global__ void __launch_bounds__(128) paged_poison_kernel(Args a, const uint32_t* nf,
                                                            int bm) {
  constexpr int W = nf_words<D>();
  __shared__ uint32_t words[W];
  const int hk = blockIdx.x, b = blockIdx.y, r0 = blockIdx.z * bm;
  const int r1 = min(r0 + bm, a.rows);
  if (threadIdx.x < W) words[threadIdx.x] = 0;
  __syncthreads();
  Args whole = a;
  whole.split_pages = a.pages_per_seq;   // one split: the whole walk
  const Walk w = make_walk(whole, b, 0);
  if (w.lo >= w.hi) return;
  int lo, hi;
  block_range(whole, w, r0, r1, lo, hi);   // the tile's pages, as its blocks read them
  const int p0 = w.lo / a.page_size, n = w.hi / a.page_size;
  const int c0 = lo < hi ? lo / a.page_size : p0, c1 = lo < hi ? hi / a.page_size : p0;
  uint32_t acc[W];
#pragma unroll
  for (int k = 0; k < W; ++k) acc[k] = 0;
  const uint32_t* marks = nf + (size_t(b) * a.h_kv + hk) * a.pages_per_seq * W;
  for (int i = p0 + threadIdx.x; i < n; i += 128)
    if (i < c0 || i >= c1)
#pragma unroll
      for (int k = 0; k < W; ++k) acc[k] |= marks[size_t(i) * W + k];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    acc[k] = __reduce_or_sync(0xffffffffu, acc[k]);
    if (threadIdx.x % 32 == 0 && acc[k]) atomicOr(&words[k], acc[k]);
  }
  __syncthreads();
  uint32_t any = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) any |= words[k];
  if (!any) return;
  const bool all = words[W - 1] & 1u;
  T* o = static_cast<T*>(a.out);
  for (int e = threadIdx.x; e < (r1 - r0) * D; e += 128) {
    const int r = r0 + e / D, c = e % D;
    if (all || (words[c / 32] >> (c % 32) & 1u))
      fa::store1(o + q_off(a, b, hk, r, D) + c, __int_as_float(0x7fc00000));
  }
}

// -- the merge of the splits' partials ----------------------------------------------

// One block of four warps per output row: M = max_s m_s, then o = sum_s
// 2^(m_s - M) acc_s over sum_s 2^(m_s - M) l_s (o = 0 where l is 0).  Warp
// v sums the splits s = v mod 4 in order, eight loads in flight, the
// weights passed by shuffles; the four sums add in a fixed order.
template <typename T, int D>
__global__ void __launch_bounds__(128) paged_merge_kernel(Args a) {
  __shared__ float red[4][D + 1];
  __shared__ float mx[4];
  const int row = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = row % a.rows, bh = row / a.rows;
  const float* p0 = a.ws + (size_t(bh) * a.n_splits * a.rows + r) * (D + 2);
  const size_t step = size_t(a.rows) * (D + 2);
  float M = -INFINITY;
  for (int s = threadIdx.x; s < a.n_splits; s += 128) M = fmaxf(M, p0[s * step + D]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  if (lane == 0) mx[warp] = M;
  __syncthreads();
  M = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
  const float Mu = M == -INFINITY ? 0.f : M;
  float L = 0.f, acc[D / 32];
#pragma unroll
  for (int e = 0; e < D / 32; ++e) acc[e] = 0.f;
  for (int s0 = warp; s0 < a.n_splits; s0 += 128) {
    const int n = min(32, (a.n_splits - s0 + 3) / 4);   // this warp's splits s0 + 4 j
    float wt = 0.f;
    if (lane < n) {
      const float* pr = p0 + (s0 + 4 * lane) * step;
      wt = exp2f(pr[D] - Mu);
      L += wt * pr[D + 1];
    }
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float wj = __shfl_sync(0xffffffffu, wt, j);
      const float* pr = p0 + (s0 + 4 * j) * step;
#pragma unroll
      for (int e = 0; e < D / 32; ++e) acc[e] += wj * pr[lane + 32 * e];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) L += __shfl_xor_sync(0xffffffffu, L, off);
#pragma unroll
  for (int e = 0; e < D / 32; ++e) red[warp][lane + 32 * e] = acc[e];
  if (lane == 0) red[warp][D] = L;
  __syncthreads();
  if (warp > 0) return;
  L = ((red[0][D] + red[1][D]) + red[2][D]) + red[3][D];
  const float inv = L == 0.f ? 1.f : 1.f / L;
  T* o = static_cast<T*>(a.out) + q_off(a, bh / a.h_kv, bh % a.h_kv, r, D);
#pragma unroll
  for (int e = 0; e < D / 32; ++e) {
    const int c = lane + 32 * e;
    fa::store1(o + c, (((red[0][c] + red[1][c]) + red[2][c]) + red[3][c]) * inv);
  }
}

// -- dispatch ---------------------------------------------------------------------

template <typename P, int D>
cudaError_t launch_bf16(const Args& a, cudaStream_t st) {
  if (a.rows <= 16) {
    auto kernel = paged_decode_kernel<P, D>;
    static cudaError_t opted = fa::allow_smem(kernel, Dec<P, D>::SMEM);
    if (opted != cudaSuccess) return opted;
    kernel<<<dim3(a.n_splits, a.h_kv, a.b), Dec<P, D>::THREADS, Dec<P, D>::SMEM, st>>>(a);
  } else {
    auto kernel = paged_extend_kernel<P, D>;
    static cudaError_t opted = fa::allow_smem(kernel, Ext<P, D>::SMEM);
    if (opted != cudaSuccess) return opted;
    const int tiles = (a.rows + Ext<P, D>::BM - 1) / Ext<P, D>::BM;
    kernel<<<dim3(a.h_kv, a.b, tiles * a.n_splits), Ext<P, D>::THREADS, Ext<P, D>::SMEM, st>>>(
        a, tiles);
  }
  return cudaGetLastError();
}

template <typename P, int D, int BM>
cudaError_t launch_fma(const Args& a, cudaStream_t st) {
  constexpr size_t smem = fa::smem_bytes<D, BM>();
  auto kernel = paged_fma_kernel<P, D, BM>;
  static cudaError_t opted = fa::allow_smem(kernel, smem);
  if (opted != cudaSuccess) return opted;
  const int tiles = (a.rows + BM - 1) / BM;
  kernel<<<dim3(a.h_kv, a.b, tiles * a.n_splits), fa::threads<BM>(), smem, st>>>(a, tiles);
  return cudaGetLastError();
}

// The f32 row tile: 4, 16 or 64 rows, so a decode block does not compute
// 64 rows of which one is real (ops/paged_attention.py::split_plan agrees).
template <typename P, int D>
cudaError_t launch_f32(const Args& a, cudaStream_t st) {
  if (a.rows <= 4) return launch_fma<P, D, 4>(a, st);
  if (a.rows <= 16) return launch_fma<P, D, 16>(a, st);
  return launch_fma<P, D, 64>(a, st);
}

template <typename T, typename P, int D>
cudaError_t launch(const Args& a, cudaStream_t st) {
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value)
    err = launch_f32<typename std::conditional<std::is_same<P, T>::value, float, P>::type, D>(a, st);
  else
    err = launch_bf16<typename std::conditional<std::is_same<P, T>::value, bf16, P>::type, D>(a, st);
  if (err != cudaSuccess || a.n_splits == 1) return err;
  paged_merge_kernel<T, D><<<a.b * a.h_kv * a.rows, 128, 0, st>>>(a);
  return cudaGetLastError();
}

// The row tile launch() gives a block (bf16: the decode tile's 16 rows or
// the extend tile's 128; f32: the FMA tile's 4, 16 or 64), as
// ops/paged_attention.py::row_tile says.
inline int row_tile(int dtype, int rows) {
  if (dtype == 1) return rows <= 16 ? 16 : Ext<bf16, 32>::BM;
  return rows <= 4 ? 4 : rows <= 16 ? 16 : 64;
}

template <typename P>
cudaError_t nonfinite_d(int d, const Args& a, uint32_t* nf, cudaStream_t st) {
  const dim3 grid(a.pages_per_seq, a.h_kv, a.b);
  switch (d) {
    case 32: paged_nonfinite_kernel<P, 32><<<grid, 128, 0, st>>>(a, nf); break;
    case 64: paged_nonfinite_kernel<P, 64><<<grid, 128, 0, st>>>(a, nf); break;
    case 128: paged_nonfinite_kernel<P, 128><<<grid, 128, 0, st>>>(a, nf); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t poison_d(int d, const Args& a, const uint32_t* nf, int bm, cudaStream_t st) {
  const dim3 grid(a.h_kv, a.b, (a.rows + bm - 1) / bm);
  switch (d) {
    case 32: paged_poison_kernel<T, 32><<<grid, 128, 0, st>>>(a, nf, bm); break;
    case 64: paged_poison_kernel<T, 64><<<grid, 128, 0, st>>>(a, nf, bm); break;
    case 128: paged_poison_kernel<T, 128><<<grid, 128, 0, st>>>(a, nf, bm); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t dispatch_d(int d, const Args& a, cudaStream_t st) {
  switch (d) {
    case 32: return launch<T, P, 32>(a, st);
    case 64: return launch<T, P, 64>(a, st);
    case 128: return launch<T, P, 128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// page_dtype == dtype: unquantized; 2 = int8, 3 = fp8 e4m3 (scales needed)
template <typename T>
cudaError_t dispatch_pages(int page_dtype, int dtype, int d, const Args& a, cudaStream_t st) {
  if (page_dtype == dtype) return dispatch_d<T, T>(d, a, st);
  if (a.ks == nullptr || a.vs == nullptr) return cudaErrorInvalidValue;
  if (page_dtype == 2) return dispatch_d<T, int8_t>(d, a, st);
  if (page_dtype == 3) return dispatch_d<T, __nv_fp8_e4m3>(d, a, st);
  return cudaErrorInvalidValue;
}

template <class K> int attr_of(K kernel, int what, size_t smem) {
  if (what == 1) return int(smem);
  cudaFuncAttributes at;
  const cudaError_t err = cudaFuncGetAttributes(&at, kernel);
  if (err != cudaSuccess) return -int(err);
  return what == 0 ? at.numRegs : int(at.localSizeBytes);
}

template <typename P>
int attr_d(int kind, int d, int what) {
  using Q = typename std::conditional<std::is_same<P, bf16>::value, float, P>::type;
#define PAGED_ATTR(D)                                                                       \
  if (d == D) {                                                                             \
    if (kind == 0) return attr_of(paged_decode_kernel<P, D>, what, Dec<P, D>::SMEM);        \
    if (kind == 1) return attr_of(paged_extend_kernel<P, D>, what, Ext<P, D>::SMEM);        \
    if (kind == 2) return attr_of(paged_fma_kernel<Q, D, 16>, what, fa::smem_bytes<D, 16>()); \
    if (kind == 3) return attr_of(paged_merge_kernel<bf16, D>, what, 0);                    \
  }
  PAGED_ATTR(32)
  PAGED_ATTR(64)
  PAGED_ATTR(128)
#undef PAGED_ATTR
  return -int(cudaErrorInvalidValue);
}

}  // namespace

// q (b, h_kv, rows, d) with rows = group * chunk in (group, chunk) order;
// k_pages, v_pages (h_kv, n_pages, page_size, d); k_scales, v_scales
// (h_kv, n_pages, page_size) f32 for a quantized pool, else null; lengths
// (b,) int32 counting the chunk; page_indices (b, pages_per_seq) int32; out
// like q.  ws: f32 (b, h_kv, n_splits, rows, d + 2) when n_splits > 1, else
// unused; nf: fa_paged_nonfinite's marks of these pools for a wave wider
// than one row tile (the poison pass then runs last), else null; split k
// of a sequence takes its walk's pages [p0 + k *
// split_pages, p0 + (k + 1) * split_pages).  window <= 0 means none;
// scale_log2 = sm_scale * log2(e), rounded to q's dtype.  dtype codes: 0 =
// float32, 1 = bfloat16 (q and out), 2 = int8, 3 = float8 e4m3 (page
// payloads).  Launches the split kernel, then (n_splits > 1) the merge,
// then (nf given) the poison pass.
extern "C" int fa_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                  const void* k_scales, const void* v_scales,
                                  const void* lengths, const void* page_indices, void* out,
                                  void* ws, const void* nf, int b, int h_kv, int rows, int chunk, int n_pages,
                                  int page_size, int pages_per_seq, int d, int window,
                                  int split_pages, int n_splits, float scale_log2, int dtype,
                                  int page_dtype, void* stream) {
  if (b == 0 || h_kv == 0 || rows == 0) return 0;
  if (split_pages < 1 || n_splits < 1 || (n_splits > 1 && ws == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{q, k_pages, v_pages, static_cast<const float*>(k_scales),
         static_cast<const float*>(v_scales), static_cast<const int*>(lengths),
         static_cast<const int*>(page_indices), out, static_cast<float*>(ws), b, h_kv, rows,
         chunk, n_pages, page_size, pages_per_seq, window, split_pages, n_splits, scale_log2};
  if (dtype != 0 && dtype != 1) return int(cudaErrorInvalidValue);
  const cudaError_t err = dtype == 0 ? dispatch_pages<float>(page_dtype, dtype, d, a, st)
                                     : dispatch_pages<bf16>(page_dtype, dtype, d, a, st);
  const int bm = row_tile(dtype, rows);
  if (err != cudaSuccess || nf == nullptr || rows <= bm) return int(err);
  const uint32_t* marks = static_cast<const uint32_t*>(nf);
  return int(dtype == 0 ? poison_d<float>(d, a, marks, bm, st)
                        : poison_d<bf16>(d, a, marks, bm, st));
}

// The marks of C15's poison pass: nf (b, h_kv, pages_per_seq, d / 32 + 1)
// uint32, for page slot i of sequence b's walk (zero outside it) bit c % 32
// of word c / 32 set where column c of the page's V (h_kv, n_pages,
// page_size, d) holds a non-finite value, and bit 0 of word d / 32 where a
// V scale (h_kv, n_pages, page_size) is not finite (v_scales null: a pool
// in q's dtype).  lengths, page_indices, chunk and window as for
// fa_paged_attention.  page_dtype: 0 float32, 1 bfloat16, 2 int8, 3 float8
// e4m3.
extern "C" int fa_paged_nonfinite(const void* v_pages, const void* v_scales,
                                  const void* lengths, const void* page_indices, void* nf,
                                  int b, int h_kv, int chunk, int n_pages, int page_size,
                                  int pages_per_seq, int d, int window, int page_dtype,
                                  void* stream) {
  if (b == 0 || h_kv == 0 || pages_per_seq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{nullptr, nullptr, v_pages, nullptr, static_cast<const float*>(v_scales),
         static_cast<const int*>(lengths), static_cast<const int*>(page_indices), nullptr,
         nullptr, b, h_kv, 0, chunk, n_pages, page_size, pages_per_seq, window,
         pages_per_seq, 1, 0.f};
  uint32_t* marks = static_cast<uint32_t*>(nf);
  switch (page_dtype) {
    case 0: return int(nonfinite_d<float>(d, a, marks, st));
    case 1: return int(nonfinite_d<bf16>(d, a, marks, st));
    case 2: return int(nonfinite_d<int8_t>(d, a, marks, st));
    case 3: return int(nonfinite_d<__nv_fp8_e4m3>(d, a, marks, st));
    default: return int(cudaErrorInvalidValue);
  }
}

// A paged kernel's attribute, launching nothing: kind 0 the bf16 decode
// tile, 1 the bf16 extend tile, 2 the f32 FMA tile (16 rows), 3 the merge;
// what 0 registers a thread, 1 dynamic shared memory bytes, 2 local
// (spill) bytes a thread.  Negative: minus a CUDA error.
extern "C" int fa_paged_kernel_attr(int kind, int d, int page_dtype, int what) {
  if (page_dtype == 1) return attr_d<bf16>(kind, d, what);
  if (page_dtype == 2) return attr_d<int8_t>(kind, d, what);
  if (page_dtype == 3) return attr_d<__nv_fp8_e4m3>(kind, d, what);
  return -int(cudaErrorInvalidValue);
}
