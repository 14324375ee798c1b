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
// tensor cores (4 d flops per live (row, key) pair at 989 TF/s; f32 q
// three bf16 products a product, six over an f32 pool).  Measured on the
// card, a quantized pool's decode is bound by widening its payloads
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
// keep the caller's (b, chunk, h_q, d) layout.  Four tiles, by q's dtype
// and the row count (16 rows a block at decode, 128 above, either dtype):
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
//   f32, rows <= 16: paged_decode_f32_kernel, the bf16 decode tile's
//     streams and merge in split precision (split.cuh): q's three bf16
//     pieces made once in registers, S the sum of the piece products
//     (three against a quantized pool's exact bf16 K, six against an f32
//     pool's K split in registers), p (times the V scale) split in
//     registers into the A operand of P V, whose product sums from zero a
//     chunk and is added to the accumulator in f32.  See its note.
//   f32, rows > 16: paged_extend_f32_kernel, the bf16 extend tile's walk
//     with flash_fwd.cu's f32 split-precision products over 64-key tiles
//     whose payloads are widened or split into bf16 planes in shared
//     memory.  See its note.
// The online softmax's max is per chunk of 16 keys, per 128- or 64-key
// tile, and per split, where JAX's runs page by page: p rounds to bf16
// against another max now and then, about one bf16 ulp of p (bf16 q; f32
// q keeps p in f32).

// Head dims: any multiple of 8 up to 256 with bf16 q, up to 128 with f32
// q.  Every tile is compiled at the widths D = 32, 64 and 128 (bf16 q's
// decode and extend tiles and the bf16 merge also at 256) and a call runs
// at the least one that holds d (hop::tile_width); d is the row stride of
// q, o and the pools (Args::d), a staged row's columns d..D - 1 are
// zero-filled as it loads (hop::cp_chunk: 8-byte copies for an 8-bit row
// of 8 mod 16 bytes), and only columns below d are stored, the partials
// included (d + 2 floats a row).  At D 256 the decode tile keeps Q's
// fragments in shared memory (Dec::kQSmem) and reads K and a quantized V
// 16 bytes at a time, so that acc's 128 registers fit; the extend tile
// takes 64-key K and V tiles (Ext::BN), as the flash forward's does, and
// adds each 16-key chunk's P V to acc by one m64n256k16 wgmma.  The marks
// take cdiv(d, 32) words of columns and the V scale's word.

#include <climits>
#include <cuda_fp8.h>

#include <type_traits>

#include "attn_util.cuh"
#include "hopper.cuh"
#include "split.cuh"

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
  int d;   // the head dim: a stored row's values (at most the tile's D)
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
__device__ __forceinline__ size_t q_off(const Args& a, int b, int hk, int r) {
  const int group = a.rows / a.chunk, g = r / a.chunk, j = r % a.chunk;
  return ((size_t(b) * a.chunk + j) * (a.h_kv * group) + size_t(hk) * group + g) * a.d;
}

// The partial (acc[d], m, l) of row r of split s.
__device__ __forceinline__ float* partial(const Args& a, int b, int hk, int s, int r) {
  return a.ws + ((size_t(b * a.h_kv + hk) * a.n_splits + s) * a.rows + r) * size_t(a.d + 2);
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
  // D 256: Q's fragments in shared memory after the rings (16 bytes a lane
  // and k-step, 8 KB), read each chunk, where registers would hold them
  // (64 a thread) beside acc's 128
  static constexpr bool kQSmem = D > 128;
  static constexpr int QF_BYTES = kQSmem ? (D / 16) * 32 * 16 : 0;
  static constexpr size_t SMEM = size_t(WARPS * WARP_BYTES + QF_BYTES > MERGE
                                            ? WARPS * WARP_BYTES + QF_BYTES
                                            : MERGE);
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
  const uint8_t* kpool = static_cast<const uint8_t*>(a.kp) + pool * a.d * sizeof(P);
  const uint8_t* vpool = static_cast<const uint8_t*>(a.vp) + pool * a.d * sizeof(P);
  const float* kspool = C::kQuant ? a.ks + pool : nullptr;
  const float* vspool = C::kQuant ? a.vs + pool : nullptr;
  const int* tab = a.table + size_t(b) * a.pages_per_seq;
  uint8_t* mine = smem + warp * C::WARP_BYTES;

  // the page slot of key (lane % KC) of chunk i, or -1 outside the range
  auto slot_for = [&](int i) -> long long {
    const int pos = k0 + (warp + C::WARPS * i) * KC + lane % KC;
    return i < my_n && pos >= klo && pos < khi ? (long long)slot_of(a, tab, pos) : -1;
  };
  // kFull (d == D): the stored row's bytes known at compile time
  auto copy_rows = [&](uint8_t* dst, long long my_slot, auto full) {
    constexpr bool kFull = decltype(full)::value;
    constexpr int CPR = D * int(sizeof(P)) / 16;   // 16-byte chunks a staged row
    const int rb = kFull ? D * int(sizeof(P)) : a.d * int(sizeof(P));   // a stored row
    for (int i = lane; i < KC * CPR; i += 32) {
      const int r = i / CPR, c = i % CPR;
      const long long sl = __shfl_sync(0xffffffffu, my_slot, r);
      const bool ok = sl >= 0;
      const size_t off = ok ? size_t(sl) * rb : 0;
      hop::cp_chunk<kFull>(hop::smem_u32(dst + r * C::ROW + c * 16), kpool + off, kpool, c, rb,
                           ok);
      hop::cp_chunk<kFull>(hop::smem_u32(dst + (KC + r) * C::ROW + c * 16), vpool + off, vpool,
                           c, rb, ok);
    }
  };
  auto load = [&](int st, long long my_slot) {
    uint8_t* dst = mine + st * C::STAGE;
    if (a.d == D)
      copy_rows(dst, my_slot, std::true_type());
    else
      copy_rows(dst, my_slot, std::false_type());
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
  // (kQSmem: word i of lane's 16 bytes of k-step ks in qsm, each warp
  // writing every fourth k-step)
  uint32_t qf[C::kQSmem ? 1 : D / 16][4];
  uint32_t* qsm = reinterpret_cast<uint32_t*>(smem + C::WARPS * C::WARP_BYTES);
  const bf16* qrow[2] = {qp + q_off(a, b, hk, g), qp + q_off(a, b, hk, g + 8)};
  auto q_word = [&](int ks, int i) {
    const int row = g + 8 * (i & 1), col = t * KQ + 4 * ks + 2 * (i >> 1);
    float x0 = 0.f, x1 = 0.f;
    if (row < n_rows && col < a.d) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(qrow[i & 1] + col);
      x0 = __bfloat162float(__float2bfloat16(__low2float(v) * a.scale_log2));
      x1 = __bfloat162float(__float2bfloat16(__high2float(v) * a.scale_log2));
    }
    return hop::pack_bf16(x0, x1);
  };
  if constexpr (C::kQSmem) {
    for (int ks = warp; ks < D / 16; ks += C::WARPS)
#pragma unroll
      for (int i = 0; i < 4; ++i) qsm[(ks * 32 + lane) * 4 + i] = q_word(ks, i);
    __syncthreads();   // every warp reads every k-step
  } else {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[ks][i] = q_word(ks, i);
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
    if constexpr (C::kQSmem) {
      // 16 bytes of each K row at a time (KS16 k-steps), Q's fragment of a
      // k-step read once for both n-tiles
      constexpr int KS16 = 16 / (4 * int(sizeof(P)));
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int c = 0; c < KBYTES / 16; ++c) {
        uint32_t kw[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          lds<16>(kw[nt], kt + (nt * 8 + g) * C::ROW + t * KBYTES + 16 * c);
#pragma unroll
        for (int u = 0; u < KS16; ++u) {
          uint32_t qv[4];
          lds<16>(qv, reinterpret_cast<const uint8_t*>(qsm + ((c * KS16 + u) * 32 + lane) * 4));
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            uint32_t b0, b1;
            if constexpr (C::kQuant) {
              b0 = widen2<0>(kw[nt][u], P());
              b1 = widen2<1>(kw[nt][u], P());
            } else {
              b0 = kw[nt][2 * u];
              b1 = kw[nt][2 * u + 1];
            }
            hop::mma_16816(sc[nt], qv, b0, b1);
          }
        }
      }
    } else {
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
    if constexpr (C::kQuant && D > 128) {
      // as below, 16 bytes of each of the four V rows (four words of
      // n-tiles) at a time
#pragma unroll
      for (int c = 0; c < VBYTES / 16; ++c) {
        uint32_t vw[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          lds<16>(vw[q], vt + (2 * t + (q & 1) + 8 * (q >> 1)) * C::ROW + g * VBYTES + 16 * c);
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const int q = 4 * c + qq;
          const uint32_t lo01 = __byte_perm(vw[0][qq], vw[1][qq], 0x5140);
          const uint32_t hi01 = __byte_perm(vw[0][qq], vw[1][qq], 0x7362);
          const uint32_t lo89 = __byte_perm(vw[2][qq], vw[3][qq], 0x5140);
          const uint32_t hi89 = __byte_perm(vw[2][qq], vw[3][qq], 0x7362);
          hop::mma_16816(acc[4 * q], pa, widen2<0>(lo01, P()), widen2<0>(lo89, P()));
          hop::mma_16816(acc[4 * q + 1], pa, widen2<1>(lo01, P()), widen2<1>(lo89, P()));
          hop::mma_16816(acc[4 * q + 2], pa, widen2<0>(hi01, P()), widen2<0>(hi89, P()));
          hop::mma_16816(acc[4 * q + 3], pa, widen2<1>(hi01, P()), widen2<1>(hi89, P()));
        }
      }
    } else if constexpr (C::kQuant) {
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
    if (c >= a.d) continue;   // columns below d
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
      static_cast<bf16*>(a.out)[q_off(a, b, hk, r) + c] =
          __float2bfloat16(A * (L == 0.f ? 1.f : 1.f / L));
    } else {
      float* pr = partial(a, b, hk, s, r);
      pr[c] = A;
      if (c == 0) { pr[a.d] = M; pr[a.d + 1] = L; }
    }
  }
}

// -- bf16, rows > 16: the paged wgmma extend tile ------------------------------------

// D 256: K and V tiles of 64 keys (the flash forward's Tc), so that Q,
// the ring and a quantized pool's widened tiles fit (194 KB)
template <typename P, int D>
struct Ext {
  static constexpr bool kQuant = !std::is_same<P, bf16>::value;
  static constexpr int BM = 128, BN = D > 128 ? 64 : 128, THREADS = 256;
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
template <typename P, int D, bool kFull>
__device__ __forceinline__ void load_kv_rows(const Args& a, uint8_t* kdst, uint8_t* vdst,
                                             const uint8_t* kpool, const uint8_t* vpool,
                                             const int* tab, int kt, int klo, int khi) {
  using C = Ext<P, D>;
  constexpr int ROW = D * int(sizeof(P)), SWZ = C::kQuant ? C::SW8 : C::SW;
  constexpr int CH = ROW / 16, RC = SWZ / 16;
  const int rb = kFull ? ROW : a.d * int(sizeof(P));   // bytes of a stored row
  const bool whole = a.page_size % C::BN == 0;
  const size_t tile_slot = whole ? slot_of(a, tab, kt) : 0;
  for (int i = threadIdx.x; i < C::BN * CH; i += C::THREADS) {
    const int r = i / CH, c = i % CH, pos = kt + r;
    const bool ok = pos >= klo && pos < khi;
    const size_t off = ok ? (whole ? tile_slot + r : slot_of(a, tab, pos)) * rb : 0;
    const uint32_t d = (c / RC) * (C::BN * SWZ) + hop::swz<SWZ>(r * SWZ + (c % RC) * 16);
    hop::cp_chunk<kFull>(hop::smem_u32(kdst + d), kpool + off, kpool, c, rb, ok);
    hop::cp_chunk<kFull>(hop::smem_u32(vdst + d), vpool + off, vpool, c, rb, ok);
  }
}
template <typename P, int D>
__device__ __forceinline__ void load_kv(const Args& a, uint8_t* kdst, uint8_t* vdst,
                                        const uint8_t* kpool, const uint8_t* vpool,
                                        const int* tab, int kt, int klo, int khi) {
  if (a.d == D)
    load_kv_rows<P, D, true>(a, kdst, vdst, kpool, vpool, tab, kt, klo, khi);
  else
    load_kv_rows<P, D, false>(a, kdst, vdst, kpool, vpool, tab, kt, klo, khi);
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
  const uint8_t* kpool = static_cast<const uint8_t*>(a.kp) + pool * a.d * sizeof(P);
  const uint8_t* vpool = static_cast<const uint8_t*>(a.vp) + pool * a.d * sizeof(P);
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
      if (2 * BN >= C::THREADS || i < 2 * BN)   // a K and a V scale a key
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
    if (r < n_rows && c < a.d) {
      v = *reinterpret_cast<const uint4*>(qp + q_off(a, b, hk, row0 + r) + c);
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

    // S = Q K^T: 64 rows x BN keys a warpgroup, contracted over D; the
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
      float* pr = partial(a, b, hk, s, row0 + r);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        if (8 * j < a.d)
          *reinterpret_cast<float2*>(pr + 8 * j + 2 * quad) =
              make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      if (quad == 0) { pr[a.d] = m[hh]; pr[a.d + 1] = l[hh]; }
    }
    return;
  }
  // o = acc / l, staged in shared memory (the ring is free; rows padded by
  // 16 bytes) and stored in whole rows
  __syncthreads();   // both warpgroups' last wgmmas are done with the tiles
  constexpr int OS = D * 2 + 16;
  // in the ring, or in a quantized pool's widened tiles (D 256: in the
  // ring and those tiles, which follow it)
  constexpr bool kInRing = !C::kQuant || D > 128;
  static_assert(C::BM * OS <= (kInRing ? 4 * C::STAGE + (C::kQuant ? 2 * C::TILE16 : 0)
                                       : 2 * C::TILE16),
                "staged o fits");
  uint8_t* os = kInRing ? ring : k16;
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
    if (c >= a.d) continue;   // columns below d
    *reinterpret_cast<uint4*>(o + q_off(a, b, hk, row0 + r) + c) =
        *reinterpret_cast<const uint4*>(os + r * OS + 2 * c);
  }
}

// -- f32 q: split precision on the tensor cores ----------------------------------------
//
// An f32 q (and an f32 pool) has no single-pass bf16 product that holds the
// f32 gates, so both f32 tiles cut each f32 operand into three bf16 pieces
// (split.cuh: the truncating split, x = b0 + b1 + b2 exactly) and sum the
// piece products of order <= 2 on the tensor cores with f32 accumulators.
// A quantized pool's payload widens exactly to bf16, so only q's side (and
// P's) splits: three products a product; an f32 pool's K and V split too:
// six.  The tensor cores truncate each k16 step's f32 sum, so the small
// products are summed first, each S apart from q's b0 product and each
// chunk's or tile's P V from zero, and those partial sums are added in f32.
// A +-inf keeps its value in b0 with zeros in b1 and b2: over an f32 pool
// both operands' b0 (K's or V's, and q's) are taken with their non-finite
// values zeroed (sp::finite_part, sp::sanitize) in their products with the
// other operand's b1 and b2, where 0 * inf would make NaN where f32 gives
// +-inf (C17); the b0 x b0 product keeps them, so a NaN or inf V row at
// p = 0 still makes the output NaN (C8, C15).  A quantized pool's K and V
// are exact (one piece), and P = p * vs is the only non-finite A operand
// there: its products are with that one piece.

// c += a b, one mma.sync m16n8k16 (hop::mma_16816's fragments) over this
// lane's HH row halves: a[kh * HH + hh] is A's row g + 8 hh, columns 2t +
// 8 kh + {0, 1}; c[2 hh + e] is C's row g + 8 hh, column 2t + e.  HH = 1: a
// tile of at most 8 rows, whose rows g + 8 are zero in A and dropped from C.
template <int HH>
__device__ __forceinline__ void mma_hh(float (&c)[2 * HH], const uint32_t (&a)[2 * HH],
                                       uint32_t b0, uint32_t b1) {
  if constexpr (HH == 2) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    float x2, x3;
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %10, %11};\n"
        : "+f"(c[0]), "+f"(c[1]), "=f"(x2), "=f"(x3)
        : "r"(a[0]), "r"(0u), "r"(a[1]), "r"(0u), "r"(b0), "r"(b1), "f"(0.f), "f"(0.f));
  }
}

// c = the pieces of A (a[i], i = 0..2) times an exact bf16 B (three
// products, the small first), or times B's pieces bj[j] (six, split.cuh's
// order; b0f: B's b0 with its non-finite values zeroed), summed from zero.
template <int HH>
__device__ __forceinline__ void mma3(float (&c)[2 * HH], const uint32_t (&a)[3][2 * HH],
                                     uint32_t b0, uint32_t b1) {
#pragma unroll
  for (int e = 0; e < 2 * HH; ++e) c[e] = 0.f;
  mma_hh<HH>(c, a[2], b0, b1);
  mma_hh<HH>(c, a[1], b0, b1);
  mma_hh<HH>(c, a[0], b0, b1);
}
template <int HH>
__device__ __forceinline__ void mma6(float (&c)[2 * HH], const uint32_t (&a)[3][2 * HH],
                                     const uint32_t (&bj)[3][2], const uint32_t (&b0f)[2]) {
#pragma unroll
  for (int e = 0; e < 2 * HH; ++e) c[e] = 0.f;
  mma_hh<HH>(c, a[2], b0f[0], b0f[1]);      // (2, 0)
  mma_hh<HH>(c, a[0], bj[2][0], bj[2][1]);  // (0, 2)
  mma_hh<HH>(c, a[1], bj[1][0], bj[1][1]);  // (1, 1)
  mma_hh<HH>(c, a[1], b0f[0], b0f[1]);      // (1, 0)
  mma_hh<HH>(c, a[0], bj[1][0], bj[1][1]);  // (0, 1)
  mma_hh<HH>(c, a[0], bj[0][0], bj[0][1]);  // (0, 0)
}

// Four f32 values (two bf16 pairs of a B fragment) as their pieces and b0
// with its non-finite values zeroed.
__device__ __forceinline__ void split_b(float x0, float x1, float x2, float x3,
                                        uint32_t (&bj)[3][2], uint32_t (&b0f)[2]) {
  sp::split_pair(x0, x1, bj[0][0], bj[1][0], bj[2][0]);
  sp::split_pair(x2, x3, bj[0][1], bj[1][1], bj[2][1]);
  b0f[0] = sp::finite_part(bj[0][0]);
  b0f[1] = sp::finite_part(bj[0][1]);
}

// -- f32 q, rows <= 16: the split-precision decode tile (mma.sync) ---------------------

template <typename P, int D>
struct DecF {
  static constexpr bool kQuant = !std::is_same<P, float>::value;
  static constexpr int WARPS = 4, THREADS = 32 * WARPS, KC = 16;
  static constexpr int NT = D / 8, KQ = D / 4;
  // a staged key row: 8-bit payloads padded by 16 bytes (the bf16-q tile's
  // layout), f32 rows unpadded with their 16-byte units swizzled (unit)
  static constexpr int ROW = kQuant ? D + 16 : D * 4;
  // a ring slot holds the K or the V rows of one chunk (and their scales)
  static constexpr int HALF = KC * ROW + (kQuant ? KC * 4 : 0);
  // slots a warp: three chunks in flight for a quantized pool (as the
  // bf16-q tile), an f32 pool's 8 KB halves three or four slots, so that
  // two (d 128) or three blocks fit an SM
  static constexpr int HALVES = kQuant ? 6 : D == 128 ? 3 : 4;
  static constexpr int WARP_BYTES = HALVES * HALF;
  static constexpr int MERGE = (WARPS * 16 * D + 2 * WARPS * 16) * 4;
  static constexpr size_t SMEM = size_t(WARPS * WARP_BYTES > MERGE ? WARPS * WARP_BYTES : MERGE);
  // d of lane t's first value at k16 step ks (q's and K's fragments alike:
  // a quantized K row's D / 4 contiguous bytes, as the bf16-q tile; an f32
  // one 16 bytes a step); values + {0, 1} are the pair of k 2t, + {2, 3}
  // that of k 2t + 8
  __device__ static constexpr int kd(int ks, int t) { return kQuant ? t * KQ + 4 * ks : 16 * ks + 4 * t; }
  // d of accumulator column n of n-tile nd: lane group g reads contiguous
  // columns of V (NT bytes of an 8-bit row; 16 bytes of four n-tiles of an
  // f32 row)
  __device__ static constexpr int dcol(int nd, int n) {
    return kQuant ? n * NT + nd : 32 * (nd / 4) + 4 * n + nd % 4;
  }
  // the stored 16-byte unit of unit u of f32 row r: XOR-swizzled so that
  // the K reads (rows g, unit 4 ks + t) and V reads (rows 2t.., unit 8c +
  // g) of eight lanes hit eight distinct 16-byte bank groups
  __device__ static constexpr int unit(int r, int u) {
    return u ^ ((((r >> 1) & 3) << 1) ^ ((r & 1) << 2));
  }
};

// The bf16-q decode tile's streams (four warps, every fourth chunk of 16
// keys each, a cp.async ring a warp whose slots take a chunk's K rows or its
// V rows, so that an f32 pool's ring stays small) and its merge through
// shared memory, with f32 q in split precision: q * scale_log2 (f32) split
// once into three bf16 pieces as A fragments; S = the small products (q's
// b1, b2 against K's pieces, K's b1, b2 against q's b0) summed in one
// accumulator and q's b0 times K's b0 in another, added in f32; p (times
// V's scale) split into three A fragments; P V of each n-tile summed from
// zero a chunk (mma3 / mma6) and added to acc in f32.  HH = 1 (at most 8
// rows: every decode of GQA groups up to 8, verify waves of k + 1 <= 8)
// keeps no registers for rows 8..15.  What bounds it: the bytes of the
// history, as the bf16-q tile; 3 (6) times its mma.sync products and the
// split's instructions ride on the same loads.
template <typename P, int D, int HH>
__global__ void __launch_bounds__(DecF<P, D>::THREADS)
paged_decode_f32_kernel(Args a) {
  using C = DecF<P, D>;
  constexpr int KC = C::KC, H = C::HALVES, NT = C::NT, KQ = C::KQ, R2 = 2 * HH;
  extern __shared__ uint8_t smem_raw[];   // 16-byte aligned, as cp.async needs
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

  const float* qp = static_cast<const float*>(a.q);
  const size_t pool = size_t(hk) * a.n_pages * a.page_size;   // tokens before this head
  const uint8_t* kpool = static_cast<const uint8_t*>(a.kp) + pool * a.d * sizeof(P);
  const uint8_t* vpool = static_cast<const uint8_t*>(a.vp) + pool * a.d * sizeof(P);
  const float* kspool = C::kQuant ? a.ks + pool : nullptr;
  const float* vspool = C::kQuant ? a.vs + pool : nullptr;
  const int* tab = a.table + size_t(b) * a.pages_per_seq;
  uint8_t* mine = smem + warp * C::WARP_BYTES;

  // the page slot of key (lane % KC) of chunk i, or -1 outside the range
  auto slot_for = [&](int i) -> long long {
    const int pos = k0 + (warp + C::WARPS * i) * KC + lane % KC;
    return i < my_n && pos >= klo && pos < khi ? (long long)slot_of(a, tab, pos) : -1;
  };
  // half h (chunk h / 2's K rows when h is even, its V rows when odd) into
  // slot h % H; my_slot: the page slot of key lane % KC of that chunk
  // kFull (d == D): the stored row's bytes known at compile time
  auto copy_rows = [&](uint8_t* dst, const uint8_t* src, long long my_slot, auto full) {
    constexpr bool kFull = decltype(full)::value;
    constexpr int CPR = D * int(sizeof(P)) / 16;   // 16-byte chunks a staged row
    const int rb = kFull ? D * int(sizeof(P)) : a.d * int(sizeof(P));   // a stored row
    for (int i = lane; i < KC * CPR; i += 32) {
      const int r = i / CPR, c = i % CPR;
      const long long sl = __shfl_sync(0xffffffffu, my_slot, r);
      const bool ok = sl >= 0;
      const size_t off = ok ? size_t(sl) * rb : 0;
      const int cu = C::kQuant ? c : C::unit(r, c);
      hop::cp_chunk<kFull>(hop::smem_u32(dst + r * C::ROW + cu * 16), src + off, src, c, rb, ok);
    }
  };
  auto load = [&](int h, long long my_slot) {
    uint8_t* dst = mine + (h % H) * C::HALF;
    const uint8_t* src = h & 1 ? vpool : kpool;
    if (a.d == D)
      copy_rows(dst, src, my_slot, std::true_type());
    else
      copy_rows(dst, src, my_slot, std::false_type());
    if constexpr (C::kQuant) {
      if (lane < KC) {
        float* scl = reinterpret_cast<float*>(dst + KC * C::ROW);
        hop::cp_async<4>(hop::smem_u32(scl + lane),
                         (h & 1 ? vspool : kspool) + (my_slot >= 0 ? size_t(my_slot) : 0),
                         my_slot >= 0);
      }
    }
  };
  // halves go out in order, H - 1 ahead of the one in use; a chunk's page
  // slots are read one chunk ahead of its K half
  int issued = 0;
  long long cur = -1, nxt = slot_for(0);
  auto issue = [&]() {
    const int c = issued / 2;
    if (c < my_n) {
      if (!(issued & 1)) {
        cur = nxt;
        nxt = slot_for(c + 1);
      }
      load(issued, cur);
    }
    hop::cp_async_commit();
    ++issued;
  };
#pragma unroll
  for (int h = 0; h < H - 1; ++h) issue();

  // q's pieces: qf[i][ks][kh * HH + hh] = piece i of row g + 8 hh at d =
  // kd(ks, t) + 2 kh + {0, 1}, q * scale_log2 in f32 first
  uint32_t qf[3][D / 16][R2];
  bool q_inf = false;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int hh = 0; hh < HH; ++hh) {
      const int row = g + 8 * hh;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < n_rows && C::kd(ks, t) < a.d) {
        x = sp::scale4_rn(*reinterpret_cast<const float4*>(qp + q_off(a, b, hk, row) + C::kd(ks, t)),
                      a.scale_log2);
        q_inf |= isinf(x.x) || isinf(x.y) || isinf(x.z) || isinf(x.w);
      }
      sp::split_pair(x.x, x.y, qf[0][ks][hh], qf[1][ks][hh], qf[2][ks][hh]);
      sp::split_pair(x.z, x.w, qf[0][ks][HH + hh], qf[1][ks][HH + hh], qf[2][ks][HH + hh]);
    }
  // an f32 pool: q's b0 with its +-inf zeroed in the products with K's
  // b1, b2 (warp-uniform: the warp's q holds one)
  const bool q_nf = !C::kQuant && __any_sync(0xffffffffu, q_inf);
  int rlo[HH], rhi[HH];
#pragma unroll
  for (int hh = 0; hh < HH; ++hh) {
    const int R = g + 8 * hh;
    if (R < n_rows) {
      row_bounds(a, w, R, rlo[hh], rhi[hh]);
      rlo[hh] = max(rlo[hh], w.lo);
      rhi[hh] = min(rhi[hh], w.hi);
    } else {
      rlo[hh] = 0; rhi[hh] = 0;
    }
  }

  float m[HH], l[HH];   // l: this thread's columns
  float acc[NT][R2];
#pragma unroll
  for (int hh = 0; hh < HH; ++hh) { m[hh] = -INFINITY; l[hh] = 0.f; }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < R2; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < my_n; ++i) {
    hop::cp_async_wait<H - 2>();
    __syncwarp();   // K of chunk i has landed for every lane; slot (2i - 1) % H is free
    issue();
    const uint8_t* kt = mine + ((2 * i) % H) * C::HALF;

    // S = Q K^T over 16 keys: two n-tiles of 8, K row nt * 8 + g; hi = q's
    // b0 times K's b0, lo the smaller products
    float hi[2][R2], lo[2][R2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < R2; ++e) hi[nt][e] = lo[nt][e] = 0.f;
    if constexpr (C::kQuant) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t kw[KQ / 4];
        lds<KQ>(kw, kt + (nt * 8 + g) * C::ROW + t * KQ);
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t b0 = widen2<0>(kw[ks], P()), b1 = widen2<1>(kw[ks], P());
          mma_hh<HH>(lo[nt], qf[2][ks], b0, b1);
          mma_hh<HH>(lo[nt], qf[1][ks], b0, b1);
          mma_hh<HH>(hi[nt], qf[0][ks], b0, b1);
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        // q's b0 in the products with K's b1, b2: its +-inf zeroed
        uint32_t a0f[R2];
#pragma unroll
        for (int x = 0; x < R2; ++x) a0f[x] = q_nf ? sp::finite_part(qf[0][ks][x]) : qf[0][ks][x];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int r = nt * 8 + g;
          const float4 kv =
              *reinterpret_cast<const float4*>(kt + r * C::ROW + C::unit(r, 4 * ks + t) * 16);
          uint32_t bj[3][2], b0f[2];
          split_b(kv.x, kv.y, kv.z, kv.w, bj, b0f);
          mma_hh<HH>(lo[nt], qf[2][ks], b0f[0], b0f[1]);      // (2, 0)
          mma_hh<HH>(lo[nt], a0f, bj[2][0], bj[2][1]);        // (0, 2)
          mma_hh<HH>(lo[nt], qf[1][ks], bj[1][0], bj[1][1]);  // (1, 1)
          mma_hh<HH>(lo[nt], qf[1][ks], b0f[0], b0f[1]);      // (1, 0)
          mma_hh<HH>(lo[nt], a0f, bj[1][0], bj[1][1]);        // (0, 1)
          mma_hh<HH>(hi[nt], qf[0][ks], bj[0][0], bj[0][1]);  // (0, 0)
        }
      }
    }

    // scores (x K scale), mask, online softmax: hi[nt][2 hh + e] is row
    // g + 8 hh, key kc + 8 nt + 2 t + e
    const int kc = k0 + (warp + C::WARPS * i) * KC;
    const float* kscl = reinterpret_cast<const float*>(kt + KC * C::ROW);
    float mx[HH];
#pragma unroll
    for (int hh = 0; hh < HH; ++hh) mx[hh] = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < HH; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = nt * 8 + 2 * t + e, pos = kc + key;
          float x = __fadd_rn(lo[nt][2 * hh + e], hi[nt][2 * hh + e]);
          if constexpr (C::kQuant) x = __fmul_rn(x, kscl[key]);
          if (pos < rlo[hh] || pos >= rhi[hh]) x = masked(w, pos);
          hi[nt][2 * hh + e] = x;
          mx[hh] = fmaxf(mx[hh], x);
        }
    float m_use[HH];
#pragma unroll
    for (int hh = 0; hh < HH; ++hh) {
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
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < HH; ++hh) {
        const float p0 = exp2f(hi[nt][2 * hh] - m_use[hh]);
        const float p1 = exp2f(hi[nt][2 * hh + 1] - m_use[hh]);
        l[hh] += p0 + p1;
        hi[nt][2 * hh] = p0;
        hi[nt][2 * hh + 1] = p1;
      }

    hop::cp_async_wait<H - 2>();
    __syncwarp();   // V of chunk i has landed for every lane; slot 2i % H is free
    issue();
    const uint8_t* vt = mine + ((2 * i + 1) % H) * C::HALF;
    const float* vscl = reinterpret_cast<const float*>(vt + KC * C::ROW);

    // P (times V's scale) in three pieces as the A fragment: keys 0-7 (kh
    // 0), 8-15 (kh 1)
    uint32_t pa[3][R2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < HH; ++hh) {
        float p0 = hi[nt][2 * hh], p1 = hi[nt][2 * hh + 1];
        if constexpr (C::kQuant) {
          p0 = __fmul_rn(p0, vscl[nt * 8 + 2 * t]);
          p1 = __fmul_rn(p1, vscl[nt * 8 + 2 * t + 1]);
        }
        sp::split_pair(p0, p1, pa[0][nt * HH + hh], pa[1][nt * HH + hh], pa[2][nt * HH + hh]);
      }

    // O += P V, each n-tile's product from zero
    float pv[R2];
    if constexpr (C::kQuant) {
      // V rows 2t, 2t + 1, 2t + 8, 2t + 9 at columns [g NT, g NT + NT)
      uint32_t vw[4][NT / 4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        lds<NT>(vw[q], vt + (2 * t + (q & 1) + 8 * (q >> 1)) * C::ROW + g * NT);
#pragma unroll
      for (int q = 0; q < NT / 4; ++q) {
        const uint32_t lo01 = __byte_perm(vw[0][q], vw[1][q], 0x5140);
        const uint32_t hi01 = __byte_perm(vw[0][q], vw[1][q], 0x7362);
        const uint32_t lo89 = __byte_perm(vw[2][q], vw[3][q], 0x5140);
        const uint32_t hi89 = __byte_perm(vw[2][q], vw[3][q], 0x7362);
        const uint32_t bb[4][2] = {{widen2<0>(lo01, P()), widen2<0>(lo89, P())},
                                   {widen2<1>(lo01, P()), widen2<1>(lo89, P())},
                                   {widen2<0>(hi01, P()), widen2<0>(hi89, P())},
                                   {widen2<1>(hi01, P()), widen2<1>(hi89, P())}};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mma3<HH>(pv, pa, bb[e][0], bb[e][1]);
#pragma unroll
          for (int x = 0; x < R2; ++x) acc[4 * q + e][x] += pv[x];
        }
      }
    } else {
      // per four n-tiles: V rows 2t, 2t + 1, 2t + 8, 2t + 9, 16 bytes at
      // column 32 c + 4 g
#pragma unroll
      for (int c = 0; c < NT / 4; ++c) {
        float4 vr[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int rr = 2 * t + (q & 1) + 8 * (q >> 1);
          vr[q] = *reinterpret_cast<const float4*>(vt + rr * C::ROW + C::unit(rr, 8 * c + g) * 16);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t bj[3][2], b0f[2];
          split_b(sp::elem4(vr[0], e), sp::elem4(vr[1], e), sp::elem4(vr[2], e), sp::elem4(vr[3], e), bj, b0f);
          mma6<HH>(pv, pa, bj, b0f);
#pragma unroll
          for (int x = 0; x < R2; ++x) acc[4 * c + e][x] += pv[x];
        }
      }
    }
  }
  hop::cp_async_wait<0>();

  // merge the warps' states in shared memory (the rings are free), then
  // write o (one split) or the split's partial
#pragma unroll
  for (int hh = 0; hh < HH; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);            // [WARPS][16][D]
  float* mred = red + C::WARPS * 16 * D;                   // [WARPS][16]
  float* lred = mred + C::WARPS * 16;
#pragma unroll
  for (int hh = 0; hh < HH; ++hh) {
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
    if (c >= a.d) continue;   // columns below d
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
      static_cast<float*>(a.out)[q_off(a, b, hk, r) + c] = A * (L == 0.f ? 1.f : 1.f / L);
    } else {
      float* pr = partial(a, b, hk, s, r);
      pr[c] = A;
      if (c == 0) { pr[a.d] = M; pr[a.d + 1] = L; }
    }
  }
}

// -- f32 q, rows > 16: the split-precision extend tile (wgmma) -----------------------

template <typename P, int D>
struct ExtF {
  static constexpr bool kQuant = !std::is_same<P, float>::value;
  static constexpr int BM = 128, BN = 64, THREADS = 256, NP = sp::NP;
  static constexpr int KP = kQuant ? 1 : NP;        // bf16 planes of a K or V tile
  static constexpr int SW = D >= 64 ? 128 : 64;     // bytes of a swizzled bf16 row
  static constexpr int CPR = SW / 2;                // bf16 columns a region row holds
  static constexpr int Q_PLANE = BM * D * 2, KV_PLANE = BN * D * 2;
  static constexpr int ROW = D * int(sizeof(P));    // a staged key row
  static constexpr int STAGE = BN * ROW;
  // q's three planes, K's and V's planes, one staged K or V tile, the
  // tile's K and V scales: 225.5 KB for an f32 pool at d 128
  static constexpr size_t SMEM = 1024 + NP * size_t(Q_PLANE) + 2 * KP * size_t(KV_PLANE) +
                                 STAGE + 2 * BN * sizeof(float);
};

// A staged tile (BN rows of D payload values) to the bf16 planes that
// wgmma reads (hop::load_tile's swizzled K-major regions, the planes
// KV_PLANE bytes apart): an 8-bit payload widened (exact), an f32 one
// split into three pieces.  Eight values a work item.  Whether this
// thread's values hold a +-inf (f32).
template <typename P, int D>
__device__ __forceinline__ bool stage_planes(uint8_t* dst, const uint8_t* stage) {
  using C = ExtF<P, D>;
  bool inf = false;
  for (int i = threadIdx.x; i < C::BN * D / 8; i += C::THREADS) {
    const int r = i / (D / 8), c8 = i % (D / 8) * 8;
    const uint32_t off =
        (c8 / C::CPR) * (C::BN * C::SW) + hop::swz<C::SW>(r * C::SW + (c8 % C::CPR) * 2);
    if constexpr (C::kQuant) {
      const uint2 raw = *reinterpret_cast<const uint2*>(stage + r * C::ROW + c8);
      *reinterpret_cast<uint4*>(dst + off) =
          make_uint4(widen2<0>(raw.x, P()), widen2<1>(raw.x, P()), widen2<0>(raw.y, P()),
                     widen2<1>(raw.y, P()));
    } else {
      const float4 x0 = *reinterpret_cast<const float4*>(stage + r * C::ROW + c8 * 4);
      const float4 x1 = *reinterpret_cast<const float4*>(stage + r * C::ROW + c8 * 4 + 16);
      inf |= isinf(x0.x) || isinf(x0.y) || isinf(x0.z) || isinf(x0.w) || isinf(x1.x) ||
             isinf(x1.y) || isinf(x1.z) || isinf(x1.w);
      uint4 p0, p1, p2;
      sp::split_pair(x0.x, x0.y, p0.x, p1.x, p2.x);
      sp::split_pair(x0.z, x0.w, p0.y, p1.y, p2.y);
      sp::split_pair(x1.x, x1.y, p0.z, p1.z, p2.z);
      sp::split_pair(x1.z, x1.w, p0.w, p1.w, p2.w);
      *reinterpret_cast<uint4*>(dst + off) = p0;
      *reinterpret_cast<uint4*>(dst + C::KV_PLANE + off) = p1;
      *reinterpret_cast<uint4*>(dst + 2 * C::KV_PLANE + off) = p2;
    }
  }
  return inf;
}

// One tensor's rows [kt, kt + BN) of the paged pool, as stored, into the
// stage (keys outside [klo, khi) zero; one page-table read a tile when a
// page holds whole tiles, one a row otherwise), and with it (scales: the
// K tile) both tensors' scales of those keys.
template <typename P, int D>
__device__ __forceinline__ void load_stage(const Args& a, uint8_t* stage, float* scl,
                                           const uint8_t* pool, const float* kspool,
                                           const float* vspool, const int* tab, int kt, int klo,
                                           int khi, bool scales) {
  using C = ExtF<P, D>;
  constexpr int CH = C::ROW / 16;
  const bool whole = a.page_size % C::BN == 0;
  const size_t tile_slot = whole ? slot_of(a, tab, kt) : 0;
  // kFull (d == D): the stored row's bytes known at compile time
  auto copy_rows = [&](auto full) {
    constexpr bool kFull = decltype(full)::value;
    const int rb = kFull ? C::ROW : a.d * int(sizeof(P));   // bytes of a stored row
    for (int i = threadIdx.x; i < C::BN * CH; i += C::THREADS) {
      const int r = i / CH, c = i % CH, pos = kt + r;
      const bool ok = pos >= klo && pos < khi;
      const size_t off = ok ? (whole ? tile_slot + r : slot_of(a, tab, pos)) * rb : 0;
      hop::cp_chunk<kFull>(hop::smem_u32(stage + r * C::ROW + c * 16), pool + off, pool, c, rb,
                           ok);
    }
  };
  if (a.d == D)
    copy_rows(std::true_type());
  else
    copy_rows(std::false_type());
  if constexpr (C::kQuant) {
    const int i = threadIdx.x, pos = kt + i % C::BN;
    if (scales && i < 2 * C::BN) {
      const bool ok = pos >= klo && pos < khi;
      const size_t sl = ok ? slot_of(a, tab, pos) : 0;
      hop::cp_async<4>(hop::smem_u32(scl + i), (i < C::BN ? kspool : vspool) + sl, ok);
    }
  }
}

// sc (64 rows x 64 keys) += the pairs [P0, P1) of split.cuh's kSafe (or
// plain) order of q's planes (Q_PLANE bytes apart, regions BM * SW) times
// K's (KV_PLANE apart, regions BN * SW), both K-major (sp::ss_pairs), with
// q's b0 read at q0f in its products with K's b1 and b2 (q0f: q's b0
// plane with its +-inf zeroed, or q itself).
template <int D, bool kSafe, int P0, int P1>
__device__ __forceinline__ void s_pairs(float (&sc)[32], uint32_t q, uint32_t q0f, uint32_t k) {
  using C = ExtF<float, D>;
  constexpr int SW = C::SW, CPR = C::CPR;
#pragma unroll
  for (int pr = P0; pr < P1; ++pr) {
    const int i = sp::pair_a<kSafe>(pr), j = sp::pair_b<kSafe>(pr);
    const uint32_t aa = i == 0 && j > 0 ? q0f : q + i * C::Q_PLANE, bb = k + j * C::KV_PLANE;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t region = ks * 16 / CPR, off = (ks * 16 % CPR) * 2;
      hop::wgmma_ss<0>(sc, hop::desc<SW>(aa + region * C::BM * SW + off, 16, 8 * SW),
                       hop::desc<SW>(bb + region * C::BN * SW + off, 16, 8 * SW), 1);
    }
  }
}

// The bf16 extend tile's walk (128 query rows of one (sequence, kv head)
// and split, two consumer warpgroups of 64, the last row tiles first, the
// block's pages of its rows' hull, masks only on tiles that cut a row's
// interval, JAX's -1e30 for a visited key a row does not see) with
// flash_fwd.cu's f32 split-precision products (flash_fwd_f32_kernel): q's
// three bf16 planes made once a block in the prologue, S = Q K^T as
// wgmmas of the piece pairs summed from zero a tile (sp::ss_pairs: six
// over an f32 pool; q's b2, b1, b0 against a quantized pool's exact K),
// P (p times V's scale) split in registers into the A operand of P V's
// pairs (sp::rs_pairs), summed from zero a tile and added to acc in f32.
// K and V tiles of 64 keys: the payload arrives as stored in one stage
// (cp.async), and all threads widen or split it into bf16 planes in shared
// memory; K(kt)'s planes are made while V(kt) loads behind the S products,
// V(kt)'s while K(kt + 64) loads behind P V.  An f32 pool's planes at 128
// keys and d 128 pass the 227 KB of a block (q's planes take 96 KB), and a
// per-call plane workspace of the walk's pages would cost 6 more bytes an
// element of HBM writes and reads: the split in shared memory reads each
// f32 once, at 64-key tiles.  A tile holding a +-inf (f32: the threads' OR
// at the barrier) takes the products that read its b0 raw first, then
// sp::sanitize, then the rest (split.cuh's kSafe order); a +-inf in q (an
// f32 pool) has its b0 plane copied with it zeroed, for each tile, into the
// V planes' room (free while S runs), for the products with K's b1, b2.
// What bounds it: the products, three (six) times the bf16 tile's.
template <typename P, int D>
__global__ void __launch_bounds__(ExtF<P, D>::THREADS, 1)
paged_extend_f32_kernel(Args a, int row_tiles) {
  using C = ExtF<P, D>;
  constexpr int BN = C::BN, SW = C::SW, CPR = C::CPR, NP = C::NP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* kpl = qs + NP * C::Q_PLANE;              // K's planes
  uint8_t* vpl = kpl + C::KP * C::KV_PLANE;          // V's planes
  uint8_t* stage = vpl + C::KP * C::KV_PLANE;        // a K or V tile as stored
  float* scl = reinterpret_cast<float*>(stage + C::STAGE);   // [ks | vs]

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

  const float* qp = static_cast<const float*>(a.q);
  const size_t pool = size_t(hk) * a.n_pages * a.page_size;
  const uint8_t* kpool = static_cast<const uint8_t*>(a.kp) + pool * a.d * sizeof(P);
  const uint8_t* vpool = static_cast<const uint8_t*>(a.vp) + pool * a.d * sizeof(P);
  const float* kspool = C::kQuant ? a.ks + pool : nullptr;
  const float* vspool = C::kQuant ? a.vs + pool : nullptr;
  const int* tab = a.table + size_t(b) * a.pages_per_seq;
  auto load = [&](const uint8_t* src, int kt, bool scales) {
    load_stage<P, D>(a, stage, scl, src, kspool, vspool, tab, kt, klo, khi, scales);
  };
  if (start < end) load(kpool, start, true);
  hop::cp_async_commit();

  // prologue: q * scale_log2 (f32) split into three swizzled K-major
  // planes, 8 columns a work item
  bool q_inf = false;
  for (int i = threadIdx.x; i < C::BM * D / 8; i += C::THREADS) {
    const int r = i / (D / 8), c = i % (D / 8) * 8;
    float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
    if (r < n_rows && c < a.d) {
      const float* src = qp + q_off(a, b, hk, row0 + r) + c;
      x0 = sp::scale4_rn(*reinterpret_cast<const float4*>(src), a.scale_log2);
      x1 = sp::scale4_rn(*reinterpret_cast<const float4*>(src + 4), a.scale_log2);
      q_inf |= isinf(x0.x) || isinf(x0.y) || isinf(x0.z) || isinf(x0.w) || isinf(x1.x) ||
               isinf(x1.y) || isinf(x1.z) || isinf(x1.w);
    }
    uint32_t pc[NP][4];
    sp::split_pair(x0.x, x0.y, pc[0][0], pc[1][0], pc[2][0]);
    sp::split_pair(x0.z, x0.w, pc[0][1], pc[1][1], pc[2][1]);
    sp::split_pair(x1.x, x1.y, pc[0][2], pc[1][2], pc[2][2]);
    sp::split_pair(x1.z, x1.w, pc[0][3], pc[1][3], pc[2][3]);
    const uint32_t off = (c / CPR) * (C::BM * SW) + hop::swz<SW>(r * SW + (c % CPR) * 2);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      *reinterpret_cast<uint4*>(qs + p * C::Q_PLANE + off) =
          make_uint4(pc[p][0], pc[p][1], pc[p][2], pc[p][3]);
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

  // an f32 pool: q holds a +-inf (the block's threads' OR)
  const bool q_nf = !C::kQuant && __syncthreads_or(q_inf);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // l: this thread's columns
  const uint32_t q_addr = hop::smem_u32(qs) + wg * 64 * SW;
  const uint32_t k_addr = hop::smem_u32(kpl), v_addr = hop::smem_u32(vpl);
  // q's b0 for the products with K's b1, b2: with its +-inf zeroed in the V
  // planes' room (a copy of the plane, so the swizzle holds)
  const uint32_t q0f_addr = q_nf ? v_addr + wg * 64 * SW : q_addr;
  static_assert(C::Q_PLANE <= C::KP * C::KV_PLANE || C::kQuant, "q's b0 fits V's planes");
  const float* ks_s = scl;
  const float* vs_s = scl + BN;

  for (int kt = start; kt < end; kt += BN) {
    hop::cp_async_wait<0>();
    __syncthreads();   // K(kt) and the tile's scales have landed
    bool nf = stage_planes<P, D>(kpl, stage);
    hop::fence_async_smem();
    if constexpr (C::kQuant) __syncthreads();
    else nf = __syncthreads_or(nf);   // K's planes are complete; the stage is free
    load(vpool, kt, false);
    hop::cp_async_commit();
    if (q_nf) {   // rare: every tile, as V's planes overwrite it
      for (int i = threadIdx.x; i < C::Q_PLANE / 16; i += C::THREADS) {
        uint4 v = reinterpret_cast<const uint4*>(qs)[i];
        v = make_uint4(sp::finite_part(v.x), sp::finite_part(v.y), sp::finite_part(v.z), sp::finite_part(v.w));
        reinterpret_cast<uint4*>(vpl)[i] = v;
      }
      hop::fence_async_smem();
      __syncthreads();
    }

    // S = Q K^T: 64 rows x 64 keys a warpgroup; sc[4j + 2hh + e] is row
    // rl + 8hh, key kt + 8j + 2 quad + e
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    hop::fence_regs(sc);
    if (wg_live) {
      hop::wg_arrive();
      if constexpr (C::kQuant) {
#pragma unroll
        for (int pc = NP - 1; pc >= 0; --pc)
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks) {
            const uint32_t region = ks * 16 / CPR, off = (ks * 16 % CPR) * 2;
            hop::wgmma_ss<0>(sc, hop::desc<SW>(q_addr + pc * C::Q_PLANE + region * C::BM * SW + off,
                                              16, 8 * SW),
                             hop::desc<SW>(k_addr + region * BN * SW + off, 16, 8 * SW), 1);
          }
      } else if (nf) {
        s_pairs<D, true, 0, 4>(sc, q_addr, q0f_addr, k_addr);
      } else if (q_nf) {
        s_pairs<D, false, 0, 6>(sc, q_addr, q0f_addr, k_addr);
      } else {
        sp::ss_pairs<D, SW, false, 0, 6>(sc, q_addr, C::Q_PLANE, C::BM * SW, k_addr, C::KV_PLANE,
                                         BN * SW);
      }
      hop::wg_commit();
      hop::wg_wait<0>();
    }
    if (nf) {   // K holds a +-inf: b0 sanitized for the products with q's b1, b2
      __syncthreads();
      sp::sanitize<C::THREADS>(kpl, C::KV_PLANE);
      hop::fence_async_smem();
      __syncthreads();
      if (wg_live) {
        hop::wg_arrive();
        s_pairs<D, true, 4, 6>(sc, q_addr, q0f_addr, k_addr);
        hop::wg_commit();
        hop::wg_wait<0>();
      }
    }
    hop::fence_regs(sc);

    // scores (x K scale), masks, the online softmax, P (x V scale) in
    // three pieces: pp[i][2j + hh] = row hh's keys 8j + 2 quad + {0, 1}
    uint32_t pp[NP][16];
    if (wg_live) {
      const bool full = kt >= all_lo && kt + BN <= all_hi;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = 8 * j + 2 * quad + e, pos = kt + key;
            float x = sc[4 * j + 2 * hh + e];
            if constexpr (C::kQuant) x = __fmul_rn(x, ks_s[key]);
            if (!full && (pos < lo[hh] || pos >= hi[hh])) x = masked(w, pos);
            sc[4 * j + 2 * hh + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx);
        const float mu = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[hh] - mu);
        m[hh] = m_new;
        l[hh] *= alpha;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          acc[4 * jj + 2 * hh] *= alpha;
          acc[4 * jj + 2 * hh + 1] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          float p0 = exp2f(sc[4 * j + 2 * hh] - mu), p1 = exp2f(sc[4 * j + 2 * hh + 1] - mu);
          l[hh] += p0 + p1;
          if constexpr (C::kQuant) {
            p0 = __fmul_rn(p0, vs_s[8 * j + 2 * quad]);
            p1 = __fmul_rn(p1, vs_s[8 * j + 2 * quad + 1]);
          }
          sp::split_pair(p0, p1, pp[0][2 * j + hh], pp[1][2 * j + hh], pp[2][2 * j + hh]);
        }
      }
    }

    hop::cp_async_wait<0>();
    __syncthreads();   // V(kt) has landed; the scales are read
    nf = stage_planes<P, D>(vpl, stage);
    hop::fence_async_smem();
    if constexpr (C::kQuant) __syncthreads();
    else nf = __syncthreads_or(nf);   // V's planes are complete; the stage is free
    if (kt + BN < end) load(kpool, kt + BN, true);
    hop::cp_async_commit();

    // P V sums from zero, then into acc
    float pv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) pv[i] = 0.f;
    hop::fence_regs(pv);
    if (wg_live) {
      hop::wg_arrive();
      if constexpr (C::kQuant) {
#pragma unroll
        for (int pc = NP - 1; pc >= 0; --pc)
#pragma unroll
          for (int kc = 0; kc < 4; ++kc) {
            const uint32_t ak[4] = {pp[pc][4 * kc], pp[pc][4 * kc + 1], pp[pc][4 * kc + 2],
                                    pp[pc][4 * kc + 3]};
            hop::wgmma_rs<1>(pv, ak, hop::desc<SW>(v_addr + kc * 16 * SW, BN * SW, 8 * SW), 1);
          }
      } else if (nf) {
        sp::rs_pairs<D, SW, true, 0, 4>(pv, pp, v_addr, C::KV_PLANE);
      } else {
        sp::rs_pairs<D, SW, false, 0, 6>(pv, pp, v_addr, C::KV_PLANE);
      }
      hop::wg_commit();
      hop::wg_wait<0>();
    }
    if (nf) {   // V holds a +-inf: b0 sanitized for the products with P's b1, b2
      __syncthreads();
      sp::sanitize<C::THREADS>(vpl, C::KV_PLANE);
      hop::fence_async_smem();
      __syncthreads();
      if (wg_live) {
        hop::wg_arrive();
        sp::rs_pairs<D, SW, true, 4, 6>(pv, pp, v_addr, C::KV_PLANE);
        hop::wg_commit();
        hop::wg_wait<0>();
      }
    }
    hop::fence_regs(pv);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] += pv[i];
  }
  hop::cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rl + 8 * hh;
    if (r >= n_rows) continue;
    if (a.n_splits > 1) {   // the split's partial, straight from the fragment
      float* pr = partial(a, b, hk, s, row0 + r);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        if (8 * j < a.d)
          *reinterpret_cast<float2*>(pr + 8 * j + 2 * quad) =
              make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      if (quad == 0) { pr[a.d] = m[hh]; pr[a.d + 1] = l[hh]; }
    } else {
      const float inv = l[hh] == 0.f ? 1.f : 1.f / l[hh];
      float* o = static_cast<float*>(a.out) + q_off(a, b, hk, row0 + r);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        if (8 * j < a.d)
          *reinterpret_cast<float2*>(o + 8 * j + 2 * quad) =
              make_float2(acc[4 * j + 2 * hh] * inv, acc[4 * j + 2 * hh + 1] * inv);
    }
  }
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
//     columns whose V holds a non-finite value (bit c % 32 of word c / 32,
//     cdiv(d, 32) words) and a non-finite V scale (bit 0 of the word after
//     them), 16-byte loads (8 bytes for an 8-bit row of 8 mod 16 bytes).
//     Bound by the bytes of V over the walk (an int8 pool: its scales
//     alone; an int8 payload is always finite).
//   paged_poison_kernel, after the split kernel and the merge: one block a
//     (kv head, sequence, row tile) ORs the marks of the walk's pages
//     outside the tile's hull and writes NaN into those columns of the
//     tile's rows (nothing when no mark is set: it reads the marks only).

// Words of a page's marks: cdiv(d, 32) of columns, then the V scale's.
__host__ __device__ constexpr int nf_words(int d) { return (d + 31) / 32 + 1; }
constexpr int NF_MAX_WORDS = nf_words(256);

// Bit e: element e of the NW words w of payload P is not finite (never for
// int8).
template <typename P, int NW>
__device__ __forceinline__ uint32_t nonfinite_bits(const uint32_t (&w)[NW]) {
  uint32_t bits = 0;
  if constexpr (std::is_same<P, float>::value) {
#pragma unroll
    for (int e = 0; e < NW; ++e) bits |= uint32_t((w[e] & 0x7F800000u) == 0x7F800000u) << e;
  } else if constexpr (std::is_same<P, bf16>::value) {
#pragma unroll
    for (int e = 0; e < 2 * NW; ++e)
      bits |= uint32_t(((w[e / 2] >> (16 * (e % 2))) & 0x7F80u) == 0x7F80u) << e;
  } else if constexpr (std::is_same<P, __nv_fp8_e4m3>::value) {
#pragma unroll
    for (int e = 0; e < 4 * NW; ++e)
      bits |= uint32_t(((w[e / 4] >> (8 * (e % 4))) & 0x7Fu) == 0x7Fu) << e;
  }
  return bits;
}

// The marks of one unit of U bytes (16, or 8 where a row is 8 mod 16
// bytes) of V rows [r0, page) in steps of `step` rows, ORed into words.
template <typename P, int U>
__device__ __forceinline__ void mark_unit(uint32_t* words, const uint8_t* vp, int row_bytes,
                                          int r0, int step, int page, int c) {
  constexpr int NW = U / 4, EPU = U / int(sizeof(P));   // words and elements a unit
  uint32_t bits = 0;
#pragma unroll 4
  for (int r = r0; r < page; r += step) {
    uint32_t w[NW];
    if constexpr (U == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(vp + size_t(r) * row_bytes + c * U);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(vp + size_t(r) * row_bytes + c * U);
      w[0] = v.x, w[1] = v.y;
    }
    bits |= nonfinite_bits<P, NW>(w);
  }
  if (bits) atomicOr(&words[c * EPU / 32], bits << (c * EPU % 32));
}

// The columns of a row are a.d values of P, at most 256 (f32: 128): up to
// 32 units of 16 (or 8) bytes, so the 128 threads keep to one unit each, a
// quarter (or more) of the page's rows apiece.
template <typename P>
__global__ void __launch_bounds__(128) paged_nonfinite_kernel(Args a, uint32_t* nf) {
  const int W = nf_words(a.d), row_bytes = a.d * int(sizeof(P));
  __shared__ uint32_t words[NF_MAX_WORDS];
  const int i = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  if (threadIdx.x < W) words[threadIdx.x] = 0;
  __syncthreads();
  const Walk w = make_walk(a, b, 0);
  const int page = a.page_size;
  if (i * page >= w.seq_lo && i * page < w.seq_hi) {
    const int pid = min(max(a.table[size_t(b) * a.pages_per_seq + i], 0), a.n_pages - 1);
    const size_t first = (size_t(hk) * a.n_pages + pid) * page;   // the page's first slot
    if constexpr (!std::is_same<P, int8_t>::value) {
      const uint8_t* vp = static_cast<const uint8_t*>(a.vp) + first * row_bytes;
      if (row_bytes % 16 == 0) {
        const int units = row_bytes / 16, lanes = 128 / units * units;
        if (threadIdx.x < lanes)
          mark_unit<P, 16>(words, vp, row_bytes, threadIdx.x / units, lanes / units, page,
                           threadIdx.x % units);
      } else {
        const int units = row_bytes / 8, lanes = 128 / units * units;
        if (threadIdx.x < lanes)
          mark_unit<P, 8>(words, vp, row_bytes, threadIdx.x / units, lanes / units, page,
                          threadIdx.x % units);
      }
    }
    if (a.vs != nullptr)
      for (int r = threadIdx.x; r < page; r += 128)
        if (!isfinite(a.vs[first + r])) atomicOr(&words[W - 1], 1u);
  }
  __syncthreads();
  if (threadIdx.x < W)
    nf[((size_t(b) * a.h_kv + hk) * a.pages_per_seq + i) * W + threadIdx.x] = words[threadIdx.x];
}

template <typename T>
__global__ void __launch_bounds__(128) paged_poison_kernel(Args a, const uint32_t* nf,
                                                            int bm) {
  const int W = nf_words(a.d), d = a.d;
  __shared__ uint32_t words[NF_MAX_WORDS];
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
  uint32_t acc[NF_MAX_WORDS];
#pragma unroll
  for (int k = 0; k < NF_MAX_WORDS; ++k) acc[k] = 0;
  const uint32_t* marks = nf + (size_t(b) * a.h_kv + hk) * a.pages_per_seq * W;
  for (int i = p0 + threadIdx.x; i < n; i += 128)
    if (i < c0 || i >= c1)
#pragma unroll
      for (int k = 0; k < NF_MAX_WORDS; ++k)
        if (k < W) acc[k] |= marks[size_t(i) * W + k];
#pragma unroll
  for (int k = 0; k < NF_MAX_WORDS; ++k) {
    acc[k] = __reduce_or_sync(0xffffffffu, acc[k]);
    if (threadIdx.x % 32 == 0 && acc[k]) atomicOr(&words[k], acc[k]);
  }
  __syncthreads();
  uint32_t any = 0;
  for (int k = 0; k < W; ++k) any |= words[k];
  if (!any) return;
  const bool all = words[W - 1] & 1u;
  T* o = static_cast<T*>(a.out);
  for (int e = threadIdx.x; e < (r1 - r0) * d; e += 128) {
    const int r = r0 + e / d, c = e % d;
    if (all || (words[c / 32] >> (c % 32) & 1u))
      fa::store1(o + q_off(a, b, hk, r) + c, __int_as_float(0x7fc00000));
  }
}

// -- the merge of the splits' partials ----------------------------------------------

// One block of four warps per output row: M = max_s m_s, then o = sum_s
// 2^(m_s - M) acc_s over sum_s 2^(m_s - M) l_s (o = 0 where l is 0).  Warp
// v sums the splits s = v mod 4 in order, eight loads in flight, the
// weights passed by shuffles; the four sums add in a fixed order.  Lane
// columns lane + 32 e, those below d (D the tile width).
template <typename T, int D>
__global__ void __launch_bounds__(128) paged_merge_kernel(Args a) {
  __shared__ float red[4][D + 1];
  __shared__ float mx[4];
  const int row = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32, d = a.d;
  const int r = row % a.rows, bh = row / a.rows;
  const float* p0 = a.ws + (size_t(bh) * a.n_splits * a.rows + r) * (d + 2);
  const size_t step = size_t(a.rows) * (d + 2);
  float M = -INFINITY;
  for (int s = threadIdx.x; s < a.n_splits; s += 128) M = fmaxf(M, p0[s * step + d]);
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
      wt = exp2f(pr[d] - Mu);
      L += wt * pr[d + 1];
    }
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float wj = __shfl_sync(0xffffffffu, wt, j);
      const float* pr = p0 + (s0 + 4 * j) * step;
#pragma unroll
      for (int e = 0; e < D / 32; ++e)
        if (lane + 32 * e < d) acc[e] += wj * pr[lane + 32 * e];
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
  T* o = static_cast<T*>(a.out) + q_off(a, bh / a.h_kv, bh % a.h_kv, r);
#pragma unroll
  for (int e = 0; e < D / 32; ++e) {
    const int c = lane + 32 * e;
    if (c < d) fa::store1(o + c, (((red[0][c] + red[1][c]) + red[2][c]) + red[3][c]) * inv);
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

template <typename P, int D, int HH>
cudaError_t launch_decode_f32(const Args& a, cudaStream_t st) {
  using C = DecF<P, D>;
  auto kernel = paged_decode_f32_kernel<P, D, HH>;
  static cudaError_t opted = fa::allow_smem(kernel, C::SMEM);
  if (opted != cudaSuccess) return opted;
  kernel<<<dim3(a.n_splits, a.h_kv, a.b), C::THREADS, C::SMEM, st>>>(a);
  return cudaGetLastError();
}

// f32 q: the decode tile at rows <= 16 (its 8-row variant at rows <= 8),
// else the extend tile; P float for an f32 pool
template <typename P, int D>
cudaError_t launch_f32(const Args& a, cudaStream_t st) {
  if (a.rows <= 8) return launch_decode_f32<P, D, 1>(a, st);
  if (a.rows <= 16) return launch_decode_f32<P, D, 2>(a, st);
  using C = ExtF<P, D>;
  auto kernel = paged_extend_f32_kernel<P, D>;
  static cudaError_t opted = fa::allow_smem(kernel, C::SMEM);
  if (opted != cudaSuccess) return opted;
  const int tiles = (a.rows + C::BM - 1) / C::BM;
  kernel<<<dim3(a.h_kv, a.b, tiles * a.n_splits), C::THREADS, C::SMEM, st>>>(a, tiles);
  return cudaGetLastError();
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

// The row tile launch() gives a block: the decode tiles' 16 rows or the
// extend tiles' 128, either dtype, as ops/paged_attention.py::row_tile
// says.
inline int row_tile(int rows) {
  static_assert(Ext<bf16, 32>::BM == 128 && ExtF<float, 32>::BM == 128, "one extend tile");
  return rows <= 16 ? 16 : 128;
}

template <typename P>
cudaError_t nonfinite(const Args& a, uint32_t* nf, cudaStream_t st) {
  if (hop::tile_width(a.d, std::is_same<P, float>::value ? 128 : 256) == 0)
    return cudaErrorInvalidValue;
  paged_nonfinite_kernel<P><<<dim3(a.pages_per_seq, a.h_kv, a.b), 128, 0, st>>>(a, nf);
  return cudaGetLastError();
}

template <typename T>
cudaError_t poison(const Args& a, const uint32_t* nf, int bm, cudaStream_t st) {
  paged_poison_kernel<T><<<dim3(a.h_kv, a.b, (a.rows + bm - 1) / bm), 128, 0, st>>>(a, nf, bm);
  return cudaGetLastError();
}

// the kernels at the tile width of d (hop::tile_width), reading d itself;
// bf16 q up to 256 columns, f32 q up to 128
template <typename T, typename P>
cudaError_t dispatch_d(int d, const Args& a, cudaStream_t st) {
  constexpr bool kWide = std::is_same<T, bf16>::value;
  switch (hop::tile_width(d, kWide ? 256 : 128)) {
    case 32: return launch<T, P, 32>(a, st);
    case 64: return launch<T, P, 64>(a, st);
    case 128: return launch<T, P, 128>(a, st);
    case 256:
      if constexpr (kWide) return launch<T, P, 256>(a, st);
      return cudaErrorInvalidValue;
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
#define PAGED_ATTR(D)                                                                          \
  if (hop::tile_width(d) == D) {                                                               \
    if (kind == 0) return attr_of(paged_decode_kernel<P, D>, what, Dec<P, D>::SMEM);           \
    if (kind == 1) return attr_of(paged_extend_kernel<P, D>, what, Ext<P, D>::SMEM);           \
    if (kind == 2) return attr_of(paged_decode_f32_kernel<Q, D, 1>, what, DecF<Q, D>::SMEM);   \
    if (kind == 3) return attr_of(paged_merge_kernel<bf16, D>, what, 0);                       \
    if (kind == 4) return attr_of(paged_extend_f32_kernel<Q, D>, what, ExtF<Q, D>::SMEM);      \
    if (kind == 5) return attr_of(paged_decode_f32_kernel<Q, D, 2>, what, DecF<Q, D>::SMEM);   \
  }
  PAGED_ATTR(32)
  PAGED_ATTR(64)
  PAGED_ATTR(128)
#undef PAGED_ATTR
  return -int(cudaErrorInvalidValue);
}

// fa_paged_attention / fa_paged_attention_f32: the split kernel, then
// (n_splits > 1) the merge, then (nf given) the poison pass.
int paged_call(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
               const void* v_scales, const void* lengths, const void* page_indices, void* out,
               void* ws, const void* nf, int b, int h_kv, int rows, int chunk, int n_pages,
               int page_size, int pages_per_seq, int d, int window, int split_pages,
               int n_splits, float scale_log2, int dtype, int page_dtype, void* stream) {
  if (b == 0 || h_kv == 0 || rows == 0) return 0;
  if (split_pages < 1 || n_splits < 1 || (n_splits > 1 && ws == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{q, k_pages, v_pages, static_cast<const float*>(k_scales),
         static_cast<const float*>(v_scales), static_cast<const int*>(lengths),
         static_cast<const int*>(page_indices), out, static_cast<float*>(ws), b, h_kv, rows,
         chunk, n_pages, page_size, pages_per_seq, window, split_pages, n_splits, scale_log2, d};
  const cudaError_t err = dtype == 0 ? dispatch_pages<float>(page_dtype, dtype, d, a, st)
                                     : dispatch_pages<bf16>(page_dtype, dtype, d, a, st);
  const int bm = row_tile(rows);
  if (err != cudaSuccess || nf == nullptr || rows <= bm) return int(err);
  const uint32_t* marks = static_cast<const uint32_t*>(nf);
  return int(dtype == 0 ? poison<float>(a, marks, bm, st) : poison<bf16>(a, marks, bm, st));
}

}  // namespace

// bf16 q: q (b, h_kv, rows, d) with rows = group * chunk in (group, chunk)
// order; k_pages, v_pages (h_kv, n_pages, page_size, d); k_scales,
// v_scales (h_kv, n_pages, page_size) f32 for a quantized pool, else null;
// lengths (b,) int32 counting the chunk; page_indices (b, pages_per_seq)
// int32; out like q.  ws: f32 (b, h_kv, n_splits, rows, d + 2) when
// n_splits > 1, else unused; nf: fa_paged_nonfinite's marks of these pools
// for a wave wider than one row tile (the poison pass then runs last), else
// null; split k of a sequence takes its walk's pages [p0 + k *
// split_pages, p0 + (k + 1) * split_pages).  window <= 0 means none;
// scale_log2 = sm_scale * log2(e), rounded to q's dtype.  dtype codes: 0 =
// float32, 1 = bfloat16 (q and out), 2 = int8, 3 = float8 e4m3 (page
// payloads); dtype must be 1 here (f32 q: fa_paged_attention_f32).
extern "C" int fa_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                  const void* k_scales, const void* v_scales,
                                  const void* lengths, const void* page_indices, void* out,
                                  void* ws, const void* nf, int b, int h_kv, int rows, int chunk, int n_pages,
                                  int page_size, int pages_per_seq, int d, int window,
                                  int split_pages, int n_splits, float scale_log2, int dtype,
                                  int page_dtype, void* stream) {
  if (dtype != 1) return int(cudaErrorInvalidValue);
  return paged_call(q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices, out, ws, nf,
                    b, h_kv, rows, chunk, n_pages, page_size, pages_per_seq, d, window,
                    split_pages, n_splits, scale_log2, dtype, page_dtype, stream);
}

// f32 q, arguments as fa_paged_attention's with dtype 0: the split-precision
// tiles (paged_decode_f32_kernel at rows <= 16, paged_extend_f32_kernel
// above) over an f32 (page_dtype 0), int8 or fp8 pool.
extern "C" int fa_paged_attention_f32(const void* q, const void* k_pages, const void* v_pages,
                                      const void* k_scales, const void* v_scales,
                                      const void* lengths, const void* page_indices, void* out,
                                      void* ws, const void* nf, int b, int h_kv, int rows,
                                      int chunk, int n_pages, int page_size, int pages_per_seq,
                                      int d, int window, int split_pages, int n_splits,
                                      float scale_log2, int dtype, int page_dtype, void* stream) {
  if (dtype != 0) return int(cudaErrorInvalidValue);
  return paged_call(q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices, out, ws, nf,
                    b, h_kv, rows, chunk, n_pages, page_size, pages_per_seq, d, window,
                    split_pages, n_splits, scale_log2, dtype, page_dtype, stream);
}

// The marks of C15's poison pass: nf (b, h_kv, pages_per_seq, cdiv(d, 32) +
// 1) uint32, for page slot i of sequence b's walk (zero outside it) bit
// c % 32 of word c / 32 set where column c of the page's V (h_kv, n_pages,
// page_size, d) holds a non-finite value, and bit 0 of word cdiv(d, 32)
// where a V scale (h_kv, n_pages, page_size) is not finite (v_scales null: a pool
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
         pages_per_seq, 1, 0.f, d};
  uint32_t* marks = static_cast<uint32_t*>(nf);
  switch (page_dtype) {
    case 0: return int(nonfinite<float>(a, marks, st));
    case 1: return int(nonfinite<bf16>(a, marks, st));
    case 2: return int(nonfinite<int8_t>(a, marks, st));
    case 3: return int(nonfinite<__nv_fp8_e4m3>(a, marks, st));
    default: return int(cudaErrorInvalidValue);
  }
}

// A paged kernel's attribute, launching nothing: kind 0 the bf16 decode
// tile, 1 the bf16 extend tile, 2 the f32 decode tile (8 rows), 3 the
// merge, 4 the f32 extend tile, 5 the f32 decode tile (16 rows); kinds 0,
// 1 and 3 over a pool of page_dtype 1 (bf16), 2 (int8) or 3 (fp8), kinds 2,
// 4 and 5 over 0 or 1 (an f32 pool), 2 or 3; what 0 registers a thread, 1
// dynamic shared memory bytes, 2 local (spill) bytes a thread.  Negative:
// minus a CUDA error.
extern "C" int fa_paged_kernel_attr(int kind, int d, int page_dtype, int what) {
  if (page_dtype == 0 && (kind == 2 || kind >= 4)) return attr_d<bf16>(kind, d, what);
  if (page_dtype == 1) return attr_d<bf16>(kind, d, what);
  if (page_dtype == 2) return attr_d<int8_t>(kind, d, what);
  if (page_dtype == 3) return attr_d<__nv_fp8_e4m3>(kind, d, what);
  return -int(cudaErrorInvalidValue);
}
