// Flash-attention forward: o = softmax(q k^T * sm_scale) v without the
// score matrix in HBM, plus lse (natural log) per query row.
//
// Replaces the TPU kernels in flashattn_tpu/ops/flash_attention.py:
//   _fwd_subrow_varlen_kernel (wrapper _flash_fwd_subrow_varlen), the
//     causal varlen forward of batched prefill;
//   _fwd_kernel (wrapper _flash_fwd), the grid FA-2 forward with causal,
//     sliding window, kv_lengths, GQA and cross-attention;
//   _fwd_subrow_kernel and _fwd_loop_kernel, the dense causal schedules
//     (and _fwd_twolevel_kernel, which JAX's dispatcher never picks: its
//     shapes get the subrow or loop function here);
// and XLA's op-graph attention, which JAX runs below 1024 keys.
//
// Masks: row R of q attends key c when c < n_kv, c < kv_lengths[b] (if
// given), c <= R (causal, top-left aligned) and c > R - window (if
// window > 0).  Padding rows past a length still attend the valid prefix.
// A row with no live key gives o = 0 and lse = -inf.  GQA: q head h reads
// kv head h / (h_q / h_kv).
//
// The function is the one JAX computes at the shape, chosen by the caller
// (ops/flash_attention.py::_schedule, a copy of JAX's dispatcher), in bf16:
//   mode 1, the grid and loop schedules (_fwd_kernel, _fwd_loop_kernel): q
//     pre-scaled by sm_scale * log2(e) in bf16 by the caller; f32 scores;
//     a running max over JAX's key blocks of `span` keys (8 to 1024), acc
//     and l rescaled by exp2(m_old - m_new) where a block starts; the
//     unnormalised p = exp2(s - m) rounded to bf16 before the PV product;
//     o = acc * (1 / l); lse = m ln 2 + ln l.
//   mode 2, the subrow schedules (_fwd_subrow_kernel and its varlen twin):
//     the same with the whole row's max, and o = acc / l.
//   mode 0, XLA's op graph (below 1024 keys, shapes JAX cannot tile, and
//     the quantized-KV fallback): s = (q . k) sm_scale in f32, the row's
//     max m and sum l of exp(s - m), p = exp(s - m) / l normalised and then
//     rounded to bf16, o = sum p v; lse = m + ln l.
//
// bf16, modes 1 and 2 and the op graph's longer walks, runs a wgmma
// tensor-core kernel.  What bounds it on the H100 is the products (4 d flops per live
// (row, key) pair at 989 TF/s, more where a max pass repeats Q K^T), the
// softmax's exponentials behind them.  A block owns 128 query rows of one
// (batch, head): two consumer warpgroups of 64 rows.  Q is loaded once into
// shared memory; K (and V) tiles of 128 keys stream through a
// double-buffered ring in bf16 (cp.async, zero fill past n_kv), the next
// step's copy overlapping this step's math, in the swizzled layout of
// hopper.cuh.  The walk over the key tiles is a sequence of (tile, pass)
// steps (Walk): a segment of keys (JAX's key block where it is wider than a
// tile; the whole walk in mode 2 and the op graph) first takes a max
// pass, S = Q K^T and each row's masked max (the op graph's also the sum
// of exp(s - m)), without PV and without loading V; then the PV pass.  S = Q K^T is a wgmma (both K-major) into 64 f32 registers a
// thread; P is rounded to bf16 in registers and is the A operand of the P V
// wgmma (V MN-major, the transpose bit set), which sums each tile from zero
// before it is added to the f32 O accumulator, as the TPU kernels add each
// block's PV.  A key block narrower than the tile (span 8..64) is its own
// online-softmax update inside the tile (the 16-key PV chunk that two 8-key
// blocks share runs once for each).  The block walks only the key tiles
// its rows can see (causal and length bound on the right, window on the
// left; the last row tiles start first, having the longest walks); only
// tiles that cut some row's interval are masked.  The epilogue writes lse
// (f32, (b, h, n_q)) and o (bf16, staged in shared memory and stored in
// whole rows), which flash_bwd.cu reads.
//
// bf16 mode 0, the op graph, which JAX takes below 1024 keys: s = (q . k)
// sm_scale in f32, the row's max m and sum l of exp(s - m), p = exp(s - m)
// / l rounded to bf16, o = sum p v, lse = m + ln l.  A walk of at most 128
// keys (the MT model's 40, the distill draft's 128) runs
// flash_fwd_op_kernel: there the wgmma tile's 128 x 128 block (255
// registers a thread: one block an SM, a fixed ~19 us a block over three
// serial passes) wasted most of its work, so this kernel is sized to the
// rows instead: warps of 16 query rows on mma.sync m16n8k16, blocks of
// cdiv(n_q, 16) warps up to four, one (batch, head) a block, so that a
// launch of 1024 small blocks is resident at once; it loads Q, K and V
// together and computes Q K^T once.  Longer walks (N 512, 517, 1000, the
// quantized-KV fallback's 200 keys) run the wgmma kernel above with kOp:
// two passes where it took three, the max pass summing exp(s - m) online.
// Both divide by l through its reciprocal with one FMA correction
// (fa::div_rn, __fdiv_rn's bits).  The bound is the products; at the MT
// shapes the bytes (q, k, v, o at B128 H8 N40 d32: 3.2 us) and a launch's
// latency.

// Head dims: any multiple of 8 up to 256 in bf16, up to 128 in f32.  Each
// kernel is compiled at the tile widths D = 32, 64 and 128 (the bf16
// kernels also at 256) and runs a call at the least one that holds d
// (hop::tile_width); d is the row stride in device memory, the tiles'
// columns d..D - 1 are zero-filled as they load (hop::cp_chunk) and never
// stored.  The zero columns add exact zeros to every score and their
// output columns are dropped, so the function is JAX's at d (its own
// _pad128 pads d < 128 with zeros for the subrow and loop schedules the
// same way), with no padded copy of q, k or v.  At D 256 (d 136..256:
// JAX's grid from 1024 keys, its op graph below; never the subrow or loop
// schedule, which need d 128) shared memory and registers set the tiles:
// the wgmma tile takes K and V tiles of 64 keys (Q's 64 KB and a ring of
// four 32 KB tiles, 193 KB) and sums a tile's P V from zero 64 columns at
// a time (pv_add); the op graph's warp-level tile makes O in two column
// halves of 128 after one Q K^T (Og::HALF_ND).

// f32 (every schedule's function: in f32 they agree to f32 rounding, so
// one online softmax serves them all) runs on the tensor cores in split
// precision (split.cuh): each f32 operand three bf16 pieces, six bf16
// products a product, 24 bits kept (single-pass TF32, 10 bits, would miss
// the f32 gates).  From F32_TC_MIN_KV keys on (ops/flash_attention.py)
// flash_fwd_f32_kernel: the f32 function of _fwd_loop_kernel (the f32
// training route: 512-key blocks at d 128) and of the grid, subrow and op
// graph schedules.  What bounds it: the six products, 24 d flops a live
// pair at 989 TF/s (the same least time as 3 d x 4 at TF32's 494.7), the
// split pass beside (4 bytes read, 6 written an element of q, k, v); the
// pieces triple the shared memory of a tile (6 bytes an element), so a
// block keeps Q's 128 rows resident and one 64-key K tile and one V tile
// (192 KB at d 128), the next K loading behind this tile's P V and the
// next V behind the next S.  Below F32_TC_MIN_KV keys (the MT model's 40,
// the distill draft's 128) flash_fwd_f32_mma_kernel, sized to the rows as
// the bf16 op graph's flash_fwd_op_kernel is: warps of 16 query rows on
// mma.sync, blocks of cdiv(n_q, 16) warps up to four, one launch, no split
// pass in device memory (Q, K and V read once as f32, each tile split once
// into bf16 planes in shared memory).  There the
// bound is the bytes (q, k, v, o: 6.3 us at the MT decoder's B128 H8 N40
// d32) and a launch's latency; the wgmma tile's 128 rows, split pass and
// two launches would waste most of their work.  A +-inf among the pieces
// meets the other operand's zero pieces (0 * inf = NaN where f32 gives
// +-inf, C17): the warp-level kernel zeroes a non-finite b0 in those
// products (sp::finite_part); the split pass flags one in q, k or v, the
// wgmma kernel's blocks then exit, and the warp-level kernel, launched
// behind it and exiting unless the flag is set, computes the call.

#include "attn_util.cuh"
#include "hopper.cuh"
#include "split.cuh"

namespace {

// -- f32: the warp-level split-precision tile ------------------------------------

template <int D>
struct Mf {
  static constexpr int MAX_WARPS = 4;               // warps (of 16 query rows) a block
  static constexpr int BN = D == 128 ? 32 : 64;     // keys a tile
  static constexpr int ROW = D * 2 + 16;            // bytes of a plane's padded bf16 row
  static constexpr int FROW = D * 4 + 16;           // bytes of a staged f32 row
  static constexpr int NP = sp::NP;
  // Q's planes, K's and V's, and (a walk of more than one tile) a K and a
  // V tile staged as f32
  static constexpr size_t smem(int bm, int tile_rows, bool staged) {
    return size_t(NP) * (bm + 2 * tile_rows) * ROW + (staged ? size_t(2 * tile_rows) * FROW : 0);
  }
};

// Every schedule's f32 function (they agree to f32 rounding) over a walk
// of any length: one online softmax over key tiles of 8 NJ keys (NJ
// n-tiles: the walk's keys rounded up to 16 where they are fewer than BN,
// else BN) in base 2, q scaled by sm_scale * log2(e) in f32 before the
// split, o = acc * (1 / l), lse = m ln 2 + ln l.  A block of W warps (W =
// min(4, cdiv(n_q, 16)), so a short query side gets a short block) owns
// 16 W query rows of one (batch, head), a warp 16 of them on mma.sync
// m16n8k16; with KS = 2 (a grid too small for the card) two warps share
// those rows, each taking half of every tile's keys, and merge their (m,
// l, acc) at the end.  Q and the first K and V tile come in as f32 straight into
// registers (sp::split_rows_ldg), every later tile by cp.async into a
// staging buffer behind the last one's products (each byte read from
// device memory once), and the block splits each once into three bf16
// planes in shared memory (sp::split_rows), whose fragments every warp
// reads by ldmatrix.  S = Q K^T is the six products a k16 step
// (sp::tile_product: the small ones into one accumulator, b0 b0 into
// another, added in f32), P = exp2(s - m) is split in registers into the A
// operand of P V, whose six products a 16-key chunk and n-tile sum from
// zero before the f32 add.  A warp takes every key tile its own rows see,
// whole: a key it does not see scores -inf and its p = 0 still multiplies
// V, so a NaN in V reaches the rows whose walk reads its tile.  A +-inf b0
// meets the other operand's lower pieces as its finite part, so no 0 * inf
// appears that the f32 product would not make.  gate: null, or the split
// pass's flag, when the kernel runs behind flash_fwd_f32_kernel and
// computes the call only where that pass found a +-inf (C17).
template <int D, int NJ, int KS>
__global__ void __launch_bounds__(Mf<D>::MAX_WARPS * 32 * KS)
flash_fwd_f32_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ kv_lengths,
                         const int* __restrict__ gate, float* __restrict__ o,
                         float* __restrict__ lse, int h, int h_kv, int n_q, int n_kv, int causal,
                         int window, float scale_log2, int d) {
  if (gate != nullptr && *gate == 0) return;
  using C = Mf<D>;
  constexpr int TK = 8 * NJ, ND = D / 8, ROW = C::ROW, FROW = C::FROW;
  constexpr int NH = NJ / KS, TH = 8 * NH;   // a warp's n-tiles and keys of a tile
  extern __shared__ __align__(16) uint8_t mma_smem[];
  const int slabs = blockDim.x / 32 / KS, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the warp's rows, and its part of a tile
  const int slab = KS == 1 ? warp : warp % slabs, half = KS == 1 ? 0 : warp / slabs;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / h, hq = bh % h, hk = hq / (h / h_kv);
  const int bm = 16 * slabs;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * bm;   // the longest walks first
  const int n_rows = min(bm, n_q - row0);
  const float* qp = q + size_t(bh) * n_q * d;
  const float* kp = k + (size_t(b) * h_kv + hk) * size_t(n_kv) * d;
  const float* vp = v + (size_t(b) * h_kv + hk) * size_t(n_kv) * d;
  const int kv_len = kv_lengths != nullptr ? min(n_kv, max(kv_lengths[b], 0)) : n_kv;

  // the block's walk (both bounds of dense_bounds grow with the row)
  int b_lo, b_hi, lo_, hi_;
  fa::dense_bounds(row0, kv_len, causal, window, b_lo, hi_);
  fa::dense_bounds(row0 + n_rows - 1, kv_len, causal, window, lo_, b_hi);
  const int start = b_hi > b_lo ? b_lo / TK * TK : 0, end = b_hi > b_lo ? b_hi : 0;
  const int n_tiles = (end - start + TK - 1) / TK;
  uint8_t* q_pl = mma_smem;                  // Q's planes
  uint8_t* k_pl = q_pl + C::NP * bm * ROW;   // K's planes, then V's
  uint8_t* v_pl = k_pl + C::NP * TK * ROW;
  uint8_t* kv_f32 = v_pl + C::NP * TK * ROW;   // a later K tile, then its V tile
  constexpr int kv_plane = TK * ROW;
  const int q_plane = bm * ROW;
  auto load_kv = [&](int i) {
    const int kt = start + i * TK;
    hop::load_rows_padded<D * 4>(kv_f32, kp + size_t(kt) * d, kp, n_kv - kt, TK, d * 4);
    hop::load_rows_padded<D * 4>(kv_f32 + TK * FROW, vp + size_t(kt) * d, vp, n_kv - kt, TK,
                                 d * 4);
  };
  if (n_tiles > 1) load_kv(1);
  hop::cp_async_commit();
  {
    const sp::RowsJob jobs[3] = {
        {qp + size_t(row0) * d, n_rows, bm, q_pl, q_plane, scale_log2},
        {kp + size_t(start) * d, n_tiles > 0 ? n_kv - start : 0, TK, k_pl, kv_plane, 1.f},
        {vp + size_t(start) * d, n_tiles > 0 ? n_kv - start : 0, TK, v_pl, kv_plane, 1.f}};
    sp::split_rows_ldg<D>(jobs, d);
  }

  // this warp's rows, their intervals, its walk and the keys all its rows see
  const int wr0 = 16 * slab;
  const bool live_warp = wr0 < n_rows;
  int lo[2], hi[2], w_lo = 0, w_hi = 0, all_lo = 0, all_hi = 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wr0 + g + 8 * hh;
    lo[hh] = hi[hh] = 0;
    if (r < n_rows) fa::dense_bounds(row0 + r, kv_len, causal, window, lo[hh], hi[hh]);
  }
  if (live_warp) {
    fa::dense_bounds(row0 + wr0, kv_len, causal, window, w_lo, all_hi);
    fa::dense_bounds(row0 + min(wr0 + 15, n_rows - 1), kv_len, causal, window, all_lo, w_hi);
    if (w_hi <= w_lo) w_lo = w_hi = 0;
  }

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // l: this thread's columns

  __syncthreads();   // Q's planes and tile 0's are written
  for (int i = 0; i < n_tiles; ++i) {
    if (i > 0) {
      hop::cp_async_wait<0>();
      __syncthreads();   // tile i has landed; every warp is done with the last tile's planes
      sp::split_rows<D>(k_pl, kv_plane, kv_f32, TK, 1.f);
      sp::split_rows<D>(v_pl, kv_plane, kv_f32 + TK * FROW, TK, 1.f);
      __syncthreads();   // the planes are written; the staged tile is free
      if (i + 1 < n_tiles) load_kv(i + 1);
      hop::cp_async_commit();
    }
    const int kt = start + i * TK + half * TH;   // the warp's keys of the tile
    if (!live_warp || kt >= w_hi || kt + TH <= w_lo) continue;   // the warp's rows see none

    // S = Q K^T: sc[j][2hh + e] is row wr0 + g + 8hh, key kt + 8j + 2t + e
    float sc[NH][4];
    sp::tile_product<D, NH, false, true>(sc, hop::smem_u32(q_pl), q_plane, wr0,
                                         hop::smem_u32(k_pl) + half * TH * ROW, kv_plane, lane);
    const bool full = kt >= all_lo && kt + TH <= all_hi;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[j][2 * hh + e];
          const int c = kt + 8 * j + 2 * t + e;
          if (!full && (c < lo[hh] || c >= hi[hh])) x = -INFINITY;
          mx[hh] = fmaxf(mx[hh], x);
        }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m[hh], fa::row_max<4>(mx[hh]));
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[hh] - mu);
      m[hh] = m_new;
      l[hh] *= alpha;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        acc[nd][2 * hh] *= alpha;
        acc[nd][2 * hh + 1] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(sc[j][2 * hh + e] - mu);
          l[hh] += p;
          sc[j][2 * hh + e] = p;
        }
    }
    // O += P V: P's pieces the A operand, V's the B
    sp::acc_product<D, NH>(acc, sc, hop::smem_u32(v_pl) + half * TH * ROW, kv_plane, lane);
  }
  hop::cp_async_wait<0>();
  float lt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) lt[hh] = fa::row_sum<4>(l[hh]);
  if constexpr (KS == 2) {
    // the two halves of a tile meet: the second's (m, l, acc) through
    // shared memory (the planes, free now), merged by the first
    constexpr int X = ND * 4 + 4;
    float* xch = reinterpret_cast<float*>(mma_smem) + (slab * 32 + lane) * X;
    __syncthreads();   // every warp is done with the planes
    if (half == 1) {
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[4 * nd + e] = acc[nd][e];
      xch[ND * 4] = m[0], xch[ND * 4 + 1] = m[1], xch[ND * 4 + 2] = lt[0], xch[ND * 4 + 3] = lt[1];
    }
    __syncthreads();
    if (half == 1) return;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float mb = xch[ND * 4 + hh], m_new = fmaxf(m[hh], mb);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float fa_ = exp2f(m[hh] - mu), fb = exp2f(mb - mu);
      lt[hh] = lt[hh] * fa_ + xch[ND * 4 + 2 + hh] * fb;
      m[hh] = m_new;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc[nd][2 * hh + e] = acc[nd][2 * hh + e] * fa_ + xch[4 * nd + 2 * hh + e] * fb;
    }
  }
  if (!live_warp) return;
  // a row with no live key (l = 0) gives o = 0 and lse = -inf
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float lt_ = lt[hh];
    inv[hh] = lt_ == 0.f ? 0.f : 1.f / lt_;
    if (t == 0 && wr0 + g + 8 * hh < n_rows)
      lse[size_t(bh) * n_q + row0 + wr0 + g + 8 * hh] =
          lt_ == 0.f ? -INFINITY : m[hh] * fa::LN2 + logf(lt_);
  }
  sp::store_rows<D>(o + (size_t(bh) * n_q + row0 + wr0) * d, acc, inv, n_rows - wr0, lane, d);
}

template <int D, int NJ, int KS>
cudaError_t launch_f32_mma_ks(const void* q, const void* k, const void* v, const int* lens,
                              void* o, float* lse, int b, int h, int h_kv, int n_q, int n_kv,
                              int d, int causal, int window, float scale_log2,
                              cudaStream_t stream, const int* gate) {
  using C = Mf<D>;
  auto kernel = flash_fwd_f32_mma_kernel<D, NJ, KS>;
  static cudaError_t opted = fa::allow_smem(kernel, C::smem(16 * C::MAX_WARPS, 8 * NJ, true));
  if (opted != cudaSuccess) return opted;
  const int slabs = min(C::MAX_WARPS, (n_q + 15) / 16);
  dim3 grid(b * h, (n_q + 16 * slabs - 1) / (16 * slabs));
  // a walk of one tile (n_kv <= 8 NJ) stages nothing
  kernel<<<grid, 32 * slabs * KS, C::smem(16 * slabs, 8 * NJ, n_kv > 8 * NJ), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      lens, gate, static_cast<float*>(o), lse, h, h_kv, n_q, n_kv, causal, window, scale_log2, d);
  return cudaGetLastError();
}

// KS = 2 (each tile's keys split between two warps of the same rows, their
// results merged at the end) where the grid would not cover the 132 SMs
// and a tile has 32 or 64 keys: the distill draft's B16 H2 128 rows take
// 64 blocks, whose walks are then half as long a warp.
template <int D, int NJ>
cudaError_t launch_f32_mma_nj(const void* q, const void* k, const void* v, const int* lens,
                              void* o, float* lse, int b, int h, int h_kv, int n_q, int n_kv,
                              int d, int causal, int window, float scale_log2,
                              cudaStream_t stream, const int* gate) {
  const int slabs = min(Mf<D>::MAX_WARPS, (n_q + 15) / 16);
  if constexpr (NJ % 4 == 0) {
    if (size_t(b) * h * ((n_q + 16 * slabs - 1) / (16 * slabs)) < 132)
      return launch_f32_mma_ks<D, NJ, 2>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, d, causal,
                                         window, scale_log2, stream, gate);
  }
  return launch_f32_mma_ks<D, NJ, 1>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, d, causal,
                                     window, scale_log2, stream, gate);
}

// key tiles of the walk's keys rounded up to 16 (16 to 48) or BN.  gate:
// as the kernel's
template <int D>
cudaError_t launch_f32_mma(const void* q, const void* k, const void* v, const int* lens, void* o,
                           float* lse, int b, int h, int h_kv, int n_q, int n_kv, int d,
                           int causal, int window, float scale_log2, cudaStream_t stream,
                           const int* gate = nullptr) {
  constexpr int BN = Mf<D>::BN;
  const int tile = max(16, min(BN, (n_kv + 15) / 16 * 16));
#define FA_F32_MMA(NJ)                                                                           \
  launch_f32_mma_nj<D, (NJ) <= BN / 8 ? (NJ) : BN / 8>(q, k, v, lens, o, lse, b, h, h_kv, n_q,   \
                                                       n_kv, d, causal, window, scale_log2,      \
                                                       stream, gate)
  switch (tile / 8) {
    case 2: return FA_F32_MMA(2);
    case 4: return FA_F32_MMA(4);
    case 6: return FA_F32_MMA(6);
    default: return FA_F32_MMA(8);
  }
#undef FA_F32_MMA
}

// -- bf16: the tensor-core tile ----------------------------------------------------

using bf16 = __nv_bfloat16;

// D 256: K and V tiles of 64 keys, so that Q and the four tiles of the
// ring (193 KB) fit the 227 KB of shared memory a block
template <int D>
struct Tc {
  static constexpr int BM = 128, BN = D > 128 ? 64 : 128, THREADS = 256;
  static constexpr int SW = D >= 64 ? 128 : 64;   // bytes of a swizzled row
  static constexpr int CPR = SW / 2;              // bf16 columns a region row holds
  static constexpr int Q_BYTES = BM * D * 2, KV_BYTES = BN * D * 2;
  static constexpr size_t SMEM = 1024 + Q_BYTES + 4 * size_t(KV_BYTES);
};

// rows of d values (at most D), zero-padded to D
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const bf16* src, const bf16* base,
                                          int rows_valid, int rows, int d) {
  hop::load_tile<D * 2, Tc<D>::SW, Tc<D>::THREADS>(dst, src, base, rows_valid, rows, d * 2);
}

// The passes a key segment takes, in order: kMax (S only, each row's max
// over the segment; the op graph's kMaxSum also sums exp(s - m) online)
// and kPv (P and the P V product).
enum Pass { kMax = 0, kMaxSum = 1, kPv = 2 };

// The block's walk as a sequence of (tile, pass) steps: the key tiles
// [start, end) fall into segments of `seg` keys (aligned to multiples of
// seg from key 0), and each segment runs its passes over its tiles in
// turn, starting with `first`.  A step of the kMax or kMaxSum pass, which
// reads K alone, takes two tiles: twice the bytes in flight a step.
struct Walk {
  int start, end, seg, first;
  __device__ int seg_lo(int kt) const { return max(start, kt / seg * seg); }
  __device__ int seg_hi(int kt) const { return min(end, (kt / seg + 1) * seg); }
  // a kMax or kMaxSum step takes two tiles (both slots of a ring buffer)
  __device__ bool next(int& kt, int& pass, int bn) const {
    const int step = pass == kPv ? bn : 2 * bn;
    if (kt + step < seg_hi(kt)) { kt += step; return true; }
    if (pass != kPv) {
      pass = kPv;
      kt = seg_lo(kt);
      return true;
    }
    const int hi = seg_hi(kt);
    if (hi >= end) return false;
    kt = hi;
    pass = first;
    return true;
  }
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// acc += P V for one tile, P (bf16 pairs in the A fragment's layout) over
// the 16-key chunks that meet the 8-key groups [j0, j1), V MN-major.  The
// product sums from zero in its own registers and is then added to acc,
// as the TPU kernels and the plain versions add each block's PV to the
// rescaled accumulator, so the long f32 chain over the row has one add a
// tile, not one a 16-key chunk.  D 256 sums 64 columns (one swizzled
// region of V) at a time, 32 registers beside acc's 128 where a whole
// tile's would take 128; a column's sum is the same products in the same
// order either way, so each column rounds as one n256 product would.
template <int D>
__device__ __forceinline__ void pv_add(float (&acc)[D / 2], const uint32_t (&p)[Tc<D>::BN / 4],
                                       uint32_t v_addr, int j0, int j1) {
  constexpr int BN = Tc<D>::BN, SW = Tc<D>::SW;
  constexpr int CW = D > 128 ? 64 : D, CR = CW / 2;   // columns and registers of a chunk
#pragma unroll
  for (int c = 0; c < D / CW; ++c) {
    float pv[CR];
#pragma unroll
    for (int i = 0; i < CR; ++i) pv[i] = 0.f;
    hop::fence_regs(pv);
    hop::wg_arrive();
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      if (2 * kc + 1 < j0 || 2 * kc >= j1) continue;
      const uint32_t a[4] = {p[4 * kc], p[4 * kc + 1], p[4 * kc + 2], p[4 * kc + 3]};
      hop::wgmma_rs<1>(pv, a, hop::desc<SW>(v_addr + c * BN * SW + kc * 16 * SW, BN * SW, 8 * SW),
                       1);
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(pv);
    hop::fence_regs(acc);
#pragma unroll
    for (int i = 0; i < CR; ++i) acc[c * CR + i] += pv[i];
  }
}

// The TPU kernels' online-softmax step on one S tile (scores in base 2):
// an update per `sub` keys (JAX's key block when it is narrower than the
// tile, kSplit; else one for the tile), taking the max over the update's
// keys (local_max) or the max pass's m_seg, and applying it where the
// update starts a block (rescale); then P = exp2(s - m) in bf16 and
// O += P V over the 16-key chunks that meet the update's keys (pv_add).  A
// chunk split between two 8-key blocks runs once for each, the other
// block's half of P zero.
template <int D, bool kSplit>
__device__ __forceinline__ void tpu_update(float (&s)[Tc<D>::BN / 2], float (&acc)[D / 2],
                                           float (&m)[2], float (&l)[2], const float (&m_seg)[2],
                                           bool local_max, bool rescale, int sub,
                                           uint32_t v_addr) {
  constexpr int BN = Tc<D>::BN;
  const int jper = kSplit ? sub / 8 : BN / 8;
  const int n_up = kSplit ? BN / sub : 1;
  for (int sp = 0; sp < n_up; ++sp) {
    const int j0 = sp * jper, j1 = j0 + jper;
    if (rescale) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = m_seg[hh];
        if (local_max) {
          mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            if (!kSplit || (j >= j0 && j < j1))
              mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
          mx = quad_max(mx);
        }
        const float m_new = fmaxf(m[hh], mx);
        const float alpha = exp2f(m[hh] - (m_new == -INFINITY ? 0.f : m_new));
        m[hh] = m_new;
        l[hh] *= alpha;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          acc[4 * jj + 2 * hh] *= alpha;
          acc[4 * jj + 2 * hh + 1] *= alpha;
        }
      }
    }
    uint32_t p[BN / 4];   // p[2j + hh] = row hh's keys 8j + 2 quad + {0, 1}
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float p0 = 0.f, p1 = 0.f;
        if (!kSplit || (j >= j0 && j < j1)) {
          const float mu = m[hh] == -INFINITY ? 0.f : m[hh];
          p0 = exp2f(s[4 * j + 2 * hh] - mu);
          p1 = exp2f(s[4 * j + 2 * hh + 1] - mu);
          l[hh] += p0 + p1;
        }
        p[2 * j + hh] = hop::pack_bf16(p0, p1);
      }
    pv_add<D>(acc, p, v_addr, kSplit ? j0 : 0, kSplit ? j1 : BN / 8);
  }
}

// kOp = false: the TPU kernels' function.  mode 1 (grid, loop): a running
// max over JAX's key blocks of `span` keys; o = acc * (1 / l).  mode 2
// (subrow): the whole row's max; o = acc / l.  q arrives pre-scaled by
// sm_scale * log2(e) (scale = 1).  kOp = true: the op graph's function
// over a walk of more than one tile (scale = sm_scale on the f32 scores):
// the max pass also sums exp(s - m) online (l rescaled where the max
// grows), then the P V pass rounds p = exp(s - m) / l.
template <int D, bool kOp>
__global__ void __launch_bounds__(Tc<D>::THREADS, 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ kv_lengths,
                    bf16* __restrict__ o, float* __restrict__ lse, int h, int h_kv, int n_q,
                    int n_kv, int causal, int window, float scale, int mode, int span, int d) {
  using C = Tc<D>;
  constexpr int BN = C::BN, SW = C::SW, CPR = C::CPR;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* kvs = qs + C::Q_BYTES;   // K0, V0, K1, V1

  const int bh = blockIdx.x, b = bh / h, hq = bh % h, hk = hq / (h / h_kv);
  const int row0 = (gridDim.y - 1 - blockIdx.y) * C::BM;
  const int n_rows = min(C::BM, n_q - row0);
  const bf16* qp = q + size_t(bh) * n_q * d;
  const bf16* kp = k + (size_t(b) * h_kv + hk) * size_t(n_kv) * d;
  const bf16* vp = v + (size_t(b) * h_kv + hk) * size_t(n_kv) * d;
  const int kv_len = kv_lengths != nullptr ? min(n_kv, max(kv_lengths[b], 0)) : n_kv;

  // Both bounds of dense_bounds grow with the row, so the block's walk is
  // [lo(first row), hi(last row)) and a tile is inside every row's
  // interval when it lies in [lo(last row), hi(first row)).
  int walk_lo, walk_hi, all_lo, all_hi;
  fa::dense_bounds(row0, kv_len, causal, window, walk_lo, all_hi);
  fa::dense_bounds(row0 + n_rows - 1, kv_len, causal, window, all_lo, walk_hi);
  Walk walk;
  walk.start = walk_hi > walk_lo ? (walk_lo / BN) * BN : 0;
  walk.end = walk_hi > walk_lo ? walk_hi : 0;
  // one segment for the op graph and subrow, JAX's key blocks for the grid
  // and loop; a block wider than a tile first takes a max pass
  const bool whole = kOp || mode == 2;
  walk.seg = whole ? (1 << 30) : max(span, BN);
  walk.first = kOp ? kMaxSum : whole || span > BN ? kMax : kPv;
  const int sub = whole ? BN : min(span, BN);   // keys of one softmax update

  const int wg = threadIdx.x / 128, lt = threadIdx.x % 128;
  const int lane = lt % 32, quad = lane % 4;
  const int rl = wg * 64 + (lt / 32) * 16 + lane / 4;   // local row of h = 0 (+8: h = 1)
  int lo[2], hi[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    fa::dense_bounds(row0 + rl + 8 * hh, kv_len, causal, window, lo[hh], hi[hh]);

  int kt = walk.start, pass = walk.first;
  bool more = walk.start < walk.end;
  load_tile<D>(qs, qp + size_t(row0) * d, qp, n_rows, C::BM, d);
  if (more) {
    load_tile<D>(kvs, kp + size_t(kt) * d, kp, n_kv - kt, BN, d);
    if (pass == kPv)
      load_tile<D>(kvs + C::KV_BYTES, vp + size_t(kt) * d, vp, n_kv - kt, BN, d);
    else if (kt + BN < walk.seg_hi(kt))
      load_tile<D>(kvs + C::KV_BYTES, kp + size_t(kt + BN) * d, kp, n_kv - kt - BN, BN, d);
  }
  hop::cp_async_commit();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // m: the running max; l: this thread's columns' sum (the op graph's: of
  // exp(s - m_seg), online in the max pass); m_seg: the max pass's result;
  // l_row: the op graph's row sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float m_seg[2] = {-INFINITY, -INFINITY}, l_row[2] = {0.f, 0.f};

  const uint32_t q_addr = hop::smem_u32(qs) + wg * 64 * SW;
  int buf = 0;
  while (more) {
    hop::cp_async_wait<0>();
    hop::fence_async_smem();
    __syncthreads();   // step (kt, pass) has landed everywhere; buffer buf ^ 1 is free
    int nkt = kt, npass = pass;
    const bool has_next = walk.next(nkt, npass, BN);
    if (has_next) {
      // a kPv step: K and V of one tile; else K of two tiles
      uint8_t* nk = kvs + (buf ^ 1) * 2 * C::KV_BYTES;
      const int second = npass == kPv ? nkt : nkt + BN;
      load_tile<D>(nk, kp + size_t(nkt) * d, kp, n_kv - nkt, BN, d);
      if (npass == kPv)
        load_tile<D>(nk + C::KV_BYTES, vp + size_t(nkt) * d, vp, n_kv - nkt, BN, d);
      else if (second < walk.seg_hi(nkt))
        load_tile<D>(nk + C::KV_BYTES, kp + size_t(second) * d, kp, n_kv - second, BN, d);
    }
    hop::cp_async_commit();
    const uint32_t k_addr = hop::smem_u32(kvs + buf * 2 * C::KV_BYTES);
    const uint32_t v_addr = k_addr + C::KV_BYTES;

    // S = Q K^T for the tile of keys from kt_ at kaddr: 64 rows x 128 keys a
    // warpgroup, contracted over D; s[4j + 2hh + e] is row rl + 8hh, key
    // kt_ + 8j + 2 quad + e, and a key the row does not see scores -inf
    float s[BN / 2];
    auto scores = [&](uint32_t kaddr, int kt_) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
      hop::fence_regs(s);
      hop::wg_arrive();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t region = ks * 16 / CPR, off = (ks * 16 % CPR) * 2;
        hop::wgmma_ss<0>(s, hop::desc<SW>(q_addr + region * C::BM * SW + off, 16, 8 * SW),
                         hop::desc<SW>(kaddr + region * BN * SW + off, 16, 8 * SW), 1);
      }
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(s);
      const bool full = kt_ >= all_lo && kt_ + BN <= all_hi;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = __fmul_rn(s[4 * j + 2 * hh + e], scale);
            if (!full) {
              const int c = kt_ + 8 * j + 2 * quad + e;
              if (c < lo[hh] || c >= hi[hh]) x = -INFINITY;
            }
            s[4 * j + 2 * hh + e] = x;
          }
    };

    const bool seg_start = kt == walk.seg_lo(kt);
    if (pass != kPv) {
      const int tiles = kt + BN < walk.seg_hi(kt) ? 2 : 1;
      for (int t = 0; t < tiles; ++t) {
        scores(k_addr + t * C::KV_BYTES, kt + t * BN);
        if (pass == kMax) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float mx = seg_start && t == 0 ? -INFINITY : m_seg[hh];
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
              mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
            m_seg[hh] = quad_max(mx);
          }
        } else if constexpr (kOp) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float prev = seg_start && t == 0 ? -INFINITY : m_seg[hh];
            float mx = prev;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
              mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
            m_seg[hh] = quad_max(mx);
            const float mu = m_seg[hh] == -INFINITY ? 0.f : m_seg[hh];
            float tl = 0.f;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
              tl += expf(s[4 * j + 2 * hh] - mu) + expf(s[4 * j + 2 * hh + 1] - mu);
            l[hh] = (prev == m_seg[hh] ? l[hh] : l[hh] * expf(prev - mu)) + tl;
          }
        }
      }
    } else if constexpr (kOp) {
      // p = exp(s - m) / l, normalised, then rounded
      scores(k_addr, kt);
      if (seg_start) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) { l_row[hh] = quad_sum(l[hh]); m[hh] = m_seg[hh]; }
      }
      uint32_t p[BN / 4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float mu = m[hh] == -INFINITY ? 0.f : m[hh], rl = __frcp_rn(l_row[hh]);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          float pe[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            pe[e] = l_row[hh] > 0.f
                        ? fa::div_rn(expf(s[4 * j + 2 * hh + e] - mu), l_row[hh], rl)
                        : 0.f;
          p[2 * j + hh] = hop::pack_bf16(pe[0], pe[1]);
        }
      }
      pv_add<D>(acc, p, v_addr, 0, BN / 8);
    } else {
      scores(k_addr, kt);
      if (sub == BN)
        tpu_update<D, false>(s, acc, m, l, m_seg, walk.first == kPv, seg_start, BN, v_addr);
      else
        tpu_update<D, true>(s, acc, m, l, m_seg, true, true, sub, v_addr);
    }
    kt = nkt;
    pass = npass;
    more = has_next;
    buf ^= 1;
  }
  hop::cp_async_wait<0>();

  // epilogue: the row sums over the quad, then o and lse.  o is staged in
  // shared memory (the K/V ring is free; rows padded by 16 bytes, so the
  // fragment's writes hit 32 banks) and leaves in whole rows of 16-byte
  // stores, not eight rows of 16 bytes a warp instruction.
  __syncthreads();   // both warpgroups' last wgmmas are done with Q, K and V
  constexpr int OS = D * 2 + 16;   // bytes of a staged row
  static_assert(C::BM * OS <= 4 * C::KV_BYTES, "the staged tile fits in the K/V ring");
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float lt_ = kOp ? l_row[hh] : quad_sum(l[hh]);
    const int r = rl + 8 * hh, row = row0 + r;
    const float inv = lt_ == 0.f ? 0.f : 1.f / lt_;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      float o0 = acc[4 * j + 2 * hh], o1 = acc[4 * j + 2 * hh + 1];
      if (!kOp && mode == 2) {
        o0 = lt_ == 0.f ? 0.f : __fdiv_rn(o0, lt_);
        o1 = lt_ == 0.f ? 0.f : __fdiv_rn(o1, lt_);
      } else if (!kOp) {
        o0 *= inv;
        o1 *= inv;
      }
      *reinterpret_cast<__nv_bfloat162*>(kvs + r * OS + 2 * (8 * j + 2 * quad)) =
          __floats2bfloat162_rn(o0, o1);
    }
    if (quad == 0 && row < n_q)
      lse[size_t(bh) * n_q + row] =
          lt_ == 0.f ? -INFINITY : (kOp ? m[hh] : m[hh] * fa::LN2) + logf(lt_);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_rows * (D / 8); i += C::THREADS) {
    const int r = i / (D / 8), c = i % (D / 8) * 8;
    if (c >= d) continue;   // columns below d
    *reinterpret_cast<uint4*>(o + (size_t(bh) * n_q + row0 + r) * d + c) =
        *reinterpret_cast<const uint4*>(kvs + r * OS + 2 * c);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const int* lens, void* o,
                      float* lse, int b, int h, int h_kv, int n_q, int n_kv, int d, int causal,
                      int window, float scale, int mode, int span, cudaStream_t stream) {
  auto kernel = mode == 0 ? flash_fwd_tc_kernel<D, true> : flash_fwd_tc_kernel<D, false>;
  static cudaError_t opted = [] {
    cudaError_t e = fa::allow_smem(flash_fwd_tc_kernel<D, true>, Tc<D>::SMEM);
    return e != cudaSuccess ? e : fa::allow_smem(flash_fwd_tc_kernel<D, false>, Tc<D>::SMEM);
  }();
  if (opted != cudaSuccess) return opted;
  if (mode == 1 && (span < 8 || span % 8 != 0 || (span > Tc<D>::BN && span % Tc<D>::BN != 0) ||
                    (span < Tc<D>::BN && Tc<D>::BN % span != 0)))
    return cudaErrorInvalidValue;
  // the subrow schedule needs d 128 (JAX's _subrow_ok, _pad128_ok): never above
  if (D > 128 && mode == 2) return cudaErrorInvalidValue;
  dim3 grid(b * h, (n_q + Tc<D>::BM - 1) / Tc<D>::BM);
  kernel<<<grid, Tc<D>::THREADS, Tc<D>::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      lens, static_cast<bf16*>(o), lse, h, h_kv, n_q, n_kv, causal, window, scale, mode, span, d);
  return cudaGetLastError();
}

// -- bf16 op graph: the warp-level tensor-core tile ----------------------------------

template <int D>
struct Og {
  static constexpr int ROW = D * 2 + 16;   // bytes of a padded row
  static constexpr int ND = D / 8;         // 8-column n-tiles of O
  static constexpr int MAX_WARPS = 4;
  // D 256: O in two column halves of 128, one after the other, so that
  // O's registers (64 a half, 128 whole) and S's (64 at 128 keys) fit
  static constexpr int HALF_ND = 16;
};

// The op graph's function over a walk of at most one tile of BN (64 or
// 128) keys: s = (q . k) sm_scale in f32, the row's max m and sum l of
// exp(s - m), p = exp(s - m) / l rounded to bf16, o = sum p v, lse = m +
// ln l.  A block of W warps (W = min(4, cdiv(n_q, 16)), so a short query
// side gets a short block) owns 16 W query rows of one (batch, head), a
// warp 16 of them as mma.sync m16n8k16 tiles.  Q, K and V come into shared
// memory together (cp.async, rows padded against bank conflicts, zero past
// n_kv, only the 16-key chunks the walk reaches); S = Q K^T goes into
// registers (fragments by ldmatrix) and m, l and p come from those same
// registers: one Q K^T and one P V, P rounded to bf16 in place as the A
// operand.  A key a row does not see scores -inf; its p = 0 still
// multiplies V, as the op graph's product does.
template <int D, int BN>
__global__ void __launch_bounds__(Og<D>::MAX_WARPS * 32)
flash_fwd_op_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ kv_lengths,
                    bf16* __restrict__ o, float* __restrict__ lse, int h, int h_kv, int n_q,
                    int n_kv, int causal, int window, float scale, int tile_rows, int d) {
  using C = Og<D>;
  constexpr int ROW = C::ROW, NJ = BN / 8;
  extern __shared__ __align__(16) uint8_t op_smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / h, hq = bh % h, hk = hq / (h / h_kv);
  const int bm = 16 * warps;
  const int row0 = blockIdx.y * bm;
  const int n_rows = min(bm, n_q - row0);
  const bf16* qp = q + size_t(bh) * n_q * d;
  const bf16* kp = k + (size_t(b) * h_kv + hk) * size_t(n_kv) * d;
  const bf16* vp = v + (size_t(b) * h_kv + hk) * size_t(n_kv) * d;
  const int kv_len = kv_lengths != nullptr ? min(n_kv, max(kv_lengths[b], 0)) : n_kv;

  // the block's walk: the keys its rows' causal bound reaches, past the
  // rows' lengths too, as the op graph's P V product takes every key with
  // p = 0 past a length
  int walk_lo, walk_hi, lo_, hi_;
  fa::dense_bounds(row0 + n_rows - 1, n_kv, causal, window, lo_, walk_hi);
  fa::dense_bounds(row0, n_kv, causal, window, walk_lo, hi_);
  const int end = walk_hi > walk_lo ? walk_hi : 0;   // the tile's keys: [0, end)
  const int rows = (end + 15) / 16 * 16;

  uint8_t* ks = op_smem;
  uint8_t* vs = ks + tile_rows * ROW;
  uint8_t* qs = vs + tile_rows * ROW;
  hop::load_rows_padded<D * 2>(qs, qp + size_t(row0) * d, qp, n_rows, bm, d * 2);
  hop::load_rows_padded<D * 2>(ks, kp, kp, n_kv, rows, d * 2);
  hop::load_rows_padded<D * 2>(vs, vp, vp, n_kv, rows, d * 2);
  hop::cp_async_commit();

  // this warp's rows, their live keys, and the keys every one of them sees
  const int wr0 = 16 * warp;
  int lo[2], hi[2], all_lo, all_hi;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wr0 + g + 8 * hh;
    lo[hh] = hi[hh] = 0;
    if (r < n_rows) fa::dense_bounds(row0 + r, kv_len, causal, window, lo[hh], hi[hh]);
  }
  fa::dense_bounds(row0 + wr0, kv_len, causal, window, lo_, all_hi);
  fa::dense_bounds(row0 + min(wr0 + 15, n_rows - 1), kv_len, causal, window, all_lo, hi_);

  float acc[C::ND][4];
#pragma unroll
  for (int i = 0; i < C::ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, lr[2] = {0.f, 0.f};   // the row's max and sum
  // D > 128: P rounded to bf16 as the A fragments of every 16-key chunk,
  // for both column halves of O (zero where the walk has no key)
  uint32_t pw[D > 128 ? NJ / 2 : 1][4] = {};

  hop::cp_async_wait<0>();
  __syncthreads();
  if (wr0 >= n_rows) return;
  if (rows > 0) {
    // sc[j][2hh + e] is row wr0 + g + 8hh, key 8j + 2t + e
    float sc[NJ][4];
    hop::tile_scores<D, NJ>(sc, hop::smem_u32(qs), wr0, hop::smem_u32(ks), ROW, rows, lane);
    const bool full = all_lo <= 0 && rows <= all_hi;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = __fmul_rn(sc[j][2 * hh + e], scale);
          const int c = 8 * j + 2 * t + e;
          if (8 * j >= rows || (!full && (c < lo[hh] || c >= hi[hh]))) x = -INFINITY;
          sc[j][2 * hh + e] = x;
          mx[hh] = fmaxf(mx[hh], x);
        }
    // e = exp(s - m), l, then p = e / l rounded: the A operand of P V
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[hh] = fa::row_max<4>(mx[hh]);
      const float mu = m[hh] == -INFINITY ? 0.f : m[hh];
      float tl = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ex = 8 * j < rows ? expf(sc[j][2 * hh + e] - mu) : 0.f;
          sc[j][2 * hh + e] = ex;
          tl += ex;
        }
      lr[hh] = fa::row_sum<4>(tl);
      const float rl = __frcp_rn(lr[hh]);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sc[j][2 * hh + e] = lr[hh] > 0.f ? fa::div_rn(sc[j][2 * hh + e], lr[hh], rl) : 0.f;
    }
    if constexpr (D > 128) {
#pragma unroll
      for (int kc = 0; kc < NJ / 2; ++kc) hop::acc_to_a(pw[kc], sc[2 * kc], sc[2 * kc + 1]);
    } else {
#pragma unroll
      for (int kc = 0; kc < NJ / 2; ++kc) {
        if (16 * kc >= rows) continue;
        uint32_t pa[1][4];
        hop::acc_to_a(pa[0], sc[2 * kc], sc[2 * kc + 1]);
        hop::mma_rows<D, 1>(acc, pa, hop::smem_u32(vs), ROW, 16 * kc, lane);
      }
    }
  }
  if constexpr (D > 128) {
    // O = P V a column half at a time, each half stored as it completes
#pragma unroll
    for (int half = 0; half < C::ND / C::HALF_ND; ++half) {
      const int c0 = 8 * C::HALF_ND * half;   // the half's first column
      float oh[C::HALF_ND][4];
#pragma unroll
      for (int i = 0; i < C::HALF_ND; ++i) oh[i][0] = oh[i][1] = oh[i][2] = oh[i][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < NJ / 2; ++kc) {
        if (16 * kc >= rows) continue;
        const uint32_t pa[1][4] = {{pw[kc][0], pw[kc][1], pw[kc][2], pw[kc][3]}};
        hop::mma_rows<8 * C::HALF_ND, 1>(oh, pa, hop::smem_u32(vs) + 2 * c0, ROW, 16 * kc, lane);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wr0 + g + 8 * hh;
        if (r >= n_rows) continue;
        bf16* orow = o + (size_t(bh) * n_q + row0 + r) * d + c0;
#pragma unroll
        for (int nd = 0; nd < C::HALF_ND; ++nd)
          if (c0 + 8 * nd < d)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * nd + 2 * t) =
                __floats2bfloat162_rn(oh[nd][2 * hh], oh[nd][2 * hh + 1]);
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wr0 + g + 8 * hh, row = row0 + r;
    if (r >= n_rows) continue;
    bf16* orow = o + (size_t(bh) * n_q + row) * d;
    if constexpr (D <= 128) {
#pragma unroll
      for (int nd = 0; nd < C::ND; ++nd)
        if (8 * nd < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * nd + 2 * t) =
              __floats2bfloat162_rn(acc[nd][2 * hh], acc[nd][2 * hh + 1]);
    }
    if (t == 0)
      lse[size_t(bh) * n_q + row] = lr[hh] == 0.f ? -INFINITY : m[hh] + logf(lr[hh]);
  }
}

template <int D, int BN>
cudaError_t launch_op_bn(const void* q, const void* k, const void* v, const int* lens, void* o,
                         float* lse, int b, int h, int h_kv, int n_q, int n_kv, int d, int causal,
                         int window, float scale, cudaStream_t stream) {
  using C = Og<D>;
  auto kernel = flash_fwd_op_kernel<D, BN>;
  static cudaError_t opted =
      fa::allow_smem(kernel, size_t(2 * BN + 16 * C::MAX_WARPS) * C::ROW);
  if (opted != cudaSuccess) return opted;
  const int warps = min(C::MAX_WARPS, (n_q + 15) / 16);
  const int tile_rows = min(BN, (n_kv + 15) / 16 * 16);
  const size_t smem = size_t(2 * tile_rows + 16 * warps) * C::ROW;
  dim3 grid(b * h, (n_q + 16 * warps - 1) / (16 * warps));
  kernel<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      lens, static_cast<bf16*>(o), lse, h, h_kv, n_q, n_kv, causal, window, scale, tile_rows, d);
  return cudaGetLastError();
}

// one key tile up to 128 keys; beyond, the wgmma kernel's two passes
template <int D>
cudaError_t launch_op(const void* q, const void* k, const void* v, const int* lens, void* o,
                      float* lse, int b, int h, int h_kv, int n_q, int n_kv, int d, int causal,
                      int window, float scale, cudaStream_t st) {
  if (n_kv > 128)
    return launch_tc<D>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, d, causal, window, scale, 0,
                        0, st);
  if (n_kv <= 64)
    return launch_op_bn<D, 64>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, d, causal, window, scale, st);
  return launch_op_bn<D, 128>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, d, causal, window, scale, st);
}

// -- f32: split precision on the tensor cores -----------------------------------

template <int D>
struct Sp {
  static constexpr int BM = 128, BN = 64, THREADS = 256, NP = sp::NP;
  static constexpr int SW = D >= 64 ? 128 : 64;   // bytes of a swizzled row
  static constexpr int Q_BYTES = BM * D * 2, KV_BYTES = BN * D * 2;   // one plane
  static constexpr size_t SMEM = 1024 + NP * (size_t(Q_BYTES) + 2 * size_t(KV_BYTES));
};

// The f32 forward, every schedule's function (in f32 they agree to f32
// rounding): one online softmax over tiles of 64 keys in base 2, q
// pre-scaled by sm_scale * log2(e) before the split; o = acc * (1 / l),
// lse = m ln 2 + ln l.  q, k and v arrive as bf16 planes (sp::split_kernel;
// plane p of q at q + p * q_plane, of k and v at + p * kv_plane).  A block
// owns 128 query rows of one (batch, head), two consumer warpgroups of 64,
// with Q's three planes resident; the three planes of a K tile and of a V
// tile come through one buffer each, the next K tile loading while this
// tile's P V runs and the next V tile while the next S does.  S = Q K^T is
// six wgmmas a k16 step (both K-major), P = exp2(s - m) is split in
// registers into the A operand of P V's six (V MN-major), summed from zero
// a tile and then added to acc in f32 (sp::pair_a).  A warpgroup
// walks the key tiles its own rows see (64 rows and 64 keys a tile), so a
// NaN in V reaches the rows whose walk reads it.  nf[0] set: q, k or v
// holds a +-inf, and the block exits (flash_fwd_f32_mma_kernel, behind
// it, computes the call).
template <int D>
__global__ void __launch_bounds__(Sp<D>::THREADS, 1)
flash_fwd_f32_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ kv_lengths,
                     const int* __restrict__ nf, float* __restrict__ o, float* __restrict__ lse,
                     long long q_plane, long long kv_plane, int h, int h_kv, int n_q, int n_kv,
                     int causal, int window, int d) {
  using C = Sp<D>;
  constexpr int BN = C::BN, SW = C::SW, NP = C::NP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = qs + NP * C::Q_BYTES;
  uint8_t* vs = ks + NP * C::KV_BYTES;

  const int bh = blockIdx.x, b = bh / h, hq = bh % h, hk = hq / (h / h_kv);
  const int row0 = (gridDim.y - 1 - blockIdx.y) * C::BM;   // the longest walks first
  const int n_rows = min(C::BM, n_q - row0);
  const bf16* qp = q + size_t(bh) * n_q * d;
  const bf16* kp = k + (size_t(b) * h_kv + hk) * size_t(n_kv) * d;
  const bf16* vp = v + (size_t(b) * h_kv + hk) * size_t(n_kv) * d;
  const int kv_len = kv_lengths != nullptr ? min(n_kv, max(kv_lengths[b], 0)) : n_kv;
  if (nf[0] != 0) return;

  const int wg = threadIdx.x / 128, lt = threadIdx.x % 128;
  const int lane = lt % 32, quad = lane % 4;
  const int rl = wg * 64 + (lt / 32) * 16 + lane / 4;   // local row of hh = 0 (+8: hh = 1)
  // the warpgroup's rows and walk [w_start, w_hi); the tiles inside every
  // one of its rows' intervals are [all_lo, all_hi)
  const int w_rows = min(64, n_rows - wg * 64);
  int w_start = 0, w_hi = 0, all_lo = 0, all_hi = 0;
  if (w_rows > 0) {
    int lo_, hi_;
    fa::dense_bounds(row0 + wg * 64, kv_len, causal, window, lo_, all_hi);
    fa::dense_bounds(row0 + wg * 64 + w_rows - 1, kv_len, causal, window, all_lo, hi_);
    if (hi_ > lo_) { w_start = lo_ / BN * BN; w_hi = hi_; }
  }
  // the block's walk: both bounds grow with the row
  int b_lo, b_hi, lo_, hi_;
  fa::dense_bounds(row0, kv_len, causal, window, b_lo, hi_);
  fa::dense_bounds(row0 + n_rows - 1, kv_len, causal, window, lo_, b_hi);
  const int start = b_hi > b_lo ? b_lo / BN * BN : 0, end = b_hi > b_lo ? b_hi : 0;
  int lo[2], hi[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    fa::dense_bounds(row0 + rl + 8 * hh, kv_len, causal, window, lo[hh], hi[hh]);

  auto load_kv = [&](uint8_t* dst, const bf16* src, int kt) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
      hop::load_tile<D * 2, SW, C::THREADS>(dst + p * C::KV_BYTES, src + p * kv_plane + size_t(kt) * d,
                                             src, n_kv - kt, BN, d * 2);
  };
  if (start < end) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
      hop::load_tile<D * 2, SW, C::THREADS>(qs + p * C::Q_BYTES, qp + p * q_plane + size_t(row0) * d,
                                             qp, n_rows, C::BM, d * 2);
    load_kv(ks, kp, start);
  }
  hop::cp_async_commit();
  if (start < end) load_kv(vs, vp, start);
  hop::cp_async_commit();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // l: this thread's columns
  const uint32_t q_addr = hop::smem_u32(qs) + wg * 64 * SW;
  const uint32_t k_addr = hop::smem_u32(ks), v_addr = hop::smem_u32(vs);

  for (int kt = start; kt < end; kt += BN) {
    const bool act = kt >= w_start && kt < w_hi;   // this warpgroup's rows see the tile
    const bool next = kt + BN < end;
    hop::cp_async_wait<1>();
    hop::fence_async_smem();
    __syncthreads();   // K(kt) has landed everywhere

    // S = Q K^T: s[4j + 2hh + e] is row rl + 8hh, key kt + 8j + 2 quad + e
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    hop::fence_regs(s);
    if (act) {
      hop::wg_arrive();
      sp::ss_pairs<D, SW, false, 0, 6>(s, q_addr, C::Q_BYTES, C::BM * SW, k_addr, C::KV_BYTES,
                                       BN * SW);
      hop::wg_commit();
      hop::wg_wait<0>();
    }
    hop::fence_regs(s);
    __syncthreads();   // every warpgroup is done with K(kt)
    if (next) load_kv(ks, kp, kt + BN);
    hop::cp_async_commit();

    uint32_t pp[NP][16];   // P's pieces: [i][2j + hh] = row hh's keys 8j + 2 quad + {0, 1}
    if (act) {
      const bool full = kt >= all_lo && kt + BN <= all_hi;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * hh + e];
            if (!full) {
              const int c = kt + 8 * j + 2 * quad + e;
              if (c < lo[hh] || c >= hi[hh]) x = -INFINITY;
            }
            mx = fmaxf(mx, x);
          }
        mx = quad_max(mx);
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
          const float p0 = exp2f(s[4 * j + 2 * hh] - mu), p1 = exp2f(s[4 * j + 2 * hh + 1] - mu);
          l[hh] += p0 + p1;
          sp::split_pair(p0, p1, pp[0][2 * j + hh], pp[1][2 * j + hh], pp[2][2 * j + hh]);
        }
      }
    }

    hop::cp_async_wait<1>();
    hop::fence_async_smem();
    __syncthreads();   // V(kt) has landed everywhere
    // P V sums from zero, then into acc (see sp::pair_a)
    float pv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) pv[i] = 0.f;
    hop::fence_regs(pv);
    if (act) {
      hop::wg_arrive();
      sp::rs_pairs<D, SW, false, 0, 6>(pv, pp, v_addr, C::KV_BYTES);
      hop::wg_commit();
      hop::wg_wait<0>();
    }
    hop::fence_regs(pv);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] += pv[i];
    __syncthreads();   // every warpgroup is done with V(kt)
    if (next) load_kv(vs, vp, kt + BN);
    hop::cp_async_commit();
  }
  hop::cp_async_wait<0>();

  // a row with no live key (l = 0) gives o = 0 and lse = -inf
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + rl + 8 * hh;
    const float lt_ = quad_sum(l[hh]);
    if (row >= n_q) continue;
    const float inv = lt_ == 0.f ? 0.f : 1.f / lt_;
    float* orow = o + (size_t(bh) * n_q + row) * d;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < d)
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * quad) =
            make_float2(acc[4 * j + 2 * hh] * inv, acc[4 * j + 2 * hh + 1] * inv);
    if (quad == 0)
      lse[size_t(bh) * n_q + row] = lt_ == 0.f ? -INFINITY : m[hh] * fa::LN2 + logf(lt_);
  }
}

// Split q (scaled by scale_log2), k and v into bf16 planes (in `planes`:
// 3 q_elems, then 3 kv_elems for k and for v), then the kernel, then
// flash_fwd_f32_mma_kernel gated on the split pass's +-inf flag (C17).
// nf: two ints of scratch.
template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const int* lens, void* o,
                       float* lse, void* planes, int* nf, int b, int h, int h_kv, int n_q,
                       int n_kv, int d, int causal, int window, float scale_log2,
                       cudaStream_t stream) {
  using C = Sp<D>;
  auto kernel = flash_fwd_f32_kernel<D>;
  static cudaError_t opted = fa::allow_smem(kernel, C::SMEM);
  if (opted != cudaSuccess) return opted;
  const long long q_elems = (long long)b * h * n_q * d, kv_elems = (long long)b * h_kv * n_kv * d;
  bf16* qs = static_cast<bf16*>(planes);
  bf16* ks = qs + 3 * q_elems;
  bf16* vs = ks + 3 * kv_elems;
  cudaError_t e = cudaMemsetAsync(nf, 0, 2 * sizeof(int), stream);
  if (e != cudaSuccess) return e;
  sp::SplitJobs jobs = {{static_cast<const float*>(q), static_cast<const float*>(k),
                         static_cast<const float*>(v), nullptr},
                        {qs, ks, vs, nullptr},
                        {q_elems, kv_elems, kv_elems, 0},
                        {scale_log2, 1.f, 1.f, 1.f},
                        {nf, nf, nf, nullptr}};
  e = sp::split(jobs, 3, stream);
  if (e != cudaSuccess) return e;
  dim3 grid(b * h, (n_q + C::BM - 1) / C::BM);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(qs, ks, vs, lens, nf, static_cast<float*>(o), lse,
                                                q_elems, kv_elems, h, h_kv, n_q, n_kv, causal,
                                                window, d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_f32_mma<D>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, d, causal, window,
                           scale_log2, stream, nf);
}

// Each kernel at the tile width of d (hop::tile_width), reading d itself.
cudaError_t dispatch_f32_tc(int d, const void* q, const void* k, const void* v, const int* lens,
                            void* o, float* lse, void* planes, int* nf, int b, int h, int h_kv,
                            int n_q, int n_kv, int causal, int window, float scale_log2,
                            cudaStream_t st) {
  switch (hop::tile_width(d)) {
    case 32: return launch_f32<32>(q, k, v, lens, o, lse, planes, nf, b, h, h_kv, n_q, n_kv, d, causal, window, scale_log2, st);
    case 64: return launch_f32<64>(q, k, v, lens, o, lse, planes, nf, b, h, h_kv, n_q, n_kv, d, causal, window, scale_log2, st);
    case 128: return launch_f32<128>(q, k, v, lens, o, lse, planes, nf, b, h, h_kv, n_q, n_kv, d, causal, window, scale_log2, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_f32_mma(int d, const void* q, const void* k, const void* v, const int* lens,
                             void* o, float* lse, int b, int h, int h_kv, int n_q, int n_kv,
                             int causal, int window, float scale_log2, cudaStream_t st) {
  switch (hop::tile_width(d)) {
    case 32: return launch_f32_mma<32>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, d, causal, window, scale_log2, st);
    case 64: return launch_f32_mma<64>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, d, causal, window, scale_log2, st);
    case 128: return launch_f32_mma<128>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, d, causal, window, scale_log2, st);
    default: return cudaErrorInvalidValue;
  }
}

// bf16: the tiles of 32 to 256 columns (the f32 kernels and the backward
// keep 128 as their widest)
cudaError_t dispatch_bf16(int d, const void* q, const void* k, const void* v, const int* lens,
                          void* o, float* lse, int b, int h, int h_kv, int n_q, int n_kv,
                          int causal, int window, float scale, int mode, int span,
                          cudaStream_t st) {
  if (mode == 0) {
    switch (hop::tile_width(d, 256)) {
      case 32: return launch_op<32>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, d, causal, window, scale, st);
      case 64: return launch_op<64>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, d, causal, window, scale, st);
      case 128: return launch_op<128>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, d, causal, window, scale, st);
      case 256: return launch_op<256>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, d, causal, window, scale, st);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (hop::tile_width(d, 256)) {
    case 32: return launch_tc<32>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, d, causal, window, scale, mode, span, st);
    case 64: return launch_tc<64>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, d, causal, window, scale, mode, span, st);
    case 128: return launch_tc<128>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, d, causal, window, scale, mode, span, st);
    case 256: return launch_tc<256>(q, k, v, lens, o, lse, b, h, h_kv, n_q, n_kv, d, causal, window, scale, mode, span, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, h, n_q, d); k, v (b, h_kv, n_kv, d); o like q; lse (b, h, n_q) f32.
// kv_lengths (b,) int32 or null; window <= 0 means none.  bf16 (dtype
// code 1; f32 has its own entry points below) modes: 0 the op graph (scale
// = sm_scale); 1 a running max per `span` keys (8 to 1024, JAX's grid and
// loop key blocks) and 2 the whole row's max (subrow), both on q
// pre-scaled by the caller (scale = 1).
extern "C" int fa_flash_fwd(const void* q, const void* k, const void* v,
                            const void* kv_lengths, void* o, void* lse, int b,
                            int h, int h_kv, int n_q, int n_kv, int d, int causal,
                            int window, float scale, int dtype, int mode, int span,
                            void* stream) {
  if (b == 0 || h == 0 || n_q == 0) return 0;
  if (dtype != 1) return int(cudaErrorInvalidValue);
  return dispatch_bf16(d, q, k, v, static_cast<const int*>(kv_lengths), o,
                       static_cast<float*>(lse), b, h, h_kv, n_q, n_kv, causal, window, scale,
                       mode, span, static_cast<cudaStream_t>(stream));
}

// The f32 forward sized to the rows (flash_fwd_f32_mma_kernel): q, k, v, o
// f32 as fa_flash_fwd's; scale_log2 = sm_scale * log2(e), folded into q.
extern "C" int fa_flash_fwd_f32_mma(const void* q, const void* k, const void* v,
                                    const void* kv_lengths, void* o, void* lse, int b, int h,
                                    int h_kv, int n_q, int n_kv, int d, int causal, int window,
                                    float scale_log2, void* stream) {
  if (b == 0 || h == 0 || n_q == 0) return 0;
  return dispatch_f32_mma(d, q, k, v, static_cast<const int*>(kv_lengths), o,
                          static_cast<float*>(lse), b, h, h_kv, n_q, n_kv, causal, window,
                          scale_log2, static_cast<cudaStream_t>(stream));
}

// The f32 forward on the tensor cores in split precision (split.cuh): q, k,
// v, o f32 as fa_flash_fwd_f32_mma's; scale_log2 = sm_scale * log2(e),
// folded into q; planes: bf16 scratch of 3 (q's elements + 2 k's
// elements); nf: two ints of scratch.  The same function.
extern "C" int fa_flash_fwd_f32(const void* q, const void* k, const void* v,
                                const void* kv_lengths, void* o, void* lse, void* planes,
                                void* nf, int b, int h, int h_kv, int n_q, int n_kv, int d,
                                int causal, int window, float scale_log2, void* stream) {
  if (b == 0 || h == 0 || n_q == 0) return 0;
  return dispatch_f32_tc(d, q, k, v, static_cast<const int*>(kv_lengths), o,
                         static_cast<float*>(lse), planes, static_cast<int*>(nf), b, h, h_kv,
                         n_q, n_kv, causal, window, scale_log2, static_cast<cudaStream_t>(stream));
}
