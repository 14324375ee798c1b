// Flash-attention backward: dq, dk, dv of o = softmax(q k^T * sm_scale) v,
// recomputing the probabilities from q, k and the forward's lse.
//
// Replaces the TPU kernels in flashattn_tpu/ops/flash_attention.py:
//   _bwd_dkv_kernel + _bwd_dq_kernel (wrapper _flash_bwd), the grid
//     backward: causal or not, sliding window, kv_lengths, GQA, cross
//     attention;
//   _bwd_subrow_kernel (wrapper _flash_bwd_subrow), the fused dense causal
//     backward of the bf16 training route;
//   _bwd_dq_loop_kernel + _bwd_dkv_loop_kernel (wrapper _flash_bwd_loop),
//     the split dense causal backward of the f32 training route.
// One pair of kernels (per dtype) computes all three functions.  Below
// 1024 keys and at shapes JAX cannot tile, JAX differentiates XLA's op
// graph instead (jax.vjp in _flash_vjp_bwd / _varlen_vjp_bwd); in bf16 the
// op_graph mode below computes that function.
//
// Math, for query row R and key c in R's live interval [lo, hi)
// (fa::dense_bounds, the policy of the forward kernel), in base 2 as the
// TPU kernels compute it:
//   p = exp2(s * sm_scale * log2(e) - lse_R * log2(e)) with s = q_R . k_c
//   dp = do_R . v_c;   ds = p (dp - di_R) sm_scale
//   dv_c += p do_R;   dq_R += ds k_c;   dk_c += ds q_R
// with di_R = o_R . do_R (computed by the caller); in bf16 p and ds round
// to bf16 before the three products, which sum in f32.  Outside the
// interval p = 0, so a row with no live key (lse = -inf) gets dq = 0 and a
// key that no row sees (past kv_lengths) gets dk = dv = 0, without
// evaluating exp2 there.  GQA: query head h reads kv head h / (h_q / h_kv),
// and dk/dv sum over the group's query heads.
//
// Two kernels, as the TPU grid backward splits them, so that no sum crosses
// blocks: no atomics, no dQ scratch, the same result on every run.
//   dK/dV, key-major: a block owns a tile of keys of one (batch, kv head),
//     keeps their dk and dv in registers, and walks every query head of
//     its GQA group and every query tile that can see one of its keys,
//     computing the score and dp tiles key-major (s^T = k q^T, dp^T = v do^T);
//   dQ, query-major: a block owns a tile of query rows of one (batch,
//     head), keeps their dq in registers and walks the key tiles its rows
//     can see.
// The score and dp tiles are computed in both kernels: 7 score-shaped
// products where the fused TPU subrow kernel issues 5.
//
// bf16 (head dim 32, 64 or 128) runs tensor-core kernels on hopper.cuh.
// What bounds them on the H100 is the seven products (14 d flops per live
// pair at 989 TF/s).  A block of two consumer warpgroups owns 128 keys
// (dK/dV) or 128 query rows (dQ), 64 a warpgroup, resident in shared
// memory in the swizzled layout of the forward; the other side streams in
// tiles of 64 rows through a double-buffered cp.async ring (zero fill past
// the end).  Every product is a wgmma: the score and dp tiles with both
// operands K-major (as the forward's S); then p and ds, computed on the
// f32 fragment and rounded to bf16 pairs in place, are exactly the register
// A operand of dV += P^T dO, dK += dS^T Q and dQ += dS K, whose B (dO, Q or
// K) is read MN-major from the tile already resident, the transpose bit
// set: no operand is ever transposed in shared memory.  lse and di are per
// column in the key-major kernel, staged in shared memory with each query
// tile.  Only tiles that cut some pair's interval are masked; a warpgroup
// whose keys no query of a tile sees skips it.  dK, dV and dQ leave staged
// through shared memory in whole rows.
//
// f32 (one function for every schedule) runs on the tensor cores in split
// precision (split.cuh) from F32_TC_MIN_KV keys on: flash_bwd_dkv_f32_kernel
// and flash_bwd_dq_f32_kernel, the f32 training route's loop backward
// (_bwd_dq_loop_kernel, _bwd_dkv_loop_kernel) and every other schedule's
// f32 backward.  q, k, v and dO are split once a call into three bf16
// planes, q scaled by sm_scale log2(e) first as the forward scales it, so
// that S sums the forward's products in the forward's order and p =
// exp2(s - lse log2(e)) is the forward's probability bit for bit: the
// tensor cores round each step of S toward zero, and an S that drifted
// from the forward's by those steps would move p by ~3e-6 against lse (dK
// takes the scale back out at the end).  P and dS are split in registers
// into the A operand of dV, dK and dQ.  Each of the seven products a pair
// is six bf16 wgmmas (42 d x 6 flops a live pair at 989 TF/s: the bound).
// The planes take 6 bytes an element of shared memory, so a block owns 64
// keys (dK/dV) or 64 query rows (dQ) with the other side in 64-row tiles,
// four tiles of planes (192 KB at d 128).  Its two warpgroups split each
// tile's products, one S and P, the other dP and dS, and trade P and dS
// through shared memory under named barriers, so that one's exponentials
// and splits run beside the other's wgmmas.  The pair stays deterministic:
// no atomics, no sum across blocks.  Below F32_TC_MIN_KV keys (the MT
// model's 40, the distill draft's 128) the warp-level pair runs, sized to
// the rows as the bf16 op graph's Ob pair: flash_bwd_dkv_f32_mma_kernel
// (key-major) and flash_bwd_dq_f32_mma_kernel (query-major), warps of 16
// keys or rows on mma.sync m16n8k16, blocks of up to four warps, Q, K, V
// and dO read once as f32 (no split pass in device memory) and split once
// a tile into bf16 planes in shared memory; each score-shaped product is
// six mma.sync products, S in the forward kernel's order (so that p is the
// forward's bit for bit), P and dS split in registers.  Below
// MMA_DS_MAX_KV keys (ops/flash_attention.py) the dK/dV kernel leaves dS in
// a scratch (b h n_q n_kv floats) and the dQ kernel
// (flash_bwd_dq_ds_f32_mma_kernel) reads it: five products a pair where
// recomputing S and dP takes seven; longer walks (a +-inf call of the
// wgmma route) recompute them.  A non-finite
// b0 meets the other operand's lower pieces as its finite part, so these
// kernels also compute every split-precision call whose inputs hold a
// +-inf (C17): the split pass flags it, the wgmma kernels exit and the
// warp-level pair, launched behind them, runs where the flag is set.

// The op graph's backward in bf16 (op_graph = 1): with s = q . k sm_scale,
// e = exp(s - m), l = sum e and p = e / l, autodiff (torch autograd's
// order, which matches JAX's) gives per pair
//   dp = bf16(do . v);   ds = (dp / l + r) e sm_scale, each op rounded in f32;
//   dv_c += bf16(p) do;   dq_R += ds k_c;   dk_c += ds q_R   (f32, rounded once)
// with r = sum_c -dp ((e / l) / l), the gradient reaching l.  With GQA each
// query head's dk and dv round to bf16 before the group sums them, as the
// backward of repeating K and V does.  The argmax's share of the max's
// gradient (zero but for rounding) is left out.  It runs two warp-level
// tensor-core kernels (mma.sync m16n8k16, warps of 16 rows or keys, blocks
// of up to four warps sized to the rows, so that the MT model's 40-row
// launches fill the card): the dQ kernel (query-major) takes the rows'
// (m, l, r) and dQ in one walk, from registers where one 64-key tile holds
// the walk, else in three passes, and leaves (m, l, r) in ops; the dK/dV
// kernel (key-major) reads them.  No sum crosses blocks.  The products are
// bf16 x bf16 into f32, exact, summed in f32; ds is f32
// and unrounded, so it enters dQ += dS K and dK += dS^T Q as three bf16
// parts (hi, the remainder's hi, its remainder: 24 bits, an f32's), each
// an mma.  Bound: nine score-shaped products a live pair (S and dP in both
// kernels, dV, three parts each of dQ and dK; plus the row statistics'
// passes over a longer walk) at the tensor cores' rate, and the per-pair
// exp and IEEE divisions; at the MT shapes the bytes and the two launches'
// latency.

#include "attn_util.cuh"
#include "hopper.cuh"
#include "split.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// -- f32: the warp-level split-precision kernels -------------------------------

template <int D>
struct Mb {
  // warps (of 16 rows or keys) a block: at d 128 the dQ kernel's resident
  // Q and dO planes take the shared memory of two warps' rows only
  static constexpr int DKV_WARPS = 4, DQ_WARPS = D == 128 ? 2 : 4;
  // keys of a dQ kernel's tile and query rows of a dK/dV kernel's: the
  // wider the head, the narrower the tile, so that S, dP and the gradients
  // stay in registers (dK and dV take 128 a thread at d 128)
  static constexpr int BN = D == 32 ? 48 : D == 64 ? 32 : 16;
  static constexpr int BQ = D == 32 ? 64 : D == 64 ? 32 : 16;
  static constexpr int ND = D / 8, NP = sp::NP;
  static constexpr int ROW = D * 2 + 16, FROW = D * 4 + 16;
  // the planes of two resident operands of `rows` rows and two streamed
  // ones of `tile_rows`, and (a walk of more than one tile) the streamed
  // ones staged as f32
  static constexpr size_t smem(int rows, int tile_rows, bool staged) {
    return size_t(NP) * (2 * rows + 2 * tile_rows) * ROW +
           (staged ? size_t(2 * tile_rows) * FROW : 0);
  }
};

// dQ in f32, query-major, the TPU kernels' formulas from (lse, di): a
// block of W warps (W = min(4, cdiv(n_q, 16)); two at d 128) owns 16 W
// query rows of one (batch, head), their Q (scaled by scale_log2, as the
// forward's) and dO resident as bf16 planes, and walks the key tiles of 8
// NJ keys (the forward's) its rows see (K and V staged as f32 by cp.async,
// the next tile loading behind this one's products, and split once a tile
// into planes).  Per tile a warp computes S (sp::tile_product, the
// forward's S bit for bit: p = exp2(s - lse log2(e)) is the forward's
// probability), dP = dO V^T, then dS = p (dP - di) sm_scale and dQ += dS K.
template <int D, int NJ>
__global__ void __launch_bounds__(Mb<D>::DQ_WARPS * 32)
flash_bwd_dq_f32_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ di,
                            const int* __restrict__ kv_lengths, const int* __restrict__ gate,
                            float* __restrict__ dq, int h, int h_kv, int n_q, int n_kv, int causal,
                            int window, float sm_scale, float scale_log2) {
  if (gate != nullptr && *gate == 0) return;
  using C = Mb<D>;
  constexpr int TK = 8 * NJ, ND = C::ND, NP = C::NP, FROW = C::FROW, ROW = C::ROW;
  constexpr int tile_rows = TK;
  extern __shared__ __align__(16) uint8_t mma_smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / h, hq = bh % h, hk = hq / (h / h_kv);
  const int bm = 16 * warps;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * bm;   // the longest walks first
  const int n_rows = min(bm, n_q - row0);
  const float* kp = k + (size_t(b) * h_kv + hk) * size_t(n_kv) * D;
  const float* vp = v + (size_t(b) * h_kv + hk) * size_t(n_kv) * D;
  const int kv_len = kv_lengths != nullptr ? min(n_kv, max(kv_lengths[b], 0)) : n_kv;

  int b_lo, b_hi, lo_, hi_;
  fa::dense_bounds(row0, kv_len, causal, window, b_lo, hi_);
  fa::dense_bounds(row0 + n_rows - 1, kv_len, causal, window, lo_, b_hi);
  const int start = b_hi > b_lo ? b_lo / TK * TK : 0, end = b_hi > b_lo ? b_hi : 0;
  const int n_tiles = (end - start + TK - 1) / TK;
  uint8_t* q_pl = mma_smem;
  uint8_t* do_pl = q_pl + NP * bm * ROW;
  uint8_t* k_pl = do_pl + NP * bm * ROW;
  uint8_t* v_pl = k_pl + NP * tile_rows * ROW;
  uint8_t* kv_f32 = v_pl + NP * tile_rows * ROW;   // a later K tile, then its V tile
  const int q_plane = bm * ROW, kv_plane = tile_rows * ROW;
  auto load_kv = [&](int i) {
    const int kt = start + i * TK;
    hop::load_rows_padded<D * 4>(kv_f32, kp + size_t(kt) * D, kp, n_kv - kt, TK);
    hop::load_rows_padded<D * 4>(kv_f32 + TK * FROW, vp + size_t(kt) * D, vp, n_kv - kt, TK);
  };
  const size_t q_off = (size_t(bh) * n_q + row0) * D;
  if (n_tiles > 1) load_kv(1);
  hop::cp_async_commit();
  {
    const int kv_valid = n_tiles > 0 ? n_kv - start : 0;
    const sp::RowsJob jobs[4] = {
        {q + q_off, n_rows, bm, q_pl, q_plane, scale_log2},
        {dout + q_off, n_rows, bm, do_pl, q_plane, 1.f},
        {kp + size_t(start) * D, kv_valid, TK, k_pl, kv_plane, 1.f},
        {vp + size_t(start) * D, kv_valid, TK, v_pl, kv_plane, 1.f}};
    sp::split_rows_ldg<D>(jobs);
  }

  const int wr0 = 16 * warp;
  const bool live_warp = wr0 < n_rows;
  int lo[2], hi[2], w_lo = 0, w_hi = 0, all_lo = 0, all_hi = 0;
  float lse2[2], di_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wr0 + g + 8 * hh;
    lo[hh] = hi[hh] = 0;
    lse2[hh] = di_r[hh] = 0.f;
    if (r < n_rows) {
      fa::dense_bounds(row0 + r, kv_len, causal, window, lo[hh], hi[hh]);
      lse2[hh] = lse[size_t(bh) * n_q + row0 + r] * LOG2E;
      di_r[hh] = di[size_t(bh) * n_q + row0 + r];
    }
  }
  if (live_warp) {
    fa::dense_bounds(row0 + wr0, kv_len, causal, window, w_lo, all_hi);
    fa::dense_bounds(row0 + min(wr0 + 15, n_rows - 1), kv_len, causal, window, all_lo, w_hi);
    if (w_hi <= w_lo) w_lo = w_hi = 0;
  }

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  __syncthreads();   // the resident planes and tile 0's are written
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
    const int kt = start + i * TK;
    if (!live_warp || kt >= w_hi || kt + TK <= w_lo) continue;   // the warp's rows see none
    // s[j][2hh + e], dp[j][2hh + e]: row wr0 + g + 8hh, key kt + 8j + 2t + e
    float s[NJ][4], dp[NJ][4];
    sp::tile_product<D, NJ, false, true>(s, hop::smem_u32(q_pl), q_plane, wr0,
                                         hop::smem_u32(k_pl), kv_plane, lane);
    sp::tile_product<D, NJ, false, false>(dp, hop::smem_u32(do_pl), q_plane, wr0,
                                          hop::smem_u32(v_pl), kv_plane, lane);
    const bool full = kt >= all_lo && kt + TK <= all_hi;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = kt + 8 * j + 2 * t + e;
          const bool in = full || (c >= lo[hh] && c < hi[hh]);
          const float p = in ? exp2f(s[j][2 * hh + e] - lse2[hh]) : 0.f;
          dp[j][2 * hh + e] = p * (dp[j][2 * hh + e] - di_r[hh]) * sm_scale;
        }
    sp::acc_product<D, NJ>(acc, dp, hop::smem_u32(k_pl), kv_plane, lane);   // dQ += dS K
  }
  hop::cp_async_wait<0>();
  if (!live_warp) return;
  const float one[2] = {1.f, 1.f};
  sp::store_rows<D>(dq + q_off + size_t(wr0) * D, acc, one, n_rows - wr0, lane);
}

// dK and dV in f32, key-major: a block of W warps (W = min(4, cdiv(n_kv,
// 16)); KS = 2: two warps a key slab, each taking half of every query
// tile's rows, their sums added at the end) owns 16 W keys of one (batch,
// kv head), their K and V resident as bf16 planes, and walks the query
// tiles of 8 NJ rows (BQ, or the rows
// rounded up to 16 where they are fewer; Q, dO, lse and di
// staged by cp.async, Q and dO split once a tile into planes, Q scaled by
// scale_log2 as the forward's) of every query head of its GQA group that
// can see its keys.  Per tile a warp computes S^T = K Q^T (the forward's S
// bit for bit, the pairs swapped) and dP^T = V dO^T, P^T and dS^T on the
// fragment, then dV += P^T dO and dK += dS^T Q (scaled: dK takes the scale
// back out at the end).  The group's heads sum in the same registers.  ds:
// null, or dS (b, h, n_q, n_kv rounded up to 4) f32, where the kernel
// leaves every pair's dS it computes for the dQ kernel.
// At d 32 (the MT model's heads) a block of 128 threads is held to 168
// registers, so that four blocks of the MT model's 96-thread launch share
// an SM (three at the 177 it takes unbounded: a third slower on the H100).
template <int D, int NJ, int KS>
__global__ void __launch_bounds__(Mb<D>::DKV_WARPS * 32 * KS, D == 32 && KS == 1 ? 3 : 1)
flash_bwd_dkv_f32_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ di,
                             const int* __restrict__ kv_lengths, const int* __restrict__ gate,
                             float* __restrict__ dk, float* __restrict__ dv,
                             float* __restrict__ ds, int h, int h_kv, int n_q, int n_kv,
                             int causal, int window, float sm_scale, float scale_log2) {
  if (gate != nullptr && *gate == 0) return;
  using C = Mb<D>;
  constexpr int BQ = 8 * NJ, ND = C::ND, NP = C::NP, FROW = C::FROW, ROW = C::ROW;
  constexpr int tile_rows = BQ;
  constexpr int NH = NJ / KS, TH = 8 * NH;   // a warp's n-tiles and rows of a query tile
  extern __shared__ __align__(16) uint8_t mma_smem[];
  const int slabs = blockDim.x / 32 / KS, lane = threadIdx.x % 32;
  // the warp's keys, and its rows of a query tile
  const int warp = KS == 1 ? threadIdx.x / 32 : threadIdx.x / 32 % slabs;
  const int half = KS == 1 ? 0 : threadIdx.x / 32 / slabs;
  const int g = lane / 4, t = lane % 4;
  const int bk = blockIdx.x, b = bk / h_kv, hk = bk % h_kv, group = h / h_kv;
  const int nk = 16 * slabs;
  const int k0 = blockIdx.y * nk;
  const int n_keys = min(nk, n_kv - k0);
  const int kv_len = kv_lengths != nullptr ? min(n_kv, max(kv_lengths[b], 0)) : n_kv;

  // query rows that can see a key of the block: R >= k0 when causal,
  // R < k0 + nk - 1 + window with a window, none past the valid keys
  const int r_lo = causal ? k0 : 0;
  int r_hi = window > 0 ? min(n_q, k0 + nk - 1 + window) : n_q;
  if (k0 >= kv_len) r_hi = 0;
  const int q_first = r_lo / BQ * BQ;
  const int per_head = r_hi > q_first ? (r_hi - q_first + BQ - 1) / BQ : 0;
  const int steps = group * per_head;

  uint8_t* k_pl = mma_smem;
  uint8_t* v_pl = k_pl + NP * nk * ROW;
  uint8_t* q_pl = v_pl + NP * nk * ROW;
  uint8_t* do_pl = q_pl + NP * tile_rows * ROW;
  uint8_t* q_f32 = do_pl + NP * tile_rows * ROW;   // a later Q tile, then its dO tile
  const int kv_plane = nk * ROW, q_plane = tile_rows * ROW;
  // step i: query tile q_first + (i % per_head) BQ of the group's head i / per_head
  auto head_of = [&](int i) { return size_t(b) * h + hk * group + i / per_head; };
  auto row_of = [&](int i) { return q_first + i % per_head * BQ; };
  auto load_step = [&](int i) {
    const int qt = row_of(i);
    const size_t bhq = head_of(i);
    hop::load_rows_padded<D * 4>(q_f32, q + (bhq * n_q + qt) * D, q, n_q - qt, BQ);
    hop::load_rows_padded<D * 4>(q_f32 + BQ * FROW, dout + (bhq * n_q + qt) * D, dout, n_q - qt,
                                 BQ);
  };
  const size_t kv_off = size_t(bk) * n_kv * D;
  if (steps > 1) load_step(1);
  hop::cp_async_commit();
  {
    const size_t q0 = steps > 0 ? (head_of(0) * n_q + row_of(0)) * D : 0;
    const int q_valid = steps > 0 ? n_q - row_of(0) : 0;
    const sp::RowsJob jobs[4] = {
        {k + kv_off + size_t(k0) * D, n_keys, nk, k_pl, kv_plane, 1.f},
        {v + kv_off + size_t(k0) * D, n_keys, nk, v_pl, kv_plane, 1.f},
        {q + q0, q_valid, BQ, q_pl, q_plane, scale_log2},
        {dout + q0, q_valid, BQ, do_pl, q_plane, 1.f}};
    sp::split_rows_ldg<D>(jobs);
  }

  const int wk0 = k0 + 16 * warp;   // the warp's first key
  const bool live_warp = 16 * warp < n_keys;
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  __syncthreads();   // K's and V's planes and step 0's are written
  for (int i = 0; i < steps; ++i) {
    if (i > 0) {
      hop::cp_async_wait<0>();
      __syncthreads();   // step i has landed; every warp is done with the last tile's planes
      sp::split_rows<D>(q_pl, q_plane, q_f32, BQ, scale_log2);
      sp::split_rows<D>(do_pl, q_plane, q_f32 + BQ * FROW, BQ, 1.f);
      __syncthreads();   // the planes are written; the staged tile is free
      if (i + 1 < steps) load_step(i + 1);
      hop::cp_async_commit();
    }
    const int qt = row_of(i) + half * TH;   // the warp's rows of the tile
    // the warp's keys see none of its rows
    const bool skip = (causal && wk0 > qt + TH - 1) || wk0 >= kv_len ||
                      (window > 0 && wk0 + 15 <= qt - window);
    if (!live_warp || skip) continue;
    const float* lse_h = lse + head_of(i) * n_q, *di_h = di + head_of(i) * n_q;
    // s[j][2hh + e], dp[j][2hh + e]: key wk0 + g + 8hh, row qt + 8j + 2t + e
    const uint32_t q_rows = hop::smem_u32(q_pl) + half * TH * ROW;
    const uint32_t do_rows = hop::smem_u32(do_pl) + half * TH * ROW;
    float s[NH][4], dp[NH][4];
    sp::tile_product<D, NH, true, true>(s, hop::smem_u32(k_pl), kv_plane, 16 * warp, q_rows,
                                        q_plane, lane);
    sp::tile_product<D, NH, false, false>(dp, hop::smem_u32(v_pl), kv_plane, 16 * warp, do_rows,
                                          q_plane, lane);
    const bool full = qt + TH <= n_q && wk0 + 16 <= kv_len && (!causal || wk0 + 15 <= qt) &&
                      (window <= 0 || wk0 > qt + TH - 1 - window);
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int R = qt + 8 * j + 2 * t + e;
        const bool row_in = R < n_q;
        const float lse2 = row_in ? lse_h[R] * LOG2E : 0.f, di_r = row_in ? di_h[R] : 0.f;
        int lo = 0, hi = 0;
        if (!full) fa::dense_bounds(R, kv_len, causal, window, lo, hi);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int c = wk0 + g + 8 * hh;
          const bool in = full || (R < n_q && c >= lo && c < hi);
          const float p = in ? exp2f(s[j][2 * hh + e] - lse2) : 0.f;
          s[j][2 * hh + e] = p;
          dp[j][2 * hh + e] = p * (dp[j][2 * hh + e] - di_r) * sm_scale;
        }
      }
    if (ds != nullptr) {   // dS for the dQ kernel (flash_bwd_dq_ds_f32_mma_kernel)
      const int ld = (n_kv + 3) / 4 * 4;
      float* dsh = ds + head_of(i) * n_q * ld;
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int R = qt + 8 * j + 2 * t + e, c = wk0 + g + 8 * hh;
            if (R < n_q && c < n_kv) dsh[size_t(R) * ld + c] = dp[j][2 * hh + e];
          }
    }
    sp::acc_product<D, NH>(dv_acc, s, do_rows, q_plane, lane);   // dV += P^T dO
    sp::acc_product<D, NH>(dk_acc, dp, q_rows, q_plane, lane);   // dK += dS^T Q
  }
  hop::cp_async_wait<0>();
  if constexpr (KS == 2) {
    // the second half's sums through shared memory (the planes, free now),
    // added to the first's
    float* xch = reinterpret_cast<float*>(mma_smem) + (warp * 32 + lane) * (ND * 8);
    __syncthreads();   // every warp is done with the planes
    if (half == 1) {
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xch[4 * nd + e] = dk_acc[nd][e];
          xch[4 * (ND + nd) + e] = dv_acc[nd][e];
        }
    }
    __syncthreads();
    if (half == 1) return;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk_acc[nd][e] += xch[4 * nd + e];
        dv_acc[nd][e] += xch[4 * (ND + nd) + e];
      }
  }
  if (!live_warp) return;
  // dK summed dS^T (q scale_log2): its reciprocal takes the scale back out
  const float unscale[2] = {1.f / scale_log2, 1.f / scale_log2}, one[2] = {1.f, 1.f};
  const size_t off = kv_off + size_t(wk0) * D;
  sp::store_rows<D>(dk + off, dk_acc, unscale, n_keys - 16 * warp, lane);
  sp::store_rows<D>(dv + off, dv_acc, one, n_keys - 16 * warp, lane);
}

// dQ = dS K in f32 from the dK/dV kernel's dS (a walk of fewer than
// MMA_DS_MAX_KV keys): a block of W warps owns 16 W query rows of one
// (batch, head) and walks the key tiles of 8 NJ keys its rows see (KS =
// 2: two warps a row slab, each taking half of every tile's keys, their
// sums added at the end), each tile's dS rows (zero outside a row's live
// keys) and K straight into registers and split into planes; dQ += dS K,
// the six products a chunk and n-tile summed from zero.  The forward's S
// and dP are not computed again.
template <int D, int NJ, int KS>
__global__ void __launch_bounds__(4 * 32 * KS)
flash_bwd_dq_ds_f32_mma_kernel(const float* __restrict__ ds, const float* __restrict__ k,
                               const int* __restrict__ kv_lengths, float* __restrict__ dq, int h,
                               int h_kv, int n_q, int n_kv, int causal, int window) {
  constexpr int TK = 8 * NJ, ND = D / 8, NP = sp::NP, ROW = D * 2 + 16, SROW = TK * 2 + 16;
  constexpr int NC = NJ / 2 / KS;   // a warp's 16-key chunks of a tile
  extern __shared__ __align__(16) uint8_t mma_smem[];
  const int slabs = blockDim.x / 32 / KS, lane = threadIdx.x % 32;
  // the warp's rows, and its keys of a tile
  const int warp = KS == 1 ? threadIdx.x / 32 : threadIdx.x / 32 % slabs;
  const int half = KS == 1 ? 0 : threadIdx.x / 32 / slabs;
  const int bh = blockIdx.x, b = bh / h, hq = bh % h, hk = hq / (h / h_kv);
  const int bm = 16 * slabs;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * bm;   // the longest walks first
  const int n_rows = min(bm, n_q - row0);
  const int ld = (n_kv + 3) / 4 * 4;
  const float* dsp = ds + (size_t(bh) * n_q + row0) * ld;
  const float* kp = k + (size_t(b) * h_kv + hk) * size_t(n_kv) * D;
  const int kv_len = kv_lengths != nullptr ? min(n_kv, max(kv_lengths[b], 0)) : n_kv;
  int b_lo, b_hi, lo_, hi_;
  fa::dense_bounds(row0, kv_len, causal, window, b_lo, hi_);
  fa::dense_bounds(row0 + n_rows - 1, kv_len, causal, window, lo_, b_hi);
  const int start = b_hi > b_lo ? b_lo / TK * TK : 0, end = b_hi > b_lo ? b_hi : 0;
  uint8_t* k_pl = mma_smem;
  uint8_t* s_pl = k_pl + NP * TK * ROW;
  constexpr int k_plane = TK * ROW;
  const int s_plane = bm * SROW;
  const int wr0 = 16 * warp;
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int kt = start; kt < end; kt += TK) {
    __syncthreads();   // every warp is done with the last tile's planes
    const sp::RowsJob job[1] = {{kp + size_t(kt) * D, n_kv - kt, TK, k_pl, k_plane, 1.f}};
    sp::split_rows_ldg<D>(job);
    // dS rows [row0, row0 + bm) at keys [kt, kt + TK), zero off each row's
    // live keys (the dK/dV kernel writes those alone)
    for (int i = threadIdx.x; i < bm * TK / 4; i += blockDim.x) {
      const int r = i / (TK / 4), c = kt + 4 * (i % (TK / 4));
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      int lo = 0, hi = 0;
      if (r < n_rows) fa::dense_bounds(row0 + r, kv_len, causal, window, lo, hi);
      if (c + 3 >= lo && c < hi) x = *reinterpret_cast<const float4*>(dsp + size_t(r) * ld + c);
      float e4[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < lo || c + e >= hi) e4[e] = 0.f;
      uint2 w[NP];
      sp::split_pair(e4[0], e4[1], w[0].x, w[1].x, w[2].x);
      sp::split_pair(e4[2], e4[3], w[0].y, w[1].y, w[2].y);
      uint8_t* dst = s_pl + r * SROW + 8 * (i % (TK / 4));
#pragma unroll
      for (int p = 0; p < NP; ++p) *reinterpret_cast<uint2*>(dst + p * s_plane) = w[p];
    }
    __syncthreads();   // the planes are written
    if (wr0 >= n_rows) continue;
#pragma unroll
    for (int kc = half * NC; kc < (half + 1) * NC; ++kc) {
      uint32_t a[NP][4], af[4];
      sp::frags_a(a, af, hop::smem_u32(s_pl), s_plane, SROW, wr0, 16 * kc, lane);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t bb[NP][4], bf[4];
        sp::frags_b2t(bb, bf, hop::smem_u32(k_pl), k_plane, ROW, 16 * kc, 16 * n2, lane);
        sp::mma6_add<ND>(acc, n2, a, af, bb, bf);
      }
    }
  }
  if constexpr (KS == 2) {
    // the second half's sums through shared memory, added to the first's
    float* xch = reinterpret_cast<float*>(mma_smem) + (warp * 32 + lane) * (ND * 4);
    __syncthreads();   // every warp is done with the planes
    if (half == 1) {
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[4 * nd + e] = acc[nd][e];
    }
    __syncthreads();
    if (half == 1) return;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] += xch[4 * nd + e];
  }
  if (wr0 >= n_rows) return;
  const float one[2] = {1.f, 1.f};
  sp::store_rows<D>(dq + (size_t(bh) * n_q + row0 + wr0) * D, acc, one, n_rows - wr0, lane);
}

template <int D, int NJ, int KS>
cudaError_t launch_dq_ds_ks(const float* ds, const float* k, const int* lens, float* dq, int b,
                            int h, int h_kv, int n_q, int n_kv, int causal, int window,
                            cudaStream_t stream) {
  auto kernel = flash_bwd_dq_ds_f32_mma_kernel<D, NJ, KS>;
  auto smem = [](int bm) {
    return size_t(sp::NP) * (8 * NJ * (D * 2 + 16) + bm * (8 * NJ * 2 + 16));
  };
  static cudaError_t opted = fa::allow_smem(kernel, smem(64));
  if (opted != cudaSuccess) return opted;
  const int slabs = min(4, (n_q + 15) / 16);
  dim3 grid(b * h, (n_q + 16 * slabs - 1) / (16 * slabs));
  kernel<<<grid, 32 * slabs * KS, smem(16 * slabs), stream>>>(ds, k, lens, dq, h, h_kv, n_q,
                                                              n_kv, causal, window);
  return cudaGetLastError();
}

// KS = 2 (a tile's keys split between two warps of the same rows, their
// sums added at the end) where the grid would not cover the 132 SMs and a
// tile has 32 or 64 keys
template <int D, int NJ>
cudaError_t launch_dq_ds_nj(const float* ds, const float* k, const int* lens, float* dq, int b,
                            int h, int h_kv, int n_q, int n_kv, int causal, int window,
                            cudaStream_t stream) {
  const int slabs = min(4, (n_q + 15) / 16);
  if constexpr (NJ % 4 == 0) {
    if (size_t(b) * h * ((n_q + 16 * slabs - 1) / (16 * slabs)) < 132)
      return launch_dq_ds_ks<D, NJ, 2>(ds, k, lens, dq, b, h, h_kv, n_q, n_kv, causal, window,
                                       stream);
  }
  return launch_dq_ds_ks<D, NJ, 1>(ds, k, lens, dq, b, h, h_kv, n_q, n_kv, causal, window,
                                   stream);
}

// key tiles of the walk's keys rounded up to 16, at most 64
template <int D>
cudaError_t launch_dq_ds(const float* ds, const float* k, const int* lens, float* dq, int b, int h,
                         int h_kv, int n_q, int n_kv, int causal, int window,
                         cudaStream_t stream) {
  switch (max(16, min(64, (n_kv + 15) / 16 * 16)) / 8) {
    case 2: return launch_dq_ds_nj<D, 2>(ds, k, lens, dq, b, h, h_kv, n_q, n_kv, causal, window, stream);
    case 4: return launch_dq_ds_nj<D, 4>(ds, k, lens, dq, b, h, h_kv, n_q, n_kv, causal, window, stream);
    case 6: return launch_dq_ds_nj<D, 6>(ds, k, lens, dq, b, h, h_kv, n_q, n_kv, causal, window, stream);
    default: return launch_dq_ds_nj<D, 8>(ds, k, lens, dq, b, h, h_kv, n_q, n_kv, causal, window, stream);
  }
}

// The dK/dV kernel over query tiles of 8 NJQ rows, then the dQ kernel over
// key tiles of 8 NJK keys.
template <int D, int NJQ, int NJK>
cudaError_t launch_f32_mma_nj(const float* q, const float* k, const float* v, const float* dout,
                              const float* lse, const float* di, const int* lens, float* dq,
                              float* dk, float* dv, float* ds, int b, int h, int h_kv, int n_q,
                              int n_kv, int causal, int window, float sm_scale, float scale_log2,
                              cudaStream_t stream, const int* gate) {
  using C = Mb<D>;
  // KS = 2 (each query tile's rows split between two warps of the same
  // keys, their sums added at the end) where the grid would not cover the
  // 132 SMs and a tile has 32 or 64 rows
  const int slabs = min(C::DKV_WARPS, (n_kv + 15) / 16);
  const bool split = NJQ % 4 == 0 && size_t(b) * h_kv * ((n_kv + 16 * slabs - 1) / (16 * slabs)) < 132;
  auto dkv_kernel = split ? flash_bwd_dkv_f32_mma_kernel<D, NJQ, NJQ % 4 == 0 ? 2 : 1>
                          : flash_bwd_dkv_f32_mma_kernel<D, NJQ, 1>;
  auto dq_kernel = flash_bwd_dq_f32_mma_kernel<D, NJK>;
  static cudaError_t opted = [&] {
    const size_t dkv = C::smem(16 * C::DKV_WARPS, 8 * NJQ, true);
    cudaError_t e = fa::allow_smem(flash_bwd_dkv_f32_mma_kernel<D, NJQ, 1>, dkv);
    if (e == cudaSuccess)
      e = fa::allow_smem(flash_bwd_dkv_f32_mma_kernel<D, NJQ, NJQ % 4 == 0 ? 2 : 1>, dkv);
    return e != cudaSuccess
               ? e
               : fa::allow_smem(dq_kernel, C::smem(16 * C::DQ_WARPS, 8 * NJK, true));
  }();
  if (opted != cudaSuccess) return opted;
  if (n_kv > 0) {
    const int warps = slabs;
    dim3 grid(b * h_kv, (n_kv + 16 * warps - 1) / (16 * warps));
    // one query tile of one head (n_q <= 8 NJQ, no GQA) stages nothing
    const bool staged = n_q > 8 * NJQ || h > h_kv;
    dkv_kernel<<<grid, 32 * warps * (split ? 2 : 1), C::smem(16 * warps, 8 * NJQ, staged),
                 stream>>>(
        q, k, v, dout, lse, di, lens, gate, dk, dv, ds, h, h_kv, n_q, n_kv, causal, window,
        sm_scale, scale_log2);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (n_q > 0 && ds != nullptr)
    return launch_dq_ds<D>(ds, k, lens, dq, b, h, h_kv, n_q, n_kv, causal, window, stream);
  if (n_q > 0) {
    const int warps = min(C::DQ_WARPS, (n_q + 15) / 16);
    dim3 grid(b * h, (n_q + 16 * warps - 1) / (16 * warps));
    dq_kernel<<<grid, 32 * warps, C::smem(16 * warps, 8 * NJK, n_kv > 8 * NJK), stream>>>(
        q, k, v, dout, lse, di, lens, gate, dq, h, h_kv, n_q, n_kv, causal, window, sm_scale,
        scale_log2);
  }
  return cudaGetLastError();
}

// The tiles: the rows (keys) rounded up to 16 where they are fewer than BQ
// (BN), else BQ (BN), as the forward's.  ds: null (the dQ kernel computes
// S and dP again), or the dK/dV kernel's dS scratch (see there) for the
// dQ kernel that reads it.  gate: null, or the split pass's flag, when the
// kernels run only where it is set (behind the split-precision kernels,
// C17).
template <int D>
cudaError_t launch_f32_mma(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* di, const int* lens, void* dq,
                           void* dk, void* dv, float* ds, int b, int h, int h_kv, int n_q,
                           int n_kv, int causal, int window, float sm_scale, float scale_log2,
                           cudaStream_t stream, const int* gate = nullptr) {
  constexpr int BQ = Mb<D>::BQ, BN = Mb<D>::BN;
  const int nq = max(16, min(BQ, (n_q + 15) / 16 * 16)) / 8;
  const int nk = max(16, min(BN, (n_kv + 15) / 16 * 16)) / 8;
  const auto args = [&](auto launch) {
    return launch(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(dout), lse, di, lens,
                  static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), ds,
                  b, h, h_kv, n_q, n_kv, causal, window, sm_scale, scale_log2, stream, gate);
  };
  // the instances: square tiles below BN (the MT model's 48, 2 x 16 ...),
  // BQ / BN above
#define FA_F32_MMA_BWD(NQ, NK)                                                               \
  args(launch_f32_mma_nj<D, ((NQ) < BQ / 8 ? (NQ) : BQ / 8), ((NK) < BN / 8 ? (NK) : BN / 8)>)
  const int n = max(nq, nk);
  switch (n) {
    case 2: return FA_F32_MMA_BWD(2, 2);
    case 4: return FA_F32_MMA_BWD(4, 4);
    case 6: return FA_F32_MMA_BWD(6, 6);
    default: return FA_F32_MMA_BWD(8, 8);
  }
#undef FA_F32_MMA_BWD
}

// -- bf16: the tensor-core kernels ---------------------------------------------

using bf16 = __nv_bfloat16;

template <int D>
struct Tc {
  static constexpr int THREADS = 256;             // two consumer warpgroups
  static constexpr int SW = D >= 64 ? 128 : 64;   // bytes of a swizzled row
  static constexpr int CPR = SW / 2;              // bf16 columns a region row holds
  static constexpr int BIG = 128;                 // keys (dK/dV) or rows (dQ) a block owns
  static constexpr int TILE = 64;                 // rows of a streamed tile
  static constexpr int BIG_BYTES = BIG * D * 2, TILE_BYTES = TILE * D * 2;
  static constexpr size_t SMEM =
      1024 + 2 * size_t(BIG_BYTES) + 4 * size_t(TILE_BYTES) + 4 * TILE * sizeof(float);
};

template <int D>
__device__ __forceinline__ void load_rows(uint8_t* dst, const bf16* src, const bf16* base,
                                          int rows_valid, int rows) {
  hop::load_tile<D * 2, Tc<D>::SW, Tc<D>::THREADS>(dst, src, base, rows_valid, rows);
}

// acc (64 x D) += a (64 x 64, bf16 pairs in the accumulator layout of a
// 64 x 64 wgmma) times the 64-row tile at b read MN-major: a contraction
// over the tile's rows.
template <int D>
__device__ __forceinline__ void rs_tile(float (&acc)[D / 2], const uint32_t (&a)[16],
                                        uint32_t b) {
  constexpr int SW = Tc<D>::SW;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint32_t ak[4] = {a[4 * kc], a[4 * kc + 1], a[4 * kc + 2], a[4 * kc + 3]};
    hop::wgmma_rs<1>(acc, ak, hop::desc<SW>(b + kc * 16 * SW, Tc<D>::TILE * SW, 8 * SW), 1);
  }
}

// d (64 x 64) = the 64 rows at a (a tile of a_rows rows) times the 64 rows
// at b (a tile of b_rows rows) transposed, both K-major, contracted over D.
template <int D>
__device__ __forceinline__ void ss_tile(float (&d)[32], uint32_t a, int a_rows, uint32_t b,
                                        int b_rows) {
  constexpr int SW = Tc<D>::SW, CPR = Tc<D>::CPR;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t region = ks * 16 / CPR, off = (ks * 16 % CPR) * 2;
    hop::wgmma_ss<0>(d, hop::desc<SW>(a + region * a_rows * SW + off, 16, 8 * SW),
                     hop::desc<SW>(b + region * b_rows * SW + off, 16, 8 * SW), ks > 0);
  }
}

// The f32 fragment of a 64-row warpgroup tile (rows rl + 8 hh) to bf16 in
// shared memory (rows padded by 16 bytes), then rows [0, n) of the block's
// 128 to dst in whole rows of 16-byte stores.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 2], uint8_t* stage,
                                           int rl, int quad, int n) {
  constexpr int OS = D * 2 + 16;
  __syncthreads();   // the stage is free
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(stage + (rl + 8 * hh) * OS + 2 * (8 * j + 2 * quad)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  __syncthreads();
  for (int i = threadIdx.x; i < n * (D / 8); i += Tc<D>::THREADS) {
    const int r = i / (D / 8), c = i % (D / 8) * 8;
    *reinterpret_cast<uint4*>(dst + size_t(r) * D + c) =
        *reinterpret_cast<const uint4*>(stage + r * OS + 2 * c);
  }
}

// dK/dV, key-major: a block owns 128 keys of one (batch, kv head), a
// warpgroup 64 of them, with their K and V rows resident and dK, dV in f32
// registers.  Query tiles of 64 rows (Q, dO, and lse, di per column) of
// every head of the GQA group stream through a double-buffered ring.  Per
// tile S^T = K Q^T and dP^T = V dO^T (both operands K-major), then
// P^T = exp2(S^T scale_log2 - lse2) and dS^T = P^T (dP^T - di) sm_scale on
// the fragment, rounded to bf16 pairs in place: the A operand of
// dV += P^T dO and dK += dS^T Q, with dO and Q read MN-major from the same
// tiles.
template <int D>
__global__ void __launch_bounds__(Tc<D>::THREADS, 1)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        const int* __restrict__ kv_lengths, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int h, int h_kv, int n_q, int n_kv, int causal,
                        int window, float sm_scale) {
  using C = Tc<D>;
  constexpr int SW = C::SW, BT = C::TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* v_s = k_s + C::BIG_BYTES;
  uint8_t* ring = v_s + C::BIG_BYTES;   // Q0, dO0, Q1, dO1
  float* stats = reinterpret_cast<float*>(ring + 4 * C::TILE_BYTES);   // [buf][lse | di]

  const int bk = blockIdx.x, b = bk / h_kv, hk = bk % h_kv, group = h / h_kv;
  const int k0 = blockIdx.y * C::BIG;
  const int kv_len = kv_lengths != nullptr ? min(n_kv, max(kv_lengths[b], 0)) : n_kv;
  const bf16* kp = k + size_t(bk) * n_kv * D;
  const bf16* vp = v + size_t(bk) * n_kv * D;
  const float scale_log2 = sm_scale * LOG2E;

  // query rows that can see a key of the block: R >= k0 when causal,
  // R < k0 + 127 + window with a window, none past the valid keys
  const int r_lo = causal ? k0 : 0;
  int r_hi = window > 0 ? min(n_q, k0 + C::BIG - 1 + window) : n_q;
  if (k0 >= kv_len) r_hi = 0;
  const int q_first = (r_lo / BT) * BT;
  const int per_head = r_hi > q_first ? (r_hi - q_first + BT - 1) / BT : 0;
  const int n_tiles = group * per_head;

  auto load = [&](int t, int buf) {
    const int g = t / per_head, qt = q_first + (t % per_head) * BT;
    const size_t bh = size_t(b) * h + hk * group + g;
    uint8_t* qd = ring + buf * 2 * C::TILE_BYTES;
    load_rows<D>(qd, q + (bh * n_q + qt) * D, q, n_q - qt, BT);
    load_rows<D>(qd + C::TILE_BYTES, dout + (bh * n_q + qt) * D, dout, n_q - qt, BT);
    const int i = threadIdx.x;
    if (i < 2 * BT) {
      const float* src = (i < BT ? lse : di) + bh * n_q + qt + i % BT;
      const bool ok = qt + i % BT < n_q;
      hop::cp_async<4>(hop::smem_u32(stats + buf * 2 * BT + i), ok ? src : lse, ok);
    }
  };

  load_rows<D>(k_s, kp + size_t(k0) * D, kp, n_kv - k0, C::BIG);
  load_rows<D>(v_s, vp + size_t(k0) * D, vp, n_kv - k0, C::BIG);
  if (n_tiles > 0) load(0, 0);
  hop::cp_async_commit();

  const int wg = threadIdx.x / 128, lt = threadIdx.x % 128;
  const int lane = lt % 32, quad = lane % 4;
  const int rl = wg * 64 + (lt / 32) * 16 + lane / 4;   // local key of hh = 0 (+8: hh = 1)
  const int kw0 = k0 + wg * 64;                         // the warpgroup's first key

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const uint32_t k_addr = hop::smem_u32(k_s) + wg * 64 * SW;
  const uint32_t v_addr = hop::smem_u32(v_s) + wg * 64 * SW;
  for (int t = 0, buf = 0; t < n_tiles; ++t, buf ^= 1) {
    hop::cp_async_wait<0>();
    hop::fence_async_smem();
    __syncthreads();   // tile t has landed everywhere; buffer buf ^ 1 is free
    if (t + 1 < n_tiles) load(t + 1, buf ^ 1);
    hop::cp_async_commit();

    const int qt = q_first + (t % per_head) * BT;
    // the warpgroup's keys see no query of the tile
    if ((causal && kw0 > qt + BT - 1) || kw0 >= kv_len ||
        (window > 0 && kw0 + 63 <= qt - window))
      continue;
    const uint32_t q_addr = hop::smem_u32(ring + buf * 2 * C::TILE_BYTES);
    const uint32_t do_addr = q_addr + C::TILE_BYTES;
    const float* lse_s = stats + buf * 2 * BT;
    const float* di_s = lse_s + BT;

    float s[32], dp[32];   // S^T and dP^T: 64 keys x 64 queries a warpgroup
    hop::fence_regs(s);
    hop::fence_regs(dp);
    hop::wg_arrive();
    ss_tile<D>(s, k_addr, C::BIG, q_addr, BT);
    ss_tile<D>(dp, v_addr, C::BIG, do_addr, BT);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(s);
    hop::fence_regs(dp);

    // s[4j + 2hh + e] is key k0 + rl + 8hh, query qt + 8j + 2 quad + e
    const bool full = qt + BT <= n_q && kw0 + 64 <= kv_len &&
                      (!causal || kw0 + 63 <= qt) && (window <= 0 || kw0 > qt + BT - 1 - window);
    uint32_t p[16], ds[16];   // bf16 pairs: [2j + hh] = key hh's queries 8j + 2 quad + {0, 1}
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float pv[2], dsv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * quad + e, R = qt + c, key = k0 + rl + 8 * hh;
          bool live = true;
          if (!full) {
            int lo, hi;
            fa::dense_bounds(R, kv_len, causal, window, lo, hi);
            live = R < n_q && key >= lo && key < hi;
          }
          const int i = 4 * j + 2 * hh + e;
          pv[e] = live ? exp2f(s[i] * scale_log2 - lse_s[c] * LOG2E) : 0.f;
          dsv[e] = pv[e] * (dp[i] - di_s[c]) * sm_scale;
        }
        p[2 * j + hh] = hop::pack_bf16(pv[0], pv[1]);
        ds[2 * j + hh] = hop::pack_bf16(dsv[0], dsv[1]);
      }

    hop::fence_regs(dv_acc);
    hop::fence_regs(dk_acc);
    hop::wg_arrive();
    rs_tile<D>(dv_acc, p, do_addr);
    rs_tile<D>(dk_acc, ds, q_addr);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(dv_acc);
    hop::fence_regs(dk_acc);
  }
  hop::cp_async_wait<0>();

  // the ring is free once every warpgroup is past its last wgmma
  const int n_keys = max(0, min(C::BIG, n_kv - k0));
  const size_t off = (size_t(bk) * n_kv + k0) * D;
  store_rows<D>(dk + off, dk_acc, ring, rl, quad, n_keys);
  store_rows<D>(dv + off, dv_acc, ring, rl, quad, n_keys);
}

// dQ, query-major: a block owns 128 query rows of one (batch, head), a
// warpgroup 64 of them, with their Q and dO rows resident and dQ in f32
// registers, and walks the key tiles of 64 its rows can see (K and V through
// a double-buffered ring).  Per tile S = Q K^T and dP = dO V^T (both
// K-major), P and dS on the fragment, dS rounded to bf16 pairs in place:
// the A operand of dQ += dS K, K read MN-major from the same tile.
template <int D>
__global__ void __launch_bounds__(Tc<D>::THREADS, 1)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ di,
                       const int* __restrict__ kv_lengths, bf16* __restrict__ dq, int h,
                       int h_kv, int n_q, int n_kv, int causal, int window, float sm_scale) {
  using C = Tc<D>;
  constexpr int BN = C::TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* do_s = q_s + C::BIG_BYTES;
  uint8_t* ring = do_s + C::BIG_BYTES;   // K0, V0, K1, V1

  const int bh = blockIdx.x, b = bh / h, hq = bh % h, hk = hq / (h / h_kv);
  const int row0 = (gridDim.y - 1 - blockIdx.y) * C::BIG;   // the longest walks first
  const int n_rows = min(C::BIG, n_q - row0);
  const bf16* qp = q + size_t(bh) * n_q * D;
  const bf16* dop = dout + size_t(bh) * n_q * D;
  const bf16* kp = k + (size_t(b) * h_kv + hk) * size_t(n_kv) * D;
  const bf16* vp = v + (size_t(b) * h_kv + hk) * size_t(n_kv) * D;
  const int kv_len = kv_lengths != nullptr ? min(n_kv, max(kv_lengths[b], 0)) : n_kv;
  const float scale_log2 = sm_scale * LOG2E;

  // both bounds of dense_bounds grow with the row (see flash_fwd.cu)
  int walk_lo, walk_hi, all_lo, all_hi;
  fa::dense_bounds(row0, kv_len, causal, window, walk_lo, all_hi);
  fa::dense_bounds(row0 + n_rows - 1, kv_len, causal, window, all_lo, walk_hi);
  const int start = walk_hi > walk_lo ? (walk_lo / BN) * BN : 0;
  const int end = walk_hi > walk_lo ? walk_hi : 0;

  load_rows<D>(q_s, qp + size_t(row0) * D, qp, n_rows, C::BIG);
  load_rows<D>(do_s, dop + size_t(row0) * D, dop, n_rows, C::BIG);
  if (start < end) {
    load_rows<D>(ring, kp + size_t(start) * D, kp, n_kv - start, BN);
    load_rows<D>(ring + C::TILE_BYTES, vp + size_t(start) * D, vp, n_kv - start, BN);
  }
  hop::cp_async_commit();

  const int wg = threadIdx.x / 128, lt = threadIdx.x % 128;
  const int lane = lt % 32, quad = lane % 4;
  const int rl = wg * 64 + (lt / 32) * 16 + lane / 4;   // local row of hh = 0 (+8: hh = 1)
  int lo[2], hi[2];
  float lse2[2], di_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + rl + 8 * hh;
    fa::dense_bounds(row, kv_len, causal, window, lo[hh], hi[hh]);
    const bool ok = row < n_q;
    lse2[hh] = ok ? lse[size_t(bh) * n_q + row] * LOG2E : 0.f;
    di_r[hh] = ok ? di[size_t(bh) * n_q + row] : 0.f;
  }

  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

  const uint32_t q_addr = hop::smem_u32(q_s) + wg * 64 * C::SW;
  const uint32_t do_addr = hop::smem_u32(do_s) + wg * 64 * C::SW;
  int buf = 0;
  for (int kt = start; kt < end; kt += BN, buf ^= 1) {
    hop::cp_async_wait<0>();
    hop::fence_async_smem();
    __syncthreads();   // tile kt has landed everywhere; buffer buf ^ 1 is free
    if (kt + BN < end) {
      uint8_t* nk = ring + (buf ^ 1) * 2 * C::TILE_BYTES;
      load_rows<D>(nk, kp + size_t(kt + BN) * D, kp, n_kv - kt - BN, BN);
      load_rows<D>(nk + C::TILE_BYTES, vp + size_t(kt + BN) * D, vp, n_kv - kt - BN, BN);
    }
    hop::cp_async_commit();
    const uint32_t k_addr = hop::smem_u32(ring + buf * 2 * C::TILE_BYTES);
    const uint32_t v_addr = k_addr + C::TILE_BYTES;

    float s[32], dp[32];   // S and dP: 64 rows x 64 keys a warpgroup
    hop::fence_regs(s);
    hop::fence_regs(dp);
    hop::wg_arrive();
    ss_tile<D>(s, q_addr, C::BIG, k_addr, BN);
    ss_tile<D>(dp, do_addr, C::BIG, v_addr, BN);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(s);
    hop::fence_regs(dp);

    // s[4j + 2hh + e] is row rl + 8hh, key kt + 8j + 2 quad + e
    const bool full = kt >= all_lo && kt + BN <= all_hi;
    uint32_t ds[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float dsv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = kt + 8 * j + 2 * quad + e, i = 4 * j + 2 * hh + e;
          const bool live = full || (c >= lo[hh] && c < hi[hh]);
          const float p = live ? exp2f(s[i] * scale_log2 - lse2[hh]) : 0.f;
          dsv[e] = p * (dp[i] - di_r[hh]) * sm_scale;
        }
        ds[2 * j + hh] = hop::pack_bf16(dsv[0], dsv[1]);
      }

    hop::fence_regs(dq_acc);
    hop::wg_arrive();
    rs_tile<D>(dq_acc, ds, k_addr);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(dq_acc);
  }
  hop::cp_async_wait<0>();
  store_rows<D>(dq + (size_t(bh) * n_q + row0) * D, dq_acc, ring, rl, quad, n_rows);
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* di, const int* lens, void* dq, void* dk,
                      void* dv, int b, int h, int h_kv, int n_q, int n_kv, int causal,
                      int window, float sm_scale, cudaStream_t stream) {
  using C = Tc<D>;
  auto dkv_kernel = flash_bwd_dkv_tc_kernel<D>;
  auto dq_kernel = flash_bwd_dq_tc_kernel<D>;
  static cudaError_t opted = [&] {
    cudaError_t e = fa::allow_smem(dkv_kernel, C::SMEM);
    return e != cudaSuccess ? e : fa::allow_smem(dq_kernel, C::SMEM);
  }();
  if (opted != cudaSuccess) return opted;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* dob = static_cast<const bf16*>(dout);
  if (n_kv > 0) {
    dim3 grid(b * h_kv, (n_kv + C::BIG - 1) / C::BIG);
    dkv_kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
        qb, kb, vb, dob, lse, di, lens, static_cast<bf16*>(dk), static_cast<bf16*>(dv), h,
        h_kv, n_q, n_kv, causal, window, sm_scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (n_q > 0) {
    dim3 grid(b * h, (n_q + C::BIG - 1) / C::BIG);
    dq_kernel<<<grid, C::THREADS, C::SMEM, stream>>>(qb, kb, vb, dob, lse, di, lens,
                                                     static_cast<bf16*>(dq), h, h_kv, n_q,
                                                     n_kv, causal, window, sm_scale);
  }
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(int d, const void* q, const void* k, const void* v,
                          const void* dout, const float* lse, const float* di, const int* lens,
                          void* dq, void* dk, void* dv, int b, int h, int h_kv, int n_q,
                          int n_kv, int causal, int window, float sm_scale, cudaStream_t st) {
  switch (d) {
    case 32: return launch_tc<32>(q, k, v, dout, lse, di, lens, dq, dk, dv, b, h, h_kv, n_q, n_kv, causal, window, sm_scale, st);
    case 64: return launch_tc<64>(q, k, v, dout, lse, di, lens, dq, dk, dv, b, h, h_kv, n_q, n_kv, causal, window, sm_scale, st);
    case 128: return launch_tc<128>(q, k, v, dout, lse, di, lens, dq, dk, dv, b, h, h_kv, n_q, n_kv, causal, window, sm_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// -- bf16 op graph: warp-level tensor-core kernels ----------------------------------

template <int D>
struct Ob {
  static constexpr int BN = 64;                 // keys of a dQ kernel's tile
  // query rows of a dK/dV kernel's tile: at d 128 dK and dV hold 128
  // registers a thread, so the score tiles are narrow
  static constexpr int BQ = D == 128 ? 16 : 64;
  static constexpr int ND = D / 8;
  static constexpr int ROW = D * 2 + 16;        // bytes of a padded row
  // warps a block: four, or eight over a long walk with enough blocks to
  // fill the card, halving what each row or key reads from L2
  static constexpr int MAX_WARPS = 8;
  static constexpr int NP = 3;                  // bf16 parts of the f32 dS operand
};

// The A fragments of the f32 accumulators c0, c1 (n-tiles 2 kc, 2 kc + 1)
// as NP bf16 parts whose sum is their value: hi = bf16(x), then the parts
// of the remainder x - hi, which f32 holds exactly.
template <int NP>
__device__ __forceinline__ void split_a(uint32_t (&a)[NP][4], const float (&c0)[4],
                                        const float (&c1)[4]) {
  float r0[4], r1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { r0[i] = c0[i]; r1[i] = c1[i]; }
#pragma unroll
  for (int pt = 0; pt < NP; ++pt) {
    float h0[4], h1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h0[i] = round_bf16(r0[i]);
      h1[i] = round_bf16(r1[i]);
      r0[i] -= h0[i];
      r1[i] -= h1[i];
    }
    hop::acc_to_a(a[pt], h0, h1);
  }
}

// ds of one live pair: e = exp(s - m) with s scaled; ds = (bf16(dp) / l + r)
// e sm_scale, each op rounded in f32 (torch autograd's order); rl = 1 / l
// rounded, for fa::div_rn
__device__ __forceinline__ float op_ds(float dp, float e, float l, float rl, float r,
                                       float sm_scale) {
  return __fmul_rn(__fmul_rn(__fadd_rn(fa::div_rn(round_bf16(dp), l, rl), r), e), sm_scale);
}

// dQ and the row statistics, query-major: a block of W warps (W =
// min(4, cdiv(n_q, 16)), or up to eight over a long walk) owns 16 W query
// rows of one (batch, head), a warp 16 of them as an mma.sync tile, and
// walks the key tiles of BN its rows can see (K, and V where a pass needs
// it, through a double-buffered cp.async ring).  A walk of one tile
// computes S = Q K^T and dP = dO V^T once and takes m, l, r, P and dS from
// those registers.  A longer walk
// takes three passes: the max (S), then l and r (S, dP: l summed from the
// final max, as the op graph sums it), then dS (S, dP) and dQ += dS K.
// dS, f32, enters the product as NP bf16 parts.  (m, l, r, 1 / l) go to
// ops for the dK/dV kernel.
template <int D>
__global__ void __launch_bounds__(Ob<D>::MAX_WARPS * 32)
flash_bwd_op_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const int* __restrict__ kv_lengths, float* __restrict__ ops,
                       bf16* __restrict__ dq, int h, int h_kv, int n_q, int n_kv, int causal,
                       int window, float sm_scale, int tile_rows) {
  using C = Ob<D>;
  constexpr int BN = C::BN, ROW = C::ROW, NJ = BN / 8, NP = C::NP;
  extern __shared__ __align__(16) uint8_t op_smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / h, hq = bh % h, hk = hq / (h / h_kv);
  const int bm = 16 * warps;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * bm;   // the longest walks first
  const int n_rows = min(bm, n_q - row0);
  const bf16* qp = q + size_t(bh) * n_q * D;
  const bf16* dop = dout + size_t(bh) * n_q * D;
  const bf16* kp = k + (size_t(b) * h_kv + hk) * size_t(n_kv) * D;
  const bf16* vp = v + (size_t(b) * h_kv + hk) * size_t(n_kv) * D;
  const int kv_len = kv_lengths != nullptr ? min(n_kv, max(kv_lengths[b], 0)) : n_kv;

  int walk_lo, walk_hi, lo_, hi_;
  fa::dense_bounds(row0, kv_len, causal, window, walk_lo, hi_);
  fa::dense_bounds(row0 + n_rows - 1, kv_len, causal, window, lo_, walk_hi);
  const int start = walk_hi > walk_lo ? walk_lo / BN * BN : 0;
  const int end = walk_hi > walk_lo ? walk_hi : 0;
  const int n_tiles = (end - start + BN - 1) / BN;
  const bool one = n_tiles == 1;
  const int steps = one ? 1 : 3 * n_tiles;

  const int nstage = n_kv > BN ? 2 : 1;
  uint8_t* qs = op_smem + nstage * 2 * tile_rows * ROW;
  uint8_t* dos = qs + bm * ROW;
  auto stage = [&](int st) { return op_smem + st * 2 * tile_rows * ROW; };
  auto load_step = [&](int i) {
    const int kt = start + i % n_tiles * BN;
    const int rows = (min(BN, end - kt) + 15) / 16 * 16;
    uint8_t* dst = stage(i % nstage);
    hop::load_rows_padded<D * 2>(dst, kp + size_t(kt) * D, kp, n_kv - kt, rows);
    if (one || i >= n_tiles)
      hop::load_rows_padded<D * 2>(dst + tile_rows * ROW, vp + size_t(kt) * D, vp, n_kv - kt,
                                   rows);
  };

  const int wr0 = 16 * warp;
  const bool live_warp = wr0 < n_rows;
  int lo[2], hi[2], all_lo, all_hi;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wr0 + g + 8 * hh;
    lo[hh] = hi[hh] = 0;
    if (r < n_rows) fa::dense_bounds(row0 + r, kv_len, causal, window, lo[hh], hi[hh]);
  }
  fa::dense_bounds(row0 + wr0, kv_len, causal, window, lo_, all_hi);
  fa::dense_bounds(row0 + min(wr0 + 15, n_rows - 1), kv_len, causal, window, all_lo, hi_);

  hop::load_rows_padded<D * 2>(qs, qp + size_t(row0) * D, qp, n_rows, bm);
  hop::load_rows_padded<D * 2>(dos, dop + size_t(row0) * D, dop, n_rows, bm);
  if (steps > 0) load_step(0);
  hop::cp_async_commit();

  float acc[C::ND][4];
#pragma unroll
  for (int i = 0; i < C::ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // m: the row's max (running in the first pass); l, rr: this thread's
  // columns' sums of e and of r's terms; lr, r: the row's
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rr[2] = {0.f, 0.f};
  float lr[2] = {0.f, 0.f}, r[2] = {0.f, 0.f};

  const uint32_t q_addr = hop::smem_u32(qs), do_addr = hop::smem_u32(dos);
  for (int i = 0; i < steps; ++i) {
    hop::cp_async_wait<0>();
    __syncthreads();   // step i has landed everywhere; the other stage is free
    if (i + 1 < steps) load_step(i + 1);
    hop::cp_async_commit();
    if (!live_warp) continue;
    const int pass = one ? 3 : i / n_tiles;   // 0: m; 1: l, r; 2: dS, dQ; 3: all
    const int kt = start + i % n_tiles * BN;
    const int rows = (min(BN, end - kt) + 15) / 16 * 16;
    const uint32_t k_addr = hop::smem_u32(stage(i % nstage));
    const uint32_t v_addr = k_addr + tile_rows * ROW;

    // sc[j][2hh + e], dp[j][2hh + e]: row wr0 + g + 8hh, key kt + 8j + 2t + e
    float sc[NJ][4], dp[NJ][4];
    hop::tile_scores<D, NJ>(sc, q_addr, wr0, k_addr, ROW, rows, lane);
    if (pass > 0) hop::tile_scores<D, NJ>(dp, do_addr, wr0, v_addr, ROW, rows, lane);
    const bool full = kt >= all_lo && kt + rows <= all_hi;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = __fmul_rn(sc[j][2 * hh + e], sm_scale);
          const int c = kt + 8 * j + 2 * t + e;
          if (8 * j >= rows || (!full && (c < lo[hh] || c >= hi[hh]))) x = -INFINITY;
          sc[j][2 * hh + e] = x;
          mx[hh] = fmaxf(mx[hh], x);
        }

    if (pass == 0 || pass == 3) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) m[hh] = fmaxf(m[hh], fa::row_max<4>(mx[hh]));
      if (pass == 0) continue;
    }
    // e = exp(s - m) in sc, 0 for a masked pair
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float mu = m[hh] == -INFINITY ? 0.f : m[hh];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = sc[j][2 * hh + e];
          sc[j][2 * hh + e] = x == -INFINITY ? 0.f : expf(x - mu);
        }
    }
    if (pass == 1) {
      // l and sum -bf16(dp) e from the row's final max; r = that sum / l / l
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float tl = 0.f, tr = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float ex = sc[j][2 * hh + e];
            tl += ex;
            if (ex != 0.f) tr += __fmul_rn(-round_bf16(dp[j][2 * hh + e]), ex);
          }
        l[hh] += tl;
        rr[hh] += tr;
        if (i == 2 * n_tiles - 1) {
          lr[hh] = fa::row_sum<4>(l[hh]);
          const float rs = fa::row_sum<4>(rr[hh]);
          r[hh] = lr[hh] > 0.f ? __fdiv_rn(__fdiv_rn(rs, lr[hh]), lr[hh]) : 0.f;
        }
      }
      continue;
    }
    if (pass == 3) {
      // one tile: l, then r = sum -bf16(dp) (e / l) / l, the gradient that
      // reaches l, term by term as torch's autograd rounds it
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float tl = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) tl += sc[j][2 * hh] + sc[j][2 * hh + 1];
        lr[hh] = fa::row_sum<4>(tl);
        const float rl = __frcp_rn(lr[hh]);
        float tr = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float ex = sc[j][2 * hh + e];
            if (ex != 0.f)
              tr += __fmul_rn(-round_bf16(dp[j][2 * hh + e]),
                              fa::div_rn(fa::div_rn(ex, lr[hh], rl), lr[hh], rl));
          }
        r[hh] = fa::row_sum<4>(tr);
      }
    }
    // dS in dp, then dQ += dS K over the tile's 16-key chunks
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float rl = __frcp_rn(lr[hh]);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ex = sc[j][2 * hh + e];
          dp[j][2 * hh + e] =
              ex != 0.f ? op_ds(dp[j][2 * hh + e], ex, lr[hh], rl, r[hh], sm_scale) : 0.f;
        }
    }
#pragma unroll
    for (int kc = 0; kc < NJ / 2; ++kc) {
      if (16 * kc >= rows) continue;
      uint32_t a[NP][4];
      split_a<NP>(a, dp[2 * kc], dp[2 * kc + 1]);
      hop::mma_rows<D, NP>(acc, a, k_addr, ROW, 16 * kc, lane);
    }
  }
  hop::cp_async_wait<0>();
  if (!live_warp) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rl = wr0 + g + 8 * hh, row = row0 + rl;
    if (rl >= n_rows) continue;
    bf16* out = dq + (size_t(bh) * n_q + row) * D;
#pragma unroll
    for (int nd = 0; nd < C::ND; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * nd + 2 * t) =
          __floats2bfloat162_rn(acc[nd][2 * hh], acc[nd][2 * hh + 1]);
    if (t == 0) {
      const bool live = lr[hh] > 0.f;
      *reinterpret_cast<float4*>(ops + (size_t(bh) * n_q + row) * 4) =
          make_float4(m[hh], lr[hh], live ? r[hh] : 0.f, live ? __frcp_rn(lr[hh]) : 0.f);
    }
  }
}

// dK and dV, key-major: a block of W warps (W = min(4, cdiv(n_kv, 16)),
// or up to eight over many query tiles) owns 16 W keys of one (batch, kv
// head), a warp 16 of them, with K and V resident in shared memory, and
// walks the query tiles of BQ rows (Q, dO and the rows' (m, l, r, 1 / l)
// from the dQ kernel, through a double-buffered
// ring) of every query head of its GQA group that can see its keys.  Per
// tile S^T = K Q^T and dP^T = V dO^T; P^T and dS^T on the fragment, the
// A operands of dV += P^T dO (P rounded to bf16) and dK += dS^T Q (dS as
// NP bf16 parts).  With GQA (kSeq) each head's dK and dV round to bf16
// before the group sums them in f32 (in shared memory), as the backward of
// repeating K and V does; a rounding there may move a head's sum by one
// ulp of the head's value, larger than one of the group's sum where the
// heads cancel, so those sums follow the plain version's order instead:
// P^T and dS^T go through shared memory and each head's dV and dK add up
// row by row in f32 FMAs on CUDA cores.
template <int D, bool kSeq>
__global__ void __launch_bounds__(Ob<D>::MAX_WARPS * 32)
flash_bwd_op_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const int* __restrict__ kv_lengths, const float* __restrict__ ops,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int h, int h_kv, int n_q,
                        int n_kv, int causal, int window, float sm_scale, int tile_rows) {
  using C = Ob<D>;
  constexpr int BQ = C::BQ, ROW = C::ROW, NJ = BQ / 8, NP = C::NP, ND = C::ND;
  extern __shared__ __align__(16) uint8_t op_smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bk = blockIdx.x, b = bk / h_kv, hk = bk % h_kv, group = h / h_kv;
  const int nk = 16 * warps;
  const int k0 = blockIdx.y * nk;
  const int n_keys = min(nk, n_kv - k0);
  const int kv_len = kv_lengths != nullptr ? min(n_kv, max(kv_lengths[b], 0)) : n_kv;
  const bf16* kp = k + size_t(bk) * n_kv * D;
  const bf16* vp = v + size_t(bk) * n_kv * D;

  // query rows that can see a key of the block: R >= k0 when causal,
  // R < k0 + nk - 1 + window with a window, none past the valid keys
  const int r_lo = causal ? k0 : 0;
  int r_hi = window > 0 ? min(n_q, k0 + nk - 1 + window) : n_q;
  if (k0 >= kv_len) r_hi = 0;
  const int q_first = r_lo / BQ * BQ;
  const int per_head = r_hi > q_first ? (r_hi - q_first + BQ - 1) / BQ : 0;
  const int steps = group * per_head;

  const int nstage = n_q > BQ || group > 1 ? 2 : 1;
  uint8_t* ks = op_smem;
  uint8_t* vs = ks + nk * ROW;
  uint8_t* ring = vs + nk * ROW;   // [stage][Q | dO]
  float* stats = reinterpret_cast<float*>(ring + nstage * 2 * tile_rows * ROW);   // [stage][BQ][4]
  float* grp = stats + nstage * 4 * BQ;   // GQA: [2 ND 4][threads], f32
  float* seq = grp + 2 * ND * 4 * blockDim.x + warp * 2 * 16 * (BQ + 1);   // GQA: P^T, dS^T
  auto load_step = [&](int i) {
    const int qt = q_first + i % per_head * BQ;
    const size_t bhq = size_t(b) * h + hk * group + i / per_head;
    const int rows = (min(BQ, n_q - qt) + 15) / 16 * 16;
    uint8_t* dst = ring + i % nstage * 2 * tile_rows * ROW;
    hop::load_rows_padded<D * 2>(dst, q + (bhq * n_q + qt) * D, q, n_q - qt, rows);
    hop::load_rows_padded<D * 2>(dst + tile_rows * ROW, dout + (bhq * n_q + qt) * D, dout,
                                 n_q - qt, rows);
    float* st = stats + i % nstage * 4 * BQ;
    const float* src = ops + (bhq * n_q + qt) * 4;
    for (int j = threadIdx.x; j < BQ; j += blockDim.x) {
      const bool ok = j < n_q - qt;
      hop::cp_async<16>(hop::smem_u32(st + 4 * j), ok ? src + 4 * j : ops, ok);
    }
  };

  hop::load_rows_padded<D * 2>(ks, kp + size_t(k0) * D, kp, n_keys, nk);
  hop::load_rows_padded<D * 2>(vs, vp + size_t(k0) * D, vp, n_keys, nk);
  if (steps > 0) load_step(0);
  hop::cp_async_commit();

  const int wk0 = k0 + 16 * warp;   // the warp's first key
  const bool live_warp = 16 * warp < n_keys;
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  if (kSeq)
    for (int i = 0; i < 2 * ND * 4; ++i) grp[i * blockDim.x + threadIdx.x] = 0.f;

  const uint32_t k_addr = hop::smem_u32(ks), v_addr = hop::smem_u32(vs);
  for (int i = 0; i < steps; ++i) {
    hop::cp_async_wait<0>();
    __syncthreads();   // step i has landed everywhere; the other stage is free
    if (i + 1 < steps) load_step(i + 1);
    hop::cp_async_commit();
    if (!live_warp) continue;
    const int qt = q_first + i % per_head * BQ;
    const int rows = (min(BQ, n_q - qt) + 15) / 16 * 16;
    const uint32_t q_addr = hop::smem_u32(ring + i % nstage * 2 * tile_rows * ROW);
    const uint32_t do_addr = q_addr + tile_rows * ROW;
    const float* st = stats + i % nstage * 4 * BQ;
    // the warp's keys see no query of the tile
    const bool skip = (causal && wk0 > qt + rows - 1) || wk0 >= kv_len ||
                      (window > 0 && wk0 + 15 <= qt - window);
    if (!skip) {
      // sc[j][2hh + e], dp[j][2hh + e]: key wk0 + g + 8hh, row qt + 8j + 2t + e
      float sc[NJ][4], dp[NJ][4];
      hop::tile_scores<D, NJ>(sc, k_addr, 16 * warp, q_addr, ROW, rows, lane);
      hop::tile_scores<D, NJ>(dp, v_addr, 16 * warp, do_addr, ROW, rows, lane);
      const bool full = qt + rows <= n_q && wk0 + 16 <= kv_len &&
                        (!causal || wk0 + 15 <= qt) &&
                        (window <= 0 || wk0 > qt + rows - 1 - window);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int rl = 8 * j + 2 * t + e, R = qt + rl;
          const float m = st[4 * rl], l = st[4 * rl + 1], r = st[4 * rl + 2],
                      rcp = st[4 * rl + 3];
          int lo = 0, hi = 0;
          if (!full) fa::dense_bounds(R, kv_len, causal, window, lo, hi);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int c = wk0 + g + 8 * hh;
            const bool live =
                8 * j < rows && l > 0.f && (full || (R < n_q && c >= lo && c < hi));
            const float ex = live ? expf(__fmul_rn(sc[j][2 * hh + e], sm_scale) - m) : 0.f;
            sc[j][2 * hh + e] = live ? fa::div_rn(ex, l, rcp) : 0.f;
            dp[j][2 * hh + e] = live ? op_ds(dp[j][2 * hh + e], ex, l, rcp, r, sm_scale) : 0.f;
          }
        }
      if constexpr (kSeq) {
        // P^T (rounded) and dS^T to this warp's shared memory, then each
        // (key, column) of dV and dK sums the tile's rows in order
        float* pt = seq;
        float* dst = seq + 16 * (BQ + 1);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int at = (g + 8 * hh) * (BQ + 1) + 8 * j + 2 * t + e;
              pt[at] = round_bf16(sc[j][2 * hh + e]);
              dst[at] = dp[j][2 * hh + e];
            }
        __syncwarp();
        const uint8_t* qrow = ring + i % nstage * 2 * tile_rows * ROW;
        const uint8_t* dorow = qrow + tile_rows * ROW;
        for (int rl = 0; rl < rows; ++rl) {
          const float p0 = pt[g * (BQ + 1) + rl], p1 = pt[(g + 8) * (BQ + 1) + rl];
          const float s0 = dst[g * (BQ + 1) + rl], s1 = dst[(g + 8) * (BQ + 1) + rl];
#pragma unroll
          for (int nd = 0; nd < ND; ++nd) {
            const float2 d2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                dorow + rl * ROW + (8 * nd + 2 * t) * 2));
            const float2 q2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                qrow + rl * ROW + (8 * nd + 2 * t) * 2));
            dv_acc[nd][0] = __fmaf_rn(p0, d2.x, dv_acc[nd][0]);
            dv_acc[nd][1] = __fmaf_rn(p0, d2.y, dv_acc[nd][1]);
            dv_acc[nd][2] = __fmaf_rn(p1, d2.x, dv_acc[nd][2]);
            dv_acc[nd][3] = __fmaf_rn(p1, d2.y, dv_acc[nd][3]);
            dk_acc[nd][0] = __fmaf_rn(s0, q2.x, dk_acc[nd][0]);
            dk_acc[nd][1] = __fmaf_rn(s0, q2.y, dk_acc[nd][1]);
            dk_acc[nd][2] = __fmaf_rn(s1, q2.x, dk_acc[nd][2]);
            dk_acc[nd][3] = __fmaf_rn(s1, q2.y, dk_acc[nd][3]);
          }
        }
        __syncwarp();   // the tile's P^T and dS^T are read
      } else {
#pragma unroll
        for (int kc = 0; kc < NJ / 2; ++kc) {
          if (16 * kc >= rows) continue;
          uint32_t pa[1][4], da[NP][4];
          hop::acc_to_a(pa[0], sc[2 * kc], sc[2 * kc + 1]);
          hop::mma_rows<D, 1>(dv_acc, pa, do_addr, ROW, 16 * kc, lane);
          split_a<NP>(da, dp[2 * kc], dp[2 * kc + 1]);
          hop::mma_rows<D, NP>(dk_acc, da, q_addr, ROW, 16 * kc, lane);
        }
      }
    }
    if (kSeq && i % per_head == per_head - 1) {
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          grp[(4 * nd + e) * blockDim.x + threadIdx.x] += round_bf16(dk_acc[nd][e]);
          grp[(4 * (ND + nd) + e) * blockDim.x + threadIdx.x] += round_bf16(dv_acc[nd][e]);
          dk_acc[nd][e] = dv_acc[nd][e] = 0.f;
        }
    }
  }
  hop::cp_async_wait<0>();
  if (!live_warp) return;
  if (kSeq) {
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk_acc[nd][e] = grp[(4 * nd + e) * blockDim.x + threadIdx.x];
        dv_acc[nd][e] = grp[(4 * (ND + nd) + e) * blockDim.x + threadIdx.x];
      }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kl = 16 * warp + g + 8 * hh;
    if (kl >= n_keys) continue;
    const size_t off = (size_t(bk) * n_kv + k0 + kl) * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * nd + 2 * t) =
          __floats2bfloat162_rn(dk_acc[nd][2 * hh], dk_acc[nd][2 * hh + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * nd + 2 * t) =
          __floats2bfloat162_rn(dv_acc[nd][2 * hh], dv_acc[nd][2 * hh + 1]);
    }
  }
}

// The op graph's backward: the dQ kernel (which writes the rows' (m, l, r)
// to ops), then the dK/dV kernel, which reads them.
template <int D>
cudaError_t launch_op(const void* q, const void* k, const void* v, const void* dout,
                      float* ops, const int* lens, void* dq, void* dk, void* dv, int b, int h,
                      int h_kv, int n_q, int n_kv, int causal, int window, float sm_scale,
                      cudaStream_t stream) {
  using C = Ob<D>;
  auto dq_kernel = flash_bwd_op_dq_kernel<D>;
  const int group = h / h_kv;
  auto dkv_kernel = group > 1 ? flash_bwd_op_dkv_kernel<D, true> : flash_bwd_op_dkv_kernel<D, false>;
  constexpr int kRows = 16 * C::MAX_WARPS;   // a block's query rows (dQ) or keys (dK/dV)
  // GQA's shared memory: the group sums, and P^T and dS^T a warp
  auto gqa_bytes = [](int warps) {
    return (2 * C::ND * 4 * 32 + 2 * 16 * (C::BQ + 1)) * warps * sizeof(float);
  };
  static cudaError_t opted = [&] {
    const size_t dkv = size_t(2 * kRows + 2 * 2 * C::BQ) * C::ROW + 2 * 4 * C::BQ * sizeof(float);
    cudaError_t e = fa::allow_smem(dq_kernel, size_t(2 * 2 * C::BN + 2 * kRows) * C::ROW);
    if (e == cudaSuccess) e = fa::allow_smem(flash_bwd_op_dkv_kernel<D, false>, dkv);
    return e != cudaSuccess ? e
                            : fa::allow_smem(flash_bwd_op_dkv_kernel<D, true>,
                                             dkv + gqa_bytes(4));
  }();
  if (opted != cudaSuccess) return opted;
  if (ops == nullptr) return cudaErrorInvalidValue;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* dob = static_cast<const bf16*>(dout);
  if (n_q > 0) {
    const int nstage = n_kv > C::BN ? 2 : 1;
    const bool wide = nstage == 2 && size_t(b) * h * ((n_q + 127) / 128) >= 132;
    const int warps = min(wide ? 8 : 4, (n_q + 15) / 16);
    const int tile_rows = min(C::BN, (n_kv + 15) / 16 * 16);
    const size_t smem = size_t(nstage * 2 * tile_rows + 2 * 16 * warps) * C::ROW;
    dim3 grid(b * h, (n_q + 16 * warps - 1) / (16 * warps));
    dq_kernel<<<grid, 32 * warps, smem, stream>>>(qb, kb, vb, dob, lens, ops,
                                                  static_cast<bf16*>(dq), h, h_kv, n_q, n_kv,
                                                  causal, window, sm_scale, tile_rows);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (n_kv > 0) {
    const int nstage = n_q > C::BQ || group > 1 ? 2 : 1;
    const bool wide = group == 1 && n_q > C::BQ &&
                      size_t(b) * h_kv * ((n_kv + 127) / 128) >= 132;
    const int warps = min(wide ? 8 : 4, (n_kv + 15) / 16);
    const int tile_rows = min(C::BQ, (n_q + 15) / 16 * 16);
    const size_t smem = size_t(2 * 16 * warps + nstage * 2 * tile_rows) * C::ROW +
                        nstage * 4 * C::BQ * sizeof(float) + (group > 1 ? gqa_bytes(warps) : 0);
    dim3 grid(b * h_kv, (n_kv + 16 * warps - 1) / (16 * warps));
    dkv_kernel<<<grid, 32 * warps, smem, stream>>>(qb, kb, vb, dob, lens, ops,
                                                   static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                                   h, h_kv, n_q, n_kv, causal, window, sm_scale,
                                                   tile_rows);
  }
  return cudaGetLastError();
}

cudaError_t dispatch_op(int d, const void* q, const void* k, const void* v, const void* dout,
                        float* ops, const int* lens, void* dq, void* dk, void* dv, int b, int h,
                        int h_kv, int n_q, int n_kv, int causal, int window, float sm_scale,
                        cudaStream_t st) {
  switch (d) {
    case 32: return launch_op<32>(q, k, v, dout, ops, lens, dq, dk, dv, b, h, h_kv, n_q, n_kv, causal, window, sm_scale, st);
    case 64: return launch_op<64>(q, k, v, dout, ops, lens, dq, dk, dv, b, h, h_kv, n_q, n_kv, causal, window, sm_scale, st);
    case 128: return launch_op<128>(q, k, v, dout, ops, lens, dq, dk, dv, b, h, h_kv, n_q, n_kv, causal, window, sm_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// -- f32: split precision on the tensor cores -----------------------------------

template <int D>
struct Sb {
  // two consumer warpgroups over 64 keys (dK/dV) or 64 query rows (dQ) a
  // block, the other side in tiles of 64: one warpgroup computes S and P,
  // the other dP and dS, and they trade P and dS through shared memory
  static constexpr int THREADS = 256, ROWS = 64, NP = sp::NP;
  static constexpr int SW = D >= 64 ? 128 : 64;   // bytes of a swizzled row
  static constexpr int PLANE = ROWS * D * 2;      // bytes of one plane of a 64-row tile
  // four tiles of planes, lse and di of a query tile, the P / dS exchange
  static constexpr size_t SMEM =
      1024 + 4 * NP * size_t(PLANE) + (2 * ROWS + ROWS * ROWS) * sizeof(float);
};

// The NP planes of rows [row0, row0 + 64) of a (n, D) matrix whose planes
// lie `plane` elements apart, into swizzled tiles (hop::load_tile's
// layout); rows at or past n are zero.  Threads tid = 0 .. NT - 1 share the
// copies (the block, or one warpgroup).
template <int D, int NT = Sb<D>::THREADS>
__device__ __forceinline__ void load_planes(uint8_t* dst, const bf16* src, long long plane,
                                            int row0, int n, int tid) {
  using C = Sb<D>;
  constexpr int CHUNKS = D * 2 / 16, REGION_CHUNKS = C::SW / 16;
#pragma unroll
  for (int p = 0; p < C::NP; ++p) {
    const uint8_t* s = reinterpret_cast<const uint8_t*>(src + p * plane + size_t(row0) * D);
    for (int i = tid; i < C::ROWS * CHUNKS; i += NT) {
      const int r = i / CHUNKS, c = i % CHUNKS;
      const bool ok = r < n - row0;
      uint8_t* d = dst + p * C::PLANE + (c / REGION_CHUNKS) * (C::ROWS * C::SW) +
                   hop::swz<C::SW>(r * C::SW + (c % REGION_CHUNKS) * 16);
      hop::cp_async<16>(hop::smem_u32(d), ok ? s + size_t(r) * D * 2 + c * 16 : (const void*)src,
                        ok);
    }
  }
}

// acc (64 x NCOL) += the six split products of a (sp::rs_pairs) times NCOL
// columns of the 64-row tile at b (MN-major, b at their first region), in
// chunks of at most 64 columns (one region), each summed from zero and
// then added to acc in f32 (sp::pair_a).
template <int D, int NCOL = D>
__device__ __forceinline__ void promoted_rs(float (&acc)[NCOL / 2],
                                            const uint32_t (&a)[sp::NP][16], uint32_t b) {
  using C = Sb<D>;
  constexpr int N = NCOL > 64 ? 64 : NCOL;
#pragma unroll
  for (int ch = 0; ch < NCOL / N; ++ch) {
    float t[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) t[i] = 0.f;
    hop::fence_regs(t);
    hop::wg_arrive();
    sp::rs_pairs<N, C::SW, false, 0, 6>(t, a, b + ch * C::ROWS * C::SW, C::PLANE);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(t);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[ch * N / 2 + i] += t[i];
  }
}

// d (64 x 64) = the six split products of the 64-row tile at a times the
// 64-row tile at b transposed, both K-major, waited for; kSwap: a holds the
// B pieces of the product (sp::ss_pairs).
template <int D, bool kSwap = false>
__device__ __forceinline__ void split_ss(float (&d)[32], uint32_t a, uint32_t b) {
  using C = Sb<D>;
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  hop::fence_regs(d);
  hop::wg_arrive();
  sp::ss_pairs<D, C::SW, false, 0, 6, kSwap>(d, a, C::PLANE, C::ROWS * C::SW, b, C::PLANE,
                                             C::ROWS * C::SW);
  hop::wg_commit();
  hop::wg_wait<0>();
  hop::fence_regs(d);
}

// Rows [0, n) of a warpgroup's 64-row fragment of NCOL columns to dst (rows
// D apart).
template <int D, int NCOL = D>
__device__ __forceinline__ void store_f32_rows(float* dst, const float (&acc)[NCOL / 2], int rl,
                                               int quad, int n) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rl + 8 * hh;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < NCOL / 8; ++j)
      *reinterpret_cast<float2*>(dst + size_t(r) * D + 8 * j + 2 * quad) =
          make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
}

// dK/dV in f32, key-major: a block owns 64 keys of one (batch, kv head),
// their K and V planes resident, and walks every query tile of 64 rows (Q
// and dO planes, lse and di) of each head of the GQA group that sees one of
// its keys.  Warpgroup 1 computes S^T = K Q^T (Q scaled: the forward's S,
// transposed) and P^T, hands P^T to warpgroup 0 through shared memory and
// sums dV += P^T dO; warpgroup 0 computes dP^T = V dO^T, then dS^T from
// P^T, and sums dK += dS^T Q.  Each product is six wgmmas a k16 step (the
// score products K-major; P^T and dS^T split in registers into the A
// operand, Q and dO read MN-major; promoted_rs).  Twelve of the 24 products
// a tile fall to each warpgroup, so one's exponentials and splits run
// beside the other's wgmmas.
template <int D>
__global__ void __launch_bounds__(Sb<D>::THREADS, 1)
flash_bwd_dkv_f32_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         const int* __restrict__ kv_lengths, const int* __restrict__ nf,
                         float* __restrict__ dk, float* __restrict__ dv, long long q_plane,
                         long long kv_plane, int h, int h_kv, int n_q, int n_kv, int causal,
                         int window, float sm_scale, float scale_log2) {
  if (*nf != 0) return;   // a +-inf: the warp-level kernels compute the call
  using C = Sb<D>;
  constexpr int BT = C::ROWS, NP = C::NP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* v_s = k_s + NP * C::PLANE;
  uint8_t* q_s = v_s + NP * C::PLANE;
  uint8_t* do_s = q_s + NP * C::PLANE;
  float* stats = reinterpret_cast<float*>(do_s + NP * C::PLANE);   // lse | di
  float* xch = stats + 2 * BT;   // P^T, [i][thread of the warpgroup]

  const int bk = blockIdx.x, b = bk / h_kv, hk = bk % h_kv, group = h / h_kv;
  const int k0 = blockIdx.y * BT;
  const int kv_len = kv_lengths != nullptr ? min(n_kv, max(kv_lengths[b], 0)) : n_kv;

  // query rows that can see a key of the block: R >= k0 when causal,
  // R < k0 + 63 + window with a window, none past the valid keys
  const int r_lo = causal ? k0 : 0;
  int r_hi = window > 0 ? min(n_q, k0 + BT - 1 + window) : n_q;
  if (k0 >= kv_len) r_hi = 0;
  const int q_first = r_lo / BT * BT;
  const int per_head = r_hi > q_first ? (r_hi - q_first + BT - 1) / BT : 0;
  const int n_tiles = group * per_head;
  auto head = [&](int t) { return size_t(b) * h + hk * group + t / per_head; };
  auto tile_row = [&](int t) { return q_first + t % per_head * BT; };
  auto load_tile = [&](int t) {   // Q and dO planes, lse and di of tile t
    const size_t bh = head(t);
    const int qt = tile_row(t), i = threadIdx.x;
    load_planes<D>(q_s, q + bh * n_q * D, q_plane, qt, n_q, i);
    load_planes<D>(do_s, dout + bh * n_q * D, q_plane, qt, n_q, i);
    if (i < 2 * BT) {
      const float* src = (i < BT ? lse : di) + bh * n_q + qt + i % BT;
      const bool ok = qt + i % BT < n_q;
      hop::cp_async<4>(hop::smem_u32(stats + i), ok ? src : lse, ok);
    }
  };

  const size_t kv_off = size_t(bk) * n_kv * D;
  load_planes<D>(k_s, k + kv_off, kv_plane, k0, n_kv, threadIdx.x);
  load_planes<D>(v_s, v + kv_off, kv_plane, k0, n_kv, threadIdx.x);
  if (n_tiles > 0) load_tile(0);
  hop::cp_async_commit();

  const int wg = threadIdx.x / 128, lt = threadIdx.x % 128;
  const int lane = lt % 32, quad = lane % 4;
  const int rl = (lt / 32) * 16 + lane / 4;   // local key of hh = 0 (+8: hh = 1)
  float acc[D / 2];   // dK (warpgroup 0) or dV (warpgroup 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const uint32_t k_addr = hop::smem_u32(k_s), v_addr = hop::smem_u32(v_s);
  const uint32_t q_addr = hop::smem_u32(q_s), do_addr = hop::smem_u32(do_s);
  for (int t = 0; t < n_tiles; ++t) {
    const int qt = tile_row(t);
    hop::cp_async_wait<0>();
    hop::fence_async_smem();
    __syncthreads();   // tile t has landed everywhere
    // x[4j + 2hh + e] is key k0 + rl + 8hh, query qt + 8j + 2 quad + e
    float x[32];
    uint32_t pa[NP][16];
    if (wg == 1) {
      split_ss<D, true>(x, k_addr, q_addr);   // S^T
      const bool full = qt + BT <= n_q && k0 + BT <= kv_len && (!causal || k0 + BT - 1 <= qt) &&
                        (window <= 0 || k0 > qt + BT - 1 - window);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * quad + e, R = qt + c, key = k0 + rl + 8 * hh;
            bool live = true;
            if (!full) {
              int lo, hi;
              fa::dense_bounds(R, kv_len, causal, window, lo, hi);
              live = R < n_q && key >= lo && key < hi;
            }
            const int i = 4 * j + 2 * hh + e;
            x[i] = live ? exp2f(x[i] - stats[c] * LOG2E) : 0.f;
            xch[i * 128 + lt] = x[i];
          }
      hop::bar_arrive(1, C::THREADS);   // P^T is in the exchange
      sp::split_tile(pa, x);
      promoted_rs<D>(acc, pa, do_addr);   // dV += P^T dO
    } else {
      split_ss<D>(x, v_addr, do_addr);   // dP^T
      hop::bar_sync(1, C::THREADS);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
            x[i] = xch[i * 128 + lt] * (x[i] - stats[BT + 8 * j + 2 * quad + e]) * sm_scale;
          }
      sp::split_tile(pa, x);
      promoted_rs<D>(acc, pa, q_addr);   // dK += dS^T Q
    }
    __syncthreads();   // tile t and the exchange are read
    if (t + 1 < n_tiles) load_tile(t + 1);
    hop::cp_async_commit();
  }
  hop::cp_async_wait<0>();
  const int n_keys = max(0, min(BT, n_kv - k0));
  if (wg == 0) {
    // dK summed dS^T (q scale_log2): its reciprocal takes the scale back out
    const float unscale = 1.f / scale_log2;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= unscale;
  }
  store_f32_rows<D>((wg == 0 ? dk : dv) + kv_off + size_t(k0) * D, acc, rl, quad, n_keys);
}

// dQ in f32, query-major: a block owns 64 query rows of one (batch, head),
// their Q and dO planes resident, and walks the key tiles of 64 its rows
// see.  Warpgroup 0 computes S = Q K^T (Q scaled: the forward's S) and P,
// warpgroup 1 dP = dO V^T and, from P, dS; then each sums its half of dQ's
// columns (d 128; below, warpgroup 0 all of them) += dS K (K read MN-major;
// promoted_rs).  V's next tile loads behind this tile's dS and dQ, K's
// behind nothing.
template <int D>
__global__ void __launch_bounds__(Sb<D>::THREADS, 1)
flash_bwd_dq_f32_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        const int* __restrict__ kv_lengths, const int* __restrict__ nf,
                        float* __restrict__ dq, long long q_plane, long long kv_plane, int h,
                        int h_kv, int n_q, int n_kv, int causal, int window, float sm_scale,
                        float scale_log2) {
  if (*nf != 0) return;   // a +-inf: the warp-level kernels compute the call
  using C = Sb<D>;
  constexpr int BN = C::ROWS, NP = C::NP;
  // dQ's columns a warpgroup holds: d 128 splits them, 64 each
  constexpr int NQ = D == 128 ? 64 : D;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* do_s = q_s + NP * C::PLANE;
  uint8_t* k_s = do_s + NP * C::PLANE;
  uint8_t* v_s = k_s + NP * C::PLANE;
  float* xch = reinterpret_cast<float*>(v_s + NP * C::PLANE) + 2 * C::ROWS;   // P, then dS

  const int bh = blockIdx.x, b = bh / h, hq = bh % h, hk = hq / (h / h_kv);
  const int row0 = (gridDim.y - 1 - blockIdx.y) * C::ROWS;   // the longest walks first
  const int n_rows = min(C::ROWS, n_q - row0);
  const bf16* qp = q + size_t(bh) * n_q * D;
  const bf16* dop = dout + size_t(bh) * n_q * D;
  const bf16* kp = k + (size_t(b) * h_kv + hk) * size_t(n_kv) * D;
  const bf16* vp = v + (size_t(b) * h_kv + hk) * size_t(n_kv) * D;
  const int kv_len = kv_lengths != nullptr ? min(n_kv, max(kv_lengths[b], 0)) : n_kv;

  // both bounds of dense_bounds grow with the row
  int walk_lo, walk_hi, all_lo, all_hi;
  fa::dense_bounds(row0, kv_len, causal, window, walk_lo, all_hi);
  fa::dense_bounds(row0 + n_rows - 1, kv_len, causal, window, all_lo, walk_hi);
  const int start = walk_hi > walk_lo ? walk_lo / BN * BN : 0;
  const int end = walk_hi > walk_lo ? walk_hi : 0;

  if (start < end) {
    load_planes<D>(q_s, qp, q_plane, row0, n_q, threadIdx.x);
    load_planes<D>(do_s, dop, q_plane, row0, n_q, threadIdx.x);
    load_planes<D>(k_s, kp, kv_plane, start, n_kv, threadIdx.x);
    load_planes<D>(v_s, vp, kv_plane, start, n_kv, threadIdx.x);
  }
  hop::cp_async_commit();

  const int wg = threadIdx.x / 128, lt = threadIdx.x % 128;
  const int lane = lt % 32, quad = lane % 4;
  const int rl = (lt / 32) * 16 + lane / 4;   // local row of hh = 0 (+8: hh = 1)
  int lo[2], hi[2];
  float lse2[2], di_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + rl + 8 * hh;
    fa::dense_bounds(row, kv_len, causal, window, lo[hh], hi[hh]);
    const bool ok = row < n_q;
    lse2[hh] = ok ? lse[size_t(bh) * n_q + row] * LOG2E : 0.f;
    di_r[hh] = ok ? di[size_t(bh) * n_q + row] : 0.f;
  }

  const bool has_dq = D == 128 || wg == 0;
  float acc[NQ / 2];
#pragma unroll
  for (int i = 0; i < NQ / 2; ++i) acc[i] = 0.f;
  const uint32_t q_addr = hop::smem_u32(q_s), do_addr = hop::smem_u32(do_s);
  const uint32_t k_addr = hop::smem_u32(k_s), v_addr = hop::smem_u32(v_s);
  const uint32_t k_cols = k_addr + (D == 128 ? wg * C::ROWS * C::SW : 0);
  for (int kt = start; kt < end; kt += BN) {
    const bool next = kt + BN < end;
    hop::cp_async_wait<0>();
    hop::fence_async_smem();
    __syncthreads();   // K(kt) and V(kt) have landed everywhere
    // x[4j + 2hh + e] is row rl + 8hh, key kt + 8j + 2 quad + e: S then P,
    // or dP; then dS in both warpgroups
    float x[32];
    if (wg == 0) {
      split_ss<D>(x, q_addr, k_addr);   // S
      const bool full = kt >= all_lo && kt + BN <= all_hi;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = kt + 8 * j + 2 * quad + e, i = 4 * j + 2 * hh + e;
            const bool live = full || (c >= lo[hh] && c < hi[hh]);
            xch[i * 128 + lt] = live ? exp2f(x[i] - lse2[hh]) : 0.f;
          }
      hop::bar_arrive(1, C::THREADS);   // P is in the exchange
      hop::bar_sync(2, C::THREADS);     // dS is
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = xch[i * 128 + lt];
    } else {
      split_ss<D>(x, do_addr, v_addr);   // dP
      // V(kt) is read: warpgroup 1 alone loads the next V
      if (next) load_planes<D, 128>(v_s, vp, kv_plane, kt + BN, n_kv, lt);
      hop::cp_async_commit();
      hop::bar_sync(1, C::THREADS);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
            x[i] = xch[i * 128 + lt] * (x[i] - di_r[hh]) * sm_scale;
            xch[i * 128 + lt] = x[i];
          }
      hop::bar_arrive(2, C::THREADS);
    }
    if (has_dq) {
      uint32_t pa[NP][16];
      sp::split_tile(pa, x);
      promoted_rs<D, NQ>(acc, pa, k_cols);   // dQ += dS K
    }
    __syncthreads();   // K(kt) and the exchange are read
    if (next) load_planes<D>(k_s, kp, kv_plane, kt + BN, n_kv, threadIdx.x);
    hop::cp_async_commit();
  }
  hop::cp_async_wait<0>();
  if (has_dq)
    store_f32_rows<D, NQ>(dq + (size_t(bh) * n_q + row0) * D + (D == 128 ? wg * 64 : 0), acc, rl,
                          quad, n_rows);
}

// Split q, dout, k and v into bf16 planes (in `planes`: 3 q_elems for q
// and for dout, then 3 kv_elems for k and for v), then the dK/dV kernel,
// then the dQ kernel, then the warp-level pair gated on the split pass's
// +-inf flag nf (C17).
template <int D>
cudaError_t launch_f32_tc(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* di, const int* lens, void* dq, void* dk,
                          void* dv, void* planes, int* nf, int b, int h, int h_kv, int n_q,
                          int n_kv, int causal, int window, float sm_scale, float scale_log2,
                          cudaStream_t stream) {
  using C = Sb<D>;
  auto dkv_kernel = flash_bwd_dkv_f32_kernel<D>;
  auto dq_kernel = flash_bwd_dq_f32_kernel<D>;
  static cudaError_t opted = [&] {
    cudaError_t e = fa::allow_smem(dkv_kernel, C::SMEM);
    return e != cudaSuccess ? e : fa::allow_smem(dq_kernel, C::SMEM);
  }();
  if (opted != cudaSuccess) return opted;
  const long long q_elems = (long long)b * h * n_q * D, kv_elems = (long long)b * h_kv * n_kv * D;
  bf16* qs = static_cast<bf16*>(planes);
  bf16* dos = qs + 3 * q_elems;
  bf16* ks = dos + 3 * q_elems;
  bf16* vs = ks + 3 * kv_elems;
  cudaError_t e = cudaMemsetAsync(nf, 0, sizeof(int), stream);
  if (e != cudaSuccess) return e;
  sp::SplitJobs jobs = {{static_cast<const float*>(q), static_cast<const float*>(dout),
                         static_cast<const float*>(k), static_cast<const float*>(v)},
                        {qs, dos, ks, vs},
                        {q_elems, q_elems, kv_elems, kv_elems},
                        {scale_log2, 1.f, 1.f, 1.f},
                        {nf, nf, nf, nf}};
  e = sp::split(jobs, 4, stream);
  if (e != cudaSuccess) return e;
  if (n_kv > 0) {
    dim3 grid(b * h_kv, (n_kv + C::ROWS - 1) / C::ROWS);
    dkv_kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
        qs, ks, vs, dos, lse, di, lens, nf, static_cast<float*>(dk), static_cast<float*>(dv),
        q_elems, kv_elems, h, h_kv, n_q, n_kv, causal, window, sm_scale, scale_log2);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (n_q > 0) {
    dim3 grid(b * h, (n_q + C::ROWS - 1) / C::ROWS);
    dq_kernel<<<grid, C::THREADS, C::SMEM, stream>>>(qs, ks, vs, dos, lse, di, lens, nf,
                                                     static_cast<float*>(dq), q_elems, kv_elems, h,
                                                     h_kv, n_q, n_kv, causal, window, sm_scale,
                                                     scale_log2);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return launch_f32_mma<D>(q, k, v, dout, lse, di, lens, dq, dk, dv, nullptr, b, h, h_kv, n_q,
                           n_kv, causal, window, sm_scale, scale_log2, stream, nf);
}

cudaError_t dispatch_f32_tc(int d, const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* di, const int* lens, void* dq, void* dk,
                            void* dv, void* planes, int* nf, int b, int h, int h_kv, int n_q,
                            int n_kv, int causal, int window, float sm_scale, float scale_log2,
                            cudaStream_t st) {
  switch (d) {
    case 32: return launch_f32_tc<32>(q, k, v, dout, lse, di, lens, dq, dk, dv, planes, nf, b, h, h_kv, n_q, n_kv, causal, window, sm_scale, scale_log2, st);
    case 64: return launch_f32_tc<64>(q, k, v, dout, lse, di, lens, dq, dk, dv, planes, nf, b, h, h_kv, n_q, n_kv, causal, window, sm_scale, scale_log2, st);
    case 128: return launch_f32_tc<128>(q, k, v, dout, lse, di, lens, dq, dk, dv, planes, nf, b, h, h_kv, n_q, n_kv, causal, window, sm_scale, scale_log2, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_f32_mma(int d, const void* q, const void* k, const void* v,
                             const void* dout, const float* lse, const float* di, const int* lens,
                             void* dq, void* dk, void* dv, float* ds, int b, int h, int h_kv,
                             int n_q, int n_kv, int causal, int window, float sm_scale,
                             float scale_log2, cudaStream_t st) {
  switch (d) {
    case 32: return launch_f32_mma<32>(q, k, v, dout, lse, di, lens, dq, dk, dv, ds, b, h, h_kv, n_q, n_kv, causal, window, sm_scale, scale_log2, st);
    case 64: return launch_f32_mma<64>(q, k, v, dout, lse, di, lens, dq, dk, dv, ds, b, h, h_kv, n_q, n_kv, causal, window, sm_scale, scale_log2, st);
    case 128: return launch_f32_mma<128>(q, k, v, dout, lse, di, lens, dq, dk, dv, ds, b, h, h_kv, n_q, n_kv, causal, window, sm_scale, scale_log2, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dout, dq (b, h, n_q, d); k, v, dk, dv (b, h_kv, n_kv, d); lse and di
// (b, h, n_q) f32, lse in natural log.  kv_lengths (b,) int32 or null;
// window <= 0 means none.  dtype: 1 = bfloat16 (f32 has its own entry
// points below).  op_graph = 0: the TPU kernels' backward from (lse, di): the dK/dV
// kernel, then the dQ kernel.  op_graph = 1 (bfloat16): autodiff of the op
// graph; lse and di are unused, ops (b, h, n_q, 4) f32 is the scratch in
// which the dQ kernel leaves each row's (m, l, r, 1 / l) for the dK/dV
// kernel.
extern "C" int fa_flash_bwd(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* di,
                            void* ops, const void* kv_lengths, void* dq, void* dk,
                            void* dv, int b, int h, int h_kv, int n_q, int n_kv, int d,
                            int causal, int window, float sm_scale, int dtype,
                            int op_graph, void* stream) {
  if (b == 0 || h == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_lengths);
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(di);
  if (dtype == 1 && op_graph)
    return dispatch_op(d, q, k, v, dout, static_cast<float*>(ops), lens, dq, dk, dv, b, h,
                       h_kv, n_q, n_kv, causal, window, sm_scale, st);
  if (dtype == 1)
    return dispatch_bf16(d, q, k, v, dout, l, dd, lens, dq, dk, dv, b, h, h_kv, n_q, n_kv,
                         causal, window, sm_scale, st);
  return int(cudaErrorInvalidValue);
}

// The f32 backward sized to the rows (the warp-level kernels): q, k, v,
// dout, dq, dk, dv f32 as fa_flash_bwd's, the TPU kernels' backward from
// (lse, di); scale_log2: the forward's (fa_flash_fwd_f32_mma's), folded
// into q for S as there, so that S is the forward's bit for bit and p =
// exp2(s - lse log2(e)) sums to 1 against the forward's lse.  ds: null, or
// f32 scratch of b h n_q (n_kv rounded up to 4): the dK/dV kernel leaves
// dS there and the dQ kernel reads it instead of computing S and dP again.
extern "C" int fa_flash_bwd_f32_mma(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* di,
                                    const void* kv_lengths, void* dq, void* dk, void* dv, void* ds,
                                    int b, int h, int h_kv, int n_q, int n_kv, int d, int causal,
                                    int window, float sm_scale, float scale_log2, void* stream) {
  if (b == 0 || h == 0) return 0;
  return dispatch_f32_mma(d, q, k, v, dout, static_cast<const float*>(lse),
                          static_cast<const float*>(di), static_cast<const int*>(kv_lengths), dq,
                          dk, dv, static_cast<float*>(ds), b, h, h_kv, n_q, n_kv, causal, window,
                          sm_scale, scale_log2, static_cast<cudaStream_t>(stream));
}

// The f32 backward on the tensor cores in split precision (split.cuh):
// arguments as fa_flash_bwd_f32_mma's, with planes: bf16 scratch of 3 (2
// q's elements + 2 k's elements), nf: an int of scratch (the split pass's
// flag of a +-inf in q, dout, k or v, on which the split kernels exit and
// the warp-level kernels run instead, C17), and scale_log2: the forward's
// (fa_flash_fwd_f32's), folded into q before the split as there, so that
// S is the forward's bit for bit and p = exp2(s - lse log2(e)) sums to 1
// against the forward's lse (the tensor cores' truncation of S cancels).
extern "C" int fa_flash_bwd_f32(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* di,
                                const void* kv_lengths, void* dq, void* dk, void* dv,
                                void* planes, void* nf, int b, int h, int h_kv, int n_q, int n_kv,
                                int d, int causal, int window, float sm_scale, float scale_log2,
                                void* stream) {
  if (b == 0 || h == 0) return 0;
  return dispatch_f32_tc(d, q, k, v, dout, static_cast<const float*>(lse),
                         static_cast<const float*>(di), static_cast<const int*>(kv_lengths), dq,
                         dk, dv, planes, static_cast<int*>(nf), b, h, h_kv, n_q, n_kv, causal,
                         window, sm_scale, scale_log2, static_cast<cudaStream_t>(stream));
}
