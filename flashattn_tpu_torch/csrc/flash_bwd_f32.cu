// Flash-attention backward in f32: dq, dk, dv of o = softmax(q k^T * sm_scale) v,
// recomputing the probabilities from q, k and the forward's lse, on the
// tensor cores in split precision (split.cuh).
//
// Replaces, in f32, the TPU kernels flash_bwd.cu replaces (the grid, subrow
// and loop backward of flashattn_tpu/ops/flash_attention.py, and below 1024
// keys XLA's op graph, whose f32 function is the same to f32 rounding).
// The math (base 2, from lse and di = rowsum(o * do)), the key-major dK/dV
// and query-major dQ kernels, and the head dims (d <= 128, d % 8 == 0: the
// 32-, 64- or 128-column tile zero-padded as it loads, d the row stride,
// an instance compiled for d == D) are flash_bwd.cu's.
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

#include "attn_util.cuh"
#include "hopper.cuh"
#include "split.cuh"

namespace {

using bf16 = __nv_bfloat16;
using fa::LOG2E;

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
template <int D, int NJ, bool kFull>
__global__ void __launch_bounds__(Mb<D>::DQ_WARPS * 32)
flash_bwd_dq_f32_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ di,
                            const int* __restrict__ kv_lengths, const int* __restrict__ gate,
                            float* __restrict__ dq, int h, int h_kv, int n_q, int n_kv, int causal,
                            int window, float sm_scale, float scale_log2, int d_) {
  if (gate != nullptr && *gate == 0) return;
  const int d = kFull ? D : d_;   // kFull: the rows fill the tile (d == D)
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
  const float* kp = k + (size_t(b) * h_kv + hk) * size_t(n_kv) * d;
  const float* vp = v + (size_t(b) * h_kv + hk) * size_t(n_kv) * d;
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
    hop::load_rows_padded<D * 4>(kv_f32, kp + size_t(kt) * d, kp, n_kv - kt, TK, d * 4);
    hop::load_rows_padded<D * 4>(kv_f32 + TK * FROW, vp + size_t(kt) * d, vp, n_kv - kt, TK,
                                 d * 4);
  };
  const size_t q_off = (size_t(bh) * n_q + row0) * d;
  if (n_tiles > 1) load_kv(1);
  hop::cp_async_commit();
  {
    const int kv_valid = n_tiles > 0 ? n_kv - start : 0;
    const sp::RowsJob jobs[4] = {
        {q + q_off, n_rows, bm, q_pl, q_plane, scale_log2},
        {dout + q_off, n_rows, bm, do_pl, q_plane, 1.f},
        {kp + size_t(start) * d, kv_valid, TK, k_pl, kv_plane, 1.f},
        {vp + size_t(start) * d, kv_valid, TK, v_pl, kv_plane, 1.f}};
    sp::split_rows_ldg<D>(jobs, d);
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
  sp::store_rows<D>(dq + q_off + size_t(wr0) * d, acc, one, n_rows - wr0, lane, d);
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
template <int D, int NJ, int KS, bool kFull>
__global__ void __launch_bounds__(Mb<D>::DKV_WARPS * 32 * KS, D == 32 && KS == 1 ? 3 : 1)
flash_bwd_dkv_f32_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ di,
                             const int* __restrict__ kv_lengths, const int* __restrict__ gate,
                             float* __restrict__ dk, float* __restrict__ dv,
                             float* __restrict__ ds, int h, int h_kv, int n_q, int n_kv,
                             int causal, int window, float sm_scale, float scale_log2,
                             int d_) {
  if (gate != nullptr && *gate == 0) return;
  const int d = kFull ? D : d_;   // kFull: the rows fill the tile (d == D)
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
    hop::load_rows_padded<D * 4>(q_f32, q + (bhq * n_q + qt) * d, q, n_q - qt, BQ, d * 4);
    hop::load_rows_padded<D * 4>(q_f32 + BQ * FROW, dout + (bhq * n_q + qt) * d, dout, n_q - qt,
                                 BQ, d * 4);
  };
  const size_t kv_off = size_t(bk) * n_kv * d;
  if (steps > 1) load_step(1);
  hop::cp_async_commit();
  {
    const size_t q0 = steps > 0 ? (head_of(0) * n_q + row_of(0)) * d : 0;
    const int q_valid = steps > 0 ? n_q - row_of(0) : 0;
    const sp::RowsJob jobs[4] = {
        {k + kv_off + size_t(k0) * d, n_keys, nk, k_pl, kv_plane, 1.f},
        {v + kv_off + size_t(k0) * d, n_keys, nk, v_pl, kv_plane, 1.f},
        {q + q0, q_valid, BQ, q_pl, q_plane, scale_log2},
        {dout + q0, q_valid, BQ, do_pl, q_plane, 1.f}};
    sp::split_rows_ldg<D>(jobs, d);
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
  const size_t off = kv_off + size_t(wk0) * d;
  sp::store_rows<D>(dk + off, dk_acc, unscale, n_keys - 16 * warp, lane, d);
  sp::store_rows<D>(dv + off, dv_acc, one, n_keys - 16 * warp, lane, d);
}

// dQ = dS K in f32 from the dK/dV kernel's dS (a walk of fewer than
// MMA_DS_MAX_KV keys): a block of W warps owns 16 W query rows of one
// (batch, head) and walks the key tiles of 8 NJ keys its rows see (KS =
// 2: two warps a row slab, each taking half of every tile's keys, their
// sums added at the end), each tile's dS rows (zero outside a row's live
// keys) and K straight into registers and split into planes; dQ += dS K,
// the six products a chunk and n-tile summed from zero.  The forward's S
// and dP are not computed again.
template <int D, int NJ, int KS, bool kFull>
__global__ void __launch_bounds__(4 * 32 * KS)
flash_bwd_dq_ds_f32_mma_kernel(const float* __restrict__ ds, const float* __restrict__ k,
                               const int* __restrict__ kv_lengths, float* __restrict__ dq, int h,
                               int h_kv, int n_q, int n_kv, int causal, int window, int d_) {
  const int d = kFull ? D : d_;   // kFull: the rows fill the tile (d == D)
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
  const float* kp = k + (size_t(b) * h_kv + hk) * size_t(n_kv) * d;
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
    const sp::RowsJob job[1] = {{kp + size_t(kt) * d, n_kv - kt, TK, k_pl, k_plane, 1.f}};
    sp::split_rows_ldg<D>(job, d);
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
  sp::store_rows<D>(dq + (size_t(bh) * n_q + row0 + wr0) * d, acc, one, n_rows - wr0, lane, d);
}

template <int D, int NJ, int KS>
cudaError_t launch_dq_ds_ks(const float* ds, const float* k, const int* lens, float* dq, int b,
                            int h, int h_kv, int n_q, int n_kv, int d, int causal, int window,
                            cudaStream_t stream) {
  auto smem = [](int bm) {
    return size_t(sp::NP) * (8 * NJ * (D * 2 + 16) + bm * (8 * NJ * 2 + 16));
  };
  static cudaError_t opted =
      fa::allow_smem_all(smem(64), flash_bwd_dq_ds_f32_mma_kernel<D, NJ, KS, true>,
                     flash_bwd_dq_ds_f32_mma_kernel<D, NJ, KS, false>);
  if (opted != cudaSuccess) return opted;
  auto kernel = d == D ? flash_bwd_dq_ds_f32_mma_kernel<D, NJ, KS, true>
                       : flash_bwd_dq_ds_f32_mma_kernel<D, NJ, KS, false>;
  const int slabs = min(4, (n_q + 15) / 16);
  dim3 grid(b * h, (n_q + 16 * slabs - 1) / (16 * slabs));
  kernel<<<grid, 32 * slabs * KS, smem(16 * slabs), stream>>>(ds, k, lens, dq, h, h_kv, n_q,
                                                              n_kv, causal, window, d);
  return cudaGetLastError();
}

// KS = 2 (a tile's keys split between two warps of the same rows, their
// sums added at the end) where the grid would not cover the 132 SMs and a
// tile has 32 or 64 keys
template <int D, int NJ>
cudaError_t launch_dq_ds_nj(const float* ds, const float* k, const int* lens, float* dq, int b,
                            int h, int h_kv, int n_q, int n_kv, int d, int causal, int window,
                            cudaStream_t stream) {
  const int slabs = min(4, (n_q + 15) / 16);
  if constexpr (NJ % 4 == 0) {
    if (size_t(b) * h * ((n_q + 16 * slabs - 1) / (16 * slabs)) < 132)
      return launch_dq_ds_ks<D, NJ, 2>(ds, k, lens, dq, b, h, h_kv, n_q, n_kv, d, causal,
                                       window, stream);
  }
  return launch_dq_ds_ks<D, NJ, 1>(ds, k, lens, dq, b, h, h_kv, n_q, n_kv, d, causal, window,
                                   stream);
}

// key tiles of the walk's keys rounded up to 16, at most 64
template <int D>
cudaError_t launch_dq_ds(const float* ds, const float* k, const int* lens, float* dq, int b, int h,
                         int h_kv, int n_q, int n_kv, int d, int causal, int window,
                         cudaStream_t stream) {
  switch (max(16, min(64, (n_kv + 15) / 16 * 16)) / 8) {
    case 2: return launch_dq_ds_nj<D, 2>(ds, k, lens, dq, b, h, h_kv, n_q, n_kv, d, causal, window, stream);
    case 4: return launch_dq_ds_nj<D, 4>(ds, k, lens, dq, b, h, h_kv, n_q, n_kv, d, causal, window, stream);
    case 6: return launch_dq_ds_nj<D, 6>(ds, k, lens, dq, b, h, h_kv, n_q, n_kv, d, causal, window, stream);
    default: return launch_dq_ds_nj<D, 8>(ds, k, lens, dq, b, h, h_kv, n_q, n_kv, d, causal, window, stream);
  }
}

// The dK/dV kernel over query tiles of 8 NJQ rows, then the dQ kernel over
// key tiles of 8 NJK keys.
template <int D, int NJQ, int NJK>
cudaError_t launch_f32_mma_nj(const float* q, const float* k, const float* v, const float* dout,
                              const float* lse, const float* di, const int* lens, float* dq,
                              float* dk, float* dv, float* ds, int b, int h, int h_kv, int n_q,
                              int n_kv, int d, int causal, int window, float sm_scale,
                              float scale_log2, cudaStream_t stream, const int* gate) {
  using C = Mb<D>;
  // KS = 2 (each query tile's rows split between two warps of the same
  // keys, their sums added at the end) where the grid would not cover the
  // 132 SMs and a tile has 32 or 64 rows
  const int slabs = min(C::DKV_WARPS, (n_kv + 15) / 16);
  const bool split = NJQ % 4 == 0 && size_t(b) * h_kv * ((n_kv + 16 * slabs - 1) / (16 * slabs)) < 132;
  constexpr int KS2 = NJQ % 4 == 0 ? 2 : 1;
  const bool full = d == D;
  auto dkv_kernel = split ? (full ? flash_bwd_dkv_f32_mma_kernel<D, NJQ, KS2, true>
                                  : flash_bwd_dkv_f32_mma_kernel<D, NJQ, KS2, false>)
                          : (full ? flash_bwd_dkv_f32_mma_kernel<D, NJQ, 1, true>
                                  : flash_bwd_dkv_f32_mma_kernel<D, NJQ, 1, false>);
  auto dq_kernel = full ? flash_bwd_dq_f32_mma_kernel<D, NJK, true>
                        : flash_bwd_dq_f32_mma_kernel<D, NJK, false>;
  static cudaError_t opted = [] {
    const cudaError_t e = fa::allow_smem_all(
        C::smem(16 * C::DKV_WARPS, 8 * NJQ, true), flash_bwd_dkv_f32_mma_kernel<D, NJQ, 1, true>,
        flash_bwd_dkv_f32_mma_kernel<D, NJQ, 1, false>,
        flash_bwd_dkv_f32_mma_kernel<D, NJQ, KS2, true>,
        flash_bwd_dkv_f32_mma_kernel<D, NJQ, KS2, false>);
    return e != cudaSuccess ? e
                            : fa::allow_smem_all(C::smem(16 * C::DQ_WARPS, 8 * NJK, true),
                                             flash_bwd_dq_f32_mma_kernel<D, NJK, true>,
                                             flash_bwd_dq_f32_mma_kernel<D, NJK, false>);
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
        sm_scale, scale_log2, d);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (n_q > 0 && ds != nullptr)
    return launch_dq_ds<D>(ds, k, lens, dq, b, h, h_kv, n_q, n_kv, d, causal, window, stream);
  if (n_q > 0) {
    const int warps = min(C::DQ_WARPS, (n_q + 15) / 16);
    dim3 grid(b * h, (n_q + 16 * warps - 1) / (16 * warps));
    dq_kernel<<<grid, 32 * warps, C::smem(16 * warps, 8 * NJK, n_kv > 8 * NJK), stream>>>(
        q, k, v, dout, lse, di, lens, gate, dq, h, h_kv, n_q, n_kv, causal, window, sm_scale,
        scale_log2, d);
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
                           int n_kv, int d, int causal, int window, float sm_scale,
                           float scale_log2, cudaStream_t stream, const int* gate = nullptr) {
  constexpr int BQ = Mb<D>::BQ, BN = Mb<D>::BN;
  const int nq = max(16, min(BQ, (n_q + 15) / 16 * 16)) / 8;
  const int nk = max(16, min(BN, (n_kv + 15) / 16 * 16)) / 8;
  const auto args = [&](auto launch) {
    return launch(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(dout), lse, di, lens,
                  static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), ds,
                  b, h, h_kv, n_q, n_kv, d, causal, window, sm_scale, scale_log2, stream, gate);
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

// The NP planes of rows [row0, row0 + 64) of a (n, d) matrix whose planes
// lie `plane` elements apart, into swizzled tiles of D columns
// (hop::load_tile's layout); rows at or past n and columns d..D - 1 are
// zero (hop::cp_chunk; kFull: d == D, known at compile time).  Threads
// tid = 0 .. NT - 1 share the copies (the block, or one warpgroup).
template <int D, bool kFull, int NT = Sb<D>::THREADS>
__device__ __forceinline__ void load_planes(uint8_t* dst, const bf16* src, long long plane,
                                            int row0, int n, int tid, int d) {
  using C = Sb<D>;
  constexpr int CHUNKS = D * 2 / 16, REGION_CHUNKS = C::SW / 16;
  const int row_bytes = kFull ? D * 2 : d * 2;
#pragma unroll
  for (int p = 0; p < C::NP; ++p) {
    const uint8_t* s = reinterpret_cast<const uint8_t*>(src + p * plane) + size_t(row0) * row_bytes;
    for (int i = tid; i < C::ROWS * CHUNKS; i += NT) {
      const int r = i / CHUNKS, c = i % CHUNKS;
      const bool ok = r < n - row0;
      uint8_t* t = dst + p * C::PLANE + (c / REGION_CHUNKS) * (C::ROWS * C::SW) +
                   hop::swz<C::SW>(r * C::SW + (c % REGION_CHUNKS) * 16);
      hop::cp_chunk<kFull>(hop::smem_u32(t), s + (ok ? size_t(r) * row_bytes : 0), src, c,
                           row_bytes, ok);
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

// Rows [0, n) of a warpgroup's 64-row fragment of NCOL columns to dst: its
// columns below cols, rows ld floats apart.
template <int D, int NCOL = D>
__device__ __forceinline__ void store_f32_rows(float* dst, const float (&acc)[NCOL / 2], int rl,
                                               int quad, int n, int ld, int cols) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rl + 8 * hh;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < NCOL / 8; ++j)
      if (8 * j < cols)
        *reinterpret_cast<float2*>(dst + size_t(r) * ld + 8 * j + 2 * quad) =
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
template <int D, bool kFull>
__global__ void __launch_bounds__(Sb<D>::THREADS, 1)
flash_bwd_dkv_f32_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         const int* __restrict__ kv_lengths, const int* __restrict__ nf,
                         float* __restrict__ dk, float* __restrict__ dv, long long q_plane,
                         long long kv_plane, int h, int h_kv, int n_q, int n_kv, int causal,
                         int window, float sm_scale, float scale_log2, int d_) {
  if (*nf != 0) return;   // a +-inf: the warp-level kernels compute the call
  const int d = kFull ? D : d_;   // kFull: the rows fill the tile (d == D)
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
    load_planes<D, kFull>(q_s, q + bh * n_q * d, q_plane, qt, n_q, i, d);
    load_planes<D, kFull>(do_s, dout + bh * n_q * d, q_plane, qt, n_q, i, d);
    if (i < 2 * BT) {
      const float* src = (i < BT ? lse : di) + bh * n_q + qt + i % BT;
      const bool ok = qt + i % BT < n_q;
      hop::cp_async<4>(hop::smem_u32(stats + i), ok ? src : lse, ok);
    }
  };

  const size_t kv_off = size_t(bk) * n_kv * d;
  load_planes<D, kFull>(k_s, k + kv_off, kv_plane, k0, n_kv, threadIdx.x, d);
  load_planes<D, kFull>(v_s, v + kv_off, kv_plane, k0, n_kv, threadIdx.x, d);
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
  store_f32_rows<D>((wg == 0 ? dk : dv) + kv_off + size_t(k0) * d, acc, rl, quad, n_keys, d, d);
}

// dQ in f32, query-major: a block owns 64 query rows of one (batch, head),
// their Q and dO planes resident, and walks the key tiles of 64 its rows
// see.  Warpgroup 0 computes S = Q K^T (Q scaled: the forward's S) and P,
// warpgroup 1 dP = dO V^T and, from P, dS; then each sums its half of dQ's
// columns (d 128; below, warpgroup 0 all of them) += dS K (K read MN-major;
// promoted_rs).  V's next tile loads behind this tile's dS and dQ, K's
// behind nothing.
template <int D, bool kFull>
__global__ void __launch_bounds__(Sb<D>::THREADS, 1)
flash_bwd_dq_f32_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        const int* __restrict__ kv_lengths, const int* __restrict__ nf,
                        float* __restrict__ dq, long long q_plane, long long kv_plane, int h,
                        int h_kv, int n_q, int n_kv, int causal, int window, float sm_scale,
                        float scale_log2, int d_) {
  if (*nf != 0) return;   // a +-inf: the warp-level kernels compute the call
  const int d = kFull ? D : d_;   // kFull: the rows fill the tile (d == D)
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
  const bf16* qp = q + size_t(bh) * n_q * d;
  const bf16* dop = dout + size_t(bh) * n_q * d;
  const bf16* kp = k + (size_t(b) * h_kv + hk) * size_t(n_kv) * d;
  const bf16* vp = v + (size_t(b) * h_kv + hk) * size_t(n_kv) * d;
  const int kv_len = kv_lengths != nullptr ? min(n_kv, max(kv_lengths[b], 0)) : n_kv;

  // both bounds of dense_bounds grow with the row
  int walk_lo, walk_hi, all_lo, all_hi;
  fa::dense_bounds(row0, kv_len, causal, window, walk_lo, all_hi);
  fa::dense_bounds(row0 + n_rows - 1, kv_len, causal, window, all_lo, walk_hi);
  const int start = walk_hi > walk_lo ? walk_lo / BN * BN : 0;
  const int end = walk_hi > walk_lo ? walk_hi : 0;

  if (start < end) {
    load_planes<D, kFull>(q_s, qp, q_plane, row0, n_q, threadIdx.x, d);
    load_planes<D, kFull>(do_s, dop, q_plane, row0, n_q, threadIdx.x, d);
    load_planes<D, kFull>(k_s, kp, kv_plane, start, n_kv, threadIdx.x, d);
    load_planes<D, kFull>(v_s, vp, kv_plane, start, n_kv, threadIdx.x, d);
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
      if (next) load_planes<D, kFull, 128>(v_s, vp, kv_plane, kt + BN, n_kv, lt, d);
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
    if (next) load_planes<D, kFull>(k_s, kp, kv_plane, kt + BN, n_kv, threadIdx.x, d);
    hop::cp_async_commit();
  }
  hop::cp_async_wait<0>();
  if (has_dq) {
    const int col0 = D == 128 ? wg * 64 : 0;   // the warpgroup's first column
    store_f32_rows<D, NQ>(dq + (size_t(bh) * n_q + row0) * d + col0, acc, rl, quad, n_rows, d,
                          d - col0);
  }
}

// Split q, dout, k and v into bf16 planes (in `planes`: 3 q_elems for q
// and for dout, then 3 kv_elems for k and for v), then the dK/dV kernel,
// then the dQ kernel, then the warp-level pair gated on the split pass's
// +-inf flag nf (C17).
template <int D>
cudaError_t launch_f32_tc(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* di, const int* lens, void* dq, void* dk,
                          void* dv, void* planes, int* nf, int b, int h, int h_kv, int n_q,
                          int n_kv, int d, int causal, int window, float sm_scale,
                          float scale_log2, cudaStream_t stream) {
  using C = Sb<D>;
  const bool full = d == D;
  auto dkv_kernel = full ? flash_bwd_dkv_f32_kernel<D, true> : flash_bwd_dkv_f32_kernel<D, false>;
  auto dq_kernel = full ? flash_bwd_dq_f32_kernel<D, true> : flash_bwd_dq_f32_kernel<D, false>;
  static cudaError_t opted =
      fa::allow_smem_all(C::SMEM, flash_bwd_dkv_f32_kernel<D, true>, flash_bwd_dkv_f32_kernel<D, false>,
                     flash_bwd_dq_f32_kernel<D, true>, flash_bwd_dq_f32_kernel<D, false>);
  if (opted != cudaSuccess) return opted;
  const long long q_elems = (long long)b * h * n_q * d, kv_elems = (long long)b * h_kv * n_kv * d;
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
        q_elems, kv_elems, h, h_kv, n_q, n_kv, causal, window, sm_scale, scale_log2, d);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (n_q > 0) {
    dim3 grid(b * h, (n_q + C::ROWS - 1) / C::ROWS);
    dq_kernel<<<grid, C::THREADS, C::SMEM, stream>>>(qs, ks, vs, dos, lse, di, lens, nf,
                                                     static_cast<float*>(dq), q_elems, kv_elems, h,
                                                     h_kv, n_q, n_kv, causal, window, sm_scale,
                                                     scale_log2, d);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return launch_f32_mma<D>(q, k, v, dout, lse, di, lens, dq, dk, dv, nullptr, b, h, h_kv, n_q,
                           n_kv, d, causal, window, sm_scale, scale_log2, stream, nf);
}

cudaError_t dispatch_f32_tc(int d, const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* di, const int* lens, void* dq, void* dk,
                            void* dv, void* planes, int* nf, int b, int h, int h_kv, int n_q,
                            int n_kv, int causal, int window, float sm_scale, float scale_log2,
                            cudaStream_t st) {
  switch (hop::tile_width(d)) {
    case 32: return launch_f32_tc<32>(q, k, v, dout, lse, di, lens, dq, dk, dv, planes, nf, b, h, h_kv, n_q, n_kv, d, causal, window, sm_scale, scale_log2, st);
    case 64: return launch_f32_tc<64>(q, k, v, dout, lse, di, lens, dq, dk, dv, planes, nf, b, h, h_kv, n_q, n_kv, d, causal, window, sm_scale, scale_log2, st);
    case 128: return launch_f32_tc<128>(q, k, v, dout, lse, di, lens, dq, dk, dv, planes, nf, b, h, h_kv, n_q, n_kv, d, causal, window, sm_scale, scale_log2, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_f32_mma(int d, const void* q, const void* k, const void* v,
                             const void* dout, const float* lse, const float* di, const int* lens,
                             void* dq, void* dk, void* dv, float* ds, int b, int h, int h_kv,
                             int n_q, int n_kv, int causal, int window, float sm_scale,
                             float scale_log2, cudaStream_t st) {
  switch (hop::tile_width(d)) {
    case 32: return launch_f32_mma<32>(q, k, v, dout, lse, di, lens, dq, dk, dv, ds, b, h, h_kv, n_q, n_kv, d, causal, window, sm_scale, scale_log2, st);
    case 64: return launch_f32_mma<64>(q, k, v, dout, lse, di, lens, dq, dk, dv, ds, b, h, h_kv, n_q, n_kv, d, causal, window, sm_scale, scale_log2, st);
    case 128: return launch_f32_mma<128>(q, k, v, dout, lse, di, lens, dq, dk, dv, ds, b, h, h_kv, n_q, n_kv, d, causal, window, sm_scale, scale_log2, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

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
