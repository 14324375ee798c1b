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
// Head dims: any d <= 128 that is a multiple of 8, as in flash_fwd.cu.
// Each kernel is compiled at the tile widths D = 32, 64 and 128 and runs a
// call at the least one that holds d (hop::tile_width); d is the row
// stride of q, k, v, dO and the gradients in device memory, the tiles'
// columns d..D - 1 are zero-filled as they load (hop::cp_chunk) and never
// stored.  The zero columns add exact zeros to S = Q K^T and dP = dO V^T,
// so P, dS, lse and di are unchanged, and dQ = dS K, dK = dS^T Q and dV =
// P^T dO are zero there: the function is JAX's at d (its _pad128 pads the
// subrow and loop schedules' backward the same way), with no padded copy of
// q, k, v, dO or the gradients.  A call at d == D takes an instance
// compiled for it (kFull: the stride a constant, no zero-fill branch): the
// runtime stride cost the bf16 wgmma pair up to 24% at d 32 and the f32
// warp-level kernels (flash_bwd_f32.cu) up to 16% at the MT model's d 32
// (PERF.md, rows 8-10).
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
// bf16 runs tensor-core kernels on hopper.cuh.  What bounds them on the
// H100 is the seven products (14 d flops per live pair at 989 TF/s; the
// tile's D where d < D).  A block of two consumer warpgroups owns 128 keys
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
// f32 (one function for every schedule) runs the split-precision kernels
// of flash_bwd_f32.cu, in a file of their own so that the two compile in
// parallel.

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

namespace {

using fa::LOG2E;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// rows of d values (at most D), zero-padded to D
template <int D>
__device__ __forceinline__ void load_rows(uint8_t* dst, const bf16* src, const bf16* base,
                                          int rows_valid, int rows, int d) {
  hop::load_tile<D * 2, Tc<D>::SW, Tc<D>::THREADS>(dst, src, base, rows_valid, rows, d * 2);
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
// 128 to dst in 16-byte stores: their columns below d, rows d apart.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 2], uint8_t* stage,
                                           int rl, int quad, int n, int d) {
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
    if (c >= d) continue;
    *reinterpret_cast<uint4*>(dst + size_t(r) * d + c) =
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
template <int D, bool kFull>
__global__ void __launch_bounds__(Tc<D>::THREADS, 1)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        const int* __restrict__ kv_lengths, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int h, int h_kv, int n_q, int n_kv, int causal,
                        int window, float sm_scale, int d_) {
  const int d = kFull ? D : d_;   // kFull: the rows fill the tile (d == D)
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
  const bf16* kp = k + size_t(bk) * n_kv * d;
  const bf16* vp = v + size_t(bk) * n_kv * d;
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
    load_rows<D>(qd, q + (bh * n_q + qt) * d, q, n_q - qt, BT, d);
    load_rows<D>(qd + C::TILE_BYTES, dout + (bh * n_q + qt) * d, dout, n_q - qt, BT, d);
    const int i = threadIdx.x;
    if (i < 2 * BT) {
      const float* src = (i < BT ? lse : di) + bh * n_q + qt + i % BT;
      const bool ok = qt + i % BT < n_q;
      hop::cp_async<4>(hop::smem_u32(stats + buf * 2 * BT + i), ok ? src : lse, ok);
    }
  };

  load_rows<D>(k_s, kp + size_t(k0) * d, kp, n_kv - k0, C::BIG, d);
  load_rows<D>(v_s, vp + size_t(k0) * d, vp, n_kv - k0, C::BIG, d);
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
  const size_t off = (size_t(bk) * n_kv + k0) * d;
  store_rows<D>(dk + off, dk_acc, ring, rl, quad, n_keys, d);
  store_rows<D>(dv + off, dv_acc, ring, rl, quad, n_keys, d);
}

// dQ, query-major: a block owns 128 query rows of one (batch, head), a
// warpgroup 64 of them, with their Q and dO rows resident and dQ in f32
// registers, and walks the key tiles of 64 its rows can see (K and V through
// a double-buffered ring).  Per tile S = Q K^T and dP = dO V^T (both
// K-major), P and dS on the fragment, dS rounded to bf16 pairs in place:
// the A operand of dQ += dS K, K read MN-major from the same tile.
template <int D, bool kFull>
__global__ void __launch_bounds__(Tc<D>::THREADS, 1)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ di,
                       const int* __restrict__ kv_lengths, bf16* __restrict__ dq, int h,
                       int h_kv, int n_q, int n_kv, int causal, int window, float sm_scale,
                       int d_) {
  const int d = kFull ? D : d_;   // kFull: the rows fill the tile (d == D)
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
  const bf16* qp = q + size_t(bh) * n_q * d;
  const bf16* dop = dout + size_t(bh) * n_q * d;
  const bf16* kp = k + (size_t(b) * h_kv + hk) * size_t(n_kv) * d;
  const bf16* vp = v + (size_t(b) * h_kv + hk) * size_t(n_kv) * d;
  const int kv_len = kv_lengths != nullptr ? min(n_kv, max(kv_lengths[b], 0)) : n_kv;
  const float scale_log2 = sm_scale * LOG2E;

  // both bounds of dense_bounds grow with the row (see flash_fwd.cu)
  int walk_lo, walk_hi, all_lo, all_hi;
  fa::dense_bounds(row0, kv_len, causal, window, walk_lo, all_hi);
  fa::dense_bounds(row0 + n_rows - 1, kv_len, causal, window, all_lo, walk_hi);
  const int start = walk_hi > walk_lo ? (walk_lo / BN) * BN : 0;
  const int end = walk_hi > walk_lo ? walk_hi : 0;

  load_rows<D>(q_s, qp + size_t(row0) * d, qp, n_rows, C::BIG, d);
  load_rows<D>(do_s, dop + size_t(row0) * d, dop, n_rows, C::BIG, d);
  if (start < end) {
    load_rows<D>(ring, kp + size_t(start) * d, kp, n_kv - start, BN, d);
    load_rows<D>(ring + C::TILE_BYTES, vp + size_t(start) * d, vp, n_kv - start, BN, d);
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
      load_rows<D>(nk, kp + size_t(kt + BN) * d, kp, n_kv - kt - BN, BN, d);
      load_rows<D>(nk + C::TILE_BYTES, vp + size_t(kt + BN) * d, vp, n_kv - kt - BN, BN, d);
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
  store_rows<D>(dq + (size_t(bh) * n_q + row0) * d, dq_acc, ring, rl, quad, n_rows, d);
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* di, const int* lens, void* dq, void* dk,
                      void* dv, int b, int h, int h_kv, int n_q, int n_kv, int d, int causal,
                      int window, float sm_scale, cudaStream_t stream) {
  using C = Tc<D>;
  const bool full = d == D;
  auto dkv_kernel = full ? flash_bwd_dkv_tc_kernel<D, true> : flash_bwd_dkv_tc_kernel<D, false>;
  auto dq_kernel = full ? flash_bwd_dq_tc_kernel<D, true> : flash_bwd_dq_tc_kernel<D, false>;
  static cudaError_t opted =
      fa::allow_smem_all(C::SMEM, flash_bwd_dkv_tc_kernel<D, true>, flash_bwd_dkv_tc_kernel<D, false>,
                     flash_bwd_dq_tc_kernel<D, true>, flash_bwd_dq_tc_kernel<D, false>);
  if (opted != cudaSuccess) return opted;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* dob = static_cast<const bf16*>(dout);
  if (n_kv > 0) {
    dim3 grid(b * h_kv, (n_kv + C::BIG - 1) / C::BIG);
    dkv_kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
        qb, kb, vb, dob, lse, di, lens, static_cast<bf16*>(dk), static_cast<bf16*>(dv), h,
        h_kv, n_q, n_kv, causal, window, sm_scale, d);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (n_q > 0) {
    dim3 grid(b * h, (n_q + C::BIG - 1) / C::BIG);
    dq_kernel<<<grid, C::THREADS, C::SMEM, stream>>>(qb, kb, vb, dob, lse, di, lens,
                                                     static_cast<bf16*>(dq), h, h_kv, n_q,
                                                     n_kv, causal, window, sm_scale, d);
  }
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(int d, const void* q, const void* k, const void* v,
                          const void* dout, const float* lse, const float* di, const int* lens,
                          void* dq, void* dk, void* dv, int b, int h, int h_kv, int n_q,
                          int n_kv, int causal, int window, float sm_scale, cudaStream_t st) {
  switch (hop::tile_width(d)) {
    case 32: return launch_tc<32>(q, k, v, dout, lse, di, lens, dq, dk, dv, b, h, h_kv, n_q, n_kv, d, causal, window, sm_scale, st);
    case 64: return launch_tc<64>(q, k, v, dout, lse, di, lens, dq, dk, dv, b, h, h_kv, n_q, n_kv, d, causal, window, sm_scale, st);
    case 128: return launch_tc<128>(q, k, v, dout, lse, di, lens, dq, dk, dv, b, h, h_kv, n_q, n_kv, d, causal, window, sm_scale, st);
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
template <int D, bool kFull>
__global__ void __launch_bounds__(Ob<D>::MAX_WARPS * 32)
flash_bwd_op_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const int* __restrict__ kv_lengths, float* __restrict__ ops,
                       bf16* __restrict__ dq, int h, int h_kv, int n_q, int n_kv, int causal,
                       int window, float sm_scale, int tile_rows, int d_) {
  const int d = kFull ? D : d_;   // kFull: the rows fill the tile (d == D)
  using C = Ob<D>;
  constexpr int BN = C::BN, ROW = C::ROW, NJ = BN / 8, NP = C::NP;
  extern __shared__ __align__(16) uint8_t op_smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / h, hq = bh % h, hk = hq / (h / h_kv);
  const int bm = 16 * warps;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * bm;   // the longest walks first
  const int n_rows = min(bm, n_q - row0);
  const bf16* qp = q + size_t(bh) * n_q * d;
  const bf16* dop = dout + size_t(bh) * n_q * d;
  const bf16* kp = k + (size_t(b) * h_kv + hk) * size_t(n_kv) * d;
  const bf16* vp = v + (size_t(b) * h_kv + hk) * size_t(n_kv) * d;
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
    hop::load_rows_padded<D * 2>(dst, kp + size_t(kt) * d, kp, n_kv - kt, rows, d * 2);
    if (one || i >= n_tiles)
      hop::load_rows_padded<D * 2>(dst + tile_rows * ROW, vp + size_t(kt) * d, vp, n_kv - kt,
                                   rows, d * 2);
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

  hop::load_rows_padded<D * 2>(qs, qp + size_t(row0) * d, qp, n_rows, bm, d * 2);
  hop::load_rows_padded<D * 2>(dos, dop + size_t(row0) * d, dop, n_rows, bm, d * 2);
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
    bf16* out = dq + (size_t(bh) * n_q + row) * d;
#pragma unroll
    for (int nd = 0; nd < C::ND; ++nd)
      if (8 * nd < d)
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
template <int D, bool kSeq, bool kFull>
__global__ void __launch_bounds__(Ob<D>::MAX_WARPS * 32)
flash_bwd_op_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const int* __restrict__ kv_lengths, const float* __restrict__ ops,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int h, int h_kv, int n_q,
                        int n_kv, int causal, int window, float sm_scale, int tile_rows,
                        int d_) {
  const int d = kFull ? D : d_;   // kFull: the rows fill the tile (d == D)
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
  const bf16* kp = k + size_t(bk) * n_kv * d;
  const bf16* vp = v + size_t(bk) * n_kv * d;

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
    hop::load_rows_padded<D * 2>(dst, q + (bhq * n_q + qt) * d, q, n_q - qt, rows, d * 2);
    hop::load_rows_padded<D * 2>(dst + tile_rows * ROW, dout + (bhq * n_q + qt) * d, dout,
                                 n_q - qt, rows, d * 2);
    float* st = stats + i % nstage * 4 * BQ;
    const float* src = ops + (bhq * n_q + qt) * 4;
    for (int j = threadIdx.x; j < BQ; j += blockDim.x) {
      const bool ok = j < n_q - qt;
      hop::cp_async<16>(hop::smem_u32(st + 4 * j), ok ? src + 4 * j : ops, ok);
    }
  };

  hop::load_rows_padded<D * 2>(ks, kp + size_t(k0) * d, kp, n_keys, nk, d * 2);
  hop::load_rows_padded<D * 2>(vs, vp + size_t(k0) * d, vp, n_keys, nk, d * 2);
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
    const size_t off = (size_t(bk) * n_kv + k0 + kl) * d;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      if (8 * nd >= d) continue;
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
                      int h_kv, int n_q, int n_kv, int d, int causal, int window, float sm_scale,
                      cudaStream_t stream) {
  using C = Ob<D>;
  const bool full = d == D;
  auto dq_kernel = full ? flash_bwd_op_dq_kernel<D, true> : flash_bwd_op_dq_kernel<D, false>;
  const int group = h / h_kv;
  auto dkv_kernel = group > 1 ? (full ? flash_bwd_op_dkv_kernel<D, true, true>
                                      : flash_bwd_op_dkv_kernel<D, true, false>)
                              : (full ? flash_bwd_op_dkv_kernel<D, false, true>
                                      : flash_bwd_op_dkv_kernel<D, false, false>);
  constexpr int kRows = 16 * C::MAX_WARPS;   // a block's query rows (dQ) or keys (dK/dV)
  // GQA's shared memory: the group sums, and P^T and dS^T a warp
  auto gqa_bytes = [](int warps) {
    return (2 * C::ND * 4 * 32 + 2 * 16 * (C::BQ + 1)) * warps * sizeof(float);
  };
  static cudaError_t opted = [&] {
    const size_t dkv = size_t(2 * kRows + 2 * 2 * C::BQ) * C::ROW + 2 * 4 * C::BQ * sizeof(float);
    cudaError_t e = fa::allow_smem_all(size_t(2 * 2 * C::BN + 2 * kRows) * C::ROW,
                                   flash_bwd_op_dq_kernel<D, true>,
                                   flash_bwd_op_dq_kernel<D, false>);
    if (e == cudaSuccess)
      e = fa::allow_smem_all(dkv, flash_bwd_op_dkv_kernel<D, false, true>,
                         flash_bwd_op_dkv_kernel<D, false, false>);
    return e != cudaSuccess ? e
                            : fa::allow_smem_all(dkv + gqa_bytes(4),
                                             flash_bwd_op_dkv_kernel<D, true, true>,
                                             flash_bwd_op_dkv_kernel<D, true, false>);
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
                                                  causal, window, sm_scale, tile_rows, d);
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
                                                   tile_rows, d);
  }
  return cudaGetLastError();
}

cudaError_t dispatch_op(int d, const void* q, const void* k, const void* v, const void* dout,
                        float* ops, const int* lens, void* dq, void* dk, void* dv, int b, int h,
                        int h_kv, int n_q, int n_kv, int causal, int window, float sm_scale,
                        cudaStream_t st) {
  switch (hop::tile_width(d)) {
    case 32: return launch_op<32>(q, k, v, dout, ops, lens, dq, dk, dv, b, h, h_kv, n_q, n_kv, d, causal, window, sm_scale, st);
    case 64: return launch_op<64>(q, k, v, dout, ops, lens, dq, dk, dv, b, h, h_kv, n_q, n_kv, d, causal, window, sm_scale, st);
    case 128: return launch_op<128>(q, k, v, dout, ops, lens, dq, dk, dv, b, h, h_kv, n_q, n_kv, d, causal, window, sm_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dout, dq (b, h, n_q, d); k, v, dk, dv (b, h_kv, n_kv, d); lse and di
// (b, h, n_q) f32, lse in natural log.  kv_lengths (b,) int32 or null;
// window <= 0 means none.  dtype: 1 = bfloat16 (f32 has its own entry
// points, in flash_bwd_f32.cu).  op_graph = 0: the TPU kernels' backward from (lse, di): the dK/dV
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
