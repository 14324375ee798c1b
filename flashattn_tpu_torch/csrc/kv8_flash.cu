// Flash-attention forward over a quantized KV cache: o = softmax(q k^T *
// sm_scale) v and lse (natural log), where K = k_payload * k_scale and
// V = v_payload * v_scale with int8 or fp8 (e4m3) payloads and one f32
// scale per (batch, kv head, token).
//
// Replaces the TPU kernels in flashattn_tpu/ops/quant.py:
//   _kv8_fwd_kernel (wrapper flash_attention_kv_int8), the grid schedule:
//     causal or not, cross attention (n_q != n_kv);
//   _kv8_loop_kernel (wrapper _kv8_flash_loop), the q-major causal loop
//     schedule with GQA;
//   _kv8_subrow_kernel (wrapper _kv8_flash_subrow), the causal schedule with
//     the whole quantized row resident.
// JAX's dispatcher picks one of them by shape, and in bf16 each rounds in
// its own way; the caller (ops/quant.py::_kv8_route, a copy of that
// choice) passes the route's mode:
//   mode 1, the grid (_kv8_fwd_kernel): a running max over JAX's key blocks
//     of `span` keys (n_kv itself up to 1024 keys, else a power of two from
//     8 to 1024), acc and l rescaled by exp2(m_old - m_new)
//     where a block starts; p = exp2(s - m) and V = v8 * vs each rounded to
//     bf16 before the PV product; o = acc * (1 / l).
//   mode 3, the loop (_kv8_loop_kernel): the same online chain over key
//     chunks of `span` (the query block, a multiple of 128), but V's scale
//     folds into p: (p * vs) rounded to bf16 against v8, which is exact in
//     bf16; o = acc * (1 / l).
//   mode 2, the subrow (_kv8_subrow_kernel): one pass against the row's
//     max, (p * vs) rounded to bf16 against v8, o = pv / l.
// Common to all: q is pre-scaled by sm_scale * log2(e) in q's dtype.  int8
// payloads: each q row is then quantized to int8 (absmax / 127 by IEEE
// division, round half to even) and the scores are the exact integer
// product q8 . k8 times the q row's scale, then the key's scale; fp8
// payloads: q . k8 in f32 times the key's scale.  The softmax runs in f32
// in exp2; l sums the unrounded p; PV sums in f32.  Causal is top-left
// aligned (key c <= row R).  GQA: q head h reads kv head h / (h_q / h_kv).
// The Python wrapper transcodes fp8 payloads to int8 at the subrow route
// (requantize_fp8_to_int8), as the JAX dispatcher does.
//
// Head dims: any d <= 128 that is a multiple of 8, at the tile width of d
// (32, 64 or 128; hop::tile_width), d the row stride, the columns d..D - 1
// of q's tile zero (so its int8 row scale is d's) and of K's and V's tiles
// zero-filled as they load (hop::cp_chunk, 8-byte copies for rows of 8 mod
// 16 bytes), never stored: JAX's function at d.
//
// bf16 q: kv8_flash_tc_kernel, on the structure of
// the bf16 flash forward (flash_fwd.cu).  What bounds it on the H100 is its
// two products (QK^T at the int8 peak for int8 payloads, PV at the bf16
// one), more where a max pass repeats QK^T; the 1-byte K/V and their
// scales halve the bytes of a bf16 cache.  A block owns 128 query rows,
// two consumer warpgroups of 64; its prologue pre-scales (and for int8
// quantizes) them once into a swizzled K-major tile.  K/V tiles of 128 keys
// arrive as payload bytes in a double-buffered cp.async ring.  int8: S is
// one s8 x s8 -> s32 wgmma (both operands K-major, the tile of D-byte rows
// swizzled by D bytes), read from the staged K bytes as they are.  fp8: K
// is widened to bf16 in shared memory (exact) for a bf16 wgmma.  V is
// widened into the MN-major B tile, to bf16(v8 * vs) in mode 1 and to
// bf16(v8) (exact: the scale rides in p) in modes 2 and 3, and fenced to
// the async proxy, as wo_matmul.cu converts W.  The walk over the key
// tiles is a sequence of (tile, pass) steps: a key segment (JAX's block
// where it is wider than a tile, the whole walk in mode 2) first takes a
// max pass, S and each row's max without V, then the PV pass.  A key block
// narrower than the tile (mode 1, span 8..64) is its own online-softmax
// update inside the tile.  P stays in bf16 registers, the A operand of the
// PV wgmma, whose product sums from zero a tile before it is added to the
// f32 accumulator; the output leaves staged through shared memory in whole
// rows.
//
// f32 q: kv8_flash_tc_kernel in split precision (split.cuh), every route's
// function (in f32 they agree to f32 rounding: a V rounding against a p
// rounding, a running max against the row's).  Single-pass TF32 would miss
// the f32 gate (1e-4 against the plain version, which follows JAX by
// route); the payloads are exact in bf16, so f32-grade products need three
// pieces of the f32 side only.  QK^T: with int8 payloads the same s8 wgmma
// (q quantized per row from f32, exact); with fp8 payloads q's three bf16
// planes, split once a block in the prologue, times K widened to bf16: 3
// products.  PV: one online softmax over the 128-key tiles, V's scale
// folded into p in f32 (p' = p * vs), p' split in registers into three
// bf16 pieces, the A operand, against V widened to bf16(v8): 3 products,
// the small pieces first, summed from zero a tile (the tensor cores
// truncate their sums) and added to the accumulator in f32.  No split
// pass over HBM.  What bounds it: QK^T at the int8 peak (or 3 products at
// the bf16 one) and PV's 3 products at 989 TF/s.  The fp8 route's widened
// K and V share one bf16 tile (Q's planes take 96 KB at d 128).

#include <cuda_fp8.h>

#include <type_traits>

#include "attn_util.cuh"
#include "hopper.cuh"
#include "split.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Args {
  const void* q; const void* k; const void* v; const float* ks; const float* vs;
  void* o; float* lse;
  int h, h_kv, n_q, n_kv, causal;
  float scale_log2;
  int mode, span;   // bf16 q: the route (Mode) and its key block; f32 q: unused
  int d;            // the head dim (at most the tile's D)
};

enum Mode { kGrid = 1, kSubrow = 2, kLoop = 3 };

template <typename T, typename P, int D>
struct Tc {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr bool kInt8 = std::is_same<P, int8_t>::value;
  static constexpr int BM = 128, BN = 128, THREADS = 256;
  static constexpr int SW = D >= 64 ? 128 : 64;   // bytes of a swizzled bf16 row
  static constexpr int CPR = SW / 2;              // bf16 columns a region row holds
  static constexpr int SW8 = D;                   // an 8-bit row: D bytes, one region
  // Q: int8 rows, or bf16 planes (three for f32 q)
  static constexpr int Q_PLANE = BM * D * (kInt8 ? 1 : 2);
  static constexpr int Q_BYTES = (!kInt8 && kF32 ? sp::NP : 1) * Q_PLANE;
  static constexpr int STAGE = BN * D;            // payload bytes of a K or V tile
  static constexpr int TILE16 = BN * D * 2;       // a bf16 K or V tile
  // bf16 tiles: V (int8); K and V (fp8, bf16 q); K then V in one (fp8, f32 q)
  static constexpr bool kShare = kF32 && !kInt8;
  static constexpr int N16 = kInt8 || kShare ? 1 : 2;
  static constexpr size_t SMEM = 1024 + Q_BYTES + 4 * size_t(STAGE) + N16 * size_t(TILE16) +
                                 (4 * BN + BM) * sizeof(float);
};

// 8-bit payload to f32 (exact).
__device__ __forceinline__ float byte_f(int8_t b) { return float(b); }
__device__ __forceinline__ float byte_f(__nv_fp8_e4m3 b) { return float(b); }

// One staged payload tile of 128 keys (rows of D bytes, swizzled by D) to
// the bf16 tile read by wgmma (regions of CPR columns, region stride
// 128 * SW, swizzled), each value times its row's scale (scales ==
// nullptr: times 1, exact) and rounded to bf16 once.  16 bytes a work item.
template <typename P, int D>
__device__ __forceinline__ void widen_tile(uint8_t* dst, const uint8_t* stage,
                                           const float* scales) {
  constexpr int BN = 128, SW = D >= 64 ? 128 : 64, CPR = SW / 2;
  for (int i = threadIdx.x; i < BN * D / 16; i += blockDim.x) {
    const int r = i / (D / 16), c0 = i % (D / 16) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(stage + hop::swz<D>(r * D + c0));
    const P* vals = reinterpret_cast<const P*>(&raw);
    const float sc = scales != nullptr ? scales[r] : 1.f;
    uint4 out[2];
    uint32_t* o = reinterpret_cast<uint32_t*>(out);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = hop::pack_bf16(__fmul_rn(byte_f(vals[2 * e]), sc),
                            __fmul_rn(byte_f(vals[2 * e + 1]), sc));
    uint8_t* region = dst + (c0 / CPR) * (BN * SW);
    const int cb = (c0 % CPR) * 2;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<uint4*>(region + hop::swz<SW>(r * SW + cb + 16 * hf)) = out[hf];
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The passes a key segment takes, in order: kMax (S only, each row's max
// over the segment) and kPv (P and the P V product).
enum Pass { kMax = 0, kPv = 1 };

// The block's walk, keys [0, end) in tiles of 128, as a sequence of (tile,
// pass) steps: the tiles fall into segments of `seg` keys (a multiple of
// 128, aligned from key 0), and each segment runs its passes over its
// tiles in turn, starting with `first`.  (A max step over two K tiles, as
// flash_fwd.cu's, was no faster here: 0.287 against 0.280 ms at B4 H8
// N2048 int8 on an H100 80GB HBM3 at 700 W, tools/ab_chip_smoke.py.)
struct Walk {
  int end, seg, first;
  __device__ int seg_lo(int kt) const { return kt / seg * seg; }
  __device__ int seg_hi(int kt) const { return min(end, (kt / seg + 1) * seg); }
  __device__ bool next(int& kt, int& pass) const {
    if (kt + 128 < seg_hi(kt)) { kt += 128; return true; }
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

// acc += P V for one tile, P (bf16 pairs in the A fragment's layout) over
// the 16-key chunks that meet the 8-key groups [j0, j1), V MN-major.  The
// product sums from zero in its own registers and is then added to acc,
// as the TPU kernels add each block's PV to the rescaled accumulator.
template <int D>
__device__ __forceinline__ void pv_add(float (&acc)[D / 2], const uint32_t (&p)[32],
                                       uint32_t v_addr, int j0, int j1) {
  constexpr int BN = 128, SW = D >= 64 ? 128 : 64;
  float pv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) pv[i] = 0.f;
  hop::fence_regs(pv);
  hop::wg_arrive();
#pragma unroll
  for (int kc = 0; kc < BN / 16; ++kc) {
    if (2 * kc + 1 < j0 || 2 * kc >= j1) continue;
    const uint32_t a[4] = {p[4 * kc], p[4 * kc + 1], p[4 * kc + 2], p[4 * kc + 3]};
    hop::wgmma_rs<1>(pv, a, hop::desc<SW>(v_addr + kc * 16 * SW, BN * SW, 8 * SW), 1);
  }
  hop::wg_commit();
  hop::wg_wait<0>();
  hop::fence_regs(pv);
  hop::fence_regs(acc);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] += pv[i];
}

// Rescale row hh's accumulator and sum where its running max becomes m_new.
template <int D>
__device__ __forceinline__ float rescale(float (&acc)[D / 2], float (&m)[2], float (&l)[2], int hh,
                                         float mx) {
  const float m_new = fmaxf(m[hh], mx);
  const float alpha = exp2f(m[hh] - (m_new == -INFINITY ? 0.f : m_new));
  m[hh] = m_new;
  l[hh] *= alpha;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    acc[4 * jj + 2 * hh] *= alpha;
    acc[4 * jj + 2 * hh + 1] *= alpha;
  }
  return m_new == -INFINITY ? 0.f : m_new;
}

// The TPU kernels' online-softmax step on one bf16 S tile (scores in base
// 2): an update per `sub` keys (JAX's key block when it is narrower than
// the tile, kSplit; else one for the tile), taking the max over the
// update's keys (local_max) or the max pass's m_seg, and applying it where
// the update starts a block (rescale); then P = exp2(s - m), times V's
// scale where it folds (vs_fold != nullptr), in bf16, and O += P V over the
// 16-key chunks that meet the update's keys.  A chunk split between two
// 8-key blocks runs once for each, the other block's half of P zero.
template <int D, bool kSplit>
__device__ __forceinline__ void tpu_update(float (&s)[64], float (&acc)[D / 2], float (&m)[2],
                                           float (&l)[2], const float (&m_seg)[2], bool local_max,
                                           bool rescale_now, int sub, const float* vs_fold,
                                           int quad, uint32_t v_addr) {
  constexpr int BN = 128;
  const int jper = kSplit ? sub / 8 : BN / 8;
  const int n_up = kSplit ? BN / sub : 1;
  for (int sp_ = 0; sp_ < n_up; ++sp_) {
    const int j0 = sp_ * jper, j1 = j0 + jper;
    if (rescale_now) {
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
        rescale<D>(acc, m, l, hh, mx);
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
          if (vs_fold != nullptr) {
            const float2 vsc = *reinterpret_cast<const float2*>(vs_fold + 8 * j + 2 * quad);
            p0 = __fmul_rn(p0, vsc.x);
            p1 = __fmul_rn(p1, vsc.y);
          }
        }
        p[2 * j + hh] = hop::pack_bf16(p0, p1);
      }
    pv_add<D>(acc, p, v_addr, kSplit ? j0 : 0, kSplit ? j1 : BN / 8);
  }
}

// The f32 online-softmax step on one S tile: the tile's max, p = exp2(s -
// m), p' = p * vs (f32) split in registers into three bf16 pieces, and
// O += P' V as three products a 64-key half (the small pieces first),
// summed from zero and then added to acc in f32.
template <int D>
__device__ __forceinline__ void f32_update(float (&s)[64], float (&acc)[D / 2], float (&m)[2],
                                           float (&l)[2], const float* vs_s, int quad,
                                           uint32_t v_addr) {
  constexpr int BN = 128, SW = D >= 64 ? 128 : 64;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
    const float mu = rescale<D>(acc, m, l, hh, quad_max(mx));
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float p0 = exp2f(s[4 * j + 2 * hh] - mu), p1 = exp2f(s[4 * j + 2 * hh + 1] - mu);
      l[hh] += p0 + p1;
      const float2 vsc = *reinterpret_cast<const float2*>(vs_s + 8 * j + 2 * quad);
      s[4 * j + 2 * hh] = __fmul_rn(p0, vsc.x);
      s[4 * j + 2 * hh + 1] = __fmul_rn(p1, vsc.y);
    }
  }
  float pv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) pv[i] = 0.f;
  hop::fence_regs(pv);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t pp[sp::NP][16];   // [piece][2jj + hh]: row hh's keys 64 half + 8jj + 2 quad + {0, 1}
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = 8 * half + jj;
        sp::split_pair(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1], pp[0][2 * jj + hh],
                       pp[1][2 * jj + hh], pp[2][2 * jj + hh]);
      }
    hop::wg_arrive();
#pragma unroll
    for (int pc = sp::NP - 1; pc >= 0; --pc)
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const uint32_t a[4] = {pp[pc][4 * kc], pp[pc][4 * kc + 1], pp[pc][4 * kc + 2],
                               pp[pc][4 * kc + 3]};
        hop::wgmma_rs<1>(pv, a,
                         hop::desc<SW>(v_addr + (64 * half + 16 * kc) * SW, BN * SW, 8 * SW), 1);
      }
    hop::wg_commit();
    hop::wg_wait<0>();
  }
  hop::fence_regs(pv);
  hop::fence_regs(acc);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] += pv[i];
}

// A block owns 128 query rows of one (batch, head), a warpgroup 64, and
// walks the key tiles of 128 its rows can see (the longest walks first).
// Prologue: the rows pre-scaled (bf16: rounded to bf16; f32: in f32), then
// with int8 payloads quantized per row into an int8 tile, with fp8 stored
// as bf16 (f32 q: its three pieces) in a swizzled K-major tile.  A step:
// K (and in a PV pass V) payload bytes and their scales arrive by cp.async
// into a double-buffered staging ring (zero fill past n_kv); V (and an fp8
// K) is widened to bf16 in shared memory and fenced to the async proxy; S
// by one s8 x s8 wgmma (int8, K read from the staging tile) or bf16
// wgmmas (fp8); then the pass's softmax work and the PV wgmmas.
template <typename T, typename P, int D>
__global__ void __launch_bounds__(Tc<T, P, D>::THREADS, 1)
kv8_flash_tc_kernel(Args a) {
  using C = Tc<T, P, D>;
  constexpr int BN = C::BN, SW = C::SW, CPR = C::CPR, SW8 = C::SW8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* stage = q_s + C::Q_BYTES;                 // K0, V0, K1, V1 payload bytes
  uint8_t* k16 = stage + 4 * C::STAGE;               // fp8: the widened K tile
  uint8_t* v16 = k16 + (C::N16 == 2 ? C::TILE16 : 0);   // the widened V tile
  float* scl = reinterpret_cast<float*>(k16 + C::N16 * C::TILE16);   // [buf][ks | vs]
  float* qs_s = scl + 4 * BN;

  const int bh = blockIdx.x, b = bh / a.h, hq = bh % a.h, hk = hq / (a.h / a.h_kv);
  const int n_q = a.n_q, n_kv = a.n_kv;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * C::BM;   // the longest walks first
  const int n_rows = min(C::BM, n_q - row0);
  const int d = a.d;
  const T* qp = static_cast<const T*>(a.q) + (size_t(bh) * n_q + row0) * d;
  const size_t kv_head = (size_t(b) * a.h_kv + hk) * size_t(n_kv);
  const uint8_t* kp = static_cast<const uint8_t*>(a.k) + kv_head * d;
  const uint8_t* vp = static_cast<const uint8_t*>(a.v) + kv_head * d;
  const float* ksp = a.ks + kv_head;
  const float* vsp = a.vs + kv_head;

  int walk_lo, walk_hi, all_lo, all_hi;
  fa::dense_bounds(row0, n_kv, a.causal, 0, walk_lo, all_hi);
  fa::dense_bounds(row0 + n_rows - 1, n_kv, a.causal, 0, all_lo, walk_hi);
  // f32: one online softmax over the tiles; bf16: the route's segments
  Walk walk{walk_hi, BN, kPv};
  int sub = BN;
  bool fold = true;
  if constexpr (!C::kF32) {
    // one max over the walk: the subrow's, or a grid block holding every
    // key (JAX's block is n_kv itself up to 1024 keys); a walk of one tile
    // takes its max on the way
    const bool whole = a.mode == kSubrow || a.span >= n_kv;
    walk.seg = whole ? (1 << 30) : max(a.span, BN);
    walk.first = (whole && walk_hi > BN) || a.span > BN ? kMax : kPv;
    sub = whole ? BN : min(a.span, BN);
    fold = a.mode != kGrid;
  }

  // step (kt, pass) into buffer buf: K (and in a PV step V) and their scales
  auto load = [&](int kt, int buf, bool with_v) {
    uint8_t* st = stage + buf * 2 * C::STAGE;
    hop::load_tile<D, SW8, C::THREADS>(st, kp + size_t(kt) * d, kp, n_kv - kt, BN, d);
    if (with_v)
      hop::load_tile<D, SW8, C::THREADS>(st + C::STAGE, vp + size_t(kt) * d, vp, n_kv - kt, BN,
                                         d);
    const int i = threadIdx.x, pos = kt + i % BN;
    const bool ok = pos < n_kv;
    hop::cp_async<4>(hop::smem_u32(scl + buf * 2 * BN + i), ok ? (i < BN ? ksp : vsp) + pos : ksp,
                     ok);
  };
  int kt = 0, pass = walk.first;
  bool more = walk.end > 0;
  if (more) load(0, 0, pass == kPv);
  hop::cp_async_commit();

  // prologue: q * scale_log2 (bf16: rounded to bf16, one rounding of an
  // exact product; f32: in f32); int8 payloads: per row absmax / 127 (IEEE
  // division, 1 for a zero row), q8 = clip(rint(q / qs), -127, 127)
  {
    constexpr int PER = D / 32;   // values a lane
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < C::BM; r += C::THREADS / 32) {
      float x[PER];
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int c = lane * PER + e;
        const bool live = r < n_rows && c < d;   // columns d..D - 1 zero
        if constexpr (C::kF32)
          x[e] = live ? __fmul_rn(qp[size_t(r) * d + c], a.scale_log2) : 0.f;
        else
          x[e] = live ? __bfloat162float(__float2bfloat16(
                            __bfloat162float(qp[size_t(r) * d + c]) * a.scale_log2))
                      : 0.f;
      }
      if constexpr (C::kInt8) {
        float amax = 0.f;
#pragma unroll
        for (int e = 0; e < PER; ++e) amax = fmaxf(amax, fabsf(x[e]));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
        const float qsc = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
        if (lane == 0) qs_s[r] = qsc;
#pragma unroll
        for (int e = 0; e < PER; ++e) {
          const int c = lane * PER + e;
          q_s[hop::swz<SW8>(r * SW8 + c)] =
              uint8_t(int8_t(fminf(fmaxf(rintf(__fdiv_rn(x[e], qsc)), -127.f), 127.f)));
        }
      } else {
#pragma unroll
        for (int e = 0; e < PER; ++e) {
          const int c = lane * PER + e;
          const uint32_t off = (c / CPR) * (C::BM * SW) + hop::swz<SW>(r * SW + (c % CPR) * 2);
          if constexpr (C::kF32) {
            float b0, b1, b2;
            sp::split3(x[e], b0, b1, b2);
            *reinterpret_cast<bf16*>(q_s + off) = __float2bfloat16(b0);
            *reinterpret_cast<bf16*>(q_s + C::Q_PLANE + off) = __float2bfloat16(b1);
            *reinterpret_cast<bf16*>(q_s + 2 * C::Q_PLANE + off) = __float2bfloat16(b2);
          } else {
            *reinterpret_cast<bf16*>(q_s + off) = __float2bfloat16(x[e]);
          }
        }
      }
    }
  }

  const int wg = threadIdx.x / 128, lt = threadIdx.x % 128;
  const int lane = lt % 32, quad = lane % 4;
  const int rl = wg * 64 + (lt / 32) * 16 + lane / 4;   // local row of hh = 0 (+8: hh = 1)
  int lo[2], hi[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    fa::dense_bounds(row0 + rl + 8 * hh, n_kv, a.causal, 0, lo[hh], hi[hh]);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // m: the running max; l: this thread's columns' sum; m_seg: the max
  // pass's result
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float m_seg[2] = {-INFINITY, -INFINITY};
  float qsr[2] = {1.f, 1.f};
  bool first_step = true;

  const uint32_t q_addr = hop::smem_u32(q_s) + wg * 64 * (C::kInt8 ? SW8 : SW);
  const uint32_t k_addr = hop::smem_u32(k16), v_addr = hop::smem_u32(v16);
  int buf = 0;
  while (more) {
    hop::cp_async_wait<0>();
    __syncthreads();   // step (kt, pass) has landed everywhere; buffer buf ^ 1 is free
    int nkt = kt, npass = pass;
    const bool has_next = walk.next(nkt, npass);
    if (has_next) load(nkt, buf ^ 1, npass == kPv);
    hop::cp_async_commit();
    uint8_t* st = stage + buf * 2 * C::STAGE;
    const float* ks_s = scl + buf * 2 * BN;
    const float* vs_s = ks_s + BN;
    if (pass == kPv && !C::kShare) widen_tile<P, D>(v16, st + C::STAGE, fold ? nullptr : vs_s);
    if constexpr (!C::kInt8) widen_tile<P, D>(k16, st, nullptr);
    hop::fence_async_smem();
    __syncthreads();   // the widened tiles (and, the first time, q) are complete
    if (first_step && C::kInt8) {
      qsr[0] = qs_s[rl];
      qsr[1] = qs_s[rl + 8];
    }
    first_step = false;

    // S = Q K^T: 64 rows x 128 keys a warpgroup, then to f32 scores in
    // base 2; s[4j + 2hh + e] is row rl + 8hh, key kt + 8j + 2 quad + e,
    // and a key the row does not see scores -inf
    float s[BN / 2];
    if constexpr (C::kInt8) {
      int si[BN / 2];
      hop::fence_regs(si);
      hop::wg_arrive();
#pragma unroll
      for (int ks = 0; ks < D / 32; ++ks)
        hop::wgmma_s8(si, hop::desc<SW8>(q_addr + ks * 32, 16, 8 * SW8),
                      hop::desc<SW8>(hop::smem_u32(st) + ks * 32, 16, 8 * SW8), ks > 0);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(si);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = __fmul_rn(float(si[i]), qsr[(i / 2) % 2]);
    } else {
      hop::fence_regs(s);
      hop::wg_arrive();
      // f32 q: its pieces b2, b1, b0 in turn (the small ones first)
#pragma unroll
      for (int pc = C::Q_BYTES / C::Q_PLANE - 1; pc >= 0; --pc)
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t region = ks * 16 / CPR, off = (ks * 16 % CPR) * 2;
          hop::wgmma_ss<0>(
              s, hop::desc<SW>(q_addr + pc * C::Q_PLANE + region * C::BM * SW + off, 16, 8 * SW),
              hop::desc<SW>(k_addr + region * BN * SW + off, 16, 8 * SW),
              pc < C::Q_BYTES / C::Q_PLANE - 1 || ks > 0);
        }
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(s);
    }
    {
      const bool full = kt >= all_lo && kt + BN <= all_hi;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * quad + e;
            float x = __fmul_rn(s[4 * j + 2 * hh + e], ks_s[c]);
            if (!full && (kt + c < lo[hh] || kt + c >= hi[hh])) x = -INFINITY;
            s[4 * j + 2 * hh + e] = x;
          }
    }
    if constexpr (C::kShare) {
      // the widened K and V share one tile: V in place of K after S
      __syncthreads();
      widen_tile<P, D>(v16, st + C::STAGE, nullptr);
      hop::fence_async_smem();
      __syncthreads();
    }

    const bool seg_start = kt == walk.seg_lo(kt);
    if (pass == kMax) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = seg_start ? -INFINITY : m_seg[hh];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
        m_seg[hh] = quad_max(mx);
      }
    } else if constexpr (C::kF32) {
      f32_update<D>(s, acc, m, l, vs_s, quad, v_addr);
    } else if (sub == BN) {
      tpu_update<D, false>(s, acc, m, l, m_seg, walk.first == kPv, seg_start, BN,
                           fold ? vs_s : nullptr, quad, v_addr);
    } else {
      tpu_update<D, true>(s, acc, m, l, m_seg, true, true, sub, nullptr, quad, v_addr);
    }
    kt = nkt;
    pass = npass;
    more = has_next;
    buf ^= 1;
  }
  hop::cp_async_wait<0>();

  // epilogue: o = acc * (1 / l) (modes 1 and 3, and f32), acc / l (mode 2);
  // lse = m ln 2 + ln l; a row with no live key gives o = 0, lse = -inf
  __syncthreads();   // both warpgroups' last wgmmas are done with the tiles
  const bool divide = !C::kF32 && a.mode == kSubrow;
  if constexpr (C::kF32) {
    float* o = static_cast<float*>(a.o);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float lt_ = quad_sum(l[hh]);
      const int row = row0 + rl + 8 * hh;
      if (row >= n_q) continue;
      const float inv = lt_ == 0.f ? 0.f : 1.f / lt_;
      float* orow = o + (size_t(bh) * n_q + row) * d;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        if (8 * j < d)
          *reinterpret_cast<float2*>(orow + 8 * j + 2 * quad) =
              make_float2(acc[4 * j + 2 * hh] * inv, acc[4 * j + 2 * hh + 1] * inv);
      if (quad == 0)
        a.lse[size_t(bh) * n_q + row] = lt_ == 0.f ? -INFINITY : m[hh] * fa::LN2 + logf(lt_);
    }
  } else {
    // o staged in shared memory (the staging ring is free) and stored in
    // whole rows
    constexpr int OS = D * 2 + 16;   // bytes of a staged row
    static_assert(C::BM * OS <= 4 * C::STAGE, "the staged tile fits in the staging ring");
    bf16* o = static_cast<bf16*>(a.o) + (size_t(bh) * n_q + row0) * d;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float lt_ = quad_sum(l[hh]);
      const int r = rl + 8 * hh;
      const float inv = lt_ == 0.f ? 0.f : 1.f / lt_;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        float o0 = acc[4 * j + 2 * hh], o1 = acc[4 * j + 2 * hh + 1];
        if (divide) {
          o0 = lt_ == 0.f ? 0.f : __fdiv_rn(o0, lt_);
          o1 = lt_ == 0.f ? 0.f : __fdiv_rn(o1, lt_);
        } else {
          o0 *= inv;
          o1 *= inv;
        }
        *reinterpret_cast<__nv_bfloat162*>(stage + r * OS + 2 * (8 * j + 2 * quad)) =
            __floats2bfloat162_rn(o0, o1);
      }
      if (quad == 0 && r < n_rows)
        a.lse[size_t(bh) * n_q + row0 + r] =
            lt_ == 0.f ? -INFINITY : m[hh] * fa::LN2 + logf(lt_);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_rows * (D / 8); i += C::THREADS) {
      const int r = i / (D / 8), c = i % (D / 8) * 8;
      if (c >= d) continue;   // columns below d
      *reinterpret_cast<uint4*>(o + size_t(r) * d + c) =
          *reinterpret_cast<const uint4*>(stage + r * OS + 2 * c);
    }
  }
}

template <typename T, typename P, int D>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  using C = Tc<T, P, D>;
  auto kernel = kv8_flash_tc_kernel<T, P, D>;
  static cudaError_t opted = fa::allow_smem(kernel, C::SMEM);
  if (opted != cudaSuccess) return opted;
  if constexpr (!C::kF32) {
    const int s = a.span;
    const bool ok = a.mode == kSubrow || (a.mode == kGrid && s >= a.n_kv) ||
                    (a.mode == kLoop && s >= C::BN && s % C::BN == 0) ||
                    (a.mode == kGrid && s >= 8 && s % 8 == 0 &&
                     (s > C::BN ? s % C::BN == 0 : C::BN % s == 0));
    if (!ok) return cudaErrorInvalidValue;
  }
  dim3 grid(b * a.h, (a.n_q + C::BM - 1) / C::BM);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// the kernel at the tile width of d (hop::tile_width), reading d itself
template <typename T, typename P>
cudaError_t dispatch_d(int d, const Args& a, int b, cudaStream_t st) {
  switch (hop::tile_width(d)) {
    case 32: return launch<T, P, 32>(a, b, st);
    case 64: return launch<T, P, 64>(a, b, st);
    case 128: return launch<T, P, 128>(a, b, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* k_scales,
             const void* v_scales, void* o, void* lse, int b, int h, int h_kv, int n_q, int n_kv,
             int d, int causal, float scale_log2, int payload, int mode, int span, void* stream) {
  if (b == 0 || h == 0 || n_q == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{q, k, v, static_cast<const float*>(k_scales), static_cast<const float*>(v_scales), o,
         static_cast<float*>(lse), h, h_kv, n_q, n_kv, causal, scale_log2, mode, span, d};
  if (payload == 2) return int(dispatch_d<T, int8_t>(d, a, b, st));
  if (payload == 3) return int(dispatch_d<T, __nv_fp8_e4m3>(d, a, b, st));
  return int(cudaErrorInvalidValue);
}

}  // namespace

// q (b, h, n_q, d) bf16; k, v (b, h_kv, n_kv, d) payloads; k_scales,
// v_scales (b, h_kv, n_kv) f32; o like q; lse (b, h, n_q) f32.  scale_log2
// is sm_scale * log2(e) rounded to q's dtype.  payload 2 = int8, 3 = float8
// e4m3.  mode: 1 grid (a running max per `span` keys: 8 to 1024, or at
// least n_kv for one block), 2 subrow
// (the row's max), 3 loop (a running max per `span` keys, a multiple of
// 128, V's scale folded into p).
extern "C" int fa_kv8_flash(const void* q, const void* k, const void* v,
                            const void* k_scales, const void* v_scales, void* o,
                            void* lse, int b, int h, int h_kv, int n_q, int n_kv,
                            int d, int causal, float scale_log2, int payload, int mode,
                            int span, void* stream) {
  return dispatch<bf16>(q, k, v, k_scales, v_scales, o, lse, b, h, h_kv, n_q, n_kv, d, causal,
                        scale_log2, payload, mode, span, stream);
}

// The same with q and o f32, on the tensor cores in split precision: one
// function for every route (see the note at the top).
extern "C" int fa_kv8_flash_f32(const void* q, const void* k, const void* v,
                                const void* k_scales, const void* v_scales, void* o,
                                void* lse, int b, int h, int h_kv, int n_q, int n_kv,
                                int d, int causal, float scale_log2, int payload,
                                void* stream) {
  return dispatch<float>(q, k, v, k_scales, v_scales, o, lse, b, h, h_kv, n_q, n_kv, d, causal,
                         scale_log2, payload, kGrid, 128, stream);
}
