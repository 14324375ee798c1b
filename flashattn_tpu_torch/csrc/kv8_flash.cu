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
//     the whole quantized row resident;
// all three compute one function (in bf16 the loop and subrow schedules
// fold the V scale into p instead, another rounding), and one kernel per q
// dtype computes it at every shape.
//
// Numerics (those of the TPU grid kernel): q is pre-scaled by
// sm_scale * log2(e) in q's dtype.  int8 payloads: each q row is then
// quantized to int8 (absmax / 127 by IEEE division, round half to even) and
// the scores are the exact integer product q8 . k8 times the q row's
// scale, then the key's scale; fp8 payloads: q . k8 in f32 times the key's
// scale.  The softmax runs in f32 in exp2; P = exp2(s - m) and
// V = v8 * v_scale each round to q's dtype before the PV product, summed
// in f32 and divided by the row sum last.  Causal is top-left aligned (key
// c <= row R).  GQA: q head h reads kv head h / (h_q / h_kv).  The Python
// wrapper transcodes fp8 payloads to int8 at the TPU subrow envelope
// (requantize_fp8_to_int8), as the JAX dispatcher does, so the function is
// the same at every shape.
//
// bf16 q (head dim 32, 64 or 128) runs a tensor-core kernel on the
// structure of the bf16 flash forward (flash_fwd.cu).  What bounds it on
// the H100 is its two products (QK^T at the int8 peak for int8 payloads,
// PV at the bf16 one); the 1-byte K/V and their scales halve the bytes of
// a bf16 cache.  A block owns 128 query rows, two consumer warpgroups of
// 64; its prologue pre-scales (and for int8 quantizes) them once into a
// swizzled K-major tile.  K/V tiles of 128 keys arrive as payload bytes in
// a double-buffered cp.async ring.  int8: S is one s8 x s8 -> s32 wgmma
// (both operands K-major, the tile of D-byte rows swizzled by D bytes),
// read from the staged K bytes as they are.  fp8: K is widened to bf16 in
// shared memory (exact) for a bf16 wgmma.  V is widened to bf16(v8 * vs)
// into the MN-major B tile and fenced to the async proxy, as wo_matmul.cu
// converts W.  The online softmax runs on the fragment and P stays in bf16
// registers, the A operand of the PV wgmma; the output leaves staged through
// shared memory in whole rows.
//
// f32 q keeps the FMA tile of attn_core.cuh (bound by FP32 instruction
// throughput and shared-memory reads): one block owns (batch * head, 64
// query rows), stages K and V dequantized in f32 and walks the key tiles
// its rows can see; the int8 q rows are quantized once per block in shared
// memory.

#include <type_traits>

#include "attn_core.cuh"
#include "hopper.cuh"

namespace {

template <typename T, typename P, int D>
struct Kv8Src {
  static constexpr bool kQuantQ = std::is_same<P, int8_t>::value;
  const T* q; const P* k; const P* v; const float* ks; const float* vs;
  T* o; float* lse;
  int n_rows, kv_cap;
  int row0;            // first query row of this tile
  int causal;

  static_assert(std::is_same<T, float>::value, "bf16 q runs the tensor-core tile");
  // q * scale in q's dtype (f32)
  __device__ float4 q4(int r, int c, float scale) const {
    return fa::scale4(fa::load4(q + size_t(r) * D + c), scale);
  }
  __device__ float4 k4(int pos, int c) const {
    return fa::scale4(fa::load4(k + size_t(pos) * D + c), ks[pos]);
  }
  __device__ float4 v4(int pos, int c) const {
    return fa::scale4(fa::load4(v + size_t(pos) * D + c), vs[pos]);
  }
  __device__ T* o_row(int r) const { return o + size_t(r) * D; }
  __device__ float* lse_row(int r) const { return lse + r; }
  __device__ void bounds(int r, int& lo, int& hi) const {
    fa::dense_bounds(row0 + r, kv_cap, causal, 0, lo, hi);
  }
};

struct Args {
  const void* q; const void* k; const void* v; const float* ks; const float* vs;
  void* o; float* lse;
  int h, h_kv, n_q, n_kv, causal;
  float scale_log2;
};

template <typename T, typename P, int D>
__global__ void __launch_bounds__(fa::threads<64>())
kv8_flash_kernel(Args a) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;
  const int b = bh / a.h, hq = bh % a.h;
  const int hk = hq / (a.h / a.h_kv);
  const int row0 = blockIdx.y * 64;
  const size_t kv_head = (size_t(b) * a.h_kv + hk) * size_t(a.n_kv);

  Kv8Src<T, P, D> src;
  src.q = static_cast<const T*>(a.q) + (size_t(bh) * a.n_q + row0) * D;
  src.o = static_cast<T*>(a.o) + (size_t(bh) * a.n_q + row0) * D;
  src.lse = a.lse + size_t(bh) * a.n_q + row0;
  src.k = static_cast<const P*>(a.k) + kv_head * D;
  src.v = static_cast<const P*>(a.v) + kv_head * D;
  src.ks = a.ks + kv_head;
  src.vs = a.vs + kv_head;
  src.n_rows = min(64, a.n_q - row0);
  src.kv_cap = a.n_kv;
  src.row0 = row0;
  src.causal = a.causal;
  fa::attend<T, D, 64>(src, a.scale_log2, smem);
}

template <typename T, typename P, int D>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  constexpr size_t smem = fa::smem_bytes<D, 64>();
  auto kernel = kv8_flash_kernel<T, P, D>;
  static cudaError_t opted = fa::allow_smem(kernel, smem);
  if (opted != cudaSuccess) return opted;
  dim3 grid(b * a.h, (a.n_q + 63) / 64);
  kernel<<<grid, fa::threads<64>(), smem, stream>>>(a);
  return cudaGetLastError();
}

// -- bf16 q: the tensor-core tile --------------------------------------------------

using bf16 = __nv_bfloat16;

template <typename P, int D>
struct Tc {
  static constexpr bool kInt8 = std::is_same<P, int8_t>::value;
  static constexpr int BM = 128, BN = 128, THREADS = 256;
  static constexpr int SW = D >= 64 ? 128 : 64;   // bytes of a swizzled bf16 row
  static constexpr int CPR = SW / 2;              // bf16 columns a region row holds
  static constexpr int SW8 = D;                   // an 8-bit row: D bytes, one region
  static constexpr int Q_BYTES = BM * D * (kInt8 ? 1 : 2);
  static constexpr int STAGE = BN * D;            // payload bytes of a K or V tile
  static constexpr int TILE16 = BN * D * 2;       // a bf16 K or V tile
  static constexpr size_t SMEM = 1024 + Q_BYTES + 4 * size_t(STAGE) +
                                 (kInt8 ? 1 : 2) * size_t(TILE16) +
                                 (4 * BN + BM) * sizeof(float);
};

// 8-bit payload to f32 (exact).
__device__ __forceinline__ float byte_f(int8_t b) { return float(b); }
__device__ __forceinline__ float byte_f(__nv_fp8_e4m3 b) { return float(b); }

// One staged payload tile (rows of D bytes, swizzled by SW8) to the bf16
// tile read by wgmma (the forward's layout: regions of CPR columns, region
// stride BN * SW, swizzled), each value times its row's scale (scales ==
// nullptr: times 1) and rounded to bf16 once.  16 bytes a work item.
template <typename P, int D>
__device__ __forceinline__ void widen_tile(uint8_t* dst, const uint8_t* stage,
                                           const float* scales) {
  using C = Tc<P, D>;
  for (int i = threadIdx.x; i < C::BN * D / 16; i += C::THREADS) {
    const int r = i / (D / 16), c0 = i % (D / 16) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        stage + hop::swz<C::SW8>(r * C::SW8 + c0));
    const P* vals = reinterpret_cast<const P*>(&raw);
    const float sc = scales != nullptr ? scales[r] : 1.f;
    uint4 out[2];
    uint32_t* o = reinterpret_cast<uint32_t*>(out);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = hop::pack_bf16(byte_f(vals[2 * e]) * sc, byte_f(vals[2 * e + 1]) * sc);
    uint8_t* region = dst + (c0 / C::CPR) * (C::BN * C::SW);
    const int cb = (c0 % C::CPR) * 2;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<uint4*>(region + hop::swz<C::SW>(r * C::SW + cb + 16 * hf)) = out[hf];
  }
}

// A block owns 128 query rows of one (batch, head), a warpgroup 64, and
// walks the key tiles of 128 its rows can see.  Prologue: the rows
// pre-scaled in bf16 (and with int8 payloads quantized per row) into a
// swizzled K-major tile.  Per tile: K and V payload bytes and their scales
// arrive by cp.async into a double-buffered staging ring (zero fill past
// n_kv); V (and an fp8 K) is widened to bf16 in shared memory and fenced to
// the async proxy; S by one s8 x s8 wgmma (int8, K read from the staging
// tile) or a bf16 wgmma (fp8); the online softmax on the fragment; P in
// bf16 registers into the PV wgmma (V MN-major).
template <typename P, int D>
__global__ void __launch_bounds__(Tc<P, D>::THREADS, 1)
kv8_flash_tc_kernel(Args a) {
  using C = Tc<P, D>;
  constexpr int BN = C::BN, SW = C::SW, CPR = C::CPR, SW8 = C::SW8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* stage = q_s + C::Q_BYTES;                 // K0, V0, K1, V1 payload bytes
  uint8_t* k16 = stage + 4 * C::STAGE;               // fp8: the widened K tile
  uint8_t* v16 = k16 + (C::kInt8 ? 0 : C::TILE16);   // the widened V tile
  float* scl = reinterpret_cast<float*>(v16 + C::TILE16);   // [buf][ks | vs]
  float* qs_s = scl + 4 * BN;

  const int bh = blockIdx.x, b = bh / a.h, hq = bh % a.h, hk = hq / (a.h / a.h_kv);
  const int n_q = a.n_q, n_kv = a.n_kv;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * C::BM;   // the longest walks first
  const int n_rows = min(C::BM, n_q - row0);
  const bf16* qp = static_cast<const bf16*>(a.q) + (size_t(bh) * n_q + row0) * D;
  const size_t kv_head = (size_t(b) * a.h_kv + hk) * size_t(n_kv);
  const uint8_t* kp = static_cast<const uint8_t*>(a.k) + kv_head * D;
  const uint8_t* vp = static_cast<const uint8_t*>(a.v) + kv_head * D;
  const float* ksp = a.ks + kv_head;
  const float* vsp = a.vs + kv_head;

  int walk_lo, walk_hi, all_lo, all_hi;
  fa::dense_bounds(row0, n_kv, a.causal, 0, walk_lo, all_hi);
  fa::dense_bounds(row0 + n_rows - 1, n_kv, a.causal, 0, all_lo, walk_hi);
  const int end = walk_hi;

  auto load = [&](int kt, int buf) {
    uint8_t* st = stage + buf * 2 * C::STAGE;
    hop::load_tile<D, SW8, C::THREADS>(st, kp + size_t(kt) * D, kp, n_kv - kt, BN);
    hop::load_tile<D, SW8, C::THREADS>(st + C::STAGE, vp + size_t(kt) * D, vp, n_kv - kt, BN);
    const int i = threadIdx.x, pos = kt + i % BN;
    const bool ok = pos < n_kv;
    hop::cp_async<4>(hop::smem_u32(scl + buf * 2 * BN + i), ok ? (i < BN ? ksp : vsp) + pos : ksp,
                     ok);
  };
  if (end > 0) load(0, 0);
  hop::cp_async_commit();

  // prologue: q * scale_log2 rounded to bf16 (one rounding of an exact
  // product); int8 payloads: per row absmax / 127 (IEEE division, 1 for a
  // zero row), q8 = clip(rint(q / qs), -127, 127)
  {
    constexpr int PER = D / 32;   // values a lane
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < C::BM; r += C::THREADS / 32) {
      float x[PER];
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int c = lane * PER + e;
        x[e] = r < n_rows ? __bfloat162float(__float2bfloat16(
                                __bfloat162float(qp[size_t(r) * D + c]) * a.scale_log2))
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
          *reinterpret_cast<bf16*>(q_s + (c / CPR) * (C::BM * SW) +
                                   hop::swz<SW>(r * SW + (c % CPR) * 2)) = __float2bfloat16(x[e]);
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
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // l: this thread's columns
  float qsr[2] = {1.f, 1.f};

  const uint32_t q_addr = hop::smem_u32(q_s) + wg * 64 * (C::kInt8 ? SW8 : SW);
  int buf = 0;
  for (int kt = 0; kt < end; kt += BN, buf ^= 1) {
    hop::cp_async_wait<0>();
    __syncthreads();   // tile kt has landed everywhere; buffer buf ^ 1 is free
    if (kt + BN < end) load(kt + BN, buf ^ 1);
    hop::cp_async_commit();
    uint8_t* st = stage + buf * 2 * C::STAGE;
    const float* ks_s = scl + buf * 2 * BN;
    widen_tile<P, D>(v16, st + C::STAGE, ks_s + BN);
    if constexpr (!C::kInt8) widen_tile<P, D>(k16, st, nullptr);
    hop::fence_async_smem();
    __syncthreads();   // the widened tiles (and, the first time, q) are complete
    if (kt == 0 && C::kInt8) {
      qsr[0] = qs_s[rl];
      qsr[1] = qs_s[rl + 8];
    }

    // S = Q K^T: 64 rows x 128 keys a warpgroup, then to f32 scores
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
      for (int i = 0; i < BN / 2; ++i) s[i] = float(si[i]) * qsr[(i / 2) % 2];
    } else {
      hop::fence_regs(s);
      hop::wg_arrive();
      const uint32_t k_addr = hop::smem_u32(k16);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t region = ks * 16 / CPR, off = (ks * 16 % CPR) * 2;
        hop::wgmma_ss<0>(s, hop::desc<SW>(q_addr + region * C::BM * SW + off, 16, 8 * SW),
                         hop::desc<SW>(k_addr + region * BN * SW + off, 16, 8 * SW), ks > 0);
      }
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(s);
    }

    // online softmax on the fragment: s[4j + 2hh + e] is row rl + 8hh, key
    // kt + 8j + 2 quad + e; the scores are already in base 2
    const bool full = kt >= all_lo && kt + BN <= all_hi;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * quad + e;
          float x = s[4 * j + 2 * hh + e] * ks_s[c];
          if (!full && (kt + c < lo[hh] || kt + c >= hi[hh])) x = -INFINITY;
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

    // O += P V: P from registers (16 keys a step), the widened V MN-major
    const uint32_t v_addr = hop::smem_u32(v16);
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

  // epilogue, as the forward's: o = acc / l staged through shared memory
  // (the staging ring is free) and stored in whole rows; lse
  __syncthreads();
  constexpr int OS = D * 2 + 16;   // bytes of a staged row
  static_assert(C::BM * OS <= 4 * C::STAGE, "the staged tile fits in the staging ring");
  bf16* o = static_cast<bf16*>(a.o) + (size_t(bh) * n_q + row0) * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt_ = l[hh];
    lt_ += __shfl_xor_sync(0xffffffffu, lt_, 1);
    lt_ += __shfl_xor_sync(0xffffffffu, lt_, 2);
    const int r = rl + 8 * hh;
    const float div = lt_ == 0.f ? 1.f : lt_;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(stage + r * OS + 2 * (8 * j + 2 * quad)) =
          __floats2bfloat162_rn(__fdiv_rn(acc[4 * j + 2 * hh], div),
                                __fdiv_rn(acc[4 * j + 2 * hh + 1], div));
    if (quad == 0 && r < n_rows)
      a.lse[size_t(bh) * n_q + row0 + r] = lt_ == 0.f ? -INFINITY : m[hh] * fa::LN2 + logf(lt_);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_rows * (D / 8); i += C::THREADS) {
    const int r = i / (D / 8), c = i % (D / 8) * 8;
    *reinterpret_cast<uint4*>(o + size_t(r) * D + c) =
        *reinterpret_cast<const uint4*>(stage + r * OS + 2 * c);
  }
}

template <typename P, int D>
cudaError_t launch_tc(const Args& a, int b, cudaStream_t stream) {
  using C = Tc<P, D>;
  auto kernel = kv8_flash_tc_kernel<P, D>;
  static cudaError_t opted = fa::allow_smem(kernel, C::SMEM);
  if (opted != cudaSuccess) return opted;
  dim3 grid(b * a.h, (a.n_q + C::BM - 1) / C::BM);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// bf16 q: the tensor-core tile; f32 q: the FMA tile.
template <typename T, typename P, int D>
cudaError_t launch_any(const Args& a, int b, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_tc<P, D>(a, b, st);
  else
    return launch<T, P, D>(a, b, st);
}

template <typename T, typename P>
cudaError_t dispatch_d(int d, const Args& a, int b, cudaStream_t st) {
  switch (d) {
    case 32: return launch_any<T, P, 32>(a, b, st);
    case 64: return launch_any<T, P, 64>(a, b, st);
    case 128: return launch_any<T, P, 128>(a, b, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_payload(int payload, int d, const Args& a, int b,
                             cudaStream_t st) {
  if (payload == 2) return dispatch_d<T, int8_t>(d, a, b, st);
  if (payload == 3) return dispatch_d<T, __nv_fp8_e4m3>(d, a, b, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (b, h, n_q, d); k, v (b, h_kv, n_kv, d) payloads; k_scales, v_scales
// (b, h_kv, n_kv) f32; o like q; lse (b, h, n_q) f32.  scale_log2 is
// sm_scale * log2(e) rounded to q's dtype.  dtype codes: 0 = float32,
// 1 = bfloat16 (q, o); payload 2 = int8, 3 = float8 e4m3.
extern "C" int fa_kv8_flash(const void* q, const void* k, const void* v,
                            const void* k_scales, const void* v_scales, void* o,
                            void* lse, int b, int h, int h_kv, int n_q, int n_kv,
                            int d, int causal, float scale_log2, int dtype,
                            int payload, void* stream) {
  if (b == 0 || h == 0 || n_q == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{q, k, v, static_cast<const float*>(k_scales),
         static_cast<const float*>(v_scales), o, static_cast<float*>(lse),
         h, h_kv, n_q, n_kv, causal, scale_log2};
  if (dtype == 0) return dispatch_payload<float>(payload, d, a, b, st);
  if (dtype == 1) return dispatch_payload<__nv_bfloat16>(payload, d, a, b, st);
  return int(cudaErrorInvalidValue);
}
