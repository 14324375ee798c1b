// Fused attention softmax, forward and backward, over (B, H, F, T) scores.
//
// Forward: out = softmax(x [+ mask], -1) in x's dtype.  The additive mask
// is read as f32 and broadcast as (B|1, H|1, F|1, T) through zero strides,
// never materialised.  `causal` REPLACES every entry with col > row
// (absolute indices, aligned top-left) by DEFAULT_MASK_VALUE, whatever x
// and the mask held there (flashattn_tpu/ops/softmax.py:44-48).  Two
// roundings, a template flag (kOp) of every kernel:
// - the Pallas kernel's function: f32 inside, one rounding at the end
//   (softmax.py:40-52);
// - JAX's op graph in bf16 (attn_softmax_reference, jax.nn.softmax), which
//   JAX's impl="auto" runs: v = bf16(x + mask), the causal entries
//   bf16(DEFAULT_MASK_VALUE), d = bf16(v - max), e = bf16(exp(d)), w =
//   bf16(sum_f32(e)), out = bf16(e / w) (an IEEE division, as XLA's).
// Backward, Pallas function: dinp = out * (dout - sum_row(dout * out)), f32
// accumulation (softmax.py:55-59).  Backward, op graph (bf16): JAX's
// autodiff of the graph, from x: with m, e and w rebuilt for the row,
//   x2 = bf16(1 / bf16(w * w)), z = bf16(bf16(dout * x2) * e),
//   ba = XLA:CPU's bf16 sum of z (below), dx = bf16(bf16(bf16(dout / w) -
//   ba) * e), 0 on the causal entries.
//
// Replaces the TPU kernels flashattn_tpu/ops/softmax.py::_softmax_fwd_kernel
// and _softmax_fwd_nomask_kernel (launched by _fwd_impl) and
// _softmax_bwd_kernel (launched by _attn_softmax_vjp_bwd), which hold a
// (block_rows, T) VMEM tile per grid step; the op-graph mode is what XLA
// makes of attn_softmax_reference.
//
// What bounds it on the H100: bytes.  The forward reads x's live entries
// (and the mask) once and writes out once, the backward reads x (or out)
// and dout and writes dinp, with a few operations an element.
//
// Design, rows held in registers (softmax_fwd_rows, softmax_bwd_op_rows):
// a row belongs to a row group, G warps (G > 1) or S lanes of one warp
// (G == 1, S a power of two, so a warp holds 32 / S short rows).  Each
// thread holds C accesses of W elements (a 16-byte chunk, W = 8 bf16 / 4
// f32, when T is a whole number of chunks; else W = 1, scalar), at columns
// (k * P + idx) * W for a group of P threads.  A row's loads (x, the mask,
// dout) are all issued before any is used, and HBM is read once.  The
// row's max, then its sum, come from registers: an exact two-pass max and
// sum, no online rescaling; xor shuffles within the S lanes or the warp,
// then, for G > 1, the group's warps through shared memory in warp order
// behind the group's own named barrier.  Every thread of the group ends
// with the same value.  The output is written from registers; the entries
// of a causal row past the diagonal are the constant exp(mask - max) / sum
// (0 in practice), written without being read.  256 threads a block hold
// 256 / (32 G) or 8 * 32 / S rows, so T 33 no longer takes a block a row;
// the grid is sized to the card and the row groups walk the rows, the
// forward loading its next row while it works on the current one.
//
// What the first version lost to (probes over hand-edited copies, PERF.md):
// the kernels were bound by instructions and latency, not bytes.  A 64-bit
// row / F, an IEEE division with its slow-path check on every element and
// per-element live tests cost more than the loads; now the row index is 32
// bits, the division is e * (1/w) corrected once by its exact remainder
// (div_rn, correctly rounded like the division JAX does), and whole chunks
// are classed live, dead or across the diagonal.  Envelope: 1024 chunks a
// row (T 8192 bf16, 4096 f32) in 16-byte accesses, or 256 scalars; longer
// or unaligned rows (T 4097) take the generic kernels below, one block a
// row.  Layouts by chunks a row: <= 32 S lanes, <= 64 (G 1, C 2), <= 128
// (2, 2), <= 256 (2, 4), <= 512 (8, 2), <= 1024 (8, 4); scalars: C of 4, 5
// or 8 with the fewest lanes.  The op graph's backward does its bf16
// roundings as bf16 instructions (__hsub, __hmul: the same results, a third
// of the instructions).  Registers (nvcc -Xptxas -v, sm_90a, no spills):
// the forward at (2, 4), T 2048 bf16, 127 (both roundings; two blocks an
// SM); (8, 2) f32 58; scalar C 5 (T 33) 62; the op graph's backward at
// (2, 4) 122 (with the next row's x and dout prefetched it took 174 and ran
// 1.5x slower, so it loads its row and then works on it; capped at three
// blocks an SM it spilled and ran 3% slower).
//
// XLA:CPU's bf16 reduce_sum (what JAX's backward runs on the CPU,
// TreeReductionRewriter): a row of n > 32 values is padded with (-n) mod 32
// zeros, half of them (rounded down) in front, and each window of 32 summed
// in order from 0 with the running sum rounded to bf16 after every add;
// the window sums are reduced the same way until at most 32 are left, which
// are summed in order.  Adding a bf16 zero changes nothing, so the entries
// of a causal row past the diagonal are skipped.  The register kernel puts
// the row's z in shared memory and its group's threads take the windows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "vec16.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ops/_utils.py::DEFAULT_MASK_VALUE (-0.7 x f32 max, computed in double and
// rounded to f32, as torch rounds the Python float)
constexpr float kMaskValue = float(-0.7 * 3.4028234663852886e38);
constexpr int kMaxThreads = 256;
constexpr int kWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWindow = 32;  // XLA:CPU's reduction window

__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16(v)); }

// a / b rounded to nearest, as the IEEE division: q = a (1/b), then one
// correction by the exact remainder a - q b (Markstein: with 1/b correctly
// rounded and q within an ulp, q + r (1/b) rounds to the correctly rounded
// quotient, for normal operands).  Three operations an element instead of
// the division's refinement and its slow-path check; rb = __frcp_rn(b) is
// taken once a row.
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  const float q = __fmul_rn(a, rb);
  return __fmaf_rn(__fmaf_rn(-q, b, a), rb, q);
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16(v); }

// V consecutive elements as f32; V is 1, or a multiple of 16 bytes' worth
template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  if constexpr (V == 1) {
    v[0] = to_f(*p);
  } else {
#pragma unroll
    for (int k = 0; k < V; k += fa::kVec<T>) fa::unpack16<T>(fa::load16(p + k), v + k);
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  if constexpr (V == 1) {
    put(p, v[0]);
  } else {
#pragma unroll
    for (int k = 0; k < V; k += fa::kVec<T>) fa::store16(p + k, fa::pack16<T>(v + k));
  }
}

// (m, s) <- the merge of two partial softmax states: max, and sum of
// exp(x - max).  An empty state is (-FLT_MAX, 0), which merges without NaN.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// The row's (max, sum) from every thread's partial state, the same in every
// thread: warp shuffles, then the warps' states merged in warp order.
__device__ __forceinline__ void block_merge(float& m, float& s) {
  __shared__ float sm[kWarps], ss[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    merge(m, s, __shfl_xor_sync(kFull, m, off), __shfl_xor_sync(kFull, s, off));
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  if (threadIdx.x % 32 == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  m = sm[0];
  s = ss[0];
  for (int w = 1; w < warps; ++w) merge(m, s, sm[w], ss[w]);
}

template <bool kMax>
__device__ __forceinline__ float combine(float a, float b) {
  return kMax ? fmaxf(a, b) : a + b;
}

// The block's max or sum, the same in every thread (warp shuffles, then the
// warps in order).  `buf` holds a value per warp; the leading barrier lets
// one buffer serve consecutive calls.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* buf) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = combine<kMax>(v, __shfl_xor_sync(kFull, v, off));
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  __syncthreads();
  if (threadIdx.x % 32 == 0) buf[warp] = v;
  __syncthreads();
  v = buf[0];
  for (int w = 1; w < warps; ++w) v = combine<kMax>(v, buf[w]);
  return v;
}

// The in-order bf16 sum of p[a..b).  A whole window whose start is 16-byte
// aligned (shared memory) is read with four 16-byte loads ahead of an
// unrolled chain of adds.
__device__ __forceinline__ bf16 window_sum(const bf16* p, int a, int b) {
  bf16 acc = __float2bfloat16(0.f);
  if (b - a == kWindow && (reinterpret_cast<uintptr_t>(p + a) & 15) == 0) {
    uint4 u[kWindow / 8];
#pragma unroll
    for (int q = 0; q < kWindow / 8; ++q) u[q] = reinterpret_cast<const uint4*>(p + a)[q];
#pragma unroll
    for (int q = 0; q < kWindow / 8; ++q) {
      const bf16* h = reinterpret_cast<const bf16*>(&u[q]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = __hadd(acc, h[j]);
    }
    return acc;
  }
  for (int j = a; j < b; ++j) acc = __hadd(acc, p[j]);
  return acc;
}

template <typename Src>
__device__ __forceinline__ bf16 window_sum(Src src, int a, int b) {
  bf16 acc = __float2bfloat16(0.f);
  for (int j = a; j < b; ++j) acc = __hadd(acc, src(j));
  return acc;
}

// XLA:CPU's bf16 reduce_sum of a row of n values whose entries at `live`
// and past are 0 (header).  Level 0 reads src(j) (bf16); the window sums go
// to `part`.  XLA adds in f32 and rounds to bf16; the sum of two bf16
// values needs at most 24 bits where it can round differently, so that
// equals one bf16 add (__hadd), which keeps the serial chain short.
// Threads idx = 0..P-1 of the row's group take the windows in turn; sync()
// is the group's barrier.  Returns the sum in every thread of the group
// (through *slot).
template <typename Src, typename Sync>
__device__ float xla_bf16_sum(Src src, int n, int live, bf16* part, float* slot, int idx, int P,
                              Sync sync) {
  bool level0 = true;
  int src_off = 0, dst_off = 0;
  while (n > kWindow) {
    const int pad = (kWindow - n % kWindow) % kWindow, lo = pad / 2;
    const int nw = (n + pad) / kWindow;
    for (int k = idx; k < nw; k += P) {
      const int a = max(kWindow * k - lo, 0), b = min(kWindow * k - lo + kWindow, live);
      const bf16* prev = part + src_off;
      part[dst_off + k] = a >= b ? __float2bfloat16(0.f)
                          : level0 ? window_sum(src, a, b)
                                   : window_sum(prev, a, b);
    }
    sync();
    live = min(nw, (live + lo + kWindow - 1) / kWindow);
    n = nw;
    src_off = dst_off;
    dst_off += nw;
    level0 = false;
  }
  if (idx == 0) {
    const bf16* prev = part + src_off;
    *slot = __bfloat162float(level0 ? window_sum(src, 0, live) : window_sum(prev, 0, live));
  }
  sync();
  return *slot;
}

// ---------------------------------------------------------------------------
// Rows held in registers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The calling thread's place in its row group (header): idx of P threads,
// group `slot` of the R groups of its block.
template <int G>
struct RowGroup {
  int idx, P, slot, R, S;
  __device__ __forceinline__ explicit RowGroup(int lanes) : S(G > 1 ? 32 : lanes) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (G > 1) {
      idx = (warp % G) * 32 + lane;
      P = 32 * G;
      slot = warp / G;
      R = kWarps / G;
    } else {
      idx = lane % S;
      P = S;
      slot = warp * (32 / S) + lane / S;
      R = kWarps * (32 / S);
    }
  }
  __device__ __forceinline__ void sync() const {
    if constexpr (G > 1) group_sync(1 + slot, 32 * G);
    else __syncwarp();
  }
  // The group's max or sum: shuffles within the S lanes, then (G > 1) the
  // group's warps in order through `red` (a float per warp of the block).
  template <bool kMax>
  __device__ __forceinline__ float reduce(float v, float* red) const {
    for (int off = S / 2; off > 0; off >>= 1)
      v = combine<kMax>(v, __shfl_xor_sync(kFull, v, off));
    if constexpr (G > 1) {
      if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
      sync();
      v = red[slot * G];
#pragma unroll
      for (int i = 1; i < G; ++i) v = combine<kMax>(v, red[slot * G + i]);
    }
    return v;
  }
};

// A row's raw x (or dout) at this thread's columns, as loaded: C accesses of
// W elements, those at columns not below `live` not loaded.
template <typename T, int W, int C>
struct RawRow {
  using Item = typename std::conditional<W == 1, T, uint4>::type;
  Item r[C];
  __device__ __forceinline__ void load(const T* p, int idx, int P, int live) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c0 = (k * P + idx) * W;
      if (c0 < live) {
        if constexpr (W == 1) r[k] = p[c0];
        else r[k] = fa::load16(p + c0);
      }
    }
  }
  __device__ __forceinline__ void get(int k, float* f) const {
    if constexpr (W == 1) f[0] = to_f(r[k]);
    else fa::unpack16<T>(r[k], f);
  }
  // access k as its W values of T, unconverted
  __device__ __forceinline__ void get_raw(int k, T* h) const {
    if constexpr (W == 1) {
      h[0] = r[k];
    } else {
      const T* p = reinterpret_cast<const T*>(&r[k]);
#pragma unroll
      for (int j = 0; j < W; ++j) h[j] = p[j];
    }
  }
};

// W bf16 values to p, one 16-byte store when W is a chunk.
template <int W>
__device__ __forceinline__ void store_bf16(bf16* p, const bf16* h) {
  if constexpr (W == 1) {
    *p = h[0];
  } else {
    uint4 u;
    bf16* q = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int j = 0; j < W; ++j) q[j] = h[j];
    fa::store16(p, u);
  }
}

// The row's scores at this thread's columns: x [+ mask] as f32 (rounded to
// bf16 after the mask add when kRound), -inf at columns not below `live`.
// The mask's loads are all issued before any is used.
template <typename T, int W, int C, bool kRound>
__device__ __forceinline__ void to_scores(const RawRow<T, W, C>& xr, const float* mr, int idx,
                                          int P, int live, float (&v)[C][W]) {
  float mk[C][W];
  if (mr) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c0 = (k * P + idx) * W;
      if (c0 < live) {
        if constexpr (W == 1) {
          mk[k][0] = mr[c0];
        } else {
#pragma unroll
          for (int q = 0; q < W / 4; ++q) {
            const float4 f = *reinterpret_cast<const float4*>(mr + c0 + 4 * q);
            mk[k][4 * q] = f.x;
            mk[k][4 * q + 1] = f.y;
            mk[k][4 * q + 2] = f.z;
            mk[k][4 * q + 3] = f.w;
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c0 = (k * P + idx) * W;
    if (c0 < live) {
      xr.get(k, v[k]);
      if (mr) {
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const float a = v[k][j] + mk[k][j];
          v[k][j] = kRound ? bf16r(a) : a;
        }
      }
#pragma unroll
      for (int j = 0; j < W; ++j)
        if (c0 + j >= live) v[k][j] = -INFINITY;  // a causal row's chunk across the diagonal
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j) v[k][j] = -INFINITY;
    }
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_w(T* p, const float* v) {
  if constexpr (W == 1) put(p, v[0]);
  else fa::store16(p, fa::pack16<T>(v));
}

// A row's place: `row` (0 for a slot past the last row, whose `live` is
// 0), its causal live length and its mask row.  32-bit: rows < 2^31.
struct RowAt {
  int row, live;
  const float* mr;
  __device__ __forceinline__ RowAt(long long at, long long rows, int H, int F, int Tn,
                                   const float* mask, long long msb, long long msh,
                                   long long msf, int causal) {
    const bool active = at < rows;
    row = active ? int(at) : 0;
    const int f = row % F, bh = row / F;
    live = !active ? 0 : (causal ? min(f + 1, Tn) : Tn);
    mr = mask ? mask + (bh / H) * msb + (bh % H) * msh + f * msf : nullptr;
  }
};

template <bool kOp>
__device__ __forceinline__ float exp_shifted(float v, float m) {
  return kOp ? bf16r(expf(bf16r(v - m))) : expf(v - m);
}

template <typename T, bool kOp, int W, int G, int C>
__global__ void __launch_bounds__(kMaxThreads)
softmax_fwd_rows(const T* __restrict__ x, const float* __restrict__ mask, T* __restrict__ out,
                 long long rows, int H, int F, int Tn, long long msb, long long msh,
                 long long msf, int lanes, int causal) {
  __shared__ float red_max[kWarps], red_sum[kWarps];
  const RowGroup<G> rg(lanes);
  const float vdead = kOp ? bf16r(kMaskValue) : kMaskValue;
  const long long stride = (long long)gridDim.x * rg.R;
  long long base = (long long)blockIdx.x * rg.R;
  RowAt next(base + rg.slot, rows, H, F, Tn, mask, msb, msh, msf, causal);
  RawRow<T, W, C> xn;
  xn.load(x + size_t(next.row) * Tn, rg.idx, rg.P, next.live);
  for (; base < rows; base += stride) {
    // the next row's loads go out before this row is worked on
    const RowAt at = next;
    const RawRow<T, W, C> xr = xn;
    if (base + stride < rows) {
      next = RowAt(base + stride + rg.slot, rows, H, F, Tn, mask, msb, msh, msf, causal);
      xn.load(x + size_t(next.row) * Tn, rg.idx, rg.P, next.live);
    }
    const int live = at.live, dead = live > 0 ? Tn - live : 0;
    float v[C][W];
    to_scores<T, W, C, kOp>(xr, at.mr, rg.idx, rg.P, live, v);

    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < C; ++k)
#pragma unroll
      for (int j = 0; j < W; ++j) m = fmaxf(m, v[k][j]);
    m = rg.template reduce<true>(m, red_max);
    if (dead > 0) m = fmaxf(m, vdead);

    // exp over the chunks that hold live columns; a causal row's columns
    // past the diagonal in its last such chunk are -inf and give 0
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < C; ++k)
      if ((k * rg.P + rg.idx) * W < live) {
#pragma unroll
        for (int j = 0; j < W; ++j) {
          v[k][j] = exp_shifted<kOp>(v[k][j], m);
          s += v[k][j];
        }
      }
    s = rg.template reduce<false>(s, red_sum);
    const float edead = exp_shifted<kOp>(vdead, m);
    if (dead > 0) s += float(dead) * edead;
    const float w = kOp ? bf16r(s) : s;
    const float odead = edead / w, rw = __frcp_rn(w);

    if (live > 0) {
      T* orow = out + size_t(at.row) * Tn;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int c0 = (k * rg.P + rg.idx) * W;
        if (c0 >= Tn) continue;
        if (c0 >= live) {  // past the diagonal: the constant, never read
#pragma unroll
          for (int j = 0; j < W; ++j) v[k][j] = odead;
        } else if (c0 + W <= live) {
#pragma unroll
          for (int j = 0; j < W; ++j) v[k][j] = div_rn(v[k][j], w, rw);
        } else {
#pragma unroll
          for (int j = 0; j < W; ++j) v[k][j] = c0 + j < live ? div_rn(v[k][j], w, rw) : odead;
        }
        store_w<T, W>(orow + c0, v[k]);
      }
    }
  }
}

// The op-graph backward (bf16) of a row held in registers: x and dout read
// once, m, e and w rebuilt, z staged in shared memory for XLA's bf16 sum.
template <int W, int G, int C>
__global__ void __launch_bounds__(kMaxThreads)
softmax_bwd_op_rows(const bf16* __restrict__ x, const float* __restrict__ mask,
                    const bf16* __restrict__ dout, bf16* __restrict__ dinp, long long rows,
                    int H, int F, int Tn, long long msb, long long msh, long long msf,
                    int lanes, int causal) {
  constexpr int kCols = kMaxThreads * C * W;  // columns the block holds
  __shared__ float red_max[kWarps], red_sum[kWarps];
  __shared__ __align__(16) bf16 zbuf[kCols];
  __shared__ bf16 part[kCols / 32 + kCols / 512 + 4 * kMaxThreads];
  __shared__ float ba_slot[kMaxThreads];
  const RowGroup<G> rg(lanes);
  const int row_cols = rg.P * C * W;
  bf16* zrow = zbuf + rg.slot * row_cols;
  bf16* prow = part + rg.slot * (row_cols / 32 + row_cols / 512 + 4);
  const float vdead = bf16r(kMaskValue);
  // no next-row prefetch here: holding two rows of x and dout took the
  // registers past two blocks an SM, and the kernel ran slower (PERF.md)
  for (long long base = (long long)blockIdx.x * rg.R; base < rows;
       base += (long long)gridDim.x * rg.R) {
    const RowAt at(base + rg.slot, rows, H, F, Tn, mask, msb, msh, msf, causal);
    RawRow<bf16, W, C> xr, g;
    xr.load(x + size_t(at.row) * Tn, rg.idx, rg.P, at.live);
    g.load(dout + size_t(at.row) * Tn, rg.idx, rg.P, at.live);
    const int live = at.live, dead = live > 0 ? Tn - live : 0;
    // the scores in bf16 (x, or bf16(x + mask)), -inf past `live`; every
    // rounding below is one bf16 instruction, as XLA's f32 op and round
    // (the exact result of two bf16 operands needs at most 24 bits where
    // its rounding could differ)
    bf16 v[C][W];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c0 = (k * rg.P + rg.idx) * W;
      xr.get_raw(k, v[k]);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (c0 < live && at.mr) v[k][j] = __float2bfloat16(__bfloat162float(v[k][j]) + at.mr[c0 + j]);
        if (c0 + j >= live) v[k][j] = __float2bfloat16(-INFINITY);
      }
    }

    bf16 mb = __float2bfloat16(-INFINITY);
#pragma unroll
    for (int k = 0; k < C; ++k)
#pragma unroll
      for (int j = 0; j < W; ++j) mb = __hmax(mb, v[k][j]);
    float m = rg.template reduce<true>(__bfloat162float(mb), red_max);
    if (dead > 0) m = fmaxf(m, vdead);
    mb = __float2bfloat16(m);

    // e = bf16(exp(bf16(v - m))) in v, over the chunks holding live columns
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < C; ++k)
      if ((k * rg.P + rg.idx) * W < live) {
#pragma unroll
        for (int j = 0; j < W; ++j) {
          v[k][j] = __float2bfloat16(expf(__bfloat162float(__hsub(v[k][j], mb))));
          s += __bfloat162float(v[k][j]);
        }
      }
    s = rg.template reduce<false>(s, red_sum);
    if (dead > 0) s += float(dead) * exp_shifted<true>(vdead, m);
    const float w = bf16r(s), rw = __frcp_rn(w);
    const bf16 x2 = __float2bfloat16(1.f / bf16r(w * w));

    // z = (dout x2) e over the live chunks (0 past the diagonal: e is 0)
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c0 = (k * rg.P + rg.idx) * W;
      if (c0 < live) {
        bf16 z[W];
        g.get_raw(k, z);
#pragma unroll
        for (int j = 0; j < W; ++j) z[j] = __hmul(__hmul(z[j], x2), v[k][j]);
        store_bf16<W>(zrow + c0, z);
      }
    }
    rg.sync();
    const bf16 ba = __float2bfloat16(xla_bf16_sum(static_cast<const bf16*>(zrow), Tn, live,
                                                  prow, &ba_slot[rg.slot], rg.idx, rg.P,
                                                  [&] { rg.sync(); }));

    if (live > 0) {
      bf16* drow = dinp + size_t(at.row) * Tn;
      const bf16 zero = __float2bfloat16(0.f);
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int c0 = (k * rg.P + rg.idx) * W;
        if (c0 >= Tn) continue;
        bf16 d[W];
        if (c0 < live) {
          g.get_raw(k, d);
#pragma unroll
          for (int j = 0; j < W; ++j) {
            const bf16 bd = __float2bfloat16(div_rn(__bfloat162float(d[j]), w, rw));
            d[j] = c0 + j < live ? __hmul(__hsub(bd, ba), v[k][j]) : zero;
          }
        } else {
#pragma unroll
          for (int j = 0; j < W; ++j) d[j] = zero;
        }
        store_bf16<W>(drow + c0, d);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Generic kernels: one block per row, any T
// ---------------------------------------------------------------------------

// One block per row of x viewed as (rows, T), rows = B * H * F.  V elements a
// load (V divides T when V > 1).  msb/msh/msf: the mask's strides over B, H,
// F in elements, 0 on a broadcast dim; its T stride is 1.  The Pallas
// function takes (max, sum) in one online pass and writes in a second; the
// op graph's roundings need the row's max first, so it takes three passes.
template <typename T, int V, bool kCausal, bool kMask, bool kOp>
__global__ void __launch_bounds__(kMaxThreads)
softmax_fwd_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                   T* __restrict__ out, int H, int F, int Tn, long long msb, long long msh,
                   long long msf) {
  __shared__ float red[kWarps];
  const int row = blockIdx.x;  // rows < 2^31
  const int f = row % F, bh = row / F;
  const T* xr = x + size_t(row) * Tn;
  T* orow = out + size_t(row) * Tn;
  const float* mr = nullptr;
  if constexpr (kMask) mr = mask + (bh / H) * msb + (bh % H) * msh + f * msf;
  const int live = kCausal ? min(f + 1, Tn) : Tn;  // columns that are read
  const int live_vecs = (live + V - 1) / V;
  // the masked scores at columns c0..c0+V-1
  auto scores = [&](int c0, float* v) {
    load_vec<V>(xr + c0, v);
    if constexpr (kMask) {
      float mk[V];
      load_vec<V>(mr + c0, mk);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = kOp ? bf16r(v[k] + mk[k]) : v[k] + mk[k];
    }
  };

  float m, s, masked;
  if constexpr (kOp) {
    m = -INFINITY;
    for (int vi = threadIdx.x; vi < live_vecs; vi += blockDim.x) {
      float v[V];
      scores(vi * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (vi * V + k < live) m = fmaxf(m, v[k]);
    }
    m = block_reduce<true>(m, red);
    const float vdead = bf16r(kMaskValue);
    if (kCausal && live < Tn) m = fmaxf(m, vdead);
    s = 0.f;
    for (int vi = threadIdx.x; vi < live_vecs; vi += blockDim.x) {
      float v[V];
      scores(vi * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (vi * V + k < live) s += bf16r(expf(bf16r(v[k] - m)));
    }
    s = block_reduce<false>(s, red);
    const float edead = bf16r(expf(bf16r(vdead - m)));
    if (kCausal && live < Tn) s += float(Tn - live) * edead;
    s = bf16r(s);
    masked = edead / s;
  } else {
    m = -FLT_MAX;
    s = 0.f;
    for (int vi = threadIdx.x; vi < live_vecs; vi += blockDim.x) {
      float v[V];
      scores(vi * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (kCausal && vi * V + k >= live) continue;
        if (v[k] > m) {
          s = s * expf(m - v[k]) + 1.f;
          m = v[k];
        } else {
          s += expf(v[k] - m);
        }
      }
    }
    block_merge(m, s);
    if (kCausal && live < Tn) merge(m, s, kMaskValue, float(Tn - live));
    masked = kCausal ? expf(kMaskValue - m) / s : 0.f;
  }

  for (int vi = threadIdx.x; vi < Tn / V; vi += blockDim.x) {
    float v[V];
    const int c0 = vi * V;
    if (kCausal && c0 >= live) {
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = masked;
    } else {
      scores(c0, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float e = kOp ? bf16r(expf(bf16r(v[k] - m))) : expf(v[k] - m);
        v[k] = (!kCausal || c0 + k < live) ? e / s : masked;
      }
    }
    store_vec<V>(orow + c0, v);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
softmax_bwd_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                   T* __restrict__ dinp, int Tn) {
  __shared__ float red[kWarps];
  const long long row = blockIdx.x;
  const T* o = out + row * Tn;
  const T* g = dout + row * Tn;
  T* d = dinp + row * Tn;
  float dot = 0.f;
  for (int vi = threadIdx.x; vi < Tn / V; vi += blockDim.x) {
    float ov[V], gv[V];
    load_vec<V>(o + vi * V, ov);
    load_vec<V>(g + vi * V, gv);
#pragma unroll
    for (int k = 0; k < V; ++k) dot += ov[k] * gv[k];
  }
  dot = block_reduce<false>(dot, red);
  for (int vi = threadIdx.x; vi < Tn / V; vi += blockDim.x) {
    float ov[V], gv[V];
    load_vec<V>(o + vi * V, ov);
    load_vec<V>(g + vi * V, gv);
#pragma unroll
    for (int k = 0; k < V; ++k) ov[k] = ov[k] * (gv[k] - dot);
    store_vec<V>(d + vi * V, ov);
  }
}

// The op-graph backward (bf16), any T: passes over the row (max, sum, the
// windows of XLA's sum with z recomputed per column, dx) whose re-reads hit
// L1/L2.  Dynamic shared memory: the window sums (xla_parts bf16 values).
__global__ void __launch_bounds__(kMaxThreads)
softmax_bwd_op_kernel(const bf16* __restrict__ x, const float* __restrict__ mask,
                      const bf16* __restrict__ dout, bf16* __restrict__ dinp, int H, int F,
                      int Tn, long long msb, long long msh, long long msf, int causal) {
  extern __shared__ bf16 xla_part[];
  __shared__ float red[kWarps];
  __shared__ float slot;
  const int row = blockIdx.x;  // rows < 2^31
  const int f = row % F, bh = row / F;
  const bf16* xr = x + size_t(row) * Tn;
  const bf16* gr = dout + size_t(row) * Tn;
  bf16* dr = dinp + size_t(row) * Tn;
  const float* mr = mask ? mask + (bh / H) * msb + (bh % H) * msh + f * msf : nullptr;
  const int live = causal ? min(f + 1, Tn) : Tn;
  auto score = [&](int c) {
    const float v = __bfloat162float(xr[c]);
    return mr ? bf16r(v + mr[c]) : v;
  };
  float m = -INFINITY;
  for (int c = threadIdx.x; c < live; c += blockDim.x) m = fmaxf(m, score(c));
  m = block_reduce<true>(m, red);
  const float vdead = bf16r(kMaskValue);
  if (live < Tn) m = fmaxf(m, vdead);
  float s = 0.f;
  for (int c = threadIdx.x; c < live; c += blockDim.x) s += bf16r(expf(bf16r(score(c) - m)));
  s = block_reduce<false>(s, red);
  if (live < Tn) s += float(Tn - live) * bf16r(expf(bf16r(vdead - m)));
  const float w = bf16r(s);
  const float x2 = bf16r(1.f / bf16r(w * w));
  auto e_at = [&](int c) { return bf16r(expf(bf16r(score(c) - m))); };
  const float ba = xla_bf16_sum(
      [&](int c) { return __float2bfloat16(bf16r(__bfloat162float(gr[c]) * x2) * e_at(c)); },
      Tn, live, xla_part, &slot, threadIdx.x, blockDim.x, [] { __syncthreads(); });
  for (int c = threadIdx.x; c < Tn; c += blockDim.x) {
    float d = 0.f;
    if (c < live) d = bf16r(bf16r(__bfloat162float(gr[c]) / w) - ba) * e_at(c);
    dr[c] = __float2bfloat16(d);
  }
}

// ---------------------------------------------------------------------------
// Launch plans
// ---------------------------------------------------------------------------

// Threads per row of the generic kernels: enough warps to cover the row's
// loads once, at most 256.
int threads_for(int loads) {
  int t = (loads + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

template <int W, int G, int C>
struct Layout {};

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The register layout for rows of T (V elements a 16-byte chunk; `vec`:
// T is whole chunks and every base 16-byte aligned): fn(Layout, S).  Rows
// outside the envelope return cudaErrorNotSupported (the generic kernels).
template <int V, typename Fn>
cudaError_t by_layout(int Tn, bool vec, Fn&& fn) {
  if (vec && Tn % V == 0) {
    const int nv = Tn / V;
    if (nv <= 32) return fn(Layout<V, 1, 1>(), pow2_at_least(nv));
    if (nv <= 64) return fn(Layout<V, 1, 2>(), 32);
    if (nv <= 128) return fn(Layout<V, 2, 2>(), 32);
    if (nv <= 256) return fn(Layout<V, 2, 4>(), 32);
    if (nv <= 512) return fn(Layout<V, 8, 2>(), 32);
    if (nv <= 1024) return fn(Layout<V, 8, 4>(), 32);
    return cudaErrorNotSupported;
  }
  if (Tn > 256) return cudaErrorNotSupported;
  // scalars: the fewest lanes x accesses covering the row, C of 4, 5 or 8
  const int s4 = pow2_at_least((Tn + 3) / 4), s5 = pow2_at_least((Tn + 4) / 5),
            s8 = pow2_at_least((Tn + 7) / 8);
  if (s4 <= 32 && 4 * s4 <= 5 * s5 && 4 * s4 <= 8 * s8) return fn(Layout<1, 1, 4>(), s4);
  if (s5 <= 32 && 5 * s5 <= 8 * s8) return fn(Layout<1, 1, 5>(), s5);
  return fn(Layout<1, 1, 8>(), s8);
}

// Blocks of a row kernel: one a row group's worth of rows (R a block), at
// most as many as the card holds at once (the row groups then walk the
// rows).
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, int* per_sm, long long rows, int G, int S,
                     unsigned* grid) {
  long long resident = 0;
  const cudaError_t e = fa::resident_blocks(kernel, kMaxThreads, per_sm, &resident);
  if (e != cudaSuccess) return e;
  const long long per_block = G > 1 ? kWarps / G : kWarps * (32 / S);
  const long long blocks = (rows + per_block - 1) / per_block;
  *grid = unsigned(blocks < resident ? blocks : resident);
  return cudaSuccess;
}

struct Args {
  const void *x, *mask, *g;  // g: dout (backward)
  void* out;
  long long rows;
  int H, F, Tn;
  long long msb, msh, msf;
  bool causal;
  cudaStream_t st;
};

template <typename T, bool kOp, int W, int G, int C>
cudaError_t launch_fwd_rows(Layout<W, G, C>, int S, const Args& a) {
  static int per_sm = 0;
  unsigned grid = 0;
  const cudaError_t e = grid_for(softmax_fwd_rows<T, kOp, W, G, C>, &per_sm, a.rows, G, S, &grid);
  if (e != cudaSuccess) return e;
  softmax_fwd_rows<T, kOp, W, G, C><<<grid, kMaxThreads, 0, a.st>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.mask), static_cast<T*>(a.out),
      a.rows, a.H, a.F, a.Tn, a.msb, a.msh, a.msf, S, int(a.causal));
  return cudaGetLastError();
}

template <typename T, int V, bool kOp>
cudaError_t launch_fwd_generic(const Args& a) {
  const int threads = threads_for(a.Tn / V);
  const T* xp = static_cast<const T*>(a.x);
  const float* mp = static_cast<const float*>(a.mask);
  T* op = static_cast<T*>(a.out);
  const unsigned blocks = unsigned(a.rows);
  if (a.causal && mp)
    softmax_fwd_kernel<T, V, true, true, kOp><<<blocks, threads, 0, a.st>>>(
        xp, mp, op, a.H, a.F, a.Tn, a.msb, a.msh, a.msf);
  else if (a.causal)
    softmax_fwd_kernel<T, V, true, false, kOp><<<blocks, threads, 0, a.st>>>(
        xp, mp, op, a.H, a.F, a.Tn, a.msb, a.msh, a.msf);
  else if (mp)
    softmax_fwd_kernel<T, V, false, true, kOp><<<blocks, threads, 0, a.st>>>(
        xp, mp, op, a.H, a.F, a.Tn, a.msb, a.msh, a.msf);
  else
    softmax_fwd_kernel<T, V, false, false, kOp><<<blocks, threads, 0, a.st>>>(
        xp, mp, op, a.H, a.F, a.Tn, a.msb, a.msh, a.msf);
  return cudaGetLastError();
}

bool vec_ok(const Args& a) {
  return fa::aligned16(a.x) && fa::aligned16(a.out) && (!a.g || fa::aligned16(a.g)) &&
         (!a.mask || fa::aligned16(a.mask));
}

template <typename T, bool kOp>
cudaError_t launch_fwd(const Args& a) {
  constexpr int V = fa::kVec<T>;
  const bool vec = vec_ok(a);
  const cudaError_t e = by_layout<V>(a.Tn, vec, [&](auto layout, int S) {
    return launch_fwd_rows<T, kOp>(layout, S, a);
  });
  if (e != cudaErrorNotSupported) return e;
  if (vec && a.Tn % V == 0) return launch_fwd_generic<T, V, kOp>(a);
  return launch_fwd_generic<T, 1, kOp>(a);
}

template <int W, int G, int C>
cudaError_t launch_bwd_op_rows(Layout<W, G, C>, int S, const Args& a) {
  static int per_sm = 0;
  unsigned grid = 0;
  const cudaError_t e = grid_for(softmax_bwd_op_rows<W, G, C>, &per_sm, a.rows, G, S, &grid);
  if (e != cudaSuccess) return e;
  softmax_bwd_op_rows<W, G, C><<<grid, kMaxThreads, 0, a.st>>>(
      static_cast<const bf16*>(a.x), static_cast<const float*>(a.mask),
      static_cast<const bf16*>(a.g), static_cast<bf16*>(a.out), a.rows, a.H, a.F, a.Tn, a.msb,
      a.msh, a.msf, S, int(a.causal));
  return cudaGetLastError();
}

// Window sums XLA's bf16 reduction of n values keeps, over all its levels.
int xla_parts(int n) {
  int total = 0;
  while (n > kWindow) {
    n = (n + kWindow - 1) / kWindow;
    total += n;
  }
  return total;
}

cudaError_t launch_bwd_op(const Args& a) {
  const cudaError_t e = by_layout<8>(a.Tn, vec_ok(a), [&](auto layout, int S) {
    return launch_bwd_op_rows(layout, S, a);
  });
  if (e != cudaErrorNotSupported) return e;
  const size_t smem = sizeof(bf16) * size_t(xla_parts(a.Tn));
  if (smem > 48 * 1024) {
    const cudaError_t s = cudaFuncSetAttribute(
        softmax_bwd_op_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (s != cudaSuccess) return s;
  }
  softmax_bwd_op_kernel<<<unsigned(a.rows), threads_for(a.Tn), smem, a.st>>>(
      static_cast<const bf16*>(a.x), static_cast<const float*>(a.mask),
      static_cast<const bf16*>(a.g), static_cast<bf16*>(a.out), a.H, a.F, a.Tn, a.msb, a.msh,
      a.msf, int(a.causal));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const Args& a) {
  constexpr int V = fa::kVec<T>;
  const T* o = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  T* d = static_cast<T*>(a.out);
  const unsigned blocks = unsigned(a.rows);
  if (a.Tn % V == 0 && vec_ok(a))
    softmax_bwd_kernel<T, V><<<blocks, threads_for(a.Tn / V), 0, a.st>>>(o, g, d, a.Tn);
  else
    softmax_bwd_kernel<T, 1><<<blocks, threads_for(a.Tn), 0, a.st>>>(o, g, d, a.Tn);
  return cudaGetLastError();
}

}  // namespace

// x, out: (rows, T) contiguous, rows = B * H * F; mask: f32 with T
// contiguous and strides msb/msh/msf (0 on broadcast dims), or null.  op:
// the op graph's rounding (bf16 only; f32 has one function).  dtype codes:
// 0 = float32, 1 = bfloat16.
extern "C" int fa_softmax_fwd(const void* x, const void* mask, void* out, long long rows, int H,
                              int F, int Tn, long long msb, long long msh, long long msf,
                              int causal, int op, int dtype, void* stream) {
  if (rows <= 0 || Tn <= 0) return 0;
  if (rows > 0x7fffffffLL) return int(cudaErrorInvalidValue);  // generic: a block a row
  const Args a{x, mask, nullptr, out, rows, H, F, Tn, msb, msh, msf, causal != 0,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_fwd<float, false>(a);
  if (dtype == 1) return op ? launch_fwd<bf16, true>(a) : launch_fwd<bf16, false>(a);
  return int(cudaErrorInvalidValue);
}

// op == 0: res = out, dinp = out * (dout - sum_row(dout * out)); mask,
// strides and causal unused.  op == 1 (bf16 only): res = x, the op graph's
// backward with the forward's mask and causal flag.  res, dout, dinp: (rows,
// T) contiguous, one dtype.
extern "C" int fa_softmax_bwd(const void* res, const void* mask, const void* dout, void* dinp,
                              long long rows, int H, int F, int Tn, long long msb, long long msh,
                              long long msf, int causal, int op, int dtype, void* stream) {
  if (rows <= 0 || Tn <= 0) return 0;
  if (rows > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const Args a{res, mask, dout, dinp, rows, H, F, Tn, msb, msh, msf, causal != 0,
               static_cast<cudaStream_t>(stream)};
  if (op) return dtype == 1 ? int(launch_bwd_op(a)) : int(cudaErrorInvalidValue);
  if (dtype == 0) return int(launch_bwd<float>(a));
  if (dtype == 1) return int(launch_bwd<bf16>(a));
  return int(cudaErrorInvalidValue);
}
