// Weight-only quantized matmul: y = cast_T((x @ W_payload) * scales), with
// x (M, K) in f32 or bf16, W (K, N) an int8 or fp8 (e4m3) payload and one
// f32 scale per output column; the product accumulates in f32.
//
// Replaces the TPU kernel flashattn_tpu/ops/quant.py::_wo_matmul_kernel
// (wrapper int8_weight_only_matmul), which converts each weight tile to
// x's dtype in VMEM, accumulates the dot in f32 over the K grid axis and
// applies the per-column scale once at the end.  Both payload types are
// exact in bf16 and f32, so converting a weight to bf16 or f32 here gives
// the same value as converting it to x's dtype, and each bf16 x bf16
// product is exact in f32: only the order of the sum differs from the
// plain version.  The JAX wrapper falls back to x @ dequantize(W) at shapes
// its tiling does not divide; these kernels take every M, N and K.
//
// Four kernels, chosen by the launch:
//
// * bf16 x, M > 16 (prefill, the lm head): a tensor-core tile.  What
//   bounds it is the multiply-adds (2 M N K at 989 TF/s bf16).  A block of
//   two consumer warpgroups owns a 256 x 128 tile of y (128 rows, two m64
//   halves, a warpgroup; the tall tile halves how often each weight is
//   converted) and walks K in steps of 64 through a ring of four
//   shared-memory stages.  The x tile arrives by TMA (128-byte swizzle,
//   zero fill past M and K), the weight tile as bytes by cp.async (16-, 8-
//   or 4-byte pieces, whichever divides N: the lm head's rows of 1000
//   bytes are 8-byte aligned only; plain loads when N is odd).  The block converts each weight tile in
//   shared memory to bf16, into a ring of three B tiles in the swizzled
//   MN-major layout wgmma reads with the transpose bit set, and fences it
//   to the async proxy; each warpgroup issues wgmma m64n128k16 (x K-major,
//   W MN-major) into 2 x 64 f32 accumulators a thread.  Step t + 1's
//   weights are converted while step t's wgmma runs, and the block waits
//   only for step t - 1's, so the tensor cores always have a step queued.
//   int8 converts without the slow integer-to-float unit (the byte becomes
//   the low mantissa byte of 2^23 + 128 + b, one f32 subtraction recovers
//   b exactly).  The scale multiplies once, in the epilogue, with one
//   rounding; the tile of y then leaves through shared memory in whole
//   rows.
//   x's row stride must be a multiple of 16 bytes for TMA (K % 8 == 0);
//   other K take the FMA kernel below.
// * f32 x, M > 16: the same tile in split precision (split.cuh).  The
//   payloads are exact in bf16, so x cut into three bf16 pieces (the
//   truncating split: x = b0 + b1 + b2 exactly) times W is three exact bf16
//   products, f32-grade where single-pass TF32 (10 bits) would miss the
//   f32 gate.  One pass before the kernel writes x's pieces as three bf16
//   planes (rows padded with zeros to a multiple of 8, so any K takes
//   TMA); a stage holds a 128-row tile of each plane (three TMA boxes), so
//   a block owns 128 x 128 of y, one m64 half a warpgroup, three stages.
//   The tensor cores truncate their f32 sums, so each K step's three
//   products (b2 first, b0 last) sum from zero in registers of their own
//   and are then added to the accumulator in f32.  What bounds it: the
//   three products, 3 x 2 M N K at 989 TF/s, and the split pass beside (4
//   bytes read and 6 written an element of x).
// * M <= 16 (decode), bf16 or f32 x: a GEMV.  What bounds it is the weight
//   bytes (1 MiB at (1024, 1024): 0.3 us at 3.35 TB/s); in practice the
//   launch.  Multiply-adds on the CUDA cores in f32 (exact products of
//   the payload with x in either dtype); the tensor cores would save
//   nothing on a handful of rows.
//   A block owns 64 columns, up to 4 rows of x (more rows: more blocks in
//   z) and one K range: each thread reads its 16 columns of a weight row
//   in one 16-byte load (8- or 4-byte pieces when N is not a multiple of
//   16), 32 k-lanes stride over the rows, and x's rows wait in shared
//   memory.  K is split over the blocks of a thread-block cluster (up to
//   8, gridDim.y) so that about 264 blocks run; each block adds its
//   k-lanes in a fixed order, then the cluster adds the splits' sums in
//   rank order through distributed shared memory and applies the scale.
//   One launch, no scratch, no atomics: the result does not vary from run
//   to run.
// * bf16 x with K % 8 != 0 and M > 16: the CUDA-core FMA kernel.  A block
//   owns a 64 x 64 tile of y, walks K in steps of 32 with the tiles staged
//   in shared memory as f32, and each of its 256 threads keeps a 4 x 4
//   block of sums.

#include <cooperative_groups.h>
#include <cuda.h>   // CUtensorMap; the encoder is looked up from the driver at run time
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "split.cuh"

namespace {

namespace cg = cooperative_groups;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return float(v); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 v) { return float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One payload byte as f32 (int8 or e4m3 bits).
template <typename W> __device__ __forceinline__ float byte_f(uint8_t b);
template <> __device__ __forceinline__ float byte_f<int8_t>(uint8_t b) {
  return float(int8_t(b));
}
template <> __device__ __forceinline__ float byte_f<__nv_fp8_e4m3>(uint8_t b) {
  __nv_fp8_e4m3 v;
  v.__x = b;
  return float(v);
}

// Four payload bytes (one 32-bit word, byte 0 first) as two bf16 pairs.
template <typename W>
__device__ __forceinline__ void bytes4_bf16(uint32_t word, uint32_t& lo, uint32_t& hi) {
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&word);
  lo = hop::pack_bf16(byte_f<W>(b[0]), byte_f<W>(b[1]));
  hi = hop::pack_bf16(byte_f<W>(b[2]), byte_f<W>(b[3]));
}
template <>
__device__ __forceinline__ void bytes4_bf16<int8_t>(uint32_t word, uint32_t& lo, uint32_t& hi) {
  // byte i of u is b_i + 128; 0x4B0000uu is the f32 2^23 + u, exact
  const uint32_t u = word ^ 0x80808080u;
  constexpr float kBias = 8388736.f;   // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - kBias;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - kBias;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - kBias;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - kBias;
  lo = hop::pack_bf16(f0, f1);
  hi = hop::pack_bf16(f2, f3);
}

// -- FMA kernel ----------------------------------------------------------------

constexpr int BN = 64, BK = 32, NT = 256;

template <typename T, typename W, int BM>
__global__ void __launch_bounds__(NT)
wo_matmul_kernel(const T* __restrict__ x, const W* __restrict__ w,
                 const float* __restrict__ scales, T* __restrict__ y, int M, int N,
                 int K) {
  constexpr int TM = BM / 16;         // rows per thread
  constexpr int TN = 4;               // columns per thread
  __shared__ __align__(16) float xs[BK][BM + 4];   // x tile, k-major
  __shared__ __align__(16) float ws[BK][BN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK, m = m0 + r, k = k0 + c;
      xs[c][r] = (m < M && k < K) ? to_f(x[size_t(m) * K + k]) : 0.f;
    }
    for (int i = threadIdx.x; i < BK * BN; i += NT) {
      const int r = i / BN, c = i % BN, k = k0 + r, n = n0 + c;
      ws[r][c] = (k < K && n < N) ? to_f(w[size_t(k) * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      if constexpr (TM == 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
        a[0] = a4.x; a[1] = a4.y; a[2] = a4.z; a[3] = a4.w;
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
      }
      const float4 b4 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + tx * 4 + j;
    if (n >= N) continue;
    const float s = scales[n];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i;
      if (m < M) put(y + size_t(m) * N + n, acc[i][j] * s);
    }
  }
}

template <typename W>
cudaError_t launch_fma(const void* x, const void* w, const float* scales, void* y, int M,
                       int N, int K, cudaStream_t st) {
  using T = __nv_bfloat16;
  wo_matmul_kernel<T, W, 64><<<dim3((N + BN - 1) / BN, (M + 63) / 64), NT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), scales, static_cast<T*>(y), M, N, K);
  return cudaGetLastError();
}

// -- tensor-core tile (M > 16: bf16 x, or f32 x as three bf16 planes) ----------------

constexpr int TC_BN = 128, TC_BK = 64, TC_BUFS = 3, TC_THREADS = 256;
constexpr int W_TILE = TC_BK * TC_BN;        // payload bytes, row-major
constexpr int B_REGION = TC_BK * 128;        // one 64-column bf16 region of the B tile
constexpr int B_TILE = 2 * B_REGION;

// The tile's shape: bf16 x, 256 rows (two m64 halves a warpgroup) and four
// stages; f32 x, three planes of 128 rows (one half a warpgroup) and three
// stages.
template <bool kF32>
struct WoTc {
  static constexpr int BM = kF32 ? 128 : 256;
  static constexpr int HALVES = BM / 128;            // m64 halves a warpgroup
  static constexpr int PLANES = kF32 ? sp::NP : 1;
  static constexpr int STAGES = kF32 ? 3 : 4;
  static constexpr int X_PLANE = BM * TC_BK * 2;     // one TMA box: BM rows of 128 bytes
  static constexpr int X_TILE = PLANES * X_PLANE;
  static constexpr size_t SMEM =
      1024 + STAGES * size_t(X_TILE + W_TILE) + TC_BUFS * B_TILE + STAGES * sizeof(uint64_t);
};

// The weight bytes of k-tile rows [k0, k0 + 64) x columns [n0, n0 + 128)
// into a row-major staging tile, zero past K and N.  N % VEC == 0, so a
// piece is either wholly inside N or wholly past it.
template <int VEC>
__device__ __forceinline__ void load_w_tile(uint8_t* stage, const uint8_t* w, int k0, int n0,
                                            int K, int N) {
  constexpr int PER_ROW = TC_BN / VEC;
  for (int i = threadIdx.x; i < TC_BK * PER_ROW; i += TC_THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    const int k = k0 + r, n = n0 + c;
    const bool ok = k < K && n < N;
    const uint8_t* src = ok ? w + size_t(k) * N + n : w;
    if constexpr (VEC >= 4) {
      hop::cp_async<VEC>(hop::smem_u32(stage + r * TC_BN + c), src, ok);
    } else {
      stage[r * TC_BN + c] = ok ? *src : uint8_t(0);
    }
  }
}

// Staged payload bytes -> the bf16 B tile: (k, n) goes to region n / 64,
// row k, 16-byte chunk (n % 64) / 8, swizzled.  Each thread converts 16
// bytes of one row into two chunks.
template <typename W>
__device__ __forceinline__ void convert_w_tile(const uint8_t* stage, uint8_t* btile) {
  for (int i = threadIdx.x; i < TC_BK * TC_BN / 16; i += TC_THREADS) {
    const int k = i / (TC_BN / 16), n = (i % (TC_BN / 16)) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(stage + k * TC_BN + n);
    uint4 lo, hi;   // columns n .. n + 7 and n + 8 .. n + 15
    bytes4_bf16<W>(raw.x, lo.x, lo.y);
    bytes4_bf16<W>(raw.y, lo.z, lo.w);
    bytes4_bf16<W>(raw.z, hi.x, hi.y);
    bytes4_bf16<W>(raw.w, hi.z, hi.w);
    uint8_t* region = btile + (n / 64) * B_REGION;
    const uint32_t chunk = (n % 64) / 8;
    *reinterpret_cast<uint4*>(region + hop::swz<128>(k * 128 + chunk * 16)) = lo;
    *reinterpret_cast<uint4*>(region + hop::swz<128>(k * 128 + (chunk + 1) * 16)) = hi;
  }
}

// xmap: bf16 x (K, M), or f32 x's planes as one (Kp, 3 M) bf16 matrix, plane
// p's rows at p M (a box past M reads the next plane's rows: they only
// reach rows of y past M, which are not stored).
template <typename W, int VEC, bool kF32>
__global__ void __launch_bounds__(TC_THREADS, 1)
wo_tc_kernel(const __grid_constant__ CUtensorMap xmap, const uint8_t* __restrict__ w,
             const float* __restrict__ scales, void* __restrict__ y, int M, int N, int K) {
  using C = WoTc<kF32>;
  constexpr int STAGES = C::STAGES, HALVES = C::HALVES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* xs = smem;                                   // stages of the x tile
  uint8_t* bs = xs + STAGES * C::X_TILE;                // ring of bf16 B tiles
  uint8_t* ws = bs + TC_BUFS * B_TILE;                  // stages of payload bytes
  uint64_t* bars = reinterpret_cast<uint64_t*>(ws + STAGES * W_TILE);

  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * TC_BN;
  const int KT = (K + TC_BK - 1) / TC_BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) hop::mbar_init(hop::smem_u32(&bars[s]), 1);
    hop::mbar_fence_init();
  }
  __syncthreads();

  // k-tile t into stage t % STAGES: x by TMA (thread 0), bytes by all.
  auto issue = [&](int t) {
    if (t < KT) {
      const int s = t % STAGES;
      if (tid == 0) {
        const uint32_t bar = hop::smem_u32(&bars[s]);
        hop::mbar_expect_tx(bar, C::X_TILE);
#pragma unroll
        for (int p = 0; p < C::PLANES; ++p)
          hop::tma_load_2d(hop::smem_u32(xs + s * C::X_TILE + p * C::X_PLANE), &xmap, bar,
                           t * TC_BK, p * M + m0);
      }
      load_w_tile<VEC>(ws + s * W_TILE, w, t * TC_BK, n0, K, N);
    }
    hop::cp_async_commit();
  };

  for (int t = 0; t < STAGES; ++t) issue(t);
  hop::cp_async_wait<STAGES - 1>();
  __syncthreads();
  convert_w_tile<W>(ws, bs);
  hop::fence_async_smem();
  __syncthreads();

  float acc[HALVES][64];   // the warpgroup's m64 halves
#pragma unroll
  for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[hf][i] = 0.f;

  // Iteration t: queue tile t's wgmma, convert tile t + 1 meanwhile, then
  // wait (bf16: for tile t - 1 only; f32: for tile t, whose product is
  // then added to acc) and refill tile t - 1's stage.  B tile t + 1
  // differs from the tiles of the wgmmas in flight.  (f32 overlapping tile
  // t + 1's wgmmas with tile t's add, two product register sets, ran 6%
  // slower at (32768, 1024) x (1024, 1024) on an H100 80GB HBM3 at 700 W,
  // tools/ab_chip_smoke.py: ptxas serializes wgmmas whose neighbours'
  // accumulators other instructions read, its warning C7514.)
  for (int t = 0; t < KT; ++t) {
    const int s = t % STAGES;
    hop::mbar_wait(hop::smem_u32(&bars[s]), (t / STAGES) & 1);
    const uint32_t a0 = hop::smem_u32(xs + s * C::X_TILE + wg * HALVES * 64 * 128);
    const uint32_t b0 = hop::smem_u32(bs + (t % TC_BUFS) * B_TILE);
    float tile[64];   // f32: tile t's product, summed from zero
    if constexpr (kF32) {
      hop::fence_regs(tile);
      hop::wg_arrive();
      // the pieces b2, b1, b0 in turn (the small ones first)
#pragma unroll
      for (int p = C::PLANES - 1; p >= 0; --p)
#pragma unroll
        for (int ks = 0; ks < TC_BK / 16; ++ks)
          hop::wgmma_ss<1>(tile, hop::desc<128>(a0 + p * C::X_PLANE + ks * 32, 16, 1024),
                           hop::desc<128>(b0 + ks * 16 * 128, B_REGION, 1024),
                           p < C::PLANES - 1 || ks > 0);
    } else {
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) hop::fence_regs(acc[hf]);
      hop::wg_arrive();
#pragma unroll
      for (int ks = 0; ks < TC_BK / 16; ++ks) {
        const uint64_t b = hop::desc<128>(b0 + ks * 16 * 128, B_REGION, 1024);
#pragma unroll
        for (int hf = 0; hf < HALVES; ++hf)
          hop::wgmma_ss<1>(acc[hf], hop::desc<128>(a0 + hf * 64 * 128 + ks * 32, 16, 1024), b,
                           1);
      }
    }
    hop::wg_commit();
    if (t + 1 < KT) {
      // tile t + 1's bytes: committed groups hold tiles up to t + STAGES - 2
      // (an empty group at t = 0), so at most STAGES - 3 may still be pending
      hop::cp_async_wait<STAGES - 3>();
      __syncthreads();
      convert_w_tile<W>(ws + ((t + 1) % STAGES) * W_TILE, bs + ((t + 1) % TC_BUFS) * B_TILE);
      hop::fence_async_smem();
    }
    if constexpr (kF32) {
      hop::wg_wait<0>();
      hop::fence_regs(tile);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[0][i] += tile[i];
    } else {
      hop::wg_wait<1>();
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) hop::fence_regs(acc[hf]);
    }
    __syncthreads();   // both warpgroups are done with tile t - 1; B tile t + 1 is written
    if (t >= 1) issue(t - 1 + STAGES);
    else hop::cp_async_commit();
  }
  hop::wg_wait<0>();
#pragma unroll
  for (int hf = 0; hf < HALVES; ++hf) hop::fence_regs(acc[hf]);

  // epilogue: scale and round in registers, stage the tile in shared memory
  // (the x stages are free; rows padded by 16 bytes, so the fragment's
  // writes hit 32 banks), then write whole rows of y with 16-byte stores.
  // Stored straight from the fragment, each warp instruction would touch
  // eight rows with 16 bytes each: that took half the kernel's time.
  __syncthreads();   // both warpgroups' wgmmas have read their last x stage
  constexpr int EB = kF32 ? 4 : 2;                 // bytes of an element of y
  constexpr int YS = TC_BN * EB + 16;              // bytes of a staged row
  constexpr int PER = 16 / EB;                     // elements of a 16-byte store
  static_assert(C::BM * YS <= STAGES * C::X_TILE, "the staged tile fits in the x stages");
  const int warp = lt / 32, lane = lt % 32;
  const int r0 = wg * HALVES * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < TC_BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4), col = n0 + c;
    const float s0 = col < N ? scales[col] : 0.f, s1 = col + 1 < N ? scales[col + 1] : 0.f;
#pragma unroll
    for (int r = 0; r < 2 * HALVES; ++r) {   // half r / 2, fragment row 8 (r % 2)
      const int hf = r / 2, h = r % 2;
      uint8_t* dst = xs + (r0 + 64 * hf + 8 * h) * YS + EB * c;
      const float v0 = acc[hf][4 * j + 2 * h] * s0, v1 = acc[hf][4 * j + 2 * h + 1] * s1;
      if constexpr (kF32)
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      else
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
    }
  }
  __syncthreads();
  uint8_t* yb = static_cast<uint8_t*>(y);
  for (int i = tid; i < C::BM * TC_BN / PER; i += TC_THREADS) {
    const int r = i / (TC_BN / PER), c = i % (TC_BN / PER) * PER;
    const int row = m0 + r, col = n0 + c;
    if (row >= M || col >= N) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(xs + r * YS + EB * c);
    uint8_t* out = yb + (size_t(row) * N + col) * EB;
    if (N % PER == 0) {
      *reinterpret_cast<uint4*>(out) = v;
    } else {
      const uint8_t* e = reinterpret_cast<const uint8_t*>(&v);
      for (int q = 0; q < PER && col + q < N; ++q)
        for (int bt = 0; bt < EB; ++bt) out[q * EB + bt] = e[q * EB + bt];
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; the library links only
// the runtime, so it is looked up once through the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

template <typename W, int VEC, bool kF32>
cudaError_t launch_tc_vec(const CUtensorMap& map, const void* w, const float* scales, void* y,
                          int M, int N, int K, cudaStream_t st) {
  using C = WoTc<kF32>;
  auto kernel = wo_tc_kernel<W, VEC, kF32>;
  static const cudaError_t opted = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::SMEM));
  if (opted != cudaSuccess) return opted;
  const dim3 grid((N + TC_BN - 1) / TC_BN, (M + C::BM - 1) / C::BM);
  kernel<<<grid, TC_THREADS, C::SMEM, st>>>(map, static_cast<const uint8_t*>(w), scales, y, M,
                                            N, K);
  return cudaGetLastError();
}

// x: bf16 (M, K) with K % 8 == 0, or f32 x's three bf16 planes (3, M, kp),
// kp = K rounded up to a multiple of 8.
template <typename W, bool kF32>
cudaError_t launch_tc(const void* x, const void* w, const float* scales, void* y, int M, int N,
                      int K, int kp, cudaStream_t st) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {cuuint64_t(kp), cuuint64_t(M) * WoTc<kF32>::PLANES};
  const cuuint64_t strides[1] = {cuuint64_t(kp) * 2};
  const cuuint32_t box[2] = {TC_BK, WoTc<kF32>::BM};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  if (N % 16 == 0) return launch_tc_vec<W, 16, kF32>(map, w, scales, y, M, N, K, st);
  if (N % 8 == 0) return launch_tc_vec<W, 8, kF32>(map, w, scales, y, M, N, K, st);
  if (N % 4 == 0) return launch_tc_vec<W, 4, kF32>(map, w, scales, y, M, N, K, st);
  return launch_tc_vec<W, 1, kF32>(map, w, scales, y, M, N, K, st);
}

// f32 x (M, K) -> its three bf16 pieces, planes[p][m][k] (kp columns, zero
// past K), for K % 8 != 0; sp::split_kernel takes K % 8 == 0.
__global__ void __launch_bounds__(256)
split_rows_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ planes, int M, int K,
                  int kp) {
  const long long n = (long long)M * kp;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n; i += gridDim.x * 256ll) {
    const int m = int(i / kp), k = int(i % kp);
    float b0 = 0.f, b1 = 0.f, b2 = 0.f;
    if (k < K) sp::split3(x[size_t(m) * K + k], b0, b1, b2);
    planes[i] = __float2bfloat16(b0);
    planes[n + i] = __float2bfloat16(b1);
    planes[2 * n + i] = __float2bfloat16(b2);
  }
}

cudaError_t split_x(const float* x, __nv_bfloat16* planes, int M, int K, int kp,
                    cudaStream_t st) {
  if (kp == K) {
    sp::SplitJobs jobs = {{x, nullptr, nullptr, nullptr},
                          {planes, nullptr, nullptr, nullptr},
                          {(long long)M * K, 0, 0, 0},
                          {1.f, 1.f, 1.f, 1.f},
                          {nullptr, nullptr, nullptr, nullptr}};
    return sp::split(jobs, 1, st);
  }
  const long long blocks = ((long long)M * kp + 255) / 256;
  split_rows_kernel<<<unsigned(blocks < 1056 ? blocks : 1056), 256, 0, st>>>(x, planes, M, K, kp);
  return cudaGetLastError();
}

// -- GEMV (M <= 16, bf16 or f32 x) ---------------------------------------------

constexpr int GV_THREADS = 128, GV_CT = 4, GV_KL = 32, GV_MT = 4, GV_KC = 256;
constexpr int GV_COLS = GV_CT * 16;                  // columns a block owns
constexpr int GV_RED = GV_MT * GV_CT * 17 + 1;       // padded partials of one k-lane
constexpr int GV_MAX_SPLITS = 8;                     // the portable cluster size

// One block of a cluster: 64 columns, up to 4 rows of x, one K range.  The
// cluster's blocks split K; each sums its range, then the cluster adds the
// ranges through distributed shared memory in rank order.
template <typename T, typename W, int VEC>
__global__ void __launch_bounds__(GV_THREADS)
wo_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
               const float* __restrict__ scales, T* __restrict__ y, int M, int N, int K,
               int kchunk) {
  __shared__ float xs[GV_MT][GV_KC];
  __shared__ float red[GV_KL * GV_RED];
  __shared__ float part[GV_MT * GV_COLS];   // this block's sums over its K range
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, tx = tid % GV_CT, ty = tid / GV_CT;
  const int col0 = blockIdx.x * GV_COLS, c0 = col0 + tx * 16;
  const int mg = blockIdx.z * GV_MT;
  const int kb = blockIdx.y * kchunk, ke = min(K, kb + kchunk);

  float acc[GV_MT][16];
#pragma unroll
  for (int m = 0; m < GV_MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += GV_KC) {
    const int kn = min(GV_KC, ke - k0);
    __syncthreads();   // the previous chunk's reads of xs are done
    for (int i = tid; i < GV_MT * GV_KC; i += GV_THREADS) {
      const int r = i / GV_KC, c = i % GV_KC, m = mg + r;
      xs[r][c] = (m < M && c < kn) ? to_f(x[size_t(m) * K + k0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = ty; kk < kn; kk += GV_KL) {
      uint4 raw = make_uint4(0, 0, 0, 0);
      uint8_t* b = reinterpret_cast<uint8_t*>(&raw);
      const uint8_t* src = w + size_t(k0 + kk) * N + c0;
#pragma unroll
      for (int p = 0; p < 16 / VEC; ++p) {   // N % VEC == 0: a piece is in or out
        if (c0 + p * VEC >= N) continue;
        if constexpr (VEC == 16) raw = *reinterpret_cast<const uint4*>(src);
        else if constexpr (VEC == 8)
          reinterpret_cast<uint2*>(b)[p] = *reinterpret_cast<const uint2*>(src + 8 * p);
        else if constexpr (VEC == 4)
          reinterpret_cast<uint32_t*>(b)[p] = *reinterpret_cast<const uint32_t*>(src + 4 * p);
        else
          b[p] = src[p];
      }
      float wv[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) wv[j] = byte_f<W>(b[j]);
#pragma unroll
      for (int m = 0; m < GV_MT; ++m) {
        const float xv = xs[m][kk];
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
      }
    }
  }

  // the 32 k-lanes' partial sums, added in lane order
#pragma unroll
  for (int m = 0; m < GV_MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) red[ty * GV_RED + (m * GV_CT + tx) * 17 + j] = acc[m][j];
  __syncthreads();
  for (int i = tid; i < GV_MT * GV_COLS; i += GV_THREADS) {
    const int m = i / GV_COLS, c = i % GV_COLS;
    float s = 0.f;
#pragma unroll 8
    for (int l = 0; l < GV_KL; ++l) s += red[l * GV_RED + (m * GV_CT + c / 16) * 17 + c % 16];
    part[i] = s;
  }
  cluster.sync();   // every K range's sums are in place
  // the blocks share the outputs; each adds the ranges in rank order
  const int splits = int(cluster.num_blocks());
  for (int i = int(cluster.block_rank()) * GV_THREADS + tid; i < GV_MT * GV_COLS;
       i += splits * GV_THREADS) {
    const int row = mg + i / GV_COLS, n = col0 + i % GV_COLS;
    float s = 0.f;
    for (int r = 0; r < splits; ++r) s += cluster.map_shared_rank(part, r)[i];
    if (row < M && n < N) put(y + size_t(row) * N + n, s * scales[n]);
  }
  cluster.sync();   // no block leaves while another still reads its sums
}

template <typename T, typename W, int VEC>
cudaError_t launch_gemv_vec(const void* x, const void* w, const float* scales, void* y, int M,
                            int N, int K, cudaStream_t st) {
  // K splits: about two blocks per SM, each at least 64 rows of W deep (at
  // M 16: 0.0086 ms against 0.0095 with one block an SM and 0.0118 with 8
  // splits at any block count; M 4 alike, 0.0064; H100 80GB HBM3, 700 W,
  // tools/ab_chip_smoke.py --phases wo)
  const int blocks = (N + GV_COLS - 1) / GV_COLS * ((M + GV_MT - 1) / GV_MT);
  const int splits = max(1, min(min(GV_MAX_SPLITS, 264 / blocks), K / 64));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + GV_COLS - 1) / GV_COLS, splits, (M + GV_MT - 1) / GV_MT);
  cfg.blockDim = dim3(GV_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, wo_gemv_kernel<T, W, VEC>, static_cast<const T*>(x),
                            static_cast<const uint8_t*>(w), scales, static_cast<T*>(y), M, N, K,
                            (K + splits - 1) / splits);
}

template <typename T, typename W>
cudaError_t launch_gemv(const void* x, const void* w, const float* scales, void* y, int M, int N,
                        int K, cudaStream_t st) {
  if (N % 16 == 0) return launch_gemv_vec<T, W, 16>(x, w, scales, y, M, N, K, st);
  if (N % 8 == 0) return launch_gemv_vec<T, W, 8>(x, w, scales, y, M, N, K, st);
  if (N % 4 == 0) return launch_gemv_vec<T, W, 4>(x, w, scales, y, M, N, K, st);
  return launch_gemv_vec<T, W, 1>(x, w, scales, y, M, N, K, st);
}

template <typename W>
cudaError_t dispatch_bf16(const void* x, const void* w, const float* scales, void* y, int M, int N,
                          int K, cudaStream_t st) {
  if (M <= 16) return launch_gemv<__nv_bfloat16, W>(x, w, scales, y, M, N, K, st);
  if (K > 0 && K % 8 == 0) return launch_tc<W, false>(x, w, scales, y, M, N, K, K, st);
  return launch_fma<W>(x, w, scales, y, M, N, K, st);
}

template <typename W>
cudaError_t dispatch_f32(const void* x, const void* w, const float* scales, void* y, void* planes,
                         int M, int N, int K, cudaStream_t st) {
  if (M <= 16) return launch_gemv<float, W>(x, w, scales, y, M, N, K, st);
  if (K == 0) return cudaMemsetAsync(y, 0, size_t(M) * N * sizeof(float), st);
  const int kp = (K + 7) / 8 * 8;
  __nv_bfloat16* pl = static_cast<__nv_bfloat16*>(planes);
  const cudaError_t e = split_x(static_cast<const float*>(x), pl, M, K, kp, st);
  if (e != cudaSuccess) return e;
  return launch_tc<W, true>(pl, w, scales, y, M, N, K, kp, st);
}

}  // namespace

// x (M, K), y (M, N) row-major bf16; w (K, N) row-major payload (2 = int8,
// 3 = float8 e4m3); scales (N,) f32.
extern "C" int fa_wo_matmul(const void* x, const void* w, const void* scales, void* y, int M,
                            int N, int K, int payload, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scales);
  if (payload == 2) return int(dispatch_bf16<int8_t>(x, w, s, y, M, N, K, st));
  if (payload == 3) return int(dispatch_bf16<__nv_fp8_e4m3>(x, w, s, y, M, N, K, st));
  return int(cudaErrorInvalidValue);
}

// The same with x and y f32: the GEMV at M <= 16, else the split pass into
// planes (bf16 scratch of 3 M kp elements, kp = K rounded up to a multiple
// of 8; unused at M <= 16) and the tensor-core tile on them.
extern "C" int fa_wo_matmul_f32(const void* x, const void* w, const void* scales, void* y,
                                void* planes, int M, int N, int K, int payload, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scales);
  if (payload == 2) return int(dispatch_f32<int8_t>(x, w, s, y, planes, M, N, K, st));
  if (payload == 3) return int(dispatch_f32<__nv_fp8_e4m3>(x, w, s, y, planes, M, N, K, st));
  return int(cudaErrorInvalidValue);
}
