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
// Three kernels, chosen by the launch:
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
// * bf16 x, M <= 16 (decode): a GEMV.  What bounds it is the weight bytes
//   (1 MiB at (1024, 1024): 0.3 us at 3.35 TB/s); in practice the launch.
//   A block owns 64 columns, up to 4 rows of x (more rows: more blocks in
//   z) and one K range: each thread reads its 16 columns of a weight row
//   in one 16-byte load (8- or 4-byte pieces when N is not a multiple of
//   16), 32 k-lanes stride over the rows, and x's rows wait in shared
//   memory.  K is split over the blocks of a thread-block cluster (up to
//   8, gridDim.y) so that about 132 blocks run; each block adds its
//   k-lanes in a fixed order, then the cluster adds the splits' sums in
//   rank order through distributed shared memory and applies the scale.
//   One launch, no scratch, no atomics: the result does not vary from run
//   to run.
// * f32 x (and bf16 with K % 8 != 0): the CUDA-core FMA kernel.  Tensor
//   cores would mean TF32 for f32 x, whose three decimal digits break the
//   f32 gates.  A block owns a BM x 64 tile of y (BM = 64, or 16 when M is
//   small), walks K in steps of 32 with the tiles staged in shared memory
//   as f32, and each of its 256 threads keeps a (BM / 16) x 4 block of sums.

#include <cooperative_groups.h>
#include <cuda.h>   // CUtensorMap; the encoder is looked up from the driver at run time
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

template <typename T, typename W>
cudaError_t launch_fma(const void* x, const void* w, const float* scales, void* y, int M,
                       int N, int K, cudaStream_t st) {
  const unsigned gx = (N + BN - 1) / BN;
  if (M <= 16) {
    wo_matmul_kernel<T, W, 16><<<dim3(gx, (M + 15) / 16), NT, 0, st>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), scales,
        static_cast<T*>(y), M, N, K);
  } else {
    wo_matmul_kernel<T, W, 64><<<dim3(gx, (M + 63) / 64), NT, 0, st>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), scales,
        static_cast<T*>(y), M, N, K);
  }
  return cudaGetLastError();
}

// -- tensor-core tile (bf16 x, M > 16) -------------------------------------------

constexpr int TC_BM = 256, TC_BN = 128, TC_BK = 64, TC_STAGES = 4, TC_BUFS = 3, TC_THREADS = 256;
constexpr int X_TILE = TC_BM * TC_BK * 2;    // bf16 x tile: the TMA box, 128-byte rows
constexpr int W_TILE = TC_BK * TC_BN;        // payload bytes, row-major
constexpr int B_REGION = TC_BK * 128;        // one 64-column bf16 region of the B tile
constexpr int B_TILE = 2 * B_REGION;
constexpr size_t TC_SMEM =
    1024 + TC_STAGES * (X_TILE + W_TILE) + TC_BUFS * B_TILE + TC_STAGES * sizeof(uint64_t);

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

template <typename W, int VEC>
__global__ void __launch_bounds__(TC_THREADS, 1)
wo_tc_kernel(const __grid_constant__ CUtensorMap xmap, const uint8_t* __restrict__ w,
             const float* __restrict__ scales, __nv_bfloat16* __restrict__ y, int M, int N,
             int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* xs = smem;                                   // stages of the x tile
  uint8_t* bs = xs + TC_STAGES * X_TILE;                // ring of bf16 B tiles
  uint8_t* ws = bs + TC_BUFS * B_TILE;                  // stages of payload bytes
  uint64_t* bars = reinterpret_cast<uint64_t*>(ws + TC_STAGES * W_TILE);

  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const int KT = (K + TC_BK - 1) / TC_BK;

  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) hop::mbar_init(hop::smem_u32(&bars[s]), 1);
    hop::mbar_fence_init();
  }
  __syncthreads();

  // k-tile t into stage t % STAGES: x by TMA (thread 0), bytes by all.
  auto issue = [&](int t) {
    if (t < KT) {
      const int s = t % TC_STAGES;
      if (tid == 0) {
        const uint32_t bar = hop::smem_u32(&bars[s]);
        hop::mbar_expect_tx(bar, X_TILE);
        hop::tma_load_2d(hop::smem_u32(xs + s * X_TILE), &xmap, bar, t * TC_BK, m0);
      }
      load_w_tile<VEC>(ws + s * W_TILE, w, t * TC_BK, n0, K, N);
    }
    hop::cp_async_commit();
  };

  for (int t = 0; t < TC_STAGES; ++t) issue(t);
  hop::cp_async_wait<TC_STAGES - 1>();
  __syncthreads();
  convert_w_tile<W>(ws, bs);
  hop::fence_async_smem();
  __syncthreads();

  float acc[2][64];   // the warpgroup's two m64 halves
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[hf][i] = 0.f;

  // Iteration t: queue tile t's wgmma behind tile t - 1's, convert tile
  // t + 1 meanwhile, then wait for tile t - 1 only and refill its stage.
  // B tile t + 1 differs from the tiles of the two wgmmas in flight.
  for (int t = 0; t < KT; ++t) {
    const int s = t % TC_STAGES;
    hop::mbar_wait(hop::smem_u32(&bars[s]), (t / TC_STAGES) & 1);
    const uint32_t a0 = hop::smem_u32(xs + s * X_TILE + wg * 128 * 128);
    const uint32_t b0 = hop::smem_u32(bs + (t % TC_BUFS) * B_TILE);
    hop::fence_regs(acc[0]);
    hop::fence_regs(acc[1]);
    hop::wg_arrive();
#pragma unroll
    for (int ks = 0; ks < TC_BK / 16; ++ks) {
      const uint64_t b = hop::desc<128>(b0 + ks * 16 * 128, B_REGION, 1024);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        hop::wgmma_ss<1>(acc[hf], hop::desc<128>(a0 + hf * 64 * 128 + ks * 32, 16, 1024), b,
                         1);
    }
    hop::wg_commit();
    if (t + 1 < KT) {
      // tile t + 1's bytes: committed groups hold tiles up to t + STAGES - 2
      // (an empty group at t = 0), so at most STAGES - 3 may still be pending
      hop::cp_async_wait<TC_STAGES - 3>();
      __syncthreads();
      convert_w_tile<W>(ws + ((t + 1) % TC_STAGES) * W_TILE, bs + ((t + 1) % TC_BUFS) * B_TILE);
      hop::fence_async_smem();
    }
    hop::wg_wait<1>();
    hop::fence_regs(acc[0]);
    hop::fence_regs(acc[1]);
    __syncthreads();   // both warpgroups are done with tile t - 1; B tile t + 1 is written
    if (t >= 1) issue(t - 1 + TC_STAGES);
    else hop::cp_async_commit();
  }
  hop::wg_wait<0>();
  hop::fence_regs(acc[0]);
  hop::fence_regs(acc[1]);

  // epilogue: scale and round in registers, stage the tile in shared memory
  // (the x stages are free; rows padded to 272 bytes, so the fragment's
  // writes hit 32 banks), then write whole rows of y with 16-byte stores.
  // Stored straight from the fragment, each warp instruction would touch
  // eight rows with 16 bytes each: that took half the kernel's time.
  __syncthreads();   // both warpgroups' wgmmas have read their last x stage
  constexpr int YS = TC_BN * 2 + 16;   // bytes of a staged row
  static_assert(TC_BM * YS <= TC_STAGES * X_TILE, "the staged tile fits in the x stages");
  const int warp = lt / 32, lane = lt % 32;
  const int r0 = wg * 128 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < TC_BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4), col = n0 + c;
    const float s0 = col < N ? scales[col] : 0.f, s1 = col + 1 < N ? scales[col + 1] : 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {   // half r / 2, fragment row 8 (r % 2)
      const int hf = r / 2, h = r % 2;
      *reinterpret_cast<__nv_bfloat162*>(xs + (r0 + 64 * hf + 8 * h) * YS + 2 * c) =
          __floats2bfloat162_rn(acc[hf][4 * j + 2 * h] * s0, acc[hf][4 * j + 2 * h + 1] * s1);
    }
  }
  __syncthreads();
  for (int i = tid; i < TC_BM * TC_BN / 8; i += TC_THREADS) {
    const int r = i / (TC_BN / 8), c = i % (TC_BN / 8) * 8;
    const int row = m0 + r, col = n0 + c;
    if (row >= M || col >= N) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(xs + r * YS + 2 * c);
    __nv_bfloat16* out = y + size_t(row) * N + col;
    if (N % 8 == 0) {
      *reinterpret_cast<uint4*>(out) = v;
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
      for (int q = 0; q < 8 && col + q < N; ++q) out[q] = e[q];
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

template <typename W, int VEC>
cudaError_t launch_tc_vec(const CUtensorMap& map, const void* w, const float* scales, void* y,
                          int M, int N, int K, cudaStream_t st) {
  auto kernel = wo_tc_kernel<W, VEC>;
  static const cudaError_t opted = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(TC_SMEM));
  if (opted != cudaSuccess) return opted;
  const dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM);
  kernel<<<grid, TC_THREADS, TC_SMEM, st>>>(map, static_cast<const uint8_t*>(w), scales,
                                            static_cast<__nv_bfloat16*>(y), M, N, K);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_tc(const void* x, const void* w, const float* scales, void* y, int M, int N,
                      int K, cudaStream_t st) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {cuuint64_t(K), cuuint64_t(M)};
  const cuuint64_t strides[1] = {cuuint64_t(K) * 2};
  const cuuint32_t box[2] = {TC_BK, TC_BM};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  if (N % 16 == 0) return launch_tc_vec<W, 16>(map, w, scales, y, M, N, K, st);
  if (N % 8 == 0) return launch_tc_vec<W, 8>(map, w, scales, y, M, N, K, st);
  if (N % 4 == 0) return launch_tc_vec<W, 4>(map, w, scales, y, M, N, K, st);
  return launch_tc_vec<W, 1>(map, w, scales, y, M, N, K, st);
}

// -- GEMV (bf16 x, M <= 16) ----------------------------------------------------

constexpr int GV_THREADS = 128, GV_CT = 4, GV_KL = 32, GV_MT = 4, GV_KC = 256;
constexpr int GV_COLS = GV_CT * 16;                  // columns a block owns
constexpr int GV_RED = GV_MT * GV_CT * 17 + 1;       // padded partials of one k-lane
constexpr int GV_MAX_SPLITS = 8;                     // the portable cluster size

// One block of a cluster: 64 columns, up to 4 rows of x, one K range.  The
// cluster's blocks split K; each sums its range, then the cluster adds the
// ranges through distributed shared memory in rank order.
template <typename W, int VEC>
__global__ void __launch_bounds__(GV_THREADS)
wo_gemv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
               const float* __restrict__ scales, __nv_bfloat16* __restrict__ y, int M, int N,
               int K, int kchunk) {
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
      xs[r][c] = (m < M && c < kn) ? __bfloat162float(x[size_t(m) * K + k0 + c]) : 0.f;
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
    if (row < M && n < N) y[size_t(row) * N + n] = __float2bfloat16(s * scales[n]);
  }
  cluster.sync();   // no block leaves while another still reads its sums
}

template <typename W, int VEC>
cudaError_t launch_gemv_vec(const void* x, const void* w, const float* scales, void* y, int M,
                            int N, int K, cudaStream_t st) {
  // K splits: about one block per SM, each at least 64 rows of W deep
  const int blocks = (N + GV_COLS - 1) / GV_COLS * ((M + GV_MT - 1) / GV_MT);
  const int splits = max(1, min(min(GV_MAX_SPLITS, 132 / blocks), K / 64));
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
  return cudaLaunchKernelEx(&cfg, wo_gemv_kernel<W, VEC>,
                            static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
                            scales, static_cast<__nv_bfloat16*>(y), M, N, K,
                            (K + splits - 1) / splits);
}

template <typename W>
cudaError_t launch_gemv(const void* x, const void* w, const float* scales, void* y, int M, int N,
                        int K, cudaStream_t st) {
  if (N % 16 == 0) return launch_gemv_vec<W, 16>(x, w, scales, y, M, N, K, st);
  if (N % 8 == 0) return launch_gemv_vec<W, 8>(x, w, scales, y, M, N, K, st);
  if (N % 4 == 0) return launch_gemv_vec<W, 4>(x, w, scales, y, M, N, K, st);
  return launch_gemv_vec<W, 1>(x, w, scales, y, M, N, K, st);
}

template <typename W>
cudaError_t dispatch(int dtype, const void* x, const void* w, const float* scales, void* y, int M,
                     int N, int K, cudaStream_t st) {
  if (dtype == 0) return launch_fma<float, W>(x, w, scales, y, M, N, K, st);
  if (dtype != 1) return cudaErrorInvalidValue;
  if (M <= 16) return launch_gemv<W>(x, w, scales, y, M, N, K, st);
  if (K > 0 && K % 8 == 0) return launch_tc<W>(x, w, scales, y, M, N, K, st);
  return launch_fma<__nv_bfloat16, W>(x, w, scales, y, M, N, K, st);
}

}  // namespace

// x (M, K), y (M, N) row-major in dtype (0 = float32, 1 = bfloat16); w
// (K, N) row-major payload (2 = int8, 3 = float8 e4m3); scales (N,) f32.
extern "C" int fa_wo_matmul(const void* x, const void* w, const void* scales, void* y, int M,
                            int N, int K, int dtype, int payload, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scales);
  if (payload == 2) return int(dispatch<int8_t>(dtype, x, w, s, y, M, N, K, st));
  if (payload == 3) return int(dispatch<__nv_fp8_e4m3>(dtype, x, w, s, y, M, N, K, st));
  return int(cudaErrorInvalidValue);
}
