// Hopper (sm_90a) building blocks shared by the tensor-core kernels: the
// 128/64-byte shared-memory swizzle, wgmma matrix descriptors, the wgmma
// instructions (bf16 x bf16 -> f32, A from shared memory or registers),
// their fences, cp.async and a swizzled tile loader on it, mbarriers and
// TMA; the s8 x s8 -> s32 wgmma of the quantized-KV flash kernel; and the
// warp-level mma.sync m16n8k16 (bf16 -> f32) with ldmatrix and its
// fragment loaders, for tiles of 16 rows a warp (paged decode, the op
// graph's attention).  Inline PTX only, so a kernel that
// includes this builds in seconds.
//
// Layouts (PTX ISA, "Shared memory matrix layout"; CUTLASS's canonical GMMA
// layouts).  An operand tile lives in shared memory as regions of SW-byte
// rows (SW = 128, or 64 when a row holds only 32 bf16; an 8-bit tile of D
// bytes a row takes SW = D: 128, 64 or 32), each region based
// at a 1024-byte boundary, with the 16-byte chunk c of row r stored at
// chunk c ^ ((r * SW / 128) % (SW / 16)): the pattern TMA's SWIZZLE_128B /
// _64B writes (swz below).  One descriptor reads a 64-row (A) or N-row (B)
// slab:
//   K-major (the contraction dim runs along a row): rows are M or N, eight
//     rows form a core group, SBO = 8 * SW bytes between groups; the k16
//     step advances the start address by 32 bytes within the row.
//   MN-major (M or N runs along a row; the transpose bit set): rows are K,
//     SBO = 8 * SW bytes between groups of eight k rows, LBO = bytes
//     between SW-wide column regions; the k16 step advances 16 rows.
// Accumulator fragment of m64nNk16 (f32): thread t of the warpgroup holds
// d[4j + 2h + e] = D[16 * (t / 32) + (t % 32) / 4 + 8h][8j + 2 (t % 4) + e]
// for j < N / 8, h, e in {0, 1}; the A-from-registers fragment of one k16
// step is the same shape over 16 columns, packed as bf16 pairs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hop {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Swizzled byte offset of a byte offset into a region of SW-byte rows.
template <int SW>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  constexpr uint32_t kMask = SW / 16 - 1;
  return off ^ (((off >> 7) & kMask) << 4);
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets, swizzle mode (1 = 128 B, 2 = 64 B, 3 = 32 B).
template <int SW>
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t kLayout = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (kLayout << 62);
}

__device__ __forceinline__ void wg_arrive() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across a wgmma
// or its wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
// Generic-proxy shared-memory writes (st.shared, cp.async) before an async-
// proxy reader (wgmma, TMA).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barriers (ids 1..15; __syncthreads is id 0): bar_arrive signals
// without waiting, bar_sync waits until `count` threads have arrived or
// synced on `id`; shared-memory writes before the arrive are visible after
// the sync (a producer / consumer pair of warpgroups).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// cp.async of BYTES (4, 8 or 16) bytes; zero-fills the destination when
// pred is false (src must still be a valid address).
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(BYTES), "r"(n)
                 : "memory");
}
// Chunk c (16 bytes) of a source row of row_bytes bytes (row: its start)
// into shared memory at dst, the bytes past the row's end zero; nothing is
// read when ok is false (base: any valid address).  A row of a multiple of
// 16 bytes takes one 16-byte copy; one of 8 mod 16 (an 8-bit row at a
// head dim of 8 mod 16, whose rows are only 8-byte aligned) two of 8 bytes.
// So a tile D values wide holds a head dim d < D zero-padded, as JAX's
// _pad128 pads it, without a padded copy in device memory.  kFull: the row
// fills the tile's width (d == D), every chunk exists: one plain copy.
template <bool kFull = false>
__device__ __forceinline__ void cp_chunk(uint32_t dst, const uint8_t* row, const void* base, int c,
                                         int row_bytes, bool ok) {
  const uint8_t* src = row + 16 * c;
  if constexpr (kFull) {
    cp_async<16>(dst, ok ? src : base, ok);
    return;
  }
  const int n = ok ? row_bytes - 16 * c : 0;   // bytes of the chunk that exist
  if (row_bytes % 16 == 0) {
    cp_async<16>(dst, n > 0 ? src : base, n > 0);
  } else {
    cp_async<8>(dst, n > 0 ? src : base, n > 0);
    cp_async<8>(dst + 8, n > 8 ? src + 8 : base, n > 8);
  }
}

// load_tile's loop; kFull: src_row == ROW_BYTES, known at compile time.
template <int ROW_BYTES, int SW, int THREADS, bool kFull>
__device__ __forceinline__ void load_tile_rows(uint8_t* dst, const uint8_t* s, const void* base,
                                               int rows_valid, int rows, int src_row) {
  constexpr int CHUNKS = ROW_BYTES / 16, REGION_CHUNKS = SW / 16;
  const int stride = kFull ? ROW_BYTES : src_row;
  for (int i = threadIdx.x; i < rows * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool ok = r < rows_valid;
    uint8_t* d = dst + (c / REGION_CHUNKS) * (rows * SW) +
                 swz<SW>(r * SW + (c % REGION_CHUNKS) * 16);
    cp_chunk<kFull>(smem_u32(d), s + (ok ? size_t(r) * stride : 0), base, c, stride, ok);
  }
}

// Rows [0, rows) of a row-major matrix at src, src_row bytes a row (at
// most ROW_BYTES, a multiple of 8), into a tile of ROW_BYTES-byte rows in
// swizzled regions of SW-byte rows (region stride rows * SW bytes); rows at
// or past rows_valid and the bytes past src_row are zero (base: any valid
// address).  One chunk of 16 bytes (cp_chunk) at a time, spread over
// THREADS threads; rows of the tile's full width take a loop of plain
// copies.
template <int ROW_BYTES, int SW, int THREADS>
__device__ __forceinline__ void load_tile(uint8_t* dst, const void* src, const void* base,
                                          int rows_valid, int rows, int src_row = ROW_BYTES) {
  const uint8_t* s = static_cast<const uint8_t*>(src);
  if (src_row == ROW_BYTES)
    load_tile_rows<ROW_BYTES, SW, THREADS, true>(dst, s, base, rows_valid, rows, src_row);
  else
    load_tile_rows<ROW_BYTES, SW, THREADS, false>(dst, s, base, rows_valid, rows, src_row);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  }
}
// TMA: a 2-D box of a tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, N = 2 x the accumulator
// registers a thread (n32, n64, n128; wgmma_rs also n256).  wgmma_ss: A and B by descriptor (A
// K-major; n64 and n128, the widths callers use); wgmma_rs: A from four
// registers per thread (bf16 pairs).  TB = 1 reads B MN-major.  scale_d = 0
// overwrites d.
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

// wgmma.mma_async m64n128k32, s32 += s8 x s8: A and B by descriptor, both
// K-major (8-bit wgmma takes no other layout), 32 bytes of K a step.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

// m64n256k16: the accumulator of a 256-column tile (128 registers a thread).
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

// mma.sync m16n8k16, f32 += bf16 x bf16, one warp.  Fragments (PTX ISA,
// "Matrix fragments for mma.m16n8k16"), g = lane / 4, t = lane % 4:
//   A (16 x 16, row-major): a[0] = A[g][2t, 2t+1], a[1] = A[g+8][2t, 2t+1],
//     a[2] = A[g][2t+8, 2t+9], a[3] = A[g+8][2t+8, 2t+9] (bf16 pairs, the
//     lower column in the low half);
//   B (16 x 8): b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g];
//   C (16 x 8, f32): d[0..1] = C[g][2t, 2t+1], d[2..3] = C[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix .x4 .trans: four 8 x 8 bf16 matrices whose rows lanes 8i..8i+7
// address (16 bytes each); r[i] of lane (g, t) holds matrix i's elements
// [2t][g] and [2t+1][g], the B fragment of a row-major K x N tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// ldmatrix .x4: the same four matrices untransposed, r[i] of lane (g, t)
// holding matrix i's elements [g][2t] and [g][2t+1].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// m16n8k16 fragments by ldmatrix.x4 from a bf16 tile of padded rows in
// shared memory: `row` bytes apart, an odd multiple of 16, so that the
// eight rows of a matrix hit distinct banks (D * 2 + 16 for a row of D
// values, D a multiple of 16).  lane = threadIdx.x % 32.
//   frag_a: A of the 16 x 16 block at (m0, k0) of a tile stored M-major
//     (a row per A row: Q's rows for Q K^T);
//   frag_b2: B of the n-tiles [n0, n0 + 8) and [n0 + 8, n0 + 16) over
//     k0..k0 + 15 of a tile stored N-major (a row per B column: K's keys
//     for Q K^T), b[0..1] the first, b[2..3] the second;
//   frag_b2t: the same of a tile stored K-major (a row per B row: V's keys
//     for P V), by ldmatrix.trans.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], uint32_t tile, int row, int m0, int k0,
                                       int lane) {
  const int m = m0 + lane % 8 + (lane / 8 % 2) * 8, k = k0 + lane / 16 * 8;
  ldmatrix_x4(a, tile + m * row + k * 2);
}
__device__ __forceinline__ void frag_b2(uint32_t (&b)[4], uint32_t tile, int row, int n0, int k0,
                                        int lane) {
  const int n = n0 + lane % 8 + lane / 16 * 8, k = k0 + (lane / 8 % 2) * 8;
  ldmatrix_x4(b, tile + n * row + k * 2);
}
__device__ __forceinline__ void frag_b2t(uint32_t (&b)[4], uint32_t tile, int row, int k0, int n0,
                                         int lane) {
  const int k = k0 + lane % 8 + (lane / 8 % 2) * 8, n = n0 + lane / 16 * 8;
  ldmatrix_x4_trans(b, tile + k * row + n * 2);
}

// The A fragment of k-step kc from two m16n8 accumulators of the same 16
// rows, n-tiles 2 kc and 2 kc + 1 (the columns become the contraction),
// each value rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// c (16 x 8 NJ, f32) = the 16 rows at m0 of tile a (stored M-major) times
// the first `rows` (a multiple of 16) rows of tile b (stored N-major)
// transposed, contracted over D: a score tile, Q K^T.  n-tiles at or past
// `rows` are zero.
template <int D, int NJ>
__device__ __forceinline__ void tile_scores(float (&c)[NJ][4], uint32_t a, int m0, uint32_t b,
                                            int row, int rows, int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t fa[4];
    frag_a(fa, a, row, m0, 16 * ks, lane);
#pragma unroll
    for (int j2 = 0; j2 < NJ / 2; ++j2) {
      if (16 * j2 >= rows) continue;
      uint32_t fb[4];
      frag_b2(fb, b, row, 16 * j2, 16 * ks, lane);
      mma_16816(c[2 * j2], fa, fb[0], fb[1]);
      mma_16816(c[2 * j2 + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc (16 x D, n-tiles of 8) += A (16 x 16, NP parts summed) times the
// rows [k0, k0 + 16) of a tile stored K-major (B = its rows: V for P V).
template <int D, int NP>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 8][4], const uint32_t (&a)[NP][4],
                                         uint32_t tile, int row, int k0, int lane) {
#pragma unroll
  for (int n2 = 0; n2 < D / 16; ++n2) {
    uint32_t bb[4];
    frag_b2t(bb, tile, row, k0, 16 * n2, lane);
#pragma unroll
    for (int pt = 0; pt < NP; ++pt) {
      mma_16816(acc[2 * n2], a[pt], bb[0], bb[1]);
      mma_16816(acc[2 * n2 + 1], a[pt], bb[2], bb[3]);
    }
  }
}

// load_rows_padded's loop; kFull: src_row == ROW_BYTES.
template <int ROW_BYTES, bool kFull>
__device__ __forceinline__ void load_rows_padded_rows(uint8_t* dst, const uint8_t* s,
                                                      const void* base, int rows_valid, int rows,
                                                      int src_row) {
  constexpr int CHUNKS = ROW_BYTES / 16;
  const int stride = kFull ? ROW_BYTES : src_row;
  for (int i = threadIdx.x; i < rows * CHUNKS; i += blockDim.x) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool ok = r < rows_valid;
    cp_chunk<kFull>(smem_u32(dst + r * (ROW_BYTES + 16) + c * 16),
                    s + (ok ? size_t(r) * stride : 0), base, c, stride, ok);
  }
}

// Rows [0, rows) of a row-major matrix at src, src_row bytes a row (at
// most ROW_BYTES, a multiple of 8), into shared memory rows of ROW_BYTES +
// 16 bytes (the padding of frag_a); rows at or past rows_valid and the
// bytes past src_row are zero (base: any valid address).  One chunk of 16
// bytes (cp_chunk) at a time, spread over the block's threads.
template <int ROW_BYTES>
__device__ __forceinline__ void load_rows_padded(uint8_t* dst, const void* src, const void* base,
                                                 int rows_valid, int rows,
                                                 int src_row = ROW_BYTES) {
  const uint8_t* s = static_cast<const uint8_t*>(src);
  if (src_row == ROW_BYTES)
    load_rows_padded_rows<ROW_BYTES, true>(dst, s, base, rows_valid, rows, src_row);
  else
    load_rows_padded_rows<ROW_BYTES, false>(dst, s, base, rows_valid, rows, src_row);
}

// The tile width of a head dim: the least of 32, 64 and 128 (and 256
// where max_width is 256) that holds d, or 0 where no tile takes it (d not
// a multiple of 8, or above max_width).  The attention kernels are
// compiled for those widths and read a head dim d below the width
// zero-padded (cp_chunk); the kernels with a 256-column tile (the bf16
// flash forward, bf16-q paged attention) pass max_width 256, the others
// keep 128.
__host__ __device__ constexpr int tile_width(int d, int max_width = 128) {
  return d < 8 || d % 8 != 0 || d > max_width ? 0
         : d <= 32                            ? 32
         : d <= 64                            ? 64
         : d <= 128                           ? 128
                                              : 256;
}

}  // namespace hop
