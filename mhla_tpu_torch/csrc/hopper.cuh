// Hopper (sm_90a) building blocks of the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu), K2 and K4 (mhla_chunk.cu), K2b and K4b
// (mhla_chunk_bwd.cu), K3 / K3b (mhla_mix_wide.cu), K6 and K7
// (mhla_block.cu), K7b (mhla_block_bwd.cu), K11 / K11b (delta_chunk.cu,
// delta_chunk_bwd.cu) and K12 / K12b (gla_chunk.cu, gla_chunk_bwd.cu):
// mbarriers, TMA tile loads through tensor maps (multicast to a cluster's
// blocks too) and one-dimensional bulk copies, ldmatrix / stmatrix, wgmma products in bf16 and TF32 with their shared-memory
// descriptors and fences, named barriers, cluster barriers and setmaxnreg.
// The kernels' tiles live in shared memory in the layout a TMA load with
// 128-byte swizzle writes: a [rows][D] bf16 tile is D / 64 panels of
// [rows][64] (128 bytes a row), panel p at byte p * rows * 128, the 16-byte
// chunk c of row r at chunk c ^ (r % 8). Every tile starts at a multiple of
// 1024 bytes (8 rows: one swizzle pattern).
//
// Operands of wgmma.m64nNk16 (bf16 in, float32 sums) in that layout:
// - K-major (the K index runs along a row: q and k for S = q k^T): the
//   descriptor of k-step s (16 columns) starts at row r0 of panel s / 4,
//   32 * (s % 4) bytes into the row; 8-row groups 1024 bytes apart (stride
//   offset); the leading offset is unused.
// - MN-major (the K index runs down the rows: v for P v, where the keys are
//   the K index and the head dim is N): k-step s starts at row 16 s of panel
//   0; the N index crosses panels, rows * 128 bytes apart (leading offset);
//   8-row groups along K 1024 bytes apart (stride offset). An A operand
//   read MN-major (M^T from M's rows) takes the same descriptor, its 64
//   rows being one panel's columns.
// The float32 accumulator of m64nN is N / 8 tiles of 4 registers a thread:
// in warp w of the warpgroup, lane l holds tile i's rows 16 w + l / 4 (regs
// 0, 1) and + 8 (regs 2, 3), columns 8 i + 2 (l % 4) and + 1: the layout of
// mma.sync m16n8, once per 8 columns. The A operand from registers is the
// mma.sync m16n8k16 A fragment of the warp's 16 rows.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; libcuda's encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <mutex>

namespace hopper {

// ---- shared memory, mbarriers, named barriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA) and the block.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and add ``bytes`` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity ``parity`` has completed. (No watchdog
// here: a __trap() in this loop made ptxas spill the consumers' accumulators
// and serialize their wgmmas.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Named barriers (id 1 .. 15; 0 is __syncthreads) among ``threads`` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Registers a thread of this warpgroup may hold from here on (all four
// warps execute it; the kernel's roles must not reconverge afterwards).
template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---- TMA

// Load the box at coordinates (c0, c1, c2, c3) (innermost first) of a 4-D
// tensor map into shared memory; its bytes complete a transaction of ``bar``.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Load columns [c0, c0 + kCols) of rows [t0, t0 + rows) of head h, batch
// row b of a [B, T, H, D] map (box 64 x 1 x rows x 1) into a tile of
// kCols / 64 panels at ``dst``.
template <int kCols, int kRows>
__device__ __forceinline__ void tma_load_cols(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int c0, int t0, int h, int b) {
#pragma unroll
  for (int p = 0; p < kCols / 64; ++p)
    tma_load_4d(static_cast<char*>(dst) + p * kRows * 128, map, bar, c0 + p * 64, h, t0, b);
}

// Store a box of a 4-D tensor map from shared memory (its coordinates
// innermost first; parts outside the tensor are not written) into the
// issuing thread's open bulk group; tma_store_commit closes the group.
__device__ __forceinline__ void tma_store_4d_part(const CUtensorMap* map, const void* src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// One box stored as a bulk group of its own.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  tma_store_4d_part(map, src, c0, c1, c2, c3);
  tma_store_commit();
}

// Wait until at most N of this thread's bulk stores still read shared memory.
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until all of this thread's bulk stores are done.
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Make this thread's ordinary shared-memory writes visible to TMA.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of element (r, c) in a [rows][64] bf16 panel in the 128-byte
// swizzle layout (the one TMA reads and writes).
__device__ __forceinline__ int swizzle128(int r, int c) {
  return r * 128 + ((((c * 2) >> 4) ^ (r & 7)) << 4) + ((c * 2) & 15);
}

// Two floats rounded to bf16 and packed (lo in the low half): a wgmma A
// fragment register, or two adjacent bf16 values.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The (row, column) of element e of tile i of this thread's part of a
// warpgroup's m64nN float32 accumulator (the layout above).
__device__ __forceinline__ int acc_row(int e) {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int i, int e) {
  return 8 * i + 2 * (threadIdx.x & 3) + (e & 1);
}

// Round f(row, column, x) of a warpgroup's [64 x kN] float32 accumulator
// (the wgmma layout) to bf16 into kN / 64 panels of [64][64] at ``dst``, 8 KB
// apart, in the 128-byte swizzle layout a TMA store of 64 x 64 boxes reads.
template <int kN, typename F>
__device__ __forceinline__ void acc_to_panels(unsigned char* dst, const float (&acc)[kN / 8][4],
                                              F f) {
  const int t = threadIdx.x % 128, r0 = (t >> 5) * 16 + ((t & 31) >> 2), tg = t & 3;
#pragma unroll
  for (int i = 0; i < kN / 8; ++i) {
    unsigned char* panel = dst + (i / 8) * 64 * 128;
    const int c = (i % 8) * 8 + tg * 2, col = 8 * i + tg * 2;
    *reinterpret_cast<__nv_bfloat162*>(panel + swizzle128(r0, c)) =
        __floats2bfloat162_rn(f(r0, col, acc[i][0]), f(r0, col + 1, acc[i][1]));
    *reinterpret_cast<__nv_bfloat162*>(panel + swizzle128(r0 + 8, c)) =
        __floats2bfloat162_rn(f(r0 + 8, col, acc[i][2]), f(r0 + 8, col + 1, acc[i][3]));
  }
}

template <int kN>
__device__ __forceinline__ void acc_to_panels(unsigned char* dst, const float (&acc)[kN / 8][4]) {
  acc_to_panels<kN>(dst, acc, [](int, int, float x) { return x; });
}

// All D columns: a tile of D / 64 panels.
template <int kD, int kRows>
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int t0, int h, int b) {
  tma_load_cols<kD, kRows>(dst, map, bar, 0, t0, h, b);
}

// One-dimensional bulk copies (no tensor map): ``bytes`` (a multiple of 16,
// both addresses 16-byte aligned) from device to shared memory, completing a
// transaction of ``bar``; and from shared to device memory into the issuing
// thread's open bulk group (tma_store_commit closes it).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

// ---- wgmma

// A shared-memory matrix descriptor for the 128-byte swizzle layout;
// offsets in bytes.
__device__ __forceinline__ uint64_t make_desc(const void* smem, uint32_t lead, uint32_t stride) {
  return (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4) | ((uint64_t)((lead >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((stride >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand: rows [r0, r0 + 64 or N) of a [kRows][D] tile, k-step 0;
// kstep_kmajor<kRows>(s) added to it gives k-step s (the start address is
// the descriptor's low 14 bits, in 16-byte units).
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int r0) {
  return make_desc(static_cast<const char*>(tile) + r0 * 128, 16, 1024);
}

template <int kRows>
__device__ __forceinline__ constexpr uint64_t kstep_kmajor(int s) {
  return (uint64_t)(((s / 4) * kRows * 128 + (s % 4) * 32) >> 4);
}

// MN-major operand: a [kRows][D] tile, N running over its columns, k-step 0;
// kstep_mnmajor(s) added gives k-step s (rows 16 s .. 16 s + 15).
template <int kRows>
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile) {
  return make_desc(tile, kRows * 128, 1024);
}

__device__ __forceinline__ constexpr uint64_t kstep_mnmajor(int s) {
  return (uint64_t)(s * 16 * 128 >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of an accumulator across the
// asynchronous products (call after wgmma_wait, and before a product that
// reads registers written by ordinary code).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// One fragment. Fence only registers no pending product reads: ptxas counts
// the fence as defining them and serializes the wgmmas that do (C7513).
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[j])::"memory");
}

// The float32 accumulator operands of an m64nN product: N / 8 tiles of 4.
#define HOPPER_ACC4(d, i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
#define HOPPER_ACC8(d)                                                                  \
  HOPPER_ACC4(d, 0), HOPPER_ACC4(d, 1), HOPPER_ACC4(d, 2), HOPPER_ACC4(d, 3),           \
      HOPPER_ACC4(d, 4), HOPPER_ACC4(d, 5), HOPPER_ACC4(d, 6), HOPPER_ACC4(d, 7)
#define HOPPER_ACC16(d)                                                                 \
  HOPPER_ACC8(d), HOPPER_ACC4(d, 8), HOPPER_ACC4(d, 9), HOPPER_ACC4(d, 10),             \
      HOPPER_ACC4(d, 11), HOPPER_ACC4(d, 12), HOPPER_ACC4(d, 13), HOPPER_ACC4(d, 14),   \
      HOPPER_ACC4(d, 15)
#define HOPPER_ACC32(d)                                                                 \
  HOPPER_ACC16(d), HOPPER_ACC4(d, 16), HOPPER_ACC4(d, 17), HOPPER_ACC4(d, 18),          \
      HOPPER_ACC4(d, 19), HOPPER_ACC4(d, 20), HOPPER_ACC4(d, 21), HOPPER_ACC4(d, 22),   \
      HOPPER_ACC4(d, 23), HOPPER_ACC4(d, 24), HOPPER_ACC4(d, 25), HOPPER_ACC4(d, 26),   \
      HOPPER_ACC4(d, 27), HOPPER_ACC4(d, 28), HOPPER_ACC4(d, 29), HOPPER_ACC4(d, 30),   \
      HOPPER_ACC4(d, 31)
#define HOPPER_REGS32                                                                   \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_REGS64                                                                   \
  HOPPER_REGS32 ", "                                                                    \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "    \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define HOPPER_REGS128                                                                  \
  HOPPER_REGS64 ", "                                                                    \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "    \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "    \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "    \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "      \
  "%123, %124, %125, %126, %127"

// D[64 x N] (+)= A B, N = 64, 128 or 256 (the accumulator's size picks it): A
// and B from shared memory, K-major unless kTransA / kTransB is 1 (then
// MN-major: the K index runs down the tile's rows, as desc_mnmajor describes);
// at N = 64 with kNegA, D (+)= -A B.
template <int kTransA = 0, int kTransB = 0, int kNegA = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_REGS32
      "}, %32, %33, p, %37, 1, %35, %36;\n}\n"
      : HOPPER_ACC8(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransA), "n"(kTransB),
        "n"(kNegA ? -1 : 1));
}

template <int kTransA = 0, int kTransB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_REGS64
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : HOPPER_ACC16(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

template <int kTransA = 0, int kTransB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[32][4], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" HOPPER_REGS128
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : HOPPER_ACC32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// D[64 x N] (+)= A B, N = 64, 128 or 256: A from registers (the m64k16 A
// fragments), B from shared memory, MN-major (its rows are the K index)
// unless kTransB is 0 (then K-major); with kNegA, D (+)= -A B.
template <int kTransB = 1, int kNegA = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_REGS32
      "}, {%32, %33, %34, %35}, %36, p, %38, 1, %39;\n}\n"
      : HOPPER_ACC8(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(kNegA ? -1 : 1), "n"(kTransB));
}

template <int kTransB = 1, int kNegA = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_REGS64
      "}, {%64, %65, %66, %67}, %68, p, %70, 1, %71;\n}\n"
      : HOPPER_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(kNegA ? -1 : 1), "n"(kTransB));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32][4], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" HOPPER_REGS128
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// A [64 x 16 k] fragments of bf16(acc) for a [64 x kN] float32 accumulator:
// k-step s covers its columns [16 s, 16 s + 16) (the accumulator of one
// product as the A operand of the next, as flash_fwd.cu's P @ V).
template <int kN>
__device__ __forceinline__ void acc_frags(uint32_t (&a)[kN / 16][4],
                                          const float (&acc)[kN / 8][4]) {
#pragma unroll
  for (int s = 0; s < kN / 16; ++s) {
    a[s][0] = pack_bf16(acc[2 * s][0], acc[2 * s][1]);
    a[s][1] = pack_bf16(acc[2 * s][2], acc[2 * s][3]);
    a[s][2] = pack_bf16(acc[2 * s + 1][0], acc[2 * s + 1][1]);
    a[s][3] = pack_bf16(acc[2 * s + 1][2], acc[2 * s + 1][3]);
  }
}

// ldmatrix / stmatrix, four 8 x 8 bf16 matrices, transposed: lane l gives
// the address of row l % 8 of matrix l / 8 (16 contiguous bytes); matrix j
// is register j. ldsm_x4_t loads each stored matrix's transpose in the mma
// fragment layout (lane l: row l / 4, columns 2 (l % 4), +1); stsm_x4_t
// stores fragment j transposed (its column c becomes stored row c).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row))
               : "memory");
}

__device__ __forceinline__ void stsm_x4_t(void* row, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_u32(row)),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// ---- TF32 products (K6, K7, K7b, K12, K12b)

// Register strings and accumulator operands (N / 8 tiles of 4) of the TF32
// products of N = 16 .. 80 below.

#define HOPPER_REGS8 \
  "%0, %1, %2, %3, %4, %5, %6, %7"

#define HOPPER_REGS16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"

#define HOPPER_REGS20 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19"

#define HOPPER_REGS24 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23"

#define HOPPER_REGS28 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27"

#define HOPPER_REGS40 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39"

#define HOPPER_ACC_T10(d) \
  HOPPER_ACC8(d), HOPPER_ACC4(d, 8), HOPPER_ACC4(d, 9)

#define HOPPER_ACC_T2(d) \
  HOPPER_ACC4(d, 0), HOPPER_ACC4(d, 1)

#define HOPPER_ACC_T4(d) \
  HOPPER_ACC4(d, 0), HOPPER_ACC4(d, 1), HOPPER_ACC4(d, 2), HOPPER_ACC4(d, 3)

#define HOPPER_ACC_T5(d) \
  HOPPER_ACC4(d, 0), HOPPER_ACC4(d, 1), HOPPER_ACC4(d, 2), HOPPER_ACC4(d, 3), \
  HOPPER_ACC4(d, 4)

#define HOPPER_ACC_T6(d) \
  HOPPER_ACC4(d, 0), HOPPER_ACC4(d, 1), HOPPER_ACC4(d, 2), HOPPER_ACC4(d, 3), \
  HOPPER_ACC4(d, 4), HOPPER_ACC4(d, 5)

#define HOPPER_ACC_T7(d) \
  HOPPER_ACC4(d, 0), HOPPER_ACC4(d, 1), HOPPER_ACC4(d, 2), HOPPER_ACC4(d, 3), \
  HOPPER_ACC4(d, 4), HOPPER_ACC4(d, 5), HOPPER_ACC4(d, 6)

// D[64 x N] (+)= A B in TF32 with float32 sums, N = 16, 32, 40, 48, 56, 64 or 80
// (the accumulator's size picks it): A from registers, the m64k8 tf32
// fragment (in warp w, lane l holds rows 16 w + l / 4 (regs 0, 2) and + 8
// (1, 3), columns l % 4 (0, 1) and + 4 (2, 3)), B from shared memory,
// K-major (TF32 takes no other): a [N][K] float32 tile in 128-byte swizzled
// panels of 32 columns, a k-step of 8 being 32 bytes of a row as for bf16's
// k16.

__device__ __forceinline__ void wgmma_tf32(float (&d)[2][4], const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {" HOPPER_REGS8
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : HOPPER_ACC_T2(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[4][4], const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" HOPPER_REGS16
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : HOPPER_ACC_T4(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[5][4], const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {" HOPPER_REGS20
      "}, {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : HOPPER_ACC_T5(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[6][4], const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {" HOPPER_REGS24
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : HOPPER_ACC_T6(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[7][4], const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 {" HOPPER_REGS28
      "}, {%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
      : HOPPER_ACC_T7(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4], const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" HOPPER_REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : HOPPER_ACC8(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[10][4], const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {" HOPPER_REGS40
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : HOPPER_ACC_T10(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// x = hi + lo: hi its TF32 rounding (nearest, ties away from zero: the
// cvt.rna.tf32.f32 result for finite x, by integer arithmetic, two
// instructions where the cvt takes about six) and lo = x - hi, exact in
// float32, passed whole: the tensor cores read the top 19 bits of each
// operand word, so they take lo truncated to TF32. hi * hi' + hi * lo' + lo
// * hi' then carries a product to float32 accuracy: the truncation of lo and
// the dropped lo * lo' are 2^-21 and 2^-22 of it.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Byte offset of element (r, c) in a [rows][32] float32 panel in the
// 128-byte swizzle layout (the one TMA reads and writes).
__device__ __forceinline__ int swizzle128_f32(int r, int c) {
  return r * 128 + (((c >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// ---- clusters

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives, then waits for the rest.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// Arrive on the mbarrier at the offset of ``bar`` in block ``cta`` of the
// cluster (release at CTA scope, as a local arrive: the arriving thread's
// reads of the stage it frees have completed; a cluster-scope release made
// every arrival wait, and K6 ran about 3x slower with it).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}

// tma_load_4d into the blocks of ``mask`` of the cluster: the box lands at the
// offset of ``dst`` in each and completes a transaction of the mbarrier at
// the offset of ``bar`` in each.
__device__ __forceinline__ void tma_load_4d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, uint16_t mask, int c0,
                                                      int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6, %7}], [%2], %3;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

}  // namespace hopper

// ---- host side

namespace hopper_host {

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once in the libcuda the
// process already holds (no link flag). static: one copy per including source.
static inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A tensor map of a contiguous [B, T, H, D] bf16 tensor whose boxes are 64
// head-dim columns of ``rows`` tokens of one (batch row, head), 128-byte
// swizzle; tokens past T read as zeros. Returns a cudaError_t.
static inline int make_tile_map(CUtensorMap* map, const void* base, int B, int T, int H, int D,
                                int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)T * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A tensor map of a contiguous [B, N, R] float32 or bf16 tensor, read as
// the 4-D map {R, N, B, 1}: boxes of one row's 128 bytes (32 float32 or 64
// bf16 values) by ``rows`` rows of one batch row, 128-byte swizzle; rows past
// N and columns past R read as zeros and are not written. Returns a
// cudaError_t.
static inline int make_rows_map(CUtensorMap* map, const void* base, int is_bf16, int B, int N,
                                long long R, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t es = is_bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {(cuuint64_t)R, (cuuint64_t)N, (cuuint64_t)B, 1};
  const cuuint64_t strides[3] = {(cuuint64_t)R * es, (cuuint64_t)N * R * es,
                                 (cuuint64_t)B * N * R * es};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / es), (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        4, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// How many blocks of ``fn`` (``threads`` threads, ``smem`` bytes of dynamic
// shared memory) the current device holds at once, its SMs times the blocks
// an SM takes, into *blocks, after raising ``fn``'s shared-memory limit to
// at least ``smem``. The limit is only ever raised (to the largest size asked
// of ``fn`` on the device so far), so a size met before stays launchable
// whatever was asked in between. Asked of the runtime once per kernel, device
// and size and kept, so a launch of a persistent grid pays for neither again.
// Returns a cudaError_t.
static inline int resident_blocks(const void* fn, int threads, int smem, int* blocks) {
  struct Entry {
    const void* fn;
    int dev, smem, blocks;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int cached = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < cached; ++i)
    if (cache[i].fn == fn && cache[i].dev == dev && cache[i].smem == smem) {
      *blocks = cache[i].blocks;
      return 0;
    }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess && attr.maxDynamicSharedSizeBytes < smem)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return (int)err;
  *blocks = sms * per_sm;
  if (cached < 64) cache[cached++] = {fn, dev, smem, *blocks};
  return 0;
}

// How many clusters of ``cluster`` blocks of ``fn`` (``threads`` threads,
// ``smem`` bytes of dynamic shared memory) the current device holds at once,
// into *clusters, after raising ``fn``'s shared-memory limit to at least
// ``smem`` (only ever raised, as in resident_blocks). Kept per kernel, device
// and size. Returns a cudaError_t.
static inline int resident_clusters(const void* fn, int threads, int smem, int cluster,
                                    int* clusters) {
  struct Entry {
    const void* fn;
    int dev, smem, clusters;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int cached = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < cached; ++i)
    if (cache[i].fn == fn && cache[i].dev == dev && cache[i].smem == smem) {
      *clusters = cache[i].clusters;
      return 0;
    }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess && attr.maxDynamicSharedSizeBytes < smem)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchAttribute dims;
  dims.id = cudaLaunchAttributeClusterDimension;
  dims.val.clusterDim.x = cluster;
  dims.val.clusterDim.y = dims.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &dims;
  cfg.numAttrs = 1;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (*clusters < 1) return (int)cudaErrorInvalidConfiguration;
  if (cached < 64) cache[cached++] = {fn, dev, smem, *clusters};
  return 0;
}

}  // namespace hopper_host
