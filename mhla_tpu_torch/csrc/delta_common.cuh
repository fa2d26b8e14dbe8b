// Helpers shared by the gated delta rule kernels (delta_chunk.cu,
// delta_chunk_bwd.cu): shared-memory tile shapes, 16x16 WMMA tile products
// over operands in shared (or global) memory, and copies.
//
// Every matrix in shared memory is row-major with its row stride padded by
// 16 bytes (kLd* below), which spreads the rows of a 16x16 WMMA tile over
// the banks; the padded strides keep each tile's first element 32-byte
// aligned, as WMMA requires.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace delta {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kFrag = 16;  // WMMA tile: m = n = k = 16 for bf16
constexpr int kDk = 128;   // head dim of q and k
constexpr int kMaxC = 64;  // largest chunk
constexpr int kTile = 64;  // Dv columns per chain and per gradient pass

// padded row strides (elements) of the shared-memory matrices
constexpr int kLdC = kMaxC + 8;    // bf16 [*, C] or [*, kTile]
constexpr int kLdK = kDk + 8;      // bf16 [*, Dk]
constexpr int kLdCf = kMaxC + 4;   // float [*, C] or [*, kTile]
constexpr int kLdKf = kDk + 4;     // float [*, Dk]

typedef wmma::fragment<wmma::accumulator, kFrag, kFrag, kFrag, float> Acc;
typedef wmma::fragment<wmma::matrix_a, kFrag, kFrag, kFrag, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_a, kFrag, kFrag, kFrag, bf16, wmma::col_major> ACol;
typedef wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, bf16, wmma::col_major> BCol;

// acc += op(A)[m0:m0+16, 0:K] @ op(B)[0:K, n0:n0+16], bf16 operands, float
// accumulation. op(A) = A (row-major, row stride lda) or, with TA, X^T for
// X row-major [K, *] with stride lda; op(B) = B (row-major [K, *], stride
// ldb) or, with TB, Y^T for Y row-major [*, K] with stride ldb.
template <bool TA, bool TB>
__device__ __forceinline__ void mma_tile(Acc& acc, const bf16* A, int lda, const bf16* B,
                                         int ldb, int m0, int n0, int K) {
  for (int kk = 0; kk < K; kk += kFrag) {
    if constexpr (TA) {
      ACol a;
      wmma::load_matrix_sync(a, A + (int64_t)kk * lda + m0, (unsigned)lda);
      if constexpr (TB) {
        BCol b;
        wmma::load_matrix_sync(b, B + (int64_t)n0 * ldb + kk, (unsigned)ldb);
        wmma::mma_sync(acc, a, b, acc);
      } else {
        BRow b;
        wmma::load_matrix_sync(b, B + (int64_t)kk * ldb + n0, (unsigned)ldb);
        wmma::mma_sync(acc, a, b, acc);
      }
    } else {
      ARow a;
      wmma::load_matrix_sync(a, A + (int64_t)m0 * lda + kk, (unsigned)lda);
      if constexpr (TB) {
        BCol b;
        wmma::load_matrix_sync(b, B + (int64_t)n0 * ldb + kk, (unsigned)ldb);
        wmma::mma_sync(acc, a, b, acc);
      } else {
        BRow b;
        wmma::load_matrix_sync(b, B + (int64_t)kk * ldb + n0, (unsigned)ldb);
        wmma::mma_sync(acc, a, b, acc);
      }
    }
  }
}

// Round a 16x16 float accumulator to bf16 and write it at dst (row stride ld
// elements, 16-byte aligned rows) through the warp's 16x16 float staging tile.
__device__ __forceinline__ void store_bf16(const Acc& acc, float* stage, bf16* dst,
                                           int64_t ld) {
  wmma::store_matrix_sync(stage, acc, kFrag, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  __align__(16) bf16 vals[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) vals[i] = __float2bfloat16(stage[r * kFrag + c0 + i]);
  *reinterpret_cast<uint4*>(dst + r * ld + c0) = *reinterpret_cast<const uint4*>(vals);
  __syncwarp();
}

// One asynchronous 16-byte copy from global to shared memory (cp.async, L2
// only): a thread issues all of its copies before waiting for any, so a
// block's loads overlap instead of paying one L2 round trip each.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// Wait for this thread's copies, then for the block's: after it every
// cp.async copy of the block has landed in shared memory.
__device__ __forceinline__ void sync_loads() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// Start copying rows x cols bf16 (cols % 8 == 0) from global (row stride
// lds) into shared memory (row stride ldd), 16 bytes per copy; the data is
// there after the next sync_loads().
__device__ __forceinline__ void load_rows(bf16* dst, int ldd, const bf16* src, int64_t lds,
                                          int rows, int cols) {
  const int per_row = cols / 8;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    const int r = e / per_row, c = (e % per_row) * 8;
    cp_async16(dst + r * ldd + c, src + r * lds + c);
  }
}

// Copy rows x cols bf16 from shared memory (row stride lds) to global (row
// stride ldd), 16 bytes per thread and step.
__device__ __forceinline__ void store_rows(bf16* dst, int64_t ldd, const bf16* src, int lds,
                                           int rows, int cols) {
  const int per_row = cols / 8;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    const int r = e / per_row, c = (e % per_row) * 8;
    *reinterpret_cast<uint4*>(dst + r * ldd + c) =
        *reinterpret_cast<const uint4*>(src + r * lds + c);
  }
}

// The 8 bf16 values at p (16-byte aligned) as floats.
__device__ __forceinline__ void load8(const bf16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(v[i]);
}

// 8 floats rounded to bf16 and stored at p (16-byte aligned).
__device__ __forceinline__ void store8(bf16* p, const float* in) {
  __align__(16) bf16 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __float2bfloat16(in[i]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
}

// Sum of x over the block, the same order every run; every thread gets it.
// red: kMaxWarps floats of shared memory.
constexpr int kMaxWarps = 32;
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[warp] = x;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += red[w];
  return s;
}

}  // namespace delta
