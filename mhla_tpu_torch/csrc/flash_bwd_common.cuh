// Device pieces shared by the flash-attention backward kernels (flash_bwd.cu,
// radial_bwd.cu): the tile geometry, the delta pass, the two warp-level
// products on mma.sync fragments, the tile copy and the store of a float32
// accumulator as bf16 rows. Each source that includes this file gets its
// own copy of the delta kernel.

#pragma once

#include "flash_common.cuh"

namespace flash_bwd {

using namespace flash;

constexpr int kD = 128;      // head dim
constexpr int kTile = 64;    // queries per tile and keys per tile (16 per warp)
constexpr int kLd = kD + 8;  // shared-memory row stride in elements (see flash_fwd.cu)
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
typedef bf16 Tile[kTile][kLd];

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]; one warp per row of
// the [B*Tq*H, 128] views. grid ceil(rows / 4), 128 threads. static: one copy
// per including source, none visible to the linker.
static __global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows, int Tq, int H) {
  const int64_t row = (int64_t)blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const uint2 a = *reinterpret_cast<const uint2*>(o + row * kD + lane * 4);
  const uint2 c = *reinterpret_cast<const uint2*>(dout + row * kD + lane * 4);
  const float2 a0 = unpack2f(a.x), a1 = unpack2f(a.y);
  const float2 c0 = unpack2f(c.x), c1 = unpack2f(c.y);
  float s = a0.x * c0.x + a0.y * c0.y + a1.x * c1.x + a1.y * c1.y;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const int64_t bi = row / H;
    const int64_t i = bi % Tq, b = bi / Tq;
    delta[(b * H + h) * Tq + i] = s;
  }
}

// acc[16 rows x 64 cols] = A[16 rows x 128] @ B[64 cols x 128]^T for one
// warp: ``a`` is the shared-memory tile that holds the warp's 16 rows from
// row ``arow`` on, ``b`` the tile whose 64 rows are the columns of the result.
__device__ __forceinline__ void warp_abt(float (&acc)[kTile / 8][4], const Tile& a,
                                         int arow, const Tile& b, int lrow, int lmat) {
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int s2 = 0; s2 < kD / 32; ++s2) {  // 32 of d: two mma steps
    uint32_t a0[4], a1[4];
    const bf16* ap = &a[arow + (lmat & 1) * 8 + lrow][s2 * 32 + (lmat >> 1) * 8];
    ldmatrix_x4(a0, ap);
    ldmatrix_x4(a1, ap + 16);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      uint32_t bf[4];
      ldmatrix_x4(bf, &b[nt * 8 + lrow][s2 * 32 + lmat * 8]);
      mma_bf16(acc[nt], a0, bf[0], bf[1]);
      mma_bf16(acc[nt], a1, bf[2], bf[3]);
    }
  }
}

// acc[16 rows x 128] += A[16 rows x 64] @ B[64 x 128] for one warp: ``pa``
// holds A as packed bf16 A fragments (four steps of 16), ``b`` is the
// shared-memory tile [64][128].
__device__ __forceinline__ void warp_ab(float (&acc)[kD / 8][4],
                                        const uint32_t (&pa)[kTile / 16][4],
                                        const Tile& b, int lrow, int lmat) {
#pragma unroll
  for (int t = 0; t < kD / 8; ++t) {
#pragma unroll
    for (int s2 = 0; s2 < kTile / 32; ++s2) {  // 32 rows of b: two mma steps
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, &b[s2 * 32 + lmat * 8 + lrow][t * 8]);
      mma_bf16(acc[t], pa[2 * s2], bf[0], bf[1]);
      mma_bf16(acc[t], pa[2 * s2 + 1], bf[2], bf[3]);
    }
  }
}

// Start the copy of 64 rows of [*, H*128] from row ``r0`` on into a tile;
// rows from ``limit`` on are zero-filled.
__device__ __forceinline__ void copy_tile(Tile& dst, const bf16* src, int64_t ld, int r0,
                                          int limit, int tid) {
#pragma unroll
  for (int i = 0; i < kTile * (kD / 8) / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / (kD / 8), c8 = (e % (kD / 8)) * 8;
    const bool valid = r0 + r < limit;
    const int64_t row = valid ? r0 + r : 0;  // a readable address either way
    cp_async16(&dst[r][c8], src + row * ld + c8, valid);
  }
}

// Round a [16 x 128] float32 accumulator times ``scale`` to bf16 and store
// its rows r0 and r1 (below ``limit``) of [*, H*128].
__device__ __forceinline__ void store_rows(bf16* dst, int64_t ld, const float (&acc)[kD / 8][4],
                                           float scale, int r0, int r1, int limit, int tg) {
#pragma unroll
  for (int t = 0; t < kD / 8; ++t) {
    const int d = t * 8 + tg * 2;
    if (r0 < limit)
      *reinterpret_cast<__nv_bfloat162*>(dst + r0 * ld + d) =
          __floats2bfloat162_rn(acc[t][0] * scale, acc[t][1] * scale);
    if (r1 < limit)
      *reinterpret_cast<__nv_bfloat162*>(dst + r1 * ld + d) =
          __floats2bfloat162_rn(acc[t][2] * scale, acc[t][3] * scale);
  }
}

}  // namespace flash_bwd
