// Device pieces shared by the flash-attention backward kernels (flash_bwd.cu,
// radial_bwd.cu): the tile geometry, the delta pass, the two warp-level
// products on mma.sync fragments, the tile copy and the store of a float32
// accumulator as bf16 rows, each for a head dim D of 128 (the default) or
// 256. Each source that includes this file gets its own copy of the delta
// kernel.

#pragma once

#include "flash_common.cuh"

namespace flash_bwd {

using namespace flash;

constexpr int kD = 128;      // head dim of the default instantiations
constexpr int kTile = 64;    // queries per tile and keys per tile (16 per warp)
constexpr int kLd = kD + 8;  // shared-memory row stride in elements (see flash_fwd.cu)
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
template <int D>
using TileT = bf16[kTile][D + 8];  // a tile of 64 rows of head dim D, rows padded
typedef TileT<kD> Tile;

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]; one warp per row of
// the [B*Tq*H, D] views. grid ceil(rows / 4), 128 threads. static: one copy
// per including source, none visible to the linker.
template <int D = kD>
static __global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows, int Tq, int H) {
  constexpr int kPer = D / 32;  // elements per lane: 4 or 8
  const int64_t row = (int64_t)blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  uint32_t a[kPer / 2], c[kPer / 2];
  if constexpr (kPer == 4) {
    const uint2 ra = *reinterpret_cast<const uint2*>(o + row * D + lane * kPer);
    const uint2 rc = *reinterpret_cast<const uint2*>(dout + row * D + lane * kPer);
    a[0] = ra.x, a[1] = ra.y, c[0] = rc.x, c[1] = rc.y;
  } else {
    const uint4 ra = *reinterpret_cast<const uint4*>(o + row * D + lane * kPer);
    const uint4 rc = *reinterpret_cast<const uint4*>(dout + row * D + lane * kPer);
    a[0] = ra.x, a[1] = ra.y, a[2] = ra.z, a[3] = ra.w;
    c[0] = rc.x, c[1] = rc.y, c[2] = rc.z, c[3] = rc.w;
  }
  const float2 a0 = unpack2f(a[0]), a1 = unpack2f(a[1]);
  const float2 c0 = unpack2f(c[0]), c1 = unpack2f(c[1]);
  float s = a0.x * c0.x + a0.y * c0.y + a1.x * c1.x + a1.y * c1.y;
#pragma unroll
  for (int i = 2; i < kPer / 2; i += 2) {
    const float2 x0 = unpack2f(a[i]), x1 = unpack2f(a[i + 1]);
    const float2 y0 = unpack2f(c[i]), y1 = unpack2f(c[i + 1]);
    s += x0.x * y0.x + x0.y * y0.y + x1.x * y1.x + x1.y * y1.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const int64_t bi = row / H;
    const int64_t i = bi % Tq, b = bi / Tq;
    delta[(b * H + h) * Tq + i] = s;
  }
}

// acc[16 rows x 64 cols] = A[16 rows x D] @ B[64 cols x D]^T for one
// warp: ``a`` is the shared-memory tile that holds the warp's 16 rows from
// row ``arow`` on, ``b`` the tile whose 64 rows are the columns of the result.
template <int D = kD>
__device__ __forceinline__ void warp_abt(float (&acc)[kTile / 8][4], const TileT<D>& a,
                                         int arow, const TileT<D>& b, int lrow, int lmat) {
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int s2 = 0; s2 < D / 32; ++s2) {  // 32 of d: two mma steps
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

// acc[16 rows x D] += A[16 rows x 64] @ B[64 x D] for one warp: ``pa``
// holds A as packed bf16 A fragments (four steps of 16), ``b`` is the
// shared-memory tile [64][D].
template <int D = kD>
__device__ __forceinline__ void warp_ab(float (&acc)[D / 8][4],
                                        const uint32_t (&pa)[kTile / 16][4],
                                        const TileT<D>& b, int lrow, int lmat) {
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
#pragma unroll
    for (int s2 = 0; s2 < kTile / 32; ++s2) {  // 32 rows of b: two mma steps
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, &b[s2 * 32 + lmat * 8 + lrow][t * 8]);
      mma_bf16(acc[t], pa[2 * s2], bf[0], bf[1]);
      mma_bf16(acc[t], pa[2 * s2 + 1], bf[2], bf[3]);
    }
  }
}

// Start the copy of 64 rows of [*, H*D] from row ``r0`` on into a tile;
// rows from ``limit`` on are zero-filled.
template <int D = kD>
__device__ __forceinline__ void copy_tile(TileT<D>& dst, const bf16* src, int64_t ld, int r0,
                                          int limit, int tid) {
#pragma unroll
  for (int i = 0; i < kTile * (D / 8) / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / (D / 8), c8 = (e % (D / 8)) * 8;
    const bool valid = r0 + r < limit;
    const int64_t row = valid ? r0 + r : 0;  // a readable address either way
    cp_async16(&dst[r][c8], src + row * ld + c8, valid);
  }
}

// Round a [16 x D] float32 accumulator times ``scale`` to bf16 and store
// its rows r0 and r1 (below ``limit``) of [*, H*D].
template <int D = kD>
__device__ __forceinline__ void store_rows(bf16* dst, int64_t ld, const float (&acc)[D / 8][4],
                                           float scale, int r0, int r1, int limit, int tg) {
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
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
