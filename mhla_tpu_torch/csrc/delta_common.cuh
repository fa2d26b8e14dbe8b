// Pieces shared by the gated delta rule kernels (delta_chunk.cu: K11,
// delta_chunk_bwd.cu: K11b): the geometry, the per-(chunk, head) images the
// prep pass writes, and tile helpers, all over hopper.cuh's TMA, mbarrier
// and bf16 wgmma pieces.
//
// Every per-chunk tile holds 64 token rows whatever the chunk (C = 16, 32,
// 48 or 64): the rows past C are zero, so every product runs at M, N or K =
// 64 and the zeros drop out of every sum. Tiles live in shared memory in
// the 128-byte swizzle layout of hopper.cuh ([rows][64] bf16 panels, 128
// bytes a row, 16-byte chunk c of row r at c ^ (r % 8)).
//
// The prep pass (delta_chunk.cu) writes, per (chunk, head) item, one record:
// T and P as [64][64] bf16 tiles and w, qd and kc as [64][128] (two panels)
// in exactly that layout, then the gates (beta of each token, zero past C,
// and e^{G_last}), so a chain or gradients block loads what it needs of it
// with one or two bulk copies into a 1024-byte aligned region.

#pragma once

#include "hopper.cuh"

namespace delta {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int kDk = 128;    // head dim of q and k
constexpr int kMaxC = 64;   // largest chunk: the token rows of every tile
constexpr int kPanel = 64;  // Dv columns of a chain block and of a gradient step
constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100

constexpr int kCC = kMaxC * 128;     // bytes of a [64][64] bf16 tile (T, P, a v or dO panel)
constexpr int kCK = 2 * kMaxC * 128;  // bytes of a [64][128] tile (w, qd, kc, q, k)
constexpr int kGates = 128;           // floats of a gates record: beta[64], e^{G_last}, zeros
constexpr int kElOffset = 64;         // e^{G_last} in a gates record

// One item's record, as the prep writes it and the other kernels load it
// (byte offsets; every tile 1024-byte aligned within it).
constexpr int kRecT = 0;
constexpr int kRecP = kRecT + kCC;
constexpr int kRecW = kRecP + kCC;
constexpr int kRecQd = kRecW + kCK;
constexpr int kRecKc = kRecQd + kCK;
constexpr int kRecGates = kRecKc + kCK;
constexpr int kRecBytes = kRecGates + kGates * 4;  // 66,048
constexpr int kRecSpan = (kRecBytes + 1023) / 1024 * 1024;  // a record in shared memory, aligned

// The row and column of the 16 bytes lane `lane` addresses in an x4
// ldmatrix / stmatrix over a [rows][64] tile at 16-row step ks and warp w's
// 16 columns: matrix j = lane / 8 at (rows + 8 (j / 2), columns + 8 (j % 2)),
// the order of a k16 A fragment's registers.
__device__ __forceinline__ int x4_row(int ks, int lane) {
  return 16 * ks + 8 * (lane >> 4) + (lane & 7);
}
__device__ __forceinline__ int x4_col(int warp, int lane) {
  return 16 * warp + 8 * ((lane >> 3) & 1);
}

// Byte offset of element (r, c) of a [rows][D] bf16 tile of kRows-row panels.
template <int kRows>
__device__ __forceinline__ int tile_off(int r, int c) {
  return (c >> 6) * kRows * 128 + swizzle128(r, c & 63);
}

// Zero the rows [C, 64) of `panels` [64][64] panels at dst (threads [0, n)):
// the token rows past a chunk, which TMA never writes.
__device__ __forceinline__ void zero_tail(unsigned char* dst, int panels, int C, int tid, int n) {
  const int per = (kMaxC - C) * 8;  // 16-byte chunks past row C in a panel
  for (int e = tid; e < panels * per; e += n)
    *reinterpret_cast<uint4*>(dst + (e / per) * kCC + C * 128 + (e % per) * 16) =
        make_uint4(0, 0, 0, 0);
}

// The 8 bf16 values at p (16-byte aligned) as floats, and back.
__device__ __forceinline__ void load8(const unsigned char* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(v[i]);
}

__device__ __forceinline__ void store8(unsigned char* p, const float* in) {
  uint4 raw;
  uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = pack_bf16(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

}  // namespace delta
