// The causal and segment-id masks of the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): which 64 x 64 tiles of the [T, T] score
// matrix a block walks, which of those need a per-element mask, and the
// per-element rule. Tq == Tk == T; query tile i and key tile i hold the same
// tokens.
//
// Key j is kept for query i iff seg[i] == seg[j] (segment form) and j <= i
// (causal form). A tile can hold a kept pair only if it is on or below the
// diagonal (causal) and the [min, max] ranges of the ids of its query rows
// and of its key columns meet (segment): two disjoint ranges share no id,
// whatever the order of the ids, so skipping such a tile is exact for any
// ids. A walked tile needs the per-element rule only on the diagonal
// (causal) or where the ids of its rows and columns are not all one value
// (segment); elsewhere every pair in it is kept, bar keys past T.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_mask {

constexpr int kTile = 64;  // query rows and keys per tile
constexpr int kCausal = 1, kSegment = 2;  // bits of a kernel's mask form

// ranges[b * ntiles + j] = (min, max) of seg[b, 64 j .. min(64 j + 63, T - 1)].
// One thread per (batch row, tile). static: one copy per including source.
static __global__ void seg_tile_ranges_kernel(const int* __restrict__ seg,
                                              int2* __restrict__ ranges, int B, int T,
                                              int ntiles) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)B * ntiles) return;
  const int b = (int)(e / ntiles), j = (int)(e % ntiles);
  const int* s = seg + (int64_t)b * T;
  const int end = min(T, (j + 1) * kTile);
  int lo = s[j * kTile], hi = lo;
  for (int i = j * kTile + 1; i < end; ++i) {
    lo = min(lo, s[i]);
    hi = max(hi, s[i]);
  }
  ranges[e] = make_int2(lo, hi);
}

// Launch the range pass on ``stream`` (B * ntiles threads).
static inline cudaError_t launch_seg_tile_ranges(const int* seg, int2* ranges, int B, int T,
                                                 cudaStream_t stream) {
  const int ntiles = (T + kTile - 1) / kTile;
  const int64_t n = (int64_t)B * ntiles;
  seg_tile_ranges_kernel<<<(unsigned)((n + 127) / 128), 128, 0, stream>>>(seg, ranges, B, T,
                                                                         ntiles);
  return cudaGetLastError();
}

// The tiles a block walks along its other axis, in increasing order. A
// query-tile block (forward, dQ) walks key tiles 0 .. its own; a key-tile
// block (dK/dV) walks query tiles from its own on. ``own`` is the range of
// the block's own tile, ``ranges`` those of this batch row's tiles.
template <int kMask>
struct TileWalk {
  const int2* ranges;
  int2 own;
  int first, last;  // the walk's bounds before the segment test

  __device__ __forceinline__ TileWalk(const int2* ranges_, int own_tile, int ntiles,
                                      bool from_key_side)
      : ranges(ranges_), own(make_int2(0, 0)) {
    if (kMask & kSegment) own = ranges_[own_tile];
    first = (kMask & kCausal) && from_key_side ? own_tile : 0;
    last = (kMask & kCausal) && !from_key_side ? own_tile : ntiles - 1;
  }

  // Whether tile j can hold a kept pair with the block's own tile.
  __device__ __forceinline__ bool meets(int j) const {
    if (!(kMask & kSegment)) return true;
    const int2 r = ranges[j];
    return r.x <= own.y && own.x <= r.y;
  }

  // The first tile from j on that the walk visits, or last + 1.
  __device__ __forceinline__ int next(int j) const {
    while (j <= last && !meets(j)) ++j;
    return j;
  }

  // Whether the walked tile j needs the per-element rule (``own_tile`` is the
  // block's own tile index).
  __device__ __forceinline__ bool needs_mask(int j, int own_tile) const {
    if ((kMask & kCausal) && j == own_tile) return true;
    if (kMask & kSegment) {
      const int2 r = ranges[j];
      return !(own.x == own.y && r.x == r.y && r.x == own.x);
    }
    return false;
  }
};

// The per-element rule for query i (segment id si) and key j (segment id sj).
template <int kMask>
__device__ __forceinline__ bool keep_pair(int i, int si, int j, int sj) {
  return (!(kMask & kCausal) || j <= i) && (!(kMask & kSegment) || si == sj);
}

}  // namespace flash_mask
