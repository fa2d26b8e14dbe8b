// The causal and segment-id masks of the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): which tiles of the [T, T] score matrix a
// block walks, which of those need a per-element mask, and the per-element
// rule. Tq == Tk == T. A block's own span and the tiles it walks are
// multiples of 64 tokens (the range pre-pass's tiles), in sizes that differ
// by kernel and head dim.
//
// Key j is kept for query i iff seg[i] == seg[j] (segment form) and j <= i
// (causal form). A tile can hold a kept pair only if it reaches the
// diagonal or lies below it (causal) and the [min, max] ranges of the ids of
// its query rows and of its key columns meet (segment): two disjoint ranges
// share no id, whatever the order of the ids, so skipping such a tile is
// exact for any ids. A walked tile needs the per-element rule only where the
// diagonal crosses it (causal) or where the ids of its rows and columns are
// not all one value (segment); elsewhere every pair in it is kept, bar keys
// past T.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_mask {

constexpr int kTile = 64;  // tokens per tile of the range pre-pass
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

// The walk of a block that owns kOwn tokens of one axis, block ``own_block``
// (the queries of a forward or dQ block; the keys of a dK/dV block, with
// kKeySide), over the tiles of kStep tokens of the other axis, in increasing
// order. kOwn and kStep are multiples of kTile; a span's id range is that of
// its kTile tiles (``ranges``, this batch row's, from the pre-pass), so the
// test stays exact for any ids. With query span [qa, qb] and key span
// [ka, kb] (the last tile cut at T): causal walks the pair iff ka <= qb and
// needs the per-element rule iff kb > qa (the diagonal crosses it); the
// segment form walks it iff the two id ranges meet and needs the rule unless
// both hold one and the same id.
template <int kMask, int kOwn, int kStep, bool kKeySide>
struct TileWalk {
  const int2* ranges;
  int T, own0, own1;  // the block's first and last token
  int2 own;           // the id range of its span (segment form)
  int first, last;    // the walk's bounds before the segment test

  __device__ __forceinline__ TileWalk(const int2* ranges_, int own_block, int T_)
      : ranges(ranges_), T(T_), own(make_int2(0, 0)) {
    own0 = own_block * kOwn;
    own1 = min(own0 + kOwn, T) - 1;
    const int nsteps = (T + kStep - 1) / kStep;
    if (kMask & kSegment) own = span_range(own0, own1);
    first = (kMask & kCausal) && kKeySide ? own0 / kStep : 0;
    last = (kMask & kCausal) && !kKeySide ? min(nsteps - 1, own1 / kStep) : nsteps - 1;
  }

  // The id range of tokens [a, b] (a a multiple of kTile).
  __device__ __forceinline__ int2 span_range(int a, int b) const {
    int2 r = ranges[a / kTile];
#pragma unroll
    for (int i = 1; i < (kOwn > kStep ? kOwn : kStep) / kTile; ++i) {
      if (a + i * kTile > b) break;
      const int2 s = ranges[a / kTile + i];
      r.x = min(r.x, s.x);
      r.y = max(r.y, s.y);
    }
    return r;
  }

  // Whether step tile j can hold a kept pair with the block's span.
  __device__ __forceinline__ bool meets(int j) const {
    if (!(kMask & kSegment)) return true;
    const int2 r = span_range(j * kStep, min((j + 1) * kStep, T) - 1);
    return r.x <= own.y && own.x <= r.y;
  }

  // The first tile from j on that the walk visits, or a tile past last. All
  // 32 lanes of the calling warp take part: they test 32 tiles at once, so
  // a long run of skipped tiles costs one round of range loads, not one each.
  __device__ __forceinline__ int next(int j) const {
    if (!(kMask & kSegment)) return j;
    const int lane = threadIdx.x & 31;
    for (; j <= last; j += 32) {
      const unsigned hit = __ballot_sync(0xffffffffu, j + lane <= last && meets(j + lane));
      if (hit) return j + __ffs(hit) - 1;
    }
    return j;
  }

  // Whether the walked tile j needs the per-element rule.
  __device__ __forceinline__ bool needs_mask(int j) const {
    const int s0 = j * kStep, s1 = min(s0 + kStep, T) - 1;
    if ((kMask & kCausal) && (kKeySide ? own1 > s0 : s1 > own0)) return true;
    if (kMask & kSegment) {
      const int2 r = span_range(s0, s1);
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
