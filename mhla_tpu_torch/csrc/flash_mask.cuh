// The causal and segment-id masks of the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu), and the radial mask of the backward
// (flash_bwd.cu): which tiles of the [T, T] score matrix a block walks,
// which of those need a per-element mask, and the per-element rule. Tq ==
// Tk == T. A block's own span and the tiles it walks are
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

#include "flash_common.cuh"  // the radial rule

namespace flash_mask {

constexpr int kTile = 64;  // tokens per tile of the range pre-pass
constexpr int kCausal = 1, kSegment = 2;  // bits of a kernel's mask form
constexpr int kRadial = 4;                // a form of its own: the radial mask

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

  // The tile of walk index j (the walk's index is the tile).
  __device__ __forceinline__ int tile(int j) const { return j; }

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

// The radial form's lists (kernels/sparse_attention.py, radial_schedule,
// cached on the device): block ``own`` walks the step tiles
// entries[offsets[own] .. offsets[own + 1]) >> 1 in rising order, an entry
// being 2 * tile + full, full meaning that every pair of the block's real
// tokens with the step tile is allowed and that no token of the step tile
// lies past T. Block x of a kernel's grid (per head) takes own = order[x]:
// the blocks by falling list length, so the longest walks start first.
struct RadialList {
  const int* offsets;
  const int* entries;
  const int* order;
  int hw;  // tokens per frame
};

// The walk of one list, with TileWalk's interface; its index is the
// position in the list.
struct ListWalk {
  const int* entries;
  int first, last;

  __device__ __forceinline__ ListWalk(const RadialList& l, int own)
      : entries(l.entries + l.offsets[own]), first(0),
        last(l.offsets[own + 1] - l.offsets[own] - 1) {}

  __device__ __forceinline__ int next(int i) const { return i; }
  __device__ __forceinline__ int tile(int i) const { return entries[i] >> 1; }
  __device__ __forceinline__ bool needs_mask(int i) const { return !(entries[i] & 1); }
};

// The walk of a kernel of mask form kMask (TileWalk's parameters; the
// segment ranges of this batch row or null; the radial lists).
template <int kMask, int kOwn, int kStep, bool kKeySide>
__device__ __forceinline__ auto make_walk(const int2* ranges, const RadialList& list, int own,
                                          int T) {
  if constexpr ((kMask & kRadial) != 0) return ListWalk(list, own);
  else return TileWalk<kMask, kOwn, kStep, kKeySide>(ranges, own, T);
}

// The radial rule for a thread's two rows, whose (frame, spatial index) are
// row0 and row1, against its columns c0 + 8 nt + 2 tg + c of a tile, nt <
// kSteps and c < 2: bit 2 nt + c of keep0 / keep1 is set where the pair is
// allowed. Where hw is at least the tile's width its columns lie in at most
// two frames, so two windows a row serve all of them, with no branch per
// column; smaller frames take each column's frame in turn.
template <int kSteps>
__device__ __forceinline__ void radial_keep_bits(uint32_t& keep0, uint32_t& keep1, int2 row0,
                                                 int2 row1, int c0, int tg, int hw) {
  const int f0 = c0 / hw, s0 = c0 - f0 * hw;
  keep0 = keep1 = 0u;
  if (hw >= kSteps * 8) {
    const int wa0 = flash::radial_window(abs(row0.x - f0), hw);
    const int wb0 = flash::radial_window(abs(row0.x - f0 - 1), hw);
    const int wa1 = flash::radial_window(abs(row1.x - f0), hw);
    const int wb1 = flash::radial_window(abs(row1.x - f0 - 1), hw);
#pragma unroll
    for (int nt = 0; nt < kSteps; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        int s = s0 + nt * 8 + tg * 2 + c;
        const bool next = s >= hw;
        s = next ? s - hw : s;
        keep0 |= (uint32_t)(abs(row0.y - s) < (next ? wb0 : wa0)) << (2 * nt + c);
        keep1 |= (uint32_t)(abs(row1.y - s) < (next ? wb1 : wa1)) << (2 * nt + c);
      }
    return;
  }
  for (int nt = 0; nt < kSteps; ++nt)
    for (int c = 0; c < 2; ++c) {
      const int col = c0 + nt * 8 + tg * 2 + c, f = col / hw, s = col - f * hw;
      keep0 |= (uint32_t)flash::radial_keep(row0.x, row0.y, f, s, hw) << (2 * nt + c);
      keep1 |= (uint32_t)flash::radial_keep(row1.x, row1.y, f, s, hw) << (2 * nt + c);
    }
}

// The per-element rule for query i (segment id si) and key j (segment id sj).
template <int kMask>
__device__ __forceinline__ bool keep_pair(int i, int si, int j, int sj) {
  return (!(kMask & kCausal) || j <= i) && (!(kMask & kSegment) || si == sj);
}

}  // namespace flash_mask
