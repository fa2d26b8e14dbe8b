// K9b: flash-attention backward for Hopper (sm_90a), head dim 128 or 256.
//
// With S = scale * q k^T, P = exp(S - lse) and delta_i = sum_d dO[i, d] O[i, d]:
//
//   dV = P^T dO          dP = dO V^T          dS = P * (dP - delta)
//   dQ = scale * dS K    dK = scale * dS^T Q
//
// q, o, dO, dq: [B, Tq, H, D]; k, v, dk, dv: [B, Tk, H, D], bf16, D = 128 or 256;
// lse [B, H, Tq] float32 from the forward (flash_fwd.cu, natural log);
// delta [B, H, Tq] float32 scratch. Any Tq and Tk >= 1. Scores, P, dP and all
// sums are float32; P is rounded to bf16 before P^T dO and before dS, and dS
// is rounded to bf16 before its two products (the operands of the tensor
// cores), once each.
//
// Replaces the JAX library's Pallas TPU flash backward (its dq and dkv
// kernels), which jax.grad reaches through
// mhla_tpu/kernels/flash_attention.py:115-118 with the block sizes of :109-114.
//
// Bound: operations. 10*Tq*Tk*D FLOP per batch row and head (five
// products) against 2*(4*Tq + 4*Tk)*D bytes: far above the card's bf16
// ridge (295 FLOP/byte) at both of the video model's shapes and at the
// LM's causal 2,048 to 16,384 tokens.
// Design: three launches, no atomics, so the result is the same from run to
// run. (1) delta: one warp per (token, head) row. (2) dK, dV: a block of 4
// warps owns 64 keys of one (batch row, head); its K and V tiles stay in
// shared memory as the A operands (each warp its 16 keys), and the block
// walks over the queries 64 at a time: Q, dO, lse and delta tiles arrive by
// cp.async into two buffers. S^T = K Q^T and dP^T = V dO^T run on the tensor
// cores (mma.sync m16n8k16), P^T and dS^T are formed on the accumulator
// fragments in registers and reused in place as the A fragments of
// dV += P^T dO and dK += dS^T Q, whose float32 accumulators live in
// registers for the whole kernel. (3) dQ: the mirror image: a block owns 64
// queries (Q and dO in shared memory, lse and delta of its rows in
// registers), walks over the keys and accumulates dQ += dS K. The scores and
// dP are computed twice, once in each kernel: seven products for the
// backward's five, the price of needing no reduction across blocks. Rows and
// columns past Tq and Tk are zero-filled on the way in, get P = 0, and are
// never stored. At Tk = 512 the dK/dV kernel has only 8 key tiles per head
// to spread over the card; splitting its query range is not done yet, nor
// are wgmma and TMA.
//
// Head dim 256: a thread's dK and dV accumulators would take 2 x 128
// float32 registers, beyond the 255 a thread has (at 128 the kernel already
// uses 249-255). So the dK/dV kernel runs twice over the same walk, once
// for dV (S^T and P^T dO only) and once for dK (S^T, dP^T and dS^T Q), each
// with one [16 x 256] accumulator: eight products for the backward's five
// instead of seven. Six 64 x 256 tiles take 198 KB of shared memory, one
// block per SM; the dQ kernel is the same kernel at the wider tile. Still
// no atomics, so the result is the same from run to run.
//
// Masked forms (Tq == Tk == T; causal and / or segment ids, the rule in
// flash_mask.cuh; the backward of the same library kernel called with
// causal=True and/or SegmentIds, flash_attention.py:73-104): the same three
// launches after the forward's range pre-pass, each walk cut to the tiles
// that can hold a kept pair, read from the key side in the dK/dV kernel (for
// causal, the query tiles on and below the diagonal only; for segments, the
// same disjointness test). On the tiles that need it a dropped pair gets
// P = 0 by selection (a dropped score may lie far above lse); the unmasked
// kernels below are not changed by it.

#include <type_traits>

#include "flash_bwd_common.cuh"
#include "flash_mask.cuh"

using namespace flash_bwd;
using flash_mask::TileWalk;
using flash_mask::kSegment;

namespace {

// Q, dO, 2 K, 2 V tiles
template <int D>
constexpr int dq_smem() { return 6 * (int)sizeof(TileT<D>); }
// K, V, 2 Q, 2 dO tiles + lse, delta
template <int D>
constexpr int dkv_smem() { return 6 * (int)sizeof(TileT<D>) + 4 * kTile * (int)sizeof(float); }

// What a dK/dV launch computes: both (D = 128), or at D = 256 one of them.
constexpr int kBoth = 0, kDvOnly = 1, kDkOnly = 2;

// dK and / or dV (kPass). grid (ceil(Tk / 64), H, B); dynamic shared memory
// dkv_smem<kD>().
template <int kD, int kPass>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk, int H,
                     float scale_log2, float scale) {
  typedef TileT<kD> Tile;
  constexpr bool kDv = kPass != kDkOnly, kDk = kPass != kDvOnly;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile* kst = reinterpret_cast<Tile*>(smem_raw);  // this block's keys
  Tile* vst = kst + 1;
  Tile* qs = kst + 2;   // [2] query tiles
  Tile* dos = kst + 4;  // [2] dO tiles
  float* stat = reinterpret_cast<float*>(smem_raw + 6 * sizeof(Tile));  // [2][lse, delta][64]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int lrow = lane & 7, lmat = lane >> 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int64_t ld = (int64_t)H * kD;
  const bf16* qb = q + (int64_t)b * Tq * ld + h * kD;
  const bf16* dob = dout + (int64_t)b * Tq * ld + h * kD;
  const bf16* kb = k + (int64_t)b * Tk * ld + h * kD;
  const bf16* vb = v + (int64_t)b * Tk * ld + h * kD;
  const float* lb = lse + ((int64_t)b * H + h) * Tq;
  const float* db = delta + ((int64_t)b * H + h) * Tq;

  auto load_tile = [&](int buf, int qt0) {
    copy_tile<kD>(qs[buf], qb, ld, qt0, Tq, tid);
    copy_tile<kD>(dos[buf], dob, ld, qt0, Tq, tid);
    const int j = tid & (kTile - 1);
    const bool valid = qt0 + j < Tq;
    const float* src = (tid < kTile ? lb : db) + (valid ? qt0 + j : 0);
    cp_async4(stat + (buf * 2 + (tid >= kTile)) * kTile + j, src, valid);
  };

  copy_tile<kD>(kst[0], kb, ld, k0, Tk, tid);
  if (kDk) copy_tile<kD>(vst[0], vb, ld, k0, Tk, tid);
  load_tile(0, 0);
  cp_async_commit();

  float dkacc[kDk ? kD / 8 : 1][4], dvacc[kDv ? kD / 8 : 1][4];
#pragma unroll
  for (int t = 0; t < kD / 8; ++t) {
    if constexpr (kDk) dkacc[t][0] = dkacc[t][1] = dkacc[t][2] = dkacc[t][3] = 0.f;
    if constexpr (kDv) dvacc[t][0] = dvacc[t][1] = dvacc[t][2] = dvacc[t][3] = 0.f;
  }

  const int ntiles = (Tq + kTile - 1) / kTile;
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1, qt = it * kTile;
    // the other buffer's readers finished at the end of the last iteration
    if (it + 1 < ntiles) load_tile(buf ^ 1, qt + kTile);
    cp_async_commit();   // an empty group after the last tile keeps the count uniform
    cp_async_wait<1>();  // all but the newest group: this tile (and K, V) has landed
    __syncthreads();
    const float* ls = stat + buf * 2 * kTile;
    const float* dl = ls + kTile;

    // S^T = K Q^T for this warp's 16 keys x 64 queries, then P^T as A fragments
    float acc[kTile / 8][4];
    warp_abt<kD>(acc, kst[0], warp * 16, qs[buf], lrow, lmat);
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      const int c0 = nt * 8 + tg * 2;
      const bool ok0 = qt + c0 < Tq, ok1 = qt + c0 + 1 < Tq;
      const float l0 = ls[c0] * kLog2e, l1 = ls[c0 + 1] * kLog2e;
      const float p0 = ok0 ? exp2f(fmaf(acc[nt][0], scale_log2, -l0)) : 0.f;
      const float p1 = ok1 ? exp2f(fmaf(acc[nt][1], scale_log2, -l1)) : 0.f;
      const float p2 = ok0 ? exp2f(fmaf(acc[nt][2], scale_log2, -l0)) : 0.f;
      const float p3 = ok1 ? exp2f(fmaf(acc[nt][3], scale_log2, -l1)) : 0.f;
      pa[nt / 2][(nt & 1) * 2 + 0] = pack2f(p0, p1);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack2f(p2, p3);
    }
    if constexpr (kDv) warp_ab<kD>(dvacc, pa, dos[buf], lrow, lmat);  // dV += P^T dO

    if constexpr (kDk) {
      // dP^T = V dO^T, then dS^T = P^T * (dP^T - delta) in place of P^T
      warp_abt<kD>(acc, vst[0], warp * 16, dos[buf], lrow, lmat);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        const int c0 = nt * 8 + tg * 2;
        const float d0 = dl[c0], d1 = dl[c0 + 1];
        uint32_t& lo = pa[nt / 2][(nt & 1) * 2 + 0];
        uint32_t& hi = pa[nt / 2][(nt & 1) * 2 + 1];
        const float2 pl = unpack2f(lo), ph = unpack2f(hi);
        lo = pack2f(pl.x * (acc[nt][0] - d0), pl.y * (acc[nt][1] - d1));
        hi = pack2f(ph.x * (acc[nt][2] - d0), ph.y * (acc[nt][3] - d1));
      }
      warp_ab<kD>(dkacc, pa, qs[buf], lrow, lmat);  // dK += dS^T Q
    }
    __syncthreads();  // this buffer's fragment reads are done before it is refilled
  }

  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;
  if constexpr (kDk)
    store_rows<kD>(dk + (int64_t)b * Tk * ld + h * kD, ld, dkacc, scale, r0, r1, Tk, tg);
  if constexpr (kDv)
    store_rows<kD>(dv + (int64_t)b * Tk * ld + h * kD, ld, dvacc, 1.f, r0, r1, Tk, tg);
}

// dQ. grid (ceil(Tq / 64), H, B); dynamic shared memory dq_smem<kD>().
template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int Tq, int Tk, int H, float scale_log2,
                    float scale) {
  typedef TileT<kD> Tile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile* qst = reinterpret_cast<Tile*>(smem_raw);  // this block's queries
  Tile* dost = qst + 1;
  Tile* ks = qst + 2;  // [2] key tiles
  Tile* vs = qst + 4;  // [2] value tiles
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int lrow = lane & 7, lmat = lane >> 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int64_t ld = (int64_t)H * kD;
  const bf16* qb = q + (int64_t)b * Tq * ld + h * kD;
  const bf16* dob = dout + (int64_t)b * Tq * ld + h * kD;
  const bf16* kb = k + (int64_t)b * Tk * ld + h * kD;
  const bf16* vb = v + (int64_t)b * Tk * ld + h * kD;

  // the statistics of this thread's two rows
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float* lb = lse + ((int64_t)b * H + h) * Tq;
  const float* db = delta + ((int64_t)b * H + h) * Tq;
  const float l0 = r0 < Tq ? lb[r0] * kLog2e : 0.f, l1 = r1 < Tq ? lb[r1] * kLog2e : 0.f;
  const float d0 = r0 < Tq ? db[r0] : 0.f, d1 = r1 < Tq ? db[r1] : 0.f;

  auto load_tile = [&](int buf, int kt0) {
    copy_tile<kD>(ks[buf], kb, ld, kt0, Tk, tid);
    copy_tile<kD>(vs[buf], vb, ld, kt0, Tk, tid);
  };

  copy_tile<kD>(qst[0], qb, ld, q0, Tq, tid);
  copy_tile<kD>(dost[0], dob, ld, q0, Tq, tid);
  load_tile(0, 0);
  cp_async_commit();

  float dqacc[kD / 8][4];
#pragma unroll
  for (int t = 0; t < kD / 8; ++t) dqacc[t][0] = dqacc[t][1] = dqacc[t][2] = dqacc[t][3] = 0.f;

  const int ntiles = (Tk + kTile - 1) / kTile;
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1, kt = it * kTile;
    if (it + 1 < ntiles) load_tile(buf ^ 1, kt + kTile);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // S = Q K^T for this warp's 16 queries x 64 keys, then P as A fragments
    float acc[kTile / 8][4];
    warp_abt<kD>(acc, qst[0], warp * 16, ks[buf], lrow, lmat);
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      const int key = kt + nt * 8 + tg * 2;
      const bool ok0 = key < Tk, ok1 = key + 1 < Tk;
      const float p0 = ok0 ? exp2f(fmaf(acc[nt][0], scale_log2, -l0)) : 0.f;
      const float p1 = ok1 ? exp2f(fmaf(acc[nt][1], scale_log2, -l0)) : 0.f;
      const float p2 = ok0 ? exp2f(fmaf(acc[nt][2], scale_log2, -l1)) : 0.f;
      const float p3 = ok1 ? exp2f(fmaf(acc[nt][3], scale_log2, -l1)) : 0.f;
      pa[nt / 2][(nt & 1) * 2 + 0] = pack2f(p0, p1);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack2f(p2, p3);
    }

    // dP = dO V^T, then dS = P * (dP - delta) in place of P
    warp_abt<kD>(acc, dost[0], warp * 16, vs[buf], lrow, lmat);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      uint32_t& lo = pa[nt / 2][(nt & 1) * 2 + 0];
      uint32_t& hi = pa[nt / 2][(nt & 1) * 2 + 1];
      const float2 pl = unpack2f(lo), ph = unpack2f(hi);
      lo = pack2f(pl.x * (acc[nt][0] - d0), pl.y * (acc[nt][1] - d0));
      hi = pack2f(ph.x * (acc[nt][2] - d1), ph.y * (acc[nt][3] - d1));
    }
    warp_ab<kD>(dqacc, pa, ks[buf], lrow, lmat);  // dQ += dS K
    __syncthreads();
  }
  store_rows<kD>(dq + (int64_t)b * Tq * ld + h * kD, ld, dqacc, scale, r0, r1, Tq, tg);
}

constexpr int kSegSmem = 2 * kTile * (int)sizeof(int);  // 2 tiles of ids (segment forms)

// dK and / or dV (kPass), masked forms. grid (ceil(T / 64), H, B); dynamic
// shared memory dkv_smem<kD>() (+ kSegSmem in the segment forms). Key tile j
// walks the query tiles of its column of the mask; ``visits``, when not
// null, gets their count added.
template <int kD, int kPass, int kMask>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_masked_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            const int* __restrict__ seg, const int2* __restrict__ ranges,
                            int* __restrict__ visits, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, int T, int H, float scale_log2,
                            float scale) {
  typedef TileT<kD> Tile;
  constexpr bool kDv = kPass != kDkOnly, kDk = kPass != kDvOnly;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile* kst = reinterpret_cast<Tile*>(smem_raw);  // this block's keys
  Tile* vst = kst + 1;
  Tile* qs = kst + 2;   // [2] query tiles
  Tile* dos = kst + 4;  // [2] dO tiles
  float* stat = reinterpret_cast<float*>(smem_raw + 6 * sizeof(Tile));  // [2][lse, delta][64]
  int* qseg = reinterpret_cast<int*>(stat + 4 * kTile);                 // [2][64] query ids
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int lrow = lane & 7, lmat = lane >> 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int64_t ld = (int64_t)H * kD;
  const int64_t base = (int64_t)b * T * ld + h * kD;
  const bf16* qb = q + base;
  const bf16* dob = dout + base;
  const float* lb = lse + ((int64_t)b * H + h) * T;
  const float* db = delta + ((int64_t)b * H + h) * T;
  const int* sb = (kMask & kSegment) ? seg + (int64_t)b * T : nullptr;

  // this thread's two keys (the rows of S^T) and their ids
  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;
  const int sk0 = (kMask & kSegment) && r0 < T ? sb[r0] : 0;
  const int sk1 = (kMask & kSegment) && r1 < T ? sb[r1] : 0;

  auto load_tile = [&](int buf, int qt0) {
    copy_tile<kD>(qs[buf], qb, ld, qt0, T, tid);
    copy_tile<kD>(dos[buf], dob, ld, qt0, T, tid);
    const int j = tid & (kTile - 1);
    const bool valid = qt0 + j < T;
    const float* src = (tid < kTile ? lb : db) + (valid ? qt0 + j : 0);
    cp_async4(stat + (buf * 2 + (tid >= kTile)) * kTile + j, src, valid);
    if ((kMask & kSegment) && tid < kTile)
      cp_async4(reinterpret_cast<float*>(qseg + buf * kTile + j),
                reinterpret_cast<const float*>(sb + (valid ? qt0 + j : 0)), valid);
  };

  const int ntiles = (T + kTile - 1) / kTile;
  const TileWalk<kMask> walk((kMask & kSegment) ? ranges + (int64_t)b * ntiles : nullptr,
                             blockIdx.x, ntiles, true);
  int cur = walk.next(walk.first);
  copy_tile<kD>(kst[0], k + base, ld, k0, T, tid);
  if (kDk) copy_tile<kD>(vst[0], v + base, ld, k0, T, tid);
  if (cur <= walk.last) load_tile(0, cur * kTile);
  cp_async_commit();

  float dkacc[kDk ? kD / 8 : 1][4], dvacc[kDv ? kD / 8 : 1][4];
#pragma unroll
  for (int t = 0; t < kD / 8; ++t) {
    if constexpr (kDk) dkacc[t][0] = dkacc[t][1] = dkacc[t][2] = dkacc[t][3] = 0.f;
    if constexpr (kDv) dvacc[t][0] = dvacc[t][1] = dvacc[t][2] = dvacc[t][3] = 0.f;
  }

  int it = 0;
  for (; cur <= walk.last; ++it) {
    const int buf = it & 1, qt = cur * kTile;
    const int nxt = walk.next(cur + 1);
    // the other buffer's readers finished at the end of the last iteration
    if (nxt <= walk.last) load_tile(buf ^ 1, nxt * kTile);
    cp_async_commit();   // an empty group after the last tile keeps the count uniform
    cp_async_wait<1>();  // all but the newest group: this tile (and K, V) has landed
    __syncthreads();
    const float* ls = stat + buf * 2 * kTile;
    const float* dl = ls + kTile;
    const int* qs_ids = qseg + buf * kTile;
    const bool masked = walk.needs_mask(cur, blockIdx.x);

    // S^T = K Q^T for this warp's 16 keys x 64 queries, then P^T as A
    // fragments: 0 for queries past T and, on a masked tile, for dropped pairs
    float acc[kTile / 8][4];
    warp_abt<kD>(acc, kst[0], warp * 16, qs[buf], lrow, lmat);
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int off = nt * 8 + tg * 2 + c, col = qt + off;
        const float l = ls[off] * kLog2e;
        bool ok0 = col < T, ok1 = ok0;
        if (masked) {
          const int sq = (kMask & kSegment) ? qs_ids[off] : 0;
          ok0 = ok0 && flash_mask::keep_pair<kMask>(col, sq, r0, sk0);
          ok1 = ok1 && flash_mask::keep_pair<kMask>(col, sq, r1, sk1);
        }
        p[c] = ok0 ? exp2f(fmaf(acc[nt][c], scale_log2, -l)) : 0.f;
        p[2 + c] = ok1 ? exp2f(fmaf(acc[nt][2 + c], scale_log2, -l)) : 0.f;
      }
      pa[nt / 2][(nt & 1) * 2 + 0] = pack2f(p[0], p[1]);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack2f(p[2], p[3]);
    }
    if constexpr (kDv) warp_ab<kD>(dvacc, pa, dos[buf], lrow, lmat);  // dV += P^T dO

    if constexpr (kDk) {
      // dP^T = V dO^T, then dS^T = P^T * (dP^T - delta) in place of P^T
      warp_abt<kD>(acc, vst[0], warp * 16, dos[buf], lrow, lmat);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        const int c0 = nt * 8 + tg * 2;
        const float d0 = dl[c0], d1 = dl[c0 + 1];
        uint32_t& lo = pa[nt / 2][(nt & 1) * 2 + 0];
        uint32_t& hi = pa[nt / 2][(nt & 1) * 2 + 1];
        const float2 pl = unpack2f(lo), ph = unpack2f(hi);
        lo = pack2f(pl.x * (acc[nt][0] - d0), pl.y * (acc[nt][1] - d1));
        hi = pack2f(ph.x * (acc[nt][2] - d0), ph.y * (acc[nt][3] - d1));
      }
      warp_ab<kD>(dkacc, pa, qs[buf], lrow, lmat);  // dK += dS^T Q
    }
    __syncthreads();  // this buffer's fragment reads are done before it is refilled
    cur = nxt;
  }
  cp_async_wait<0>();
  if (visits != nullptr && tid == 0) atomicAdd(visits, it);

  if constexpr (kDk) store_rows<kD>(dk + base, ld, dkacc, scale, r0, r1, T, tg);
  if constexpr (kDv) store_rows<kD>(dv + base, ld, dvacc, 1.f, r0, r1, T, tg);
}

// dQ, masked forms. grid (ceil(T / 64), H, B); dynamic shared memory
// dq_smem<kD>() (+ kSegSmem in the segment forms). Query tile i walks the key
// tiles of its row of the mask, as the forward does.
template <int kD, int kMask>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_masked_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const int* __restrict__ seg, const int2* __restrict__ ranges,
                           int* __restrict__ visits, bf16* __restrict__ dq, int T, int H,
                           float scale_log2, float scale) {
  typedef TileT<kD> Tile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile* qst = reinterpret_cast<Tile*>(smem_raw);  // this block's queries
  Tile* dost = qst + 1;
  Tile* ks = qst + 2;  // [2] key tiles
  Tile* vs = qst + 4;  // [2] value tiles
  int* kseg = reinterpret_cast<int*>(qst + 6);  // [2][64] key ids
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int lrow = lane & 7, lmat = lane >> 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int64_t ld = (int64_t)H * kD;
  const int64_t base = (int64_t)b * T * ld + h * kD;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const int* sb = (kMask & kSegment) ? seg + (int64_t)b * T : nullptr;

  // the statistics and ids of this thread's two rows
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float* lb = lse + ((int64_t)b * H + h) * T;
  const float* db = delta + ((int64_t)b * H + h) * T;
  const float l0 = r0 < T ? lb[r0] * kLog2e : 0.f, l1 = r1 < T ? lb[r1] * kLog2e : 0.f;
  const float d0 = r0 < T ? db[r0] : 0.f, d1 = r1 < T ? db[r1] : 0.f;
  const int sq0 = (kMask & kSegment) && r0 < T ? sb[r0] : 0;
  const int sq1 = (kMask & kSegment) && r1 < T ? sb[r1] : 0;

  auto load_tile = [&](int buf, int kt0) {
    copy_tile<kD>(ks[buf], kb, ld, kt0, T, tid);
    copy_tile<kD>(vs[buf], vb, ld, kt0, T, tid);
    if ((kMask & kSegment) && tid < kTile) {
      const bool valid = kt0 + tid < T;
      cp_async4(reinterpret_cast<float*>(kseg + buf * kTile + tid),
                reinterpret_cast<const float*>(sb + (valid ? kt0 + tid : 0)), valid);
    }
  };

  const int ntiles = (T + kTile - 1) / kTile;
  const TileWalk<kMask> walk((kMask & kSegment) ? ranges + (int64_t)b * ntiles : nullptr,
                             blockIdx.x, ntiles, false);
  int cur = walk.next(walk.first);
  copy_tile<kD>(qst[0], q + base, ld, q0, T, tid);
  copy_tile<kD>(dost[0], dout + base, ld, q0, T, tid);
  if (cur <= walk.last) load_tile(0, cur * kTile);
  cp_async_commit();

  float dqacc[kD / 8][4];
#pragma unroll
  for (int t = 0; t < kD / 8; ++t) dqacc[t][0] = dqacc[t][1] = dqacc[t][2] = dqacc[t][3] = 0.f;

  int it = 0;
  for (; cur <= walk.last; ++it) {
    const int buf = it & 1, kt = cur * kTile;
    const int nxt = walk.next(cur + 1);
    if (nxt <= walk.last) load_tile(buf ^ 1, nxt * kTile);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int* ks_ids = kseg + buf * kTile;
    const bool masked = walk.needs_mask(cur, blockIdx.x);

    // S = Q K^T for this warp's 16 queries x 64 keys, then P as A fragments
    float acc[kTile / 8][4];
    warp_abt<kD>(acc, qst[0], warp * 16, ks[buf], lrow, lmat);
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int off = nt * 8 + tg * 2 + c, key = kt + off;
        bool ok0 = key < T, ok1 = ok0;
        if (masked) {
          const int sk = (kMask & kSegment) ? ks_ids[off] : 0;
          ok0 = ok0 && flash_mask::keep_pair<kMask>(r0, sq0, key, sk);
          ok1 = ok1 && flash_mask::keep_pair<kMask>(r1, sq1, key, sk);
        }
        p[c] = ok0 ? exp2f(fmaf(acc[nt][c], scale_log2, -l0)) : 0.f;
        p[2 + c] = ok1 ? exp2f(fmaf(acc[nt][2 + c], scale_log2, -l1)) : 0.f;
      }
      pa[nt / 2][(nt & 1) * 2 + 0] = pack2f(p[0], p[1]);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack2f(p[2], p[3]);
    }

    // dP = dO V^T, then dS = P * (dP - delta) in place of P
    warp_abt<kD>(acc, dost[0], warp * 16, vs[buf], lrow, lmat);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      uint32_t& lo = pa[nt / 2][(nt & 1) * 2 + 0];
      uint32_t& hi = pa[nt / 2][(nt & 1) * 2 + 1];
      const float2 pl = unpack2f(lo), ph = unpack2f(hi);
      lo = pack2f(pl.x * (acc[nt][0] - d0), pl.y * (acc[nt][1] - d0));
      hi = pack2f(ph.x * (acc[nt][2] - d1), ph.y * (acc[nt][3] - d1));
    }
    warp_ab<kD>(dqacc, pa, ks[buf], lrow, lmat);  // dQ += dS K
    __syncthreads();
    cur = nxt;
  }
  cp_async_wait<0>();
  if (visits != nullptr && tid == 0) atomicAdd(visits, it);
  store_rows<kD>(dq + base, ld, dqacc, scale, r0, r1, T, tg);
}

// The dK/dV launches of head dim kD: one kernel computing both at 128, the
// dV and the dK pass at 256. ``launch(pass)`` launches the kernel of one
// pass (a std::integral_constant).
template <int kD, typename Launch>
cudaError_t for_dkv_passes(Launch launch) {
  if constexpr (kD == 128) {
    return launch(std::integral_constant<int, kBoth>());
  } else {
    const cudaError_t err = launch(std::integral_constant<int, kDvOnly>());
    if (err != cudaSuccess) return err;
    return launch(std::integral_constant<int, kDkOnly>());
  }
}

template <int kD, int kMask>
int launch_bwd_masked(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                      const float* lse, const float* delta, const int* seg,
                      const int2* ranges, int* visits_dkv, int* visits_dq, bf16* dq, bf16* dk,
                      bf16* dv, int B, int T, int H, float scale, cudaStream_t stream) {
  const int extra = (kMask & kSegment) ? kSegSmem : 0;
  const float scale_log2 = scale * kLog2e;
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  cudaError_t err = for_dkv_passes<kD>([&](auto pass) {
    constexpr int kPass = decltype(pass)::value;
    auto dkv = flash_bwd_dkv_masked_kernel<kD, kPass, kMask>;
    cudaError_t e = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         dkv_smem<kD>() + extra);
    if (e != cudaSuccess) return e;
    // both passes walk the same tiles: count them once
    int* vis = kPass == kDkOnly ? nullptr : visits_dkv;
    dkv<<<grid, kThreads, dkv_smem<kD>() + extra, stream>>>(q, k, v, dout, lse, delta, seg,
                                                             ranges, vis, dk, dv, T, H,
                                                             scale_log2, scale);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  auto dqk = flash_bwd_dq_masked_kernel<kD, kMask>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_smem<kD>() + extra);
  if (err != cudaSuccess) return (int)err;
  dqk<<<grid, kThreads, dq_smem<kD>() + extra, stream>>>(q, k, v, dout, lse, delta, seg, ranges,
                                                         visits_dq, dq, T, H, scale_log2, scale);
  return (int)cudaGetLastError();
}

// The unmasked form: the delta pass, the dK/dV pass(es), the dQ kernel.
template <int kD>
int launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
               const float* lse, float* delta, bf16* dq, bf16* dk, bf16* dv, int B, int Tq,
               int Tk, int H, float scale, cudaStream_t stream) {
  const float scale_log2 = scale * kLog2e;
  const int64_t rows = (int64_t)B * Tq * H;
  flash_bwd_delta_kernel<kD><<<(unsigned)((rows + 3) / 4), kThreads, 0, stream>>>(
      o, dout, delta, rows, Tq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = for_dkv_passes<kD>([&](auto pass) {
    auto dkv = flash_bwd_dkv_kernel<kD, decltype(pass)::value>;
    cudaError_t e = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         dkv_smem<kD>());
    if (e != cudaSuccess) return e;
    dkv<<<dim3((Tk + kTile - 1) / kTile, H, B), kThreads, dkv_smem<kD>(), stream>>>(
        q, k, v, dout, lse, delta, dk, dv, Tq, Tk, H, scale_log2, scale);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  auto dqk = flash_bwd_dq_kernel<kD>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<kD>());
  if (err != cudaSuccess) return (int)err;
  dqk<<<dim3((Tq + kTile - 1) / kTile, H, B), kThreads, dq_smem<kD>(), stream>>>(
      q, k, v, dout, lse, delta, dq, Tq, Tk, H, scale_log2, scale);
  return (int)cudaGetLastError();
}

// The masked forms: the range pre-pass (segment forms), the delta pass and
// the masked kernels of the form ``causal`` and ``seg`` ask for.
template <int kD>
int launch_bwd_masked_forms(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* delta, void* dq, void* dk,
                            void* dv, const void* seg, void* ranges, void* visits, int B, int T,
                            int H, int causal, float scale, cudaStream_t stream) {
  cudaError_t err;
  if (seg != nullptr) {
    err = flash_mask::launch_seg_tile_ranges((const int*)seg, (int2*)ranges, B, T, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t rows = (int64_t)B * T * H;
  flash_bwd_delta_kernel<kD><<<(unsigned)((rows + 3) / 4), kThreads, 0, stream>>>(
      (const bf16*)o, (const bf16*)dout, (float*)delta, rows, T, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int* vis = (int*)visits;
  auto run = [&](auto launch) {
    return launch((const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
                  (const float*)lse, (const float*)delta, (const int*)seg,
                  (const int2*)ranges, vis, vis ? vis + 1 : nullptr, (bf16*)dq, (bf16*)dk,
                  (bf16*)dv, B, T, H, scale, stream);
  };
  using flash_mask::kCausal;
  if (seg == nullptr) return run(launch_bwd_masked<kD, kCausal>);
  return causal ? run(launch_bwd_masked<kD, kCausal | kSegment>)
                : run(launch_bwd_masked<kD, kSegment>);
}

}  // namespace

// Plain C entry points (loaded with ctypes): each launches its kernels on
// the given stream, does not synchronise, returns the first cudaError_t that
// is not 0. ``delta`` is float32 scratch [B, H, Tq]; ``D`` the head dim, 128
// or 256 (any other: cudaErrorInvalidValue).
extern "C" int mhla_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* delta, void* dq,
                              void* dk, void* dv, int B, int Tq, int Tk, int H, int D,
                              float scale, void* stream) {
  if (Tq < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  auto run = [&](auto launch) {
    return launch((const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
                  (const bf16*)dout, (const float*)lse, (float*)delta, (bf16*)dq, (bf16*)dk,
                  (bf16*)dv, B, Tq, Tk, H, scale, (cudaStream_t)stream);
  };
  if (D == 128) return run(launch_bwd<128>);
  if (D == 256) return run(launch_bwd<256>);
  return (int)cudaErrorInvalidValue;
}

// The causal and / or segment-id forms, Tq == Tk == T: the range pre-pass
// (segment forms; ``seg`` [B, T] int32 or null, ``ranges`` int32 scratch
// [B, ceil(T / 64), 2]), the delta pass and the masked kernels.
// ``visits`` is null or two int32 that get the tiles walked by the dK/dV and
// the dQ kernel added (at D = 256 the dK/dV walk is counted once, by its dV
// pass).
extern "C" int mhla_flash_bwd_masked(const void* q, const void* k, const void* v,
                                     const void* o, const void* dout, const void* lse,
                                     void* delta, void* dq, void* dk, void* dv, const void* seg,
                                     void* ranges, void* visits, int B, int T, int H, int D,
                                     int causal, float scale, void* stream) {
  if (T < 1 || (seg == nullptr && !causal)) return (int)cudaErrorInvalidValue;
  auto run = [&](auto launch) {
    return launch(q, k, v, o, dout, lse, delta, dq, dk, dv, seg, ranges, visits, B, T, H,
                  causal, scale, (cudaStream_t)stream);
  };
  if (D == 128) return run(launch_bwd_masked_forms<128>);
  if (D == 256) return run(launch_bwd_masked_forms<256>);
  return (int)cudaErrorInvalidValue;
}
