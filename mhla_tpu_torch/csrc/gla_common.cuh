// Pieces shared by the chunked GLA kernels (gla_chunk.cu: K12, gla_chunk_bwd.cu:
// K12b): float32 tiles in shared memory, TF32 wgmma products split to
// float32 accuracy, and the state pass, the one sequential part of each.
//
// Every product runs on the TF32 tensor cores (wgmma, hopper.cuh). The
// kernels take float32 operands in both compute dtypes (the wrappers hand a
// bf16 call's inputs over as float32 copies, exact), so one code path serves
// both:
// - float32 (kBf16 = false; the GLA layer's form): each operand x = hi + lo,
//   hi its TF32 rounding and lo = x - hi (exact in float32; split_tf32), and
//   hi hi' + hi lo' + lo hi' carries a product to float32 accuracy, where one
//   TF32 product is about 3e-4 off in relative RMS (K6's measurement).
// - bf16 (kBf16 = true): every operand is rounded to bf16 at the TPU kernel's
//   rounding points (rnd<true>), which TF32 holds exactly, so the hi product
//   alone is exact: one product, no lo.
//
// TF32 wgmma takes both operands K-major (the summed index running along a
// row of shared memory), A from registers and B from shared memory. So each
// product is written in whichever orientation (C or C^T = B^T A^T) puts an
// operand that is already K-major in shared memory (a token tile read along
// Dk or Dv, a state panel read along Dv, or a tile the kernel writes itself)
// on the B side; A, loaded into registers with ordinary loads, may be read in
// any orientation. A B tile loaded by TMA is split in place (hi over the
// tile, lo into a tile of the same layout); an A operand is split in
// registers.
//
// Tiles: float32 [rows][cols] in TMA's 128-byte swizzle layout, cols / 32
// panels of [rows][32] (128-byte rows), panel p at byte p * rows * 128, the
// 16-byte chunk c of row r at chunk c ^ (r % 8); every tile starts at a
// multiple of 1024 bytes. A [rows][C] tile with C = 16 is one panel, half
// used. As a B operand of N rows (the product's columns) and K columns,
// k-step s (8 columns, 32 bytes) is desc_kmajor(tile, r0) + kstep_kmajor<rows>(s).
//
// Chunks of C = 16, 32, 48 or 64 tokens, Dk = 128, Dv a multiple of 64. A
// product whose rows are the chunk's tokens (M = C) runs at M = 64 with A's
// rows past C zero.

#pragma once

#include "hopper.cuh"

namespace gla {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int kDk = 128;     // head dim of q and k
constexpr int kMaxC = 64;    // largest chunk
constexpr int kPanel = 64;   // Dv columns of a panel (the M of a product over Dv rows)
constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100

// x rounded to bf16 and back where kBf16 (a rounding point of the TPU kernel)
template <bool kBf16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (kBf16) return __bfloat162float(__float2bfloat16(x));
  return x;
}

// Bytes of a [rows][cols] float32 tile in whole 128-byte panels.
__host__ __device__ constexpr int tile_bytes(int rows, int cols) {
  return rows * 128 * ((cols + 31) / 32);
}

// Element (r, c) of a [rows][*] tile.
template <int kRows>
__device__ __forceinline__ float& tile_at(float* tile, int r, int c) {
  return *reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(tile) +
                                   (c >> 5) * kRows * 128 + swizzle128_f32(r, c & 31));
}
template <int kRows>
__device__ __forceinline__ float tile_at(const float* tile, int r, int c) {
  return *reinterpret_cast<const float*>(reinterpret_cast<const unsigned char*>(tile) +
                                         (c >> 5) * kRows * 128 + swizzle128_f32(r, c & 31));
}

// Columns [c0, c0 + kCols) of tokens [t0, t0 + kRows) of head h, batch row
// b of a make_tokens_map map into a [kRows][kCols] tile at dst.
template <int kCols, int kRows>
__device__ __forceinline__ void load_tokens(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int t0, int h, int b) {
#pragma unroll
  for (int p = 0; p < kCols / 32; ++p)
    tma_load_4d(static_cast<char*>(dst) + p * kRows * 128, map, bar, c0 + p * 32, h, t0, b);
}

// Columns [c0, c0 + kCols) of rows [r0, r0 + kRows) of a float32
// make_rows_map map of one batch row into a [kRows][kCols] tile at dst.
template <int kCols, int kRows>
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int c0, int r0) {
#pragma unroll
  for (int p = 0; p < kCols / 32; ++p)
    tma_load_4d(static_cast<char*>(dst) + p * kRows * 128, map, bar, c0 + p * 32, r0, 0, 0);
}

// x into a TF32 fragment register (hi) and, where kSplit, its remainder (lo).
template <bool kSplit>
__device__ __forceinline__ void frag(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kSplit) split_tf32(x, hi, lo);
  else hi = __float_as_uint(x), lo = 0u;
}

// Write x at (r, c) of a B tile: hi (and lo where kSplit).
template <int kRows, bool kSplit>
__device__ __forceinline__ void put_b(float* hi, float* lo, int r, int c, float x) {
  uint32_t h, l;
  frag<kSplit>(x, h, l);
  tile_at<kRows>(hi, r, c) = __uint_as_float(h);
  if constexpr (kSplit) tile_at<kRows>(lo, r, c) = __uint_as_float(l);
}

// Split a tile of `bytes` bytes in place: hi over it, lo into `lo` (the
// same layout, so elementwise); threads [0, threads) of the block.
__device__ __forceinline__ void split_tile(float* t, float* lo, int bytes, int tid, int threads) {
  float4* t4 = reinterpret_cast<float4*>(t);
  float4* l4 = reinterpret_cast<float4*>(lo);
  for (int e = tid; e < bytes / 16; e += threads) {
    float4 x = t4[e], h, l;
    uint32_t a, b;
    split_tf32(x.x, a, b), h.x = __uint_as_float(a), l.x = __uint_as_float(b);
    split_tf32(x.y, a, b), h.y = __uint_as_float(a), l.y = __uint_as_float(b);
    split_tf32(x.z, a, b), h.z = __uint_as_float(a), l.z = __uint_as_float(b);
    split_tf32(x.w, a, b), h.w = __uint_as_float(a), l.w = __uint_as_float(b);
    t4[e] = h;
    l4[e] = l;
  }
}

// acc (+)= A B over kSteps k-steps of 8 on a warpgroup: A [64][8 kSteps] in
// registers, its m64k8 fragment of k-step ks from load(ks, m, k) -> float for
// the rows m = 16 warp + g (+ 8) and columns k = 8 ks + tg (+ 4) of each lane
// (split in registers where kSplit); B at descriptors bhi / blo (its lo,
// where kSplit) of a tile of kRowsB rows, k-step ks at kstep_kmajor<kRowsB>(ks).
// kSplit: hi hi' + hi lo' + lo hi', else hi hi'. The k-steps go in groups of
// up to four, one commit group each, their fragments in two register sets
// in turn, so a group's loads overlap the previous group's products.
// Returns with the products done.
template <bool kSplit, int kSteps, int kRowsB, int R, typename LoadA>
__device__ __forceinline__ void mma(float (&acc)[R][4], LoadA load, uint64_t bhi, uint64_t blo,
                                    bool accumulate) {
  // k-steps a group: 4, or 3 or 2 where they divide kSteps (C = 48: 6, C = 16: 2)
  constexpr int kG = kSteps % 4 == 0 ? 4 : kSteps % 3 == 0 ? 3 : kSteps % 2 == 0 ? 2 : 1;
  const int lane = threadIdx.x & 31, m0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2),
            k0 = lane & 3;
  uint32_t ahi[2][kG][4], alo[2][kG][4];
#pragma unroll
  for (int g = 0; g < kSteps / kG; ++g) {
    const int s = g & 1;
#pragma unroll
    for (int q = 0; q < kG; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        frag<kSplit>(load(g * kG + q, m0 + 8 * (e & 1), 8 * (g * kG + q) + k0 + 4 * (e >> 1)),
                     ahi[s][q][e], alo[s][q][e]);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < kG; ++q) {
      const int ks = g * kG + q;
      const uint64_t off = kstep_kmajor<kRowsB>(ks);
      wgmma_tf32(acc, ahi[s][q], bhi + off, (accumulate || ks > 0) ? 1 : 0);
      if constexpr (kSplit) {
        wgmma_tf32(acc, ahi[s][q], blo + off, 1);
        wgmma_tf32(acc, alo[s][q], bhi + off, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // group g - 1 is done: its register set may be written
    fence_frag(ahi[s ^ 1]);
    if constexpr (kSplit) fence_frag(alo[s ^ 1]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

}  // namespace gla

// ---- the state pass and the host side, in the including file's anonymous
// namespace (each source gets its own copy)
namespace {

using namespace gla;

constexpr int kStateStages = 4;

template <int kC>
struct StateGeom {
  static constexpr int kX = tile_bytes(kC, kDk);      // x: [C][128]
  static constexpr int kY = tile_bytes(kC, kPanel);   // y: [C][64] (the block's Dv panel)
  static constexpr int kStage = kX + kY;
  static constexpr int kYT = tile_bytes(kPanel, kC);  // y^T: [64][C], the B operand
  static constexpr int kSmem = kStateStages * kStage + 2 * kYT + 64 + 1024;
  static_assert(kSmem <= kSmemLimit, "one block's shared memory");
};

// The state pass: one block of two warpgroups per (batch row b, head h, Dv
// panel p), walking the chunks in order (kFwd) or in reverse; warpgroup w
// holds Dk rows [64 w, 64 w + 64). The state (128 x 64) stays in registers
// as wgmma accumulators z, from
// z = s_in; per chunk n it writes z to seq[b, n, h] (the chunk-entry state,
// or in reverse the exit cotangent), then
//
//   u = x'^T y;   z = z e^{G_last} + u        (row d decays by e^{G_last, d})
//
// with x' = T(x e^{G_last}) (kFwd: kc from kd) or x (qd), y the chunk's v (or
// dO) panel; the product and the sum of the update rounded separately, as
// the TPU kernel rounds them. u is a TF32 product over the C tokens: A = x'^T
// from registers (x's tile read along its rows), B = y^T, which the block
// writes from y's tile (y read along Dv is not K-major for a sum over
// tokens) once for both warpgroups. The final z goes to s_out. x and y stream in by TMA through
// kStateStages stages, so the next chunk's loads overlap this chunk's work.
// maps: [B, T, H, Dk] (x) and [B, T, H, Dv] (y) float32, boxes of 32 columns
// by C tokens; egl [B, N, H, Dk]; s_in, s_out [B, H, Dk, Dv]; seq [B, N, H,
// Dk, Dv]; float32.
template <bool kBf16, int kC, bool kFwd>
__global__ void __launch_bounds__(256, 1)
gla_state_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_y, const float* __restrict__ egl,
                 const float* __restrict__ s_in, float* __restrict__ seq,
                 float* __restrict__ s_out, int N, int H, int Dv) {
  typedef StateGeom<kC> G;
  constexpr bool kSplit = !kBf16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* stages = smem;
  float* yt_hi = reinterpret_cast<float*>(smem + kStateStages * G::kStage);
  float* yt_lo = reinterpret_cast<float*>(smem + kStateStages * G::kStage + G::kYT);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStateStages * G::kStage + 2 * G::kYT);

  const int panels = Dv / kPanel;
  const int p = blockIdx.x % panels, h = blockIdx.x / panels % H, b = blockIdx.x / panels / H;
  const int tid = threadIdx.x, d0 = (tid >> 7) * 64, c0 = p * kPanel;

  if (tid == 0) {
    for (int s = 0; s < kStateStages; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int i) {  // the i-th chunk of the walk into stage i % kStateStages
    const int n = kFwd ? i : N - 1 - i, s = i % kStateStages;
    unsigned char* st = stages + s * G::kStage;
    mbar_arrive_expect_tx(&full[s], G::kStage);
    load_tokens<kDk, kC>(st, &map_x, &full[s], 0, n * kC, h, b);
    load_tokens<kPanel, kC>(st + G::kX, &map_y, &full[s], c0, n * kC, h, b);
  };
  if (tid == 0)
    for (int i = 0; i < kStateStages && i < N; ++i) issue(i);

  // this thread's state entries: rows d0 + acc_row(e), columns c0 + acc_col(i, e)
  const int64_t state_bh = ((int64_t)b * H + h) * kDk * Dv;
  float z[8][4], u[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const float2 v2 = *reinterpret_cast<const float2*>(
          s_in + state_bh + (int64_t)(d0 + acc_row(e)) * Dv + c0 + acc_col(i, e));
      z[i][e] = v2.x, z[i][e + 1] = v2.y;
    }
  const uint64_t dhi = desc_kmajor(yt_hi, 0), dlo = desc_kmajor(yt_lo, 0);
  for (int i = 0; i < N; ++i) {
    const int n = kFwd ? i : N - 1 - i, s = i % kStateStages;
    const float* eg = egl + (((int64_t)b * N + n) * H + h) * kDk + d0;
    const float g0 = __ldg(eg + acc_row(0)), g1 = __ldg(eg + acc_row(2));
    mbar_wait(&full[s], (i / kStateStages) & 1);
    const float* xs = reinterpret_cast<const float*>(stages + s * G::kStage);
    const float* ys = reinterpret_cast<const float*>(stages + s * G::kStage + G::kX);
    // B = y^T: [64 Dv][C tokens]
    for (int e = tid; e < kC * kPanel; e += 256) {
      const int c = e / kPanel, dv = e % kPanel;
      put_b<kPanel, kSplit>(yt_hi, yt_lo, dv, c, tile_at<kC>(ys, c, dv));
    }
    // A = x'^T: [64 Dk][C tokens], rows e^{G_last}-scaled and rounded (kFwd)
    uint32_t ahi[kC / 8][4], alo[kC / 8][4];
    const int lane = tid & 31, r0 = d0 + ((tid >> 5) & 3) * 16 + (lane >> 2), k0 = lane & 3;
#pragma unroll
    for (int ks = 0; ks < kC / 8; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = tile_at<kC>(xs, 8 * ks + k0 + 4 * (e >> 1), r0 + 8 * (e & 1));
        if constexpr (kFwd) x = rnd<kBf16>(x * ((e & 1) ? g1 : g0));
        frag<kSplit>(x, ahi[ks][e], alo[ks][e]);
      }
    fence_async_shared();  // y^T is read by the products through the async proxy
    __syncthreads();       // y^T written; stage s read by every thread
    if (tid == 0 && i + kStateStages < N) issue(i + kStateStages);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kC / 8; ++ks) {
      const uint64_t off = kstep_kmajor<kPanel>(ks);
      wgmma_tf32(u, ahi[ks], dhi + off, ks > 0 ? 1 : 0);
      if constexpr (kSplit) {
        wgmma_tf32(u, ahi[ks], dlo + off, 1);
        wgmma_tf32(u, alo[ks], dhi + off, 1);
      }
    }
    wgmma_commit();
    // the chunk-entry state (exit cotangent) while the products run
    float* out = seq + (((int64_t)b * N + n) * H + h) * kDk * Dv;
#pragma unroll
    for (int i2 = 0; i2 < 8; ++i2)
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        *reinterpret_cast<float2*>(out + (int64_t)(d0 + acc_row(e)) * Dv + c0 + acc_col(i2, e)) =
            make_float2(z[i2][e], z[i2][e + 1]);
    wgmma_wait<0>();
    fence_acc(u);
#pragma unroll
    for (int i2 = 0; i2 < 8; ++i2)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        z[i2][e] = __fadd_rn(__fmul_rn(z[i2][e], (e >> 1) ? g1 : g0), u[i2][e]);
    __syncthreads();  // every warp's products are done with y^T before it is rewritten
  }
  float* fin = s_out + state_bh;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; e += 2)
      *reinterpret_cast<float2*>(fin + (int64_t)(d0 + acc_row(e)) * Dv + c0 + acc_col(i, e)) =
          make_float2(z[i][e], z[i][e + 1]);
}

// A tensor map of a contiguous [B, T, H, D] float32 tensor whose boxes are
// 32 columns of ``rows`` tokens of one (batch row, head), 128-byte swizzle.
// Returns a cudaError_t.
inline int make_tokens_map(CUtensorMap* map, const void* base, int B, int T, int H, int D,
                           int rows) {
  const hopper_host::EncodeTiledFn fn = hopper_host::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 4, (cuuint64_t)H * D * 4,
                                 (cuuint64_t)T * H * D * 4};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Launch the state pass on `stream`: x, y the token tensors, N chunks of C.
template <bool kBf16, int kC, bool kFwd>
int launch_state(const float* x, const float* y, const float* egl, const float* s_in,
                 float* seq, float* s_out, int B, int N, int H, int Dv, cudaStream_t stream) {
  typedef StateGeom<kC> G;
  auto kern = gla_state_kernel<kBf16, kC, kFwd>;
  int blocks = 0;
  int err = hopper_host::resident_blocks((const void*)kern, 256, G::kSmem, &blocks);
  if (err) return err;
  CUtensorMap map_x, map_y;
  err = make_tokens_map(&map_x, x, B, N * kC, H, kDk, kC);
  if (!err) err = make_tokens_map(&map_y, y, B, N * kC, H, Dv, kC);
  if (err) return err;
  kern<<<B * H * (Dv / kPanel), 256, G::kSmem, stream>>>(map_x, map_y, egl, s_in, seq, s_out, N,
                                                         H, Dv);
  return (int)cudaGetLastError();
}

inline bool shape_ok(int C, int Dk, int Dv) {
  return Dk == kDk && C % 16 == 0 && C > 0 && C <= kMaxC && Dv > 0 && Dv % kPanel == 0;
}

}  // namespace
