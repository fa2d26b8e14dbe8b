// K3 and K3b at every N up to kMaxSlotsWide, for Hopper (sm_90a): the state
// mixing of the chunked MHLA op as wgmma products over TMA tiles.
//
//   K3   mixed_i = sum_{j<i} Ms[i, j] S_j                 [N, N] x [N, R]
//   K3b  dS_j    = sum_{i>j} Ms[i, j] dmixed_i            [N, N]^T x [N, R]
//        dMs[i, j] = <dmixed_i, S_j>  (i > j)             [N, R] x [R, N]
//
// S, mixed, dmixed, dS: [B, N, R] bf16 with R = H*Dk*Dv (the [B, N, H*Dk, Dv]
// states of csrc/mhla_chunk.cu, flat); Ms: [N, N] float32, its values taken
// at bf16 (the op rounds its scaled strict triangle to the compute dtype
// already), shared by the batch or one per batch row (m_bstride = N*N); dMs
// float32 in Ms's shape, summed over the batch when shared. N reaches 512
// at a context of 32,768 tokens in chunks of 64, and 32 at the 340M's 2,048.
//
// Replaces _mix_kernel, lower form (mhla_tpu/kernels/mhla_chunk_pallas.py:293)
// for K3; _mix_bwd_fused_kernel (:459), or _mix_kernel in its upper form
// (:293) with _dm_kernel (:394), for K3b. JAX runs them for N >= 128 with N %
// 64 == 0 (_mix_use_pallas, :365-367) and an XLA einsum elsewhere; the port
// runs these kernels at every N, the 340M's N = 32 included. JAX's halving
// row bands (_mix_bands, :279) keep the TPU's VMEM within bounds; here the
// skipped triangle does the same work.
//
// Bound: bytes. At N = 448 (a 28,672-token block) K3 reads and writes
// 2 x 448 x 131,072 bf16 (235 MB) for 448^2 / 2 x 131,072 x 2 = 26 GFLOP:
// 112 FLOP/byte, below the card's bf16 ridge (295 FLOP/byte); at N = 32 16
// FLOP/byte. K3b reads dmixed twice and S once and writes dS (268 MB at N =
// 256: 80 us).
//
// Design (hopper.cuh has the primitives), three forms chosen by N:
// - N <= 64 (mix_small_kernel, K3 and K3b's dS): M's one 64 x 64 tile, zero
//   at and past N, is built by each consumer warpgroup from the float32 M
//   straight into wgmma A fragments in registers (its transpose for dS), so
//   the host makes no copy of M and encodes two tensor maps. Items of 256
//   state columns stream through a ring of seven 32 KB stages (TMA zero-fills
//   the rows past N); the two consumer warpgroups take the items in turn,
//   run ceil(N / 16) products m64n256k16, round the result to bf16 in place
//   in the stage and store it by TMA (rows past N are not written), and
//   release the stage once that store has read it. A block walks a
//   contiguous run of items, so a per-row M is rebuilt about once a block.
// - The larger forms read a zero-padded bf16 copy of M's strict lower
//   triangle [Np, Np] (Np = N rounded up to 64; mix_prep_kernel for K3, the
//   prologue of K3b's Gram kernel), so every 64 x 64 tile of it is zero
//   wherever the triangle is. K3 reads its tiles K-major (A = M); dS reads
//   the same copy MN-major (A = M^T, wgmma's transposed A), so no
//   transposed copy is made. Each is a persistent grid over the strips of
//   128 state columns of each batch row whose blocks have two producer warps
//   and two consumer warpgroups, each owning 64 columns of the output in
//   float32 registers. A step is four wgmma m64n64k16 products, A = a 64 x
//   64 tile of M, B = 64 source rows read MN-major; only the tiles that can
//   hold a nonzero coefficient (j <= i for K3, j >= i for dS) are loaded or
//   multiplied. Every source element is read from device memory once and
//   every output written once, by a TMA store of a tile staged in swizzled
//   shared memory: 4-byte stores of the accumulators into rows R apart
//   halved the byte rate.
//   64 < N <= 256 (mix_stream_kernel): all kT <= 4 output tiles of a strip
//   stay in registers, so each source tile is used by every output it feeds
//   as it arrives and its stage freed at once: a GEMM's main loop, the ring
//   of source tiles running ahead across the strips. M's triangle (10 tiles
//   at N = 256) stays in shared memory for all of a block's strips, loaded
//   again only when a per-row M changes with the batch row. Timed in turns
//   against the strip kernel run at these N, it keeps K3b's dS at N = 256
//   7% faster (PERF.md section 6), so the two forms stay.
//   N > 256 (mix_strip_kernel): a strip's rows stay in shared memory (Np x
//   128 bf16: 208 KB at N = 832), two strips' worth where they fit (N <=
//   320); the walk goes over the output tiles first to last (K3) or last to
//   first (dS), M's tiles through a ring of stages, each released one step
//   late so the next step's products issue before this one's finish.
// - dMs (gram_partial_kernel, gram_reduce_kernel): a Gram product over R
//   with fixed R slices. Each block takes one 128 x 128 tile on or below
//   the diagonal of dMs and one slice of R; a producer warp streams 64
//   columns of dmixed's and S's 128 rows at a time by TMA through a ring of
//   three stages and two warpgroups sum wgmma m64n128k16 products (A and B
//   both K-major) in registers, 64 rows each, then write the float32
//   partial tile (each stage released one step late); a second pass sums
//   the slices (and, for a shared M, the batch rows) in a fixed order, just
//   after the first while the partials are in L2. No atomics, so dMs is the
//   same bit for bit from run to run. Tiles of 128 rows read each row of a
//   slice from L2 about half as often as tiles of 64 would.
// Not done: the Gram pass still reads 1.5x its rows from L2 at N = 256
// (three tile pairs a slice) and takes as long as the dS pass; clusters
// sharing a row tile by TMA multicast would cut that.

#include "hopper.cuh"

using namespace hopper;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;        // the prep and reduce kernels
constexpr int kStripThreads = 320;   // two consumer warpgroups and two producer warps
constexpr int kGramThreads = 288;    // two consumer warpgroups and a producer warp
constexpr int kTile = 64;            // rows (and M columns) per tile
constexpr int kCols = 128;           // state columns per strip
constexpr int kTileBytes = kTile * kTile * 2;
constexpr int kMaxSlotsWide = 832;   // 832 staged rows x 256 bytes = 208 KB
constexpr int kMaxTiles = kMaxSlotsWide / kTile;
constexpr int kMaxStages = 4;       // ring stages of M in the strip kernel
constexpr int kStreamTiles = 4;     // the streamed form up to N = 256: 4 output tiles a strip
constexpr int kSrcStages = 6;       // its ring of 16 KB source tiles
constexpr int kStageOutBytes = 4 * kTileBytes;  // two staging panels per consumer warpgroup
constexpr int kGramStages = 3;     // 96 KB: two Gram blocks on an SM
constexpr int kSmallSlots = 64;     // N up to here: the small form, M's tile in registers
constexpr int kSmallThreads = 384;  // a producer warpgroup and two consumer warpgroups
constexpr int kSmallCols = 256;     // state columns per item of the small form
constexpr int kSmallStageBytes = kSmallCols / 64 * kTileBytes;  // 32 KB
constexpr int kSmallStages = 7;
constexpr int kSmallSmem = kSmallStages * kSmallStageBytes + 1024 + 256;
constexpr int kSmemLimit = 232448;   // what a block of the H100 may use
constexpr int kSmemExtra = 1024 + 512;  // 1024-byte alignment, mbarriers (< 60)

// a[y][r][c] = bf16(m[y][r][c]) for c < r < N, 0 elsewhere in [Np, Np], for
// the flat cells e = first, first + step, ... of the ``rows`` matrices.
__device__ __forceinline__ void prep_cells(const float* __restrict__ m, bf16* __restrict__ a,
                                           int N, int Np, int64_t m_bstride, int rows,
                                           int64_t first, int64_t step) {
  const int64_t cells = (int64_t)Np * Np;
  for (int64_t e = first; e < rows * cells; e += step) {
    const int64_t y = e / cells;
    const int r = (int)(e % cells / Np), c = (int)(e % Np);
    const float x = r < N && c < r ? m[y * m_bstride + (int64_t)r * N + c] : 0.f;
    a[e] = __float2bfloat16(x);
  }
}

// M's bf16 copy for K3: grid (ceil(rows * Np^2 / 256)); rows = B for a
// per-row m, else 1. (K3b makes it in the Gram kernel's prologue.)
__global__ void __launch_bounds__(kThreads)
mix_prep_kernel(const float* __restrict__ m, bf16* __restrict__ a, int N, int Np,
                int64_t m_bstride, int rows) {
  prep_cells(m, a, N, Np, m_bstride, rows, (int64_t)blockIdx.x * kThreads + threadIdx.x,
             (int64_t)gridDim.x * kThreads);
}

// Source tile q of output tile J's walk: K3 takes tiles 0 .. J, dS J .. T-1;
// the diagonal tile J, which the walk's step loads just before, comes last.
template <bool kUpper>
__device__ __forceinline__ int walk_src(int J, int q, int steps) {
  if (!kUpper) return q;
  return q < steps - 1 ? J + 1 + q : J;
}

// The slot of M's tile (row block r, column block c <= r) among the
// triangle's tiles the streamed kernel keeps.
__device__ __forceinline__ int tri_slot(int r, int c) { return r * (r + 1) / 2 + c; }

// Round a consumer warpgroup's [64 x 64] float32 output tile to bf16 and
// write it at (column col, row row, batch row b) of ``map`` by one TMA store
// from its staging panel ``panel`` (8 KB, 128-byte swizzle; each warpgroup
// alternates two, so thread 0 waits for the store two tiles back to have read
// this one). Rows past the tensor are not written.
__device__ __forceinline__ void store_tile_tma(const CUtensorMap* map, unsigned char* panel,
                                               const float (&acc)[8][4], int wg, int col,
                                               int row, int b) {
  if (threadIdx.x % 128 == 0) tma_store_wait_read<1>();
  named_sync(1 + wg, 128);
  acc_to_panels<64>(panel, acc);
  fence_async_shared();
  named_sync(1 + wg, 128);
  if (threadIdx.x % 128 == 0) tma_store_4d(map, panel, col, 0, row, b);
}

// out[b, i] = sum_j a[i, j] x[b, j] over kCols-column strips of R for N >
// 256: the forward mix with a = strict lower M (K3), or dS with a = M^T
// (kUpper). A persistent grid walks the strips g = blockIdx.x, + gridDim.x,
// ... (strip g: batch row g / strips_per_row, columns (g % strips_per_row) *
// kCols on), kStripThreads threads, dynamic shared memory from strip_smem:
// ``nbuf`` buffers of the strip's rows, a ring of ``mt`` stages of M's tiles
// and, when ``staged``, the staging panels of the TMA stores. Maps: x and
// out as [B, N, 1, R] (boxes of 64 x 64), the bf16 copy of M as [rows, Np,
// 1, Np] (64 x 64).
template <bool kUpper>
__global__ void __launch_bounds__(kStripThreads, 1)
mix_strip_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_m,
                 const __grid_constant__ CUtensorMap map_out, bf16* __restrict__ out, int N,
                 int Np, int64_t R, int mt, int nbuf, int staged, int m_per_row,
                 int strips_per_row, int strips) {
  constexpr int kHalf = kCols / 2;  // columns per consumer warpgroup
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int64_t buf_bytes = (int64_t)Np * kCols * 2;
  unsigned char* xs = smem;                        // [nbuf][2 panels][Np][64]
  unsigned char* ms = smem + nbuf * buf_bytes;     // [mt][64][64]
  unsigned char* so = ms + mt * kTileBytes;        // [2 warpgroups][2][64][64] when staged
  uint64_t* src_full = reinterpret_cast<uint64_t*>(so + staged * kStageOutBytes);  // [2][kMaxTiles]
  uint64_t* src_empty = src_full + 2 * kMaxTiles;
  uint64_t* full = src_empty + 2;
  uint64_t* empty = full + kMaxStages;
  const int tiles = Np / kTile;

  if (threadIdx.x == 0) {
    for (int i = 0; i < nbuf; ++i) {
      for (int t = 0; t < tiles; ++t) mbar_init(&src_full[i * kMaxTiles + t], 1);
      mbar_init(&src_empty[i], 256);  // every consumer thread releases a strip's rows
    }
    for (int s = 0; s < mt; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x == 256) {  // warp 8: the tiles of M through the ring, in the order of the walk
    int stage = 0;
    uint32_t phase = 0;
    for (int g = blockIdx.x; g < strips; g += gridDim.x) {
      const int bm = m_per_row ? g / strips_per_row : 0;
      for (int t = 0; t < tiles; ++t) {
        const int J = kUpper ? tiles - 1 - t : t, steps = kUpper ? tiles - J : J + 1;
        for (int q = 0; q < steps; ++q) {
          const int I = walk_src<kUpper>(J, q, steps);
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], kTileBytes);
          // K3: rows J, columns I of M; dS: rows I, columns J (read transposed)
          tma_load_4d(ms + stage * kTileBytes, &map_m, &full[stage],
                      (kUpper ? J : I) * kTile, 0, (kUpper ? I : J) * kTile, bm);
          if (++stage == mt) stage = 0, phase ^= 1;
        }
      }
    }
  } else if (threadIdx.x == 288) {  // warp 9: each strip's source rows, a buffer ahead
    for (int g = blockIdx.x, k = 0; g < strips; g += gridDim.x, ++k) {
      const int kb = k % nbuf, use = k / nbuf;
      mbar_wait(&src_empty[kb], (use & 1) ^ 1);
      const int b = g / strips_per_row;
      const int col0 = (g % strips_per_row) * kCols;
      for (int t = 0; t < tiles; ++t) {  // in the order of the walk
        const int I = kUpper ? tiles - 1 - t : t;
        uint64_t* bar = &src_full[kb * kMaxTiles + I];
        mbar_arrive_expect_tx(bar, kTile * kCols * 2);
#pragma unroll
        for (int p = 0; p < kCols / 64; ++p)
          tma_load_4d(xs + kb * buf_bytes + ((int64_t)p * Np + I * kTile) * 128, &map_x, bar,
                      col0 + p * 64, 0, I * kTile, b);
      }
    }
  } else if (threadIdx.x < 256) {  // two consumer warpgroups, kHalf columns each
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int r0 = (t >> 5) * 16 + ((t & 31) >> 2), tg = t & 3;
    int stage = 0, stored = 0;
    uint32_t phase = 0;
    for (int g = blockIdx.x, k = 0; g < strips; g += gridDim.x, ++k) {
      const int kb = k % nbuf;
      const uint32_t src_phase = (k / nbuf) & 1;
      const unsigned char* xw = xs + kb * buf_bytes + (int64_t)wg * (kHalf / 64) * Np * 128;
      const int b = g / strips_per_row;
      bf16* ob = out + (int64_t)b * N * R + (int64_t)(g % strips_per_row) * kCols + wg * kHalf;
      for (int t2 = 0; t2 < tiles; ++t2) {
        const int J = kUpper ? tiles - 1 - t2 : t2, steps = kUpper ? tiles - J : J + 1;
        float acc[kHalf / 8][4];
        int prev = -1;
        wgmma_fence();
        for (int q = 0; q < steps; ++q) {
          const int I = walk_src<kUpper>(J, q, steps);
          mbar_wait(&src_full[kb * kMaxTiles + I], src_phase);
          mbar_wait(&full[stage], phase);
          const unsigned char* mtile = ms + stage * kTileBytes;
          const uint64_t da = kUpper ? desc_mnmajor<kTile>(mtile) : desc_kmajor(mtile, 0);
          const uint64_t db = make_desc(xw + I * kTile * 128, Np * 128, 1024);
#pragma unroll
          for (int s = 0; s < kTile / 16; ++s)
            wgmma_ss<kUpper ? 1 : 0, 1>(
                acc, da + (kUpper ? kstep_mnmajor(s) : kstep_kmajor<kTile>(s)),
                db + kstep_mnmajor(s), q > 0 || s > 0);
          wgmma_commit();
          wgmma_wait<1>();  // the step before this one is done: release its stage
          if (prev >= 0) mbar_arrive(&empty[prev]);
          prev = stage;
          if (++stage == mt) stage = 0, phase ^= 1;
        }
        wgmma_wait<0>();
        fence_acc(acc);
        mbar_arrive(&empty[prev]);
        if (staged) {
          store_tile_tma(&map_out, so + (wg * 2 + (stored++ & 1)) * kTileBytes, acc, wg,
                         (g % strips_per_row) * kCols + wg * kHalf, J * kTile, b);
          continue;
        }
        const int ra = J * kTile + r0, rb = ra + 8;  // no room to stage: 4-byte stores
#pragma unroll
        for (int i = 0; i < kHalf / 8; ++i) {
          const int c = i * 8 + tg * 2;
          if (ra < N)
            *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)ra * R + c) =
                __floats2bfloat162_rn(acc[i][0], acc[i][1]);
          if (rb < N)
            *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)rb * R + c) =
                __floats2bfloat162_rn(acc[i][2], acc[i][3]);
        }
      }
      mbar_arrive(&src_empty[kb]);  // this strip's rows are no longer read
    }
    if (staged && t == 0) tma_store_wait_all();
  }
}

// The same products for 64 < N <= 256 (kT = Np / 64 = 2 to 4 row tiles), streamed:
// every output tile of a strip stays in float32 registers (kT x 32 a
// thread), so each source tile is used once, by all the outputs it feeds,
// as it arrives, and its ring stage is freed at once; the producer keeps a
// ring of kSrcStages source tiles of 64 rows x 128 columns in flight across
// the strips, the loads of the next strip landing while this one's outputs
// are stored. M's triangle stays in shared memory for all the block's
// strips, loaded again only when a per-row M changes with the batch row.
// Source tiles arrive in ascending order; an output's products are summed in
// that order (fixed, so the same bits every run). Shared memory kSrcStages x
// 16 KB + kT (kT + 1) / 2 x 8 KB + kStageOutBytes + kSmemExtra.
template <bool kUpper, int kT>
__global__ void __launch_bounds__(kStripThreads, 1)
mix_stream_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_m,
                  const __grid_constant__ CUtensorMap map_out, int m_per_row,
                  int strips_per_row, int strips) {
  constexpr int kHalf = kCols / 2;
  constexpr int kSrcBytes = kTile * kCols * 2;
  constexpr int kTri = kT * (kT + 1) / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xs = smem;                           // [kSrcStages][2 panels][64][64]
  unsigned char* ms = smem + kSrcStages * kSrcBytes;  // [kTri][64][64]
  unsigned char* so = ms + kTri * kTileBytes;         // [2 warpgroups][2][64][64]
  uint64_t* src_full = reinterpret_cast<uint64_t*>(so + kStageOutBytes);
  uint64_t* src_empty = src_full + kSrcStages;
  uint64_t* m_full = src_empty + kSrcStages;  // [kTri]
  uint64_t* m_empty = m_full + kTri;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kSrcStages; ++i) {
      mbar_init(&src_full[i], 1);
      mbar_init(&src_empty[i], 256);
    }
    for (int i = 0; i < kTri; ++i) mbar_init(&m_full[i], 1);
    mbar_init(m_empty, 256);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x == 256) {  // warp 8: M's triangle, once for each M the block meets
    int cur_bm = -1, loads = 0;
    for (int g = blockIdx.x; g < strips; g += gridDim.x) {
      const int bm = m_per_row ? g / strips_per_row : 0;
      if (bm == cur_bm) continue;
      if (loads > 0) mbar_wait(m_empty, (loads - 1) & 1);
      for (int r = 0; r < kT; ++r)
        for (int c = 0; c <= r; ++c) {
          const int slot = tri_slot(r, c);
          mbar_arrive_expect_tx(&m_full[slot], kTileBytes);
          tma_load_4d(ms + slot * kTileBytes, &map_m, &m_full[slot], c * kTile, 0, r * kTile, bm);
        }
      cur_bm = bm, ++loads;
    }
  } else if (threadIdx.x == 288) {  // warp 9: the source tiles, through the ring
    int stage = 0;
    uint32_t phase = 0;
    for (int g = blockIdx.x; g < strips; g += gridDim.x) {
      const int b = g / strips_per_row, col0 = (g % strips_per_row) * kCols;
      for (int I = 0; I < kT; ++I) {
        mbar_wait(&src_empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&src_full[stage], kSrcBytes);
        unsigned char* dst = xs + stage * kSrcBytes;
        tma_load_4d(dst, &map_x, &src_full[stage], col0, 0, I * kTile, b);
        tma_load_4d(dst + kTileBytes, &map_x, &src_full[stage], col0 + 64, 0, I * kTile, b);
        if (++stage == kSrcStages) stage = 0, phase ^= 1;
      }
    }
  } else if (threadIdx.x < 256) {  // two consumer warpgroups, 64 columns each
    const int wg = threadIdx.x / 128;
    int stage = 0, cur_bm = -1, loads = 0, stored = 0;
    uint32_t phase = 0;
    for (int g = blockIdx.x; g < strips; g += gridDim.x) {
      const int bm = m_per_row ? g / strips_per_row : 0;
      if (bm != cur_bm) {  // done with the last M's triangle
        if (loads > 0) mbar_arrive(m_empty);
        cur_bm = bm, ++loads;
      }
      const uint32_t m_phase = (loads - 1) & 1;
      float acc[kT][kHalf / 8][4];
      int prev = -1;
      wgmma_fence();
      for (int I = 0; I < kT; ++I) {
        mbar_wait(&src_full[stage], phase);
        const uint64_t db = make_desc(xs + stage * kSrcBytes + wg * kTileBytes, 64 * 128, 1024);
#pragma unroll
        for (int J = 0; J < kT; ++J) {
          if (kUpper ? J > I : J < I) continue;  // dS: sources i >= j; K3: i <= j
          const int slot = kUpper ? tri_slot(I, J) : tri_slot(J, I);
          mbar_wait(&m_full[slot], m_phase);
          const unsigned char* mtile = ms + slot * kTileBytes;
          const uint64_t da = kUpper ? desc_mnmajor<kTile>(mtile) : desc_kmajor(mtile, 0);
          const int first = kUpper ? I == J : I == 0;  // this output's first source
#pragma unroll
          for (int s = 0; s < kTile / 16; ++s)
            wgmma_ss<kUpper ? 1 : 0, 1>(
                acc[J], da + (kUpper ? kstep_mnmajor(s) : kstep_kmajor<kTile>(s)),
                db + kstep_mnmajor(s), !first || s > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the source tile before this one is done: release its stage
        if (prev >= 0) mbar_arrive(&src_empty[prev]);
        prev = stage;
        if (++stage == kSrcStages) stage = 0, phase ^= 1;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int J = 0; J < kT; ++J) fence_acc(acc[J]);
      mbar_arrive(&src_empty[prev]);
      const int b = g / strips_per_row, col = (g % strips_per_row) * kCols + wg * kHalf;
#pragma unroll
      for (int J = 0; J < kT; ++J)
        store_tile_tma(&map_out, so + (wg * 2 + (stored++ & 1)) * kTileBytes, acc[J], wg, col,
                       J * kTile, b);
    }
    if (threadIdx.x % 128 == 0) tma_store_wait_all();
  }
}

// The A fragments (wgmma's m64k16 A from registers) of this thread's rows of
// the [64 x 64] tile of M it multiplies by: M's strict lower triangle for K3,
// its transpose for dS (kUpper), rounded to bf16, zero at and past N.
template <bool kUpper, int kSteps>
__device__ __forceinline__ void load_m_frags(uint32_t (&a)[kSteps][4],
                                             const float* __restrict__ m, int N) {
  const int t = threadIdx.x % 128, r0 = (t >> 5) * 16 + ((t & 31) >> 2), tg = t & 3;
  auto at = [&](int r, int c) {  // A[r][c]: M[r][c] (K3) or M[c][r] (dS), strictly lower M
    const int i = kUpper ? c : r, j = kUpper ? r : c;
    return i < N && j < i ? m[i * N + j] : 0.f;
  };
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // rows r0 (q even) and r0 + 8, columns c and c + 8
      const int r = r0 + (q & 1) * 8, c = s * 16 + tg * 2 + (q >> 1) * 8;
      const __nv_bfloat162 v = __floats2bfloat162_rn(at(r, c), at(r, c + 1));
      a[s][q] = *reinterpret_cast<const uint32_t*>(&v);
    }
}

// out[b, i] = sum_j a[i, j] x[b, j] for N <= kSmallSlots: the forward mix
// with a = strict lower M (K3), or dS with a = M^T (kUpper). A persistent
// grid; block k takes the items [k * per, (k + 1) * per) (item = batch row *
// panels + panel of kSmallCols state columns), so a per-row M changes about
// once a block. A producer warp loads each item's
// source rows ([64 rows][kSmallCols], rows past N zero) by TMA into a ring
// of kSmallStages stages; the two consumer warpgroups (240 registers a
// thread, the producer's warpgroup keeping 24) take the items in turn. A
// warpgroup holds M's tile as wgmma A fragments in registers, built
// from the float32 m (no copy of M in device memory, reloaded when a per-row
// M changes), runs kSteps = ceil(N / 16) products m64n256k16 over the stage
// (B read MN-major), rounds the result to bf16 into the same stage, stores
// it by TMA (rows past N are not written) and releases the stage once that
// store has read it, one item later, so a store overlaps the next item's
// products. Maps: x and out as [B, N, 1, R] (boxes of 64 x 64); m [N, N]
// float32, or [B, N, N] with m_bstride = N * N.
template <bool kUpper, int kSteps>
__global__ void __launch_bounds__(kSmallThreads, 1)
mix_small_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_out, const float* __restrict__ m,
                 int N, int64_t R, int64_t m_bstride, int panels, int64_t per,
                 int64_t items) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kSmallStages * kSmallStageBytes);
  uint64_t* empty = full + kSmallStages;
  const int64_t lo = blockIdx.x * per, hi = lo + per < items ? lo + per : items;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kSmallStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);  // the item's store has read the stage
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread loads, the rest give up registers
    regs_dec<24>();
    if (threadIdx.x != 0) return;
    for (int64_t j = 0; lo + j < hi; ++j) {
      const int stage = (int)(j % kSmallStages);
      const int64_t item = lo + j, col0 = item % panels * kSmallCols;
      const int b = (int)(item / panels);
      const int boxes = R - col0 < kSmallCols ? (int)((R - col0) / 64) : kSmallCols / 64;
      mbar_wait(&empty[stage], (uint32_t)(j / kSmallStages & 1) ^ 1);
      mbar_arrive_expect_tx(&full[stage], boxes * kTileBytes);
      unsigned char* st = smem + stage * kSmallStageBytes;
      for (int q = 0; q < boxes; ++q)
        tma_load_4d(st + q * kTileBytes, &map_x, &full[stage], (int)col0 + q * 64, 0, 0, b);
    }
  } else {  // two consumer warpgroups, items in turn
    regs_inc<240>();
    const int wg = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    uint32_t a[kSteps][4];
    int64_t cur = -1;
    int prev = -1;
    for (int64_t j = wg; lo + j < hi; j += 2) {
      const int stage = (int)(j % kSmallStages);
      const int64_t item = lo + j, col0 = item % panels * kSmallCols;
      const int b = (int)(item / panels);
      const int boxes = R - col0 < kSmallCols ? (int)((R - col0) / 64) : kSmallCols / 64;
      const int64_t bm = m_bstride ? b : 0;
      if (bm != cur) {
        load_m_frags<kUpper, kSteps>(a, m + bm * m_bstride, N);
        cur = bm;
      }
      mbar_wait(&full[stage], (uint32_t)(j / kSmallStages & 1));
      unsigned char* st = smem + stage * kSmallStageBytes;
      float acc[kSmallCols / 8][4];
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        wgmma_rs(acc, a[s], desc_mnmajor<kTile>(st) + kstep_mnmajor(s), s > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      fence_frag(a);
      named_sync(1 + wg, 128);  // every warp's products have read the stage
      acc_to_panels<kSmallCols>(st, acc);
      fence_async_shared();
      named_sync(1 + wg, 128);
      if (t == 0) {
        for (int q = 0; q < boxes; ++q)
          tma_store_4d_part(&map_out, st + q * kTileBytes, (int)col0 + q * 64, 0, 0, b);
        tma_store_commit();
        if (prev >= 0) {  // this warpgroup's last item: its store has read its stage
          tma_store_wait_read<1>();
          mbar_arrive(&empty[prev]);
        }
        prev = stage;
      }
    }
    if (t == 0) tma_store_wait_all();
  }
}

// One partial tile of dMs: part[b * splits + s][I-tile rows][J-tile cols] =
// sum over c in R slice s of dmix[b, i, c] * st[b, j, c], for the pair of
// 128-row tiles (I, J <= I) blockIdx.x enumerates (row by row). grid
// (pairs, splits, B), kGramThreads threads: consumer warpgroup w sums rows
// 64 w .. 64 w + 63 of the I tile against all 128 rows of the J tile.
// Maps: dmix and st as [B, N, 1, R] (boxes of 64 x 64); part holds Ng =
// ceil(N / 128) * 128 rows and columns, written below N only. The grid's
// threads first make M's bf16 copy ``a`` for the dS pass (prep_cells).
__global__ void __launch_bounds__(kGramThreads)
gram_partial_kernel(const __grid_constant__ CUtensorMap map_d,
                    const __grid_constant__ CUtensorMap map_s, float* __restrict__ part,
                    int N, int Ng, int64_t R, int64_t slice, int splits,
                    const float* __restrict__ m, bf16* __restrict__ a, int Np,
                    int64_t m_bstride, int m_rows) {
  constexpr int kHalfBytes = 2 * kTileBytes;  // one operand: [128 rows][64 columns]
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kGramStages * 2 * kHalfBytes);
  uint64_t* empty = full + kGramStages;
  int ti = 0, p = blockIdx.x;
  while (p > ti) p -= ++ti;  // pair index -> (ti, tj = p), tj <= ti
  const int tj = p;
  const int s = blockIdx.y, b = blockIdx.z;
  const int64_t c_lo = (int64_t)s * slice, c_hi = c_lo + slice < R ? c_lo + slice : R;
  const int steps = (int)((c_hi - c_lo) / 64);
  // M's bf16 copy for the dS pass that follows, spread over the whole grid
  const int64_t block = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  prep_cells(m, a, N, Np, m_bstride, m_rows, block * kGramThreads + threadIdx.x,
             (int64_t)gridDim.x * gridDim.y * gridDim.z * kGramThreads);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kGramStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warp
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int k = 0; k < steps; ++k) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], 2 * kHalfBytes);
        unsigned char* st = smem + stage * 2 * kHalfBytes;
        const int c0 = (int)(c_lo + k * 64);
        for (int h = 0; h < 2; ++h) {
          tma_load_4d(st + h * kTileBytes, &map_d, &full[stage], c0, 0, ti * 128 + h * kTile, b);
          tma_load_4d(st + kHalfBytes + h * kTileBytes, &map_s, &full[stage], c0, 0,
                      tj * 128 + h * kTile, b);
        }
        if (++stage == kGramStages) stage = 0, phase ^= 1;
      }
    }
  } else {  // two consumer warpgroups, 64 rows of the I tile each
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int r0 = (t >> 5) * 16 + ((t & 31) >> 2), tg = t & 3;
    float acc[16][4];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    int stage = 0, prev = -1;
    uint32_t phase = 0;
    wgmma_fence();
    for (int k = 0; k < steps; ++k) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = smem + stage * 2 * kHalfBytes;
      const uint64_t da = desc_kmajor(st, wg * kTile), db = desc_kmajor(st + kHalfBytes, 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(acc, da + kstep_kmajor<128>(kk), db + kstep_kmajor<128>(kk), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the step before this one is done: release its stage
      if (prev >= 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == kGramStages) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (prev >= 0) mbar_arrive(&empty[prev]);
    float* pb = part + ((int64_t)b * splits + s) * Ng * Ng;
    const int ra = ti * 128 + wg * kTile + r0, rb = ra + 8;
#pragma unroll
    for (int i = 0; i < 16; ++i) {  // the rows and columns below N, which the reduce reads
      const int c = tj * 128 + i * 8 + tg * 2;
      if (c >= N) continue;
      if (ra < N)
        *reinterpret_cast<float2*>(pb + (int64_t)ra * Ng + c) = make_float2(acc[i][0], acc[i][1]);
      if (rb < N)
        *reinterpret_cast<float2*>(pb + (int64_t)rb * Ng + c) = make_float2(acc[i][2], acc[i][3]);
    }
  }
}

// dm[o][i][j] = sum over the batch rows of output o (all of them when
// shared, row o alone when per-row) and the splits, in that fixed order, of
// part[.][i][j] for j < i; 0 for j >= i. grid (ceil(N^2 / 256), outs).
__global__ void __launch_bounds__(kThreads)
gram_reduce_kernel(const float* __restrict__ part, float* __restrict__ dm, int N, int Ng,
                   int splits, int rows_per_out) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (int64_t)N * N) return;
  const int i = (int)(e / N), j = (int)(e % N);
  float acc = 0.f;
  if (j < i) {
    const int64_t first = (int64_t)blockIdx.y * rows_per_out * splits;
    for (int64_t p = first; p < first + (int64_t)rows_per_out * splits; ++p)
      acc += part[p * Ng * Ng + (int64_t)i * Ng + j];
  }
  dm[(int64_t)blockIdx.y * N * N + e] = acc;
}

int round_up64(int n) { return (n + 63) / 64 * 64; }

// The shared memory of a strip block (N > 256), or 0 when one buffer of the
// strip's rows and two ring stages of M do not fit. Two buffers of rows
// where they fit beside four stages and the staging panels (the next strip's
// rows land while this one's outputs are stored: N <= 320), else one; the
// staging panels of the TMA stores where they fit beside two stages (N <=
// 704), else 4-byte stores from the accumulators; as many stages as then
// fit, up to four.
int strip_smem(int Np, int* nbuf, int* mt, int* staged) {
  const int rows = Np * kCols * 2;
  *nbuf = 2 * rows + 4 * kTileBytes + kStageOutBytes + kSmemExtra <= kSmemLimit ? 2 : 1;
  int room = kSmemLimit - *nbuf * rows - kSmemExtra;
  *staged = room >= kStageOutBytes + 2 * kTileBytes;
  room = (room - *staged * kStageOutBytes) / kTileBytes;
  *mt = room < kMaxStages ? room : kMaxStages;
  if (*mt < 2) return 0;
  return *nbuf * rows + *mt * kTileBytes + *staged * kStageOutBytes + kSmemExtra;
}

// A [B, N, 1, R] map of the states with 64 x 64 boxes.
int states_map(CUtensorMap* map, const void* x, int B, int N, int64_t R) {
  return hopper_host::make_tile_map(map, x, B, N, 1, (int)R, kTile);
}

// A persistent grid of the streamed form: as many blocks as fit on the SMs,
// at most one per strip.
template <bool kUpper, int kT>
int launch_stream(const CUtensorMap& mx, const CUtensorMap& mm, const CUtensorMap& mo,
                  int64_t m_bstride, int strips_per_row, int strips, cudaStream_t stream) {
  const int smem = kSrcStages * kTile * kCols * 2 + kT * (kT + 1) / 2 * kTileBytes +
                   kStageOutBytes + kSmemExtra;
  auto kern = mix_stream_kernel<kUpper, kT>;
  int fill = 0;
  const int e = hopper_host::resident_blocks((const void*)kern, kStripThreads, smem, &fill);
  if (e) return e;
  const int grid = strips < fill ? strips : fill;
  kern<<<grid, kStripThreads, smem, stream>>>(mx, mm, mo, m_bstride ? 1 : 0, strips_per_row,
                                              strips);
  return (int)cudaGetLastError();
}

// The small form (N <= kSmallSlots) at kSteps = ceil(N / 16) products a
// stage: the fewest items a block that the SMs' blocks can take, and as
// many blocks as that needs, so every block but the last has the same count
// (the card is not left waiting on a few blocks with one item more).
template <bool kUpper, int kSteps>
int launch_small(const float* m, const CUtensorMap& mx, const CUtensorMap& mo, int B, int N,
                 int64_t R, int64_t m_bstride, cudaStream_t stream) {
  auto kern = mix_small_kernel<kUpper, kSteps>;
  int fill = 0;
  const int e = hopper_host::resident_blocks((const void*)kern, kSmallThreads, kSmallSmem, &fill);
  if (e) return e;
  const int panels = (int)((R + kSmallCols - 1) / kSmallCols);
  const int64_t items = (int64_t)B * panels, per = (items + fill - 1) / fill;
  kern<<<(int)((items + per - 1) / per), kSmallThreads, kSmallSmem, stream>>>(
      mx, mo, m, N, R, m_bstride, panels, per, items);
  return (int)cudaGetLastError();
}

// One product through the small, the streamed or the strip kernel chosen by
// N. The small form builds M's tile from the float32 m itself; the others
// read a bf16 copy ``a`` [rows, Np, Np], made here for K3 (K3b's comes from
// its Gram kernel, which runs first).
template <bool kUpper>
int launch_mix(const float* m, const bf16* x, bf16* out, bf16* a, int B, int N, int64_t R,
               int64_t m_bstride, cudaStream_t stream) {
  CUtensorMap mx, mo, mm;
  int e = states_map(&mx, x, B, N, R);
  if (!e) e = states_map(&mo, out, B, N, R);
  if (e) return e;
  if (N <= kSmallSlots) {
    const int steps = (N + 15) / 16;
    auto launch = steps == 1   ? launch_small<kUpper, 1>
                  : steps == 2 ? launch_small<kUpper, 2>
                  : steps == 3 ? launch_small<kUpper, 3>
                               : launch_small<kUpper, 4>;
    return launch(m, mx, mo, B, N, R, m_bstride, stream);
  }
  const int Np = round_up64(N), tiles = Np / kTile;
  const int rows = m_bstride ? B : 1;
  int nbuf = 0, mt = 0, staged = 0;
  const int smem = tiles <= kStreamTiles ? 0 : strip_smem(Np, &nbuf, &mt, &staged);
  if (tiles > kStreamTiles && smem == 0) return (int)cudaErrorInvalidValue;
  if (!kUpper) {
    const int64_t cells = (int64_t)rows * Np * Np;
    mix_prep_kernel<<<(unsigned)((cells + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        m, a, N, Np, m_bstride, rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  e = hopper_host::make_tile_map(&mm, a, rows, Np, 1, Np, kTile);
  if (e) return e;
  const int strips_per_row = (int)(R / kCols), strips = strips_per_row * B;
  if (tiles <= kStreamTiles) {
    auto launch = tiles == 2   ? launch_stream<kUpper, 2>
                  : tiles == 3 ? launch_stream<kUpper, 3>
                               : launch_stream<kUpper, 4>;
    return launch(mx, mm, mo, m_bstride, strips_per_row, strips, stream);
  }
  auto kern = mix_strip_kernel<kUpper>;
  int fill = 0;
  e = hopper_host::resident_blocks((const void*)kern, kStripThreads, smem, &fill);
  if (e) return e;
  const int grid = strips < fill ? strips : fill;
  kern<<<grid, kStripThreads, smem, stream>>>(mx, mm, mo, out, N, Np, R, mt, nbuf, staged,
                                              m_bstride ? 1 : 0, strips_per_row, strips);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes): each launches on the given
// stream, does not synchronise, returns the first cudaError_t that is not 0.
// N <= kMaxSlotsWide and R % 128 == 0, or cudaErrorInvalidValue; every
// pointer 16-byte aligned (TMA). Scratch from the caller where N >
// kSmallSlots (else unused, may be null): ``a`` bf16 [rows, Np, Np] (rows =
// B for a per-row m, else 1; Np = N rounded up to 64); and ``part`` float32
// [B, splits, Ng, Ng] (Ng = N rounded up to 128) at every N.
extern "C" {

int mhla_mix_states_fwd(const void* m, const void* s, void* out, void* a, int B, int N,
                        long long R, long long m_bstride, void* stream) {
  if (N < 1 || N > kMaxSlotsWide || R % kCols) return (int)cudaErrorInvalidValue;
  return launch_mix<false>((const float*)m, (const bf16*)s, (bf16*)out, (bf16*)a, B, N, R,
                           m_bstride, (cudaStream_t)stream);
}

// dMs over ``splits`` slices of R of ``slice`` columns each (a multiple of
// 64; the last may be shorter, none empty), with M's bf16 copy made in the
// same kernel; then the fixed-order sum of dMs; then dS = Ms^T dmixed.
int mhla_mix_states_bwd(const void* m, const void* dmix, const void* st, void* ds, void* dm,
                        void* a, void* part, int B, int N, long long R, long long m_bstride,
                        int splits, long long slice, void* stream) {
  if (N < 1 || N > kMaxSlotsWide || R % kCols || slice % 64 || splits < 1 ||
      (long long)(splits - 1) * slice >= R)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st_ = (cudaStream_t)stream;
  const int nt = (N + 127) / 128, Ng = nt * 128, Np = round_up64(N);
  CUtensorMap md, ms;
  int e = states_map(&md, dmix, B, N, R);
  if (!e) e = states_map(&ms, st, B, N, R);
  if (e) return e;
  const int smem = kGramStages * 4 * kTileBytes + kSmemExtra;
  int fill = 0;  // (the Gram grid is one block per tile pair, slice and batch row)
  e = hopper_host::resident_blocks((const void*)gram_partial_kernel, kGramThreads, smem, &fill);
  if (e) return e;
  gram_partial_kernel<<<dim3(nt * (nt + 1) / 2, splits, B), kGramThreads, smem, st_>>>(
      md, ms, (float*)part, N, Ng, R, slice, splits, (const float*)m, (bf16*)a, Np, m_bstride,
      N <= kSmallSlots ? 0 : m_bstride ? B : 1);  // the small form makes no copy of M
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the partials' sum while they are still in L2, then dS
  const int outs = m_bstride ? B : 1;
  gram_reduce_kernel<<<dim3((unsigned)(((int64_t)N * N + kThreads - 1) / kThreads), outs),
                       kThreads, 0, st_>>>((const float*)part, (float*)dm, N, Ng, splits,
                                           m_bstride ? 1 : B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_mix<true>((const float*)m, (const bf16*)dmix, (bf16*)ds, (bf16*)a, B, N, R,
                          m_bstride, st_);
}

}  // extern "C"
