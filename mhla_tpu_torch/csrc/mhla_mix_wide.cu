// K3 and K3b for more than 32 chunk slots, for Hopper (sm_90a): the state
// mixing of the chunked MHLA op as products on the tensor cores.
//
//   K3 wide   mixed_i = sum_{j<i} Ms[i, j] S_j                 [N, N] x [N, R]
//   K3b wide  dS_j    = sum_{i>j} Ms[i, j] dmixed_i            [N, N]^T x [N, R]
//             dMs[i, j] = <dmixed_i, S_j>  (i > j)             [N, R] x [R, N]
//
// S, mixed, dmixed, dS: [B, N, R] bf16 with R = H*Dk*Dv (the [B, N, H*Dk, Dv]
// states of csrc/mhla_chunk.cu, flat); Ms: [N, N] float32 holding values
// already rounded to bf16 (the op rounds its scaled strict triangle to the
// compute dtype), shared by the batch or one per batch row (m_bstride =
// N*N); dMs float32 in Ms's shape, summed over the batch when shared. The
// 32-slot kernels of csrc/mhla_chunk.cu and csrc/mhla_chunk_bwd.cu hold a
// column of every slot in registers; these take any N up to kMaxSlotsWide,
// which a context of 32,768 tokens in chunks of 64 (512 slots) reaches at
// every prompt, block or row longer than 2,048 tokens.
//
// Replaces, for N >= 128 with N % 64 == 0 (where the JAX op runs them,
// _mix_use_pallas, mhla_tpu/kernels/mhla_chunk_pallas.py:365-367) and every
// other N > 32: _mix_kernel, lower form (:293) for K3; _mix_bwd_fused_kernel
// (:459), or _mix_kernel in its upper form (:293) with _dm_kernel (:394), for
// K3b. JAX's halving row bands (_mix_bands, :279) keep the TPU's VMEM within
// bounds; here the skipped upper triangle does the same work.
//
// Bound: bytes. At N = 448 (a 28,672-token block) K3 reads and writes
// 2 x 448 x 131,072 bf16 (235 MB) for 448^2 / 2 x 131,072 x 2 = 26 GFLOP:
// 112 FLOP/byte, below the card's bf16 ridge (295 FLOP/byte), as long as
// the products run on the tensor cores; in float32 FMAs it would be bound by
// operations 8x over. K3b moves 1.5x the bytes for twice the operations.
//
// Design:
// - M to bf16 once (mix_prep_kernel): a zero-padded [Np, Np] copy (Np = N
//   rounded up to 64) of the strict lower triangle, or of its transpose for
//   dS, so both products read an A operand that is zero wherever the
//   triangle is. Exact: M's values are bf16 already.
// - K3 and dS (mix_wide_kernel): one block of 8 warps per 128-column strip
//   of R and batch row. The block stages its strip of all N source rows in
//   shared memory (Np x 136 bf16, 139 KB at N = 512) by cp.async, one
//   commit group per 64 rows, issued in the order the block consumes them;
//   it then walks its output rows 64 at a time and waits only for the
//   groups that row tile reads, so later rows land while earlier ones
//   compute. Each warp owns 16 output rows x 64 columns in float32
//   registers and runs mma.sync m16n8k16 (bf16 in, float32 out): A = M's
//   rows read from the bf16 copy (L2-resident, 0.5 MB at N = 512; the next
//   step's fragments are loaded before the current step's products), B =
//   the staged rows by ldmatrix.trans. Steps wholly above the diagonal (K3)
//   or below it (dS) are skipped. Every source element is read from device
//   memory once and every output written once.
// - dMs (gram_partial_kernel, gram_reduce_kernel): a Gram product over R
//   with fixed R slices. Each block takes one 64 x 64 tile on or below the
//   diagonal of dMs and one slice of R, streams 64 columns of dmixed's and
//   S's rows at a time through two cp.async buffers, and writes its float32
//   partial tile; a second pass sums the slices (and, for a shared M, the
//   batch rows) in a fixed order. No atomics, so dMs is the same bit for bit
//   from run to run.
// Not done yet: wgmma, TMA, a wider strip to halve M's reads from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

using namespace flash;

namespace {

constexpr int kThreads = 256;        // 8 warps: 4 row groups x 2 column halves
constexpr int kCols = 128;           // state columns per block of the strip kernels
constexpr int kLdS = kCols + 8;      // shared-memory row stride (elements)
constexpr int kRowTile = 64;         // output rows per step of a strip block
constexpr int kMaxSlotsWide = 832;   // 832 staged rows x 272 bytes = 221 KB
constexpr int kGramThreads = 128;    // 4 warps, 16 rows of a 64 x 64 dMs tile each
constexpr int kGramCols = 64;        // columns of R per stage of the Gram kernel
constexpr int kLdG = kGramCols + 8;

// Wait until at most n of this thread's cp.async groups are in flight (n is
// known only at run time; the instruction takes an immediate).
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    case 10: cp_async_wait<10>(); break;
    case 11: cp_async_wait<11>(); break;
    case 12: cp_async_wait<12>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// a[y][r][c] = bf16(m[y][r][c]) for c < r < N (kUpper false) or
// bf16(m[y][c][r]) for r < c < N (kUpper true), 0 elsewhere in [Np, Np].
// grid (ceil(Np^2 / 256), rows); rows = B for a per-row m, else 1.
template <bool kUpper>
__global__ void __launch_bounds__(kThreads)
mix_prep_kernel(const float* __restrict__ m, bf16* __restrict__ a, int N, int Np,
                int64_t m_bstride) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (int64_t)Np * Np) return;
  const int r = (int)(e / Np), c = (int)(e % Np);
  const float* mb = m + blockIdx.y * m_bstride;
  float x = 0.f;
  if (r < N && c < N) {
    if (!kUpper && c < r) x = mb[(int64_t)r * N + c];
    if (kUpper && c > r) x = mb[(int64_t)c * N + r];
  }
  a[(int64_t)blockIdx.y * Np * Np + e] = __float2bfloat16(x);
}

// out[b, i] = sum_j a[i, j] x[b, j] over one 128-column strip of R: the
// forward mix with a = strict lower M (rows walked first to last), or dS
// with a = M^T strictly upper (kUpper: rows walked last to first).
// grid (R / kCols, B); dynamic shared memory Np * kLdS * 2 bytes.
template <bool kUpper>
__global__ void __launch_bounds__(kThreads)
mix_wide_kernel(const bf16* __restrict__ a, const bf16* __restrict__ x,
                bf16* __restrict__ out, int N, int Np, int64_t R, int64_t a_bstride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16 (*xs)[kLdS] = reinterpret_cast<bf16 (*)[kLdS]>(smem_raw);  // [Np][kLdS]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int lrow = lane & 7, lmat = lane >> 3;
  const int b = blockIdx.y;
  const int64_t col0 = (int64_t)blockIdx.x * kCols;
  const bf16* xb = x + (int64_t)b * N * R + col0;
  bf16* ob = out + (int64_t)b * N * R + col0;
  const bf16* ab = a + b * a_bstride;
  const int ntiles = Np / kRowTile;

  // stage the strip: one commit group per 64 rows, in the order of the walk
  for (int t = 0; t < ntiles; ++t) {
    const int r0 = (kUpper ? ntiles - 1 - t : t) * kRowTile;
#pragma unroll
    for (int i = 0; i < kRowTile * (kCols / 8) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = r0 + e / (kCols / 8), c8 = (e % (kCols / 8)) * 8;
      const bool valid = r < N;
      cp_async16(&xs[r][c8], xb + (valid ? r : 0) * R + c8, valid);
    }
    cp_async_commit();
  }

  const int c_half = warp >> 2;  // this warp's 64 columns of the strip
  for (int t = 0; t < ntiles; ++t) {
    const int ti = kUpper ? ntiles - 1 - t : t;
    cp_async_wait_dyn(ntiles - 1 - t);  // the groups of tiles 0..t have landed
    __syncthreads();
    const int r0 = ti * kRowTile + (warp & 3) * 16;  // this warp's 16 output rows
    // the k range that can hold a nonzero a[r][*]: j < r (lower), j > r (upper)
    const int k_lo = kUpper ? (r0 / 32) * 32 : 0;
    const int k_hi = kUpper ? Np : min(Np, ((r0 + 16 + 31) / 32) * 32);
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const bf16* a0p = ab + (int64_t)(r0 + g) * Np + tg * 2;
    const bf16* a1p = a0p + 8 * (int64_t)Np;
    // A fragments of the steps at k and k + 16, loaded one 32-step ahead
    auto load_a = [&](uint32_t (&f)[2][4], int k) {
      f[0][0] = ld32(a0p + k), f[0][1] = ld32(a1p + k);
      f[0][2] = ld32(a0p + k + 8), f[0][3] = ld32(a1p + k + 8);
      f[1][0] = ld32(a0p + k + 16), f[1][1] = ld32(a1p + k + 16);
      f[1][2] = ld32(a0p + k + 24), f[1][3] = ld32(a1p + k + 24);
    };
    uint32_t af[2][4];
    if (k_lo < k_hi) load_a(af, k_lo);
    for (int k = k_lo; k < k_hi; k += 32) {
      uint32_t cur[2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) cur[0][e] = af[0][e], cur[1][e] = af[1][e];
      if (k + 32 < k_hi) load_a(af, k + 32);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, &xs[k + lmat * 8 + lrow][c_half * 64 + nt * 8]);
        mma_bf16(acc[nt], cur[0], bf[0], bf[1]);
        mma_bf16(acc[nt], cur[1], bf[2], bf[3]);
      }
    }
    const int ra = r0 + g, rb = ra + 8;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = c_half * 64 + nt * 8 + tg * 2;
      if (ra < N)
        *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)ra * R + c) =
            __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
      if (rb < N)
        *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)rb * R + c) =
            __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
    }
  }
}

// One partial tile of dMs: part[b * splits + s][I-tile rows][J-tile cols] =
// sum over c in R slice s of dmix[b, i, c] * st[b, j, c], for the tile pair
// (I, J <= I) blockIdx.x enumerates (row by row). grid (pairs, splits, B).
__global__ void __launch_bounds__(kGramThreads)
gram_partial_kernel(const bf16* __restrict__ dmix, const bf16* __restrict__ st,
                    float* __restrict__ part, int N, int Np, int64_t R, int64_t slice,
                    int splits) {
  __shared__ __align__(16) bf16 ds[2][64][kLdG];
  __shared__ __align__(16) bf16 ss[2][64][kLdG];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int lrow = lane & 7, lmat = lane >> 3;
  int ti = 0, p = blockIdx.x;
  while (p > ti) p -= ++ti;  // pair index -> (ti, tj = p), tj <= ti
  const int tj = p;
  const int s = blockIdx.y, b = blockIdx.z;
  const int64_t c_lo = (int64_t)s * slice, c_hi = c_lo + slice < R ? c_lo + slice : R;
  const bf16* db = dmix + (int64_t)b * N * R;
  const bf16* sb = st + (int64_t)b * N * R;

  auto load = [&](int buf, int64_t c0) {
#pragma unroll
    for (int i = 0; i < 64 * (kGramCols / 8) / kGramThreads; ++i) {
      const int e = tid + i * kGramThreads;
      const int r = e / (kGramCols / 8), c8 = (e % (kGramCols / 8)) * 8;
      const int ri = ti * 64 + r, rj = tj * 64 + r;
      cp_async16(&ds[buf][r][c8], db + (ri < N ? ri : 0) * R + c0 + c8, ri < N);
      cp_async16(&ss[buf][r][c8], sb + (rj < N ? rj : 0) * R + c0 + c8, rj < N);
    }
  };

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  load(0, c_lo);
  cp_async_commit();
  int it = 0;
  for (int64_t c0 = c_lo; c0 < c_hi; c0 += kGramCols, ++it) {
    const int buf = it & 1;
    if (c0 + kGramCols < c_hi) load(buf ^ 1, c0 + kGramCols);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int s2 = 0; s2 < kGramCols / 32; ++s2) {
      uint32_t a0[4], a1[4];
      const bf16* ap = &ds[buf][warp * 16 + (lmat & 1) * 8 + lrow][s2 * 32 + (lmat >> 1) * 8];
      ldmatrix_x4(a0, ap);
      ldmatrix_x4(a1, ap + 16);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bf[4];
        ldmatrix_x4(bf, &ss[buf][nt * 8 + lrow][s2 * 32 + lmat * 8]);
        mma_bf16(acc[nt], a0, bf[0], bf[1]);
        mma_bf16(acc[nt], a1, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this buffer's reads are done before it is refilled
  }
  cp_async_wait<0>();
  float* pb = part + ((int64_t)b * splits + s) * Np * Np;
  const int ra = ti * 64 + warp * 16 + g, rb = ra + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = tj * 64 + nt * 8 + tg * 2;
    *reinterpret_cast<float2*>(pb + (int64_t)ra * Np + c) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(pb + (int64_t)rb * Np + c) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// dm[o][i][j] = sum over the batch rows of output o (all of them when
// shared, row o alone when per-row) and the splits, in that fixed order, of
// part[.][i][j] for j < i; 0 for j >= i. grid (ceil(N^2 / 256), outs).
__global__ void __launch_bounds__(kThreads)
gram_reduce_kernel(const float* __restrict__ part, float* __restrict__ dm, int N, int Np,
                   int splits, int rows_per_out) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (int64_t)N * N) return;
  const int i = (int)(e / N), j = (int)(e % N);
  float acc = 0.f;
  if (j < i) {
    const int64_t first = (int64_t)blockIdx.y * rows_per_out * splits;
    for (int64_t p = first; p < first + (int64_t)rows_per_out * splits; ++p)
      acc += part[p * Np * Np + (int64_t)i * Np + j];
  }
  dm[(int64_t)blockIdx.y * N * N + e] = acc;
}

int round_up64(int n) { return (n + 63) / 64 * 64; }

// The prep and the strip kernel for one product; ``a`` bf16 scratch
// [rows, Np, Np].
template <bool kUpper>
cudaError_t launch_mix(const float* m, const bf16* x, bf16* out, bf16* a, int B, int N,
                       int64_t R, int64_t m_bstride, cudaStream_t stream) {
  const int Np = round_up64(N);
  const int rows = m_bstride ? B : 1;
  const int64_t cells = (int64_t)Np * Np;
  mix_prep_kernel<kUpper><<<dim3((unsigned)((cells + kThreads - 1) / kThreads), rows),
                            kThreads, 0, stream>>>(m, a, N, Np, m_bstride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = Np * kLdS * (int)sizeof(bf16);
  err = cudaFuncSetAttribute(mix_wide_kernel<kUpper>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  mix_wide_kernel<kUpper><<<dim3((unsigned)(R / kCols), B), kThreads, smem, stream>>>(
      a, x, out, N, Np, R, m_bstride ? cells : 0);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes): each launches on the given
// stream, does not synchronise, returns the first cudaError_t that is not 0.
// N <= kMaxSlotsWide and R % 128 == 0, or cudaErrorInvalidValue. Scratch
// from the caller: ``a`` bf16 [rows, Np, Np] (rows = B for a per-row m, else
// 1; Np = N rounded up to 64), ``part`` float32 [B, splits, Np, Np].
extern "C" {

int mhla_mix_states_wide(const void* m, const void* s, void* out, void* a, int B, int N,
                         long long R, long long m_bstride, void* stream) {
  if (N < 1 || N > kMaxSlotsWide || R % kCols) return (int)cudaErrorInvalidValue;
  return (int)launch_mix<false>((const float*)m, (const bf16*)s, (bf16*)out, (bf16*)a, B, N,
                                R, m_bstride, (cudaStream_t)stream);
}

// dS = Ms^T dmixed, then dMs over ``splits`` slices of R of ``slice``
// columns each (a multiple of 64; splits * slice >= R).
int mhla_mix_states_wide_bwd(const void* m, const void* dmix, const void* st, void* ds,
                             void* dm, void* a, void* part, int B, int N, long long R,
                             long long m_bstride, int splits, long long slice, void* stream) {
  if (N < 1 || N > kMaxSlotsWide || R % kCols || slice % kGramCols || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st_ = (cudaStream_t)stream;
  cudaError_t err = launch_mix<true>((const float*)m, (const bf16*)dmix, (bf16*)ds, (bf16*)a,
                                     B, N, R, m_bstride, st_);
  if (err != cudaSuccess) return (int)err;
  const int Np = round_up64(N), nt = Np / 64;
  gram_partial_kernel<<<dim3(nt * (nt + 1) / 2, splits, B), kGramThreads, 0, st_>>>(
      (const bf16*)dmix, (const bf16*)st, (float*)part, N, Np, R, slice, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int outs = m_bstride ? B : 1;
  gram_reduce_kernel<<<dim3((unsigned)(((int64_t)N * N + kThreads - 1) / kThreads), outs),
                       kThreads, 0, st_>>>((const float*)part, (float*)dm, N, Np, splits,
                                           m_bstride ? 1 : B);
  return (int)cudaGetLastError();
}

}  // extern "C"
