// Forward kernels of the causal chunked MHLA op for Hopper (sm_90a):
//
//   K2 chunk_states   S_j = k_j^T v_j                         per chunk, per head
//   K3 mix_states     mixed_i = sum_{j<i} Ms[i, j] S_j        strictly-lower mixing
//   K4 chunk_output   o_i = q_i @ mixed_i + md_i * (bf16(tril(q_i k_i^T)) @ v_i)
//
// Ms is the scaled strict lower triangle of the mixing matrix and md its
// scaled diagonal (the q scale Dk^-0.5 is folded into both by the caller,
// exactly once). All products accumulate in float32; the states, the mixed
// states, the masked scores and the output are rounded to bf16, the rounding
// points of the JAX op (mhla_tpu/ops/mhla_chunk.py:222-247).
//
// Layout: token tensors are head-flat [B, N, C, H*D] (the padded [B, T, H*D]
// rows, chunked by a free reshape); states and mixed are [B, N, H*Dk, Dv].
// Ms and md are shared by the batch, or one per batch row for packed varlen
// rows: K3 and K4 read them with a batch stride (0 when shared), as the JAX
// kernels give their M blocks a batch index (mhla_chunk_pallas.py:726).
//
// What each kernel replaces, what bounds it on the H100 and what the design
// does about it:
//
// K2 replaces _phase_a_kernel (mhla_tpu/kernels/mhla_chunk_pallas.py:101).
//   Bound: bytes. At the 340M serving shape (B=4, T=2048, H=4, Dk=128,
//   Dv=256) it reads 25 MB of k/v and writes 34 MB of states for 2.1 GFLOP,
//   about 36 FLOP/byte, far below the card's ~295 FLOP/byte ridge.
//   Design: one block per (chunk, head, 128-column tile of Dv). Each warp
//   owns 16x16 output tiles and runs the C-long reduction on the tensor
//   cores with WMMA (bf16 in, fp32 accumulate), so arithmetic is never the
//   limit; k/v fragments are read straight from global memory (re-reads
//   hit L1), and the fp32 tile is rounded and written as 16-byte stores.
//
// K3 replaces _mix_kernel, lower form (mhla_chunk_pallas.py:293). The TPU
//   kernel mixes only the far chunks of 256-token supertiles; this port
//   works per chunk, so K3 produces the full strictly-lower mixing and K4
//   adds only the chunk's own diagonal term.
//   Bound: bytes. It reads and writes N * H*Dk*Dv bf16 per sequence with
//   at most N/2 FMAs per element read (N <= 32).
//   Design: one thread per pair of state columns walks all N chunk slots:
//   it loads the column's N values once into registers, forms every row i
//   from the previous j < i (the zero upper triangle is never touched), and
//   writes each output once. Neighbouring threads read neighbouring
//   addresses, so every load and store is coalesced; M sits in shared memory.
//
// K4 replaces _st_fwd_kernel (mhla_chunk_pallas.py:589). The TPU kernel
//   groups 4 chunks into a 256-row supertile to fill its 128x128 MXU; here
//   one block handles one (chunk, head, 128-column tile of Dv).
//   Bound: bytes. It reads q/k/v (25 MB) and mixed (34 MB) and writes o
//   (16 MB) for 4.3 GFLOP at the 340M serving shape.
//   Design: the [C, C] scores never leave the SM: WMMA computes q k^T into
//   fp32 shared memory (blocks above the diagonal are skipped), the block
//   masks and rounds it to bf16, then each warp accumulates
//   md * (P @ v) + q @ mixed for its 16x16 output tiles in one fp32 fragment,
//   skipping the zero blocks of P right of the diagonal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFrag = 16;       // WMMA tile: m = n = k = 16 for bf16
constexpr int kTileN = 128;     // output columns of Dv per block (K2, K4)
constexpr int kMaxSlots = 32;   // K3 keeps one column of every slot in registers

typedef wmma::fragment<wmma::accumulator, kFrag, kFrag, kFrag, float> Acc;
typedef wmma::fragment<wmma::matrix_a, kFrag, kFrag, kFrag, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_a, kFrag, kFrag, kFrag, bf16, wmma::col_major> ACol;
typedef wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, bf16, wmma::col_major> BCol;

// Round a 16x16 fp32 accumulator to bf16 and write it to dst (row stride
// ld elements) through the warp's staging tile, 16 bytes per lane.
__device__ __forceinline__ void store_tile_bf16(const Acc& acc, float* stage,
                                                bf16* dst, int64_t ld) {
  wmma::store_matrix_sync(stage, acc, kFrag, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  __align__(16) bf16 vals[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) vals[i] = __float2bfloat16(stage[r * kFrag + c0 + i]);
  *reinterpret_cast<uint4*>(dst + r * ld + c0) = *reinterpret_cast<const uint4*>(vals);
  __syncwarp();
}

// K2. grid (B*N, H, Dv/kTileN). k: [B,N,C,H*Dk], v: [B,N,C,H*Dv],
// s: [B,N,H*Dk,Dv].
__global__ void __launch_bounds__(kThreads)
chunk_states_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                    bf16* __restrict__ s, int C, int H, int Dk, int Dv) {
  __shared__ __align__(32) float stage[kWarps][kFrag * kFrag];
  const int warp = threadIdx.x >> 5;
  const int64_t bn = blockIdx.x;
  const int h = blockIdx.y, tn = blockIdx.z;
  const int64_t ldk = (int64_t)H * Dk, ldv = (int64_t)H * Dv;
  const bf16* kc = k + bn * C * ldk + h * Dk;
  const bf16* vc = v + bn * C * ldv + h * Dv + tn * kTileN;
  bf16* sc = s + (bn * H + h) * Dk * Dv + tn * kTileN;
  const int mt = Dk / kFrag, nt = kTileN / kFrag;
  for (int f = warp; f < mt * nt; f += kWarps) {
    const int fm = f / nt, fn = f % nt;
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < C; kk += kFrag) {
      ACol a;  // A = k^T: element (m, kk) = k[kk][m], column-major with ld H*Dk
      BRow b;
      wmma::load_matrix_sync(a, kc + kk * ldk + fm * kFrag, (unsigned)ldk);
      wmma::load_matrix_sync(b, vc + kk * ldv + fn * kFrag, (unsigned)ldv);
      wmma::mma_sync(acc, a, b, acc);
    }
    store_tile_bf16(acc, stage[warp], sc + (int64_t)fm * kFrag * Dv + fn * kFrag, Dv);
  }
}

// K3. grid (ceil(R/2 / kThreads), B). m: [N, N] fp32 (strictly lower), or
// [B, N, N] with m_bstride = N*N (0 when shared), its values taken at bf16,
// as the wide form takes them; s, out: [B, N, R] with R = H*Dk*Dv.
__global__ void __launch_bounds__(kThreads)
mix_states_kernel(const float* __restrict__ m, const bf16* __restrict__ s,
                  bf16* __restrict__ out, int N, int64_t R, int64_t m_bstride) {
  __shared__ float ms[kMaxSlots * kMaxSlots];
  const float* mb = m + blockIdx.y * m_bstride;
  for (int e = threadIdx.x; e < N * N; e += blockDim.x)
    ms[e] = __bfloat162float(__float2bfloat16(mb[e]));
  __syncthreads();
  const int64_t pairs = R / 2;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pairs) return;
  const int64_t base = (int64_t)blockIdx.y * N * pairs + p;
  const __nv_bfloat162* src = reinterpret_cast<const __nv_bfloat162*>(s) + base;
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out) + base;
  float2 x[kMaxSlots];
#pragma unroll
  for (int j = 0; j < kMaxSlots; ++j)
    x[j] = j < N ? __bfloat1622float2(src[j * pairs]) : make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kMaxSlots; ++i) {
    if (i < N) {
      float ax = 0.f, ay = 0.f;
#pragma unroll
      for (int j = 0; j < i; ++j) {
        const float w = ms[i * N + j];
        ax = fmaf(w, x[j].x, ax);
        ay = fmaf(w, x[j].y, ay);
      }
      dst[i * pairs] = __floats2bfloat162_rn(ax, ay);
    }
  }
}

// K4. grid (B*N, H, Dv/kTileN); dynamic shared memory C*C*(4 + 2) bytes.
// q, k: [B,N,C,H*Dk]; v, o: [B,N,C,H*Dv]; mixed: [B,N,H*Dk,Dv]; md: [N], or
// [B, N] with md_bstride = N (0 when shared).
__global__ void __launch_bounds__(kThreads)
chunk_output_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ mixed,
                    const float* __restrict__ md, bf16* __restrict__ o, int N,
                    int C, int H, int Dk, int Dv, int md_bstride) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* scores = reinterpret_cast<float*>(smem);    // [C, C] fp32
  bf16* pm = reinterpret_cast<bf16*>(scores + C * C);  // [C, C] masked, bf16
  __shared__ __align__(32) float stage[kWarps][kFrag * kFrag];
  const int warp = threadIdx.x >> 5;
  const int64_t bn = blockIdx.x;
  const int h = blockIdx.y, tn = blockIdx.z;
  const int n = (int)(bn % N);
  const int64_t ldk = (int64_t)H * Dk, ldv = (int64_t)H * Dv;
  const bf16* qc = q + bn * C * ldk + h * Dk;
  const bf16* kc = k + bn * C * ldk + h * Dk;
  const bf16* vc = v + bn * C * ldv + h * Dv + tn * kTileN;
  const bf16* mc = mixed + (bn * H + h) * Dk * Dv + tn * kTileN;
  bf16* oc = o + bn * C * ldv + h * Dv + tn * kTileN;
  const int ct = C / kFrag;

  // 1. scores = q k^T in fp32, lower block triangle only
  for (int f = warp; f < ct * ct; f += kWarps) {
    const int fm = f / ct, fn = f % ct;
    if (fn > fm) continue;
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < Dk; kk += kFrag) {
      ARow a;
      BCol b;  // B = k^T: element (kk, c) = k[c][kk], column-major with ld H*Dk
      wmma::load_matrix_sync(a, qc + fm * kFrag * ldk + kk, (unsigned)ldk);
      wmma::load_matrix_sync(b, kc + fn * kFrag * ldk + kk, (unsigned)ldk);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(scores + fm * kFrag * C + fn * kFrag, acc, C,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // 2. causal mask, rounded to bf16 (only entries c <= r were computed)
  for (int e = threadIdx.x; e < C * C; e += blockDim.x) {
    const int r = e / C, c = e % C;
    pm[e] = __float2bfloat16(c <= r ? scores[e] : 0.f);
  }
  __syncthreads();

  // 3. o = md[n] * (P @ v) + q @ mixed, one fp32 fragment per output tile
  const float mdn = md[(bn / N) * md_bstride + n];
  const int nt = kTileN / kFrag;
  for (int f = warp; f < ct * nt; f += kWarps) {
    const int fm = f / nt, fn = f % nt;
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk <= fm * kFrag; kk += kFrag) {  // P is zero right of the diagonal
      ARow a;
      BRow b;
      wmma::load_matrix_sync(a, pm + fm * kFrag * C + kk, (unsigned)C);
      wmma::load_matrix_sync(b, vc + kk * ldv + fn * kFrag, (unsigned)ldv);
      wmma::mma_sync(acc, a, b, acc);
    }
#pragma unroll
    for (int i = 0; i < acc.num_elements; ++i) acc.x[i] *= mdn;
    for (int kk = 0; kk < Dk; kk += kFrag) {
      ARow a;
      BRow b;
      wmma::load_matrix_sync(a, qc + fm * kFrag * ldk + kk, (unsigned)ldk);
      wmma::load_matrix_sync(b, mc + (int64_t)kk * Dv + fn * kFrag, (unsigned)Dv);
      wmma::mma_sync(acc, a, b, acc);
    }
    store_tile_bf16(acc, stage[warp], oc + (int64_t)fm * kFrag * ldv + fn * kFrag, ldv);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on the given
// stream, does not synchronise, and returns the launch's cudaError_t.
extern "C" {

int mhla_chunk_states(const void* k, const void* v, void* s, int bn, int C,
                      int H, int Dk, int Dv, void* stream) {
  dim3 grid(bn, H, Dv / kTileN);
  chunk_states_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)k, (const bf16*)v, (bf16*)s, C, H, Dk, Dv);
  return (int)cudaGetLastError();
}

int mhla_mix_states(const void* m, const void* s, void* out, int B, int N,
                    long long R, long long m_bstride, void* stream) {
  const long long pairs = R / 2;
  dim3 grid((unsigned)((pairs + kThreads - 1) / kThreads), B);
  mix_states_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)m, (const bf16*)s, (bf16*)out, N, (int64_t)R, (int64_t)m_bstride);
  return (int)cudaGetLastError();
}

int mhla_chunk_output(const void* q, const void* k, const void* v,
                      const void* mixed, const void* md, void* o, int bn, int N,
                      int C, int H, int Dk, int Dv, int md_bstride, void* stream) {
  dim3 grid(bn, H, Dv / kTileN);
  const size_t smem = (size_t)C * C * (sizeof(float) + sizeof(bf16));
  chunk_output_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)mixed,
      (const float*)md, (bf16*)o, N, C, H, Dk, Dv, md_bstride);
  return (int)cudaGetLastError();
}

}  // extern "C"
