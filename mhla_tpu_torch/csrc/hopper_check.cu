// One-tile checks of the wgmma operand layouts of hopper.cuh over tiles
// loaded by TMA, for each layout the flash-attention kernels, K2, K2b,
// K3 / K3b and K6 use; the card tests hold each against torch.matmul. A wrong
// descriptor offset, swizzle or fragment order gives a wrong product here,
// where it is one product and not one step of a softmax.

#include "hopper.cuh"

using namespace hopper;

namespace {

typedef __nv_bfloat16 bf16;

// Store a warpgroup's [64 x N] accumulator row-major into c.
template <int N>
__device__ void store_c(float* c, const float (&acc)[N / 8][4]) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2), tg = lane & 3;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int col = i * 8 + tg * 2;
    c[r0 * N + col] = acc[i][0];
    c[r0 * N + col + 1] = acc[i][1];
    c[(r0 + 8) * N + col] = acc[i][2];
    c[(r0 + 8) * N + col + 1] = acc[i][3];
  }
}

// C[64 x N] = A[rows kARows - 64 .. kARows) B^T: a [kARows][K] and b [N][K]
// tiles, both K-major in shared memory (S = q k^T and its kin).
template <int kARows, int N, int K>
__global__ void __launch_bounds__(128)
ss_check_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, float* c) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* as = smem;
  unsigned char* bs = smem + kARows * K * 2;
  uint64_t* bar = reinterpret_cast<uint64_t*>(bs + N * K * 2);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, (kARows + N) * K * 2);
    tma_load_tile<K, kARows>(as, &map_a, bar, 0, 0, 0);
    tma_load_tile<K, N>(bs, &map_b, bar, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  float acc[N / 8][4];
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < K / 16; ++s)
    wgmma_ss(acc, desc_kmajor(as, kARows - 64) + kstep_kmajor<kARows>(s),
             desc_kmajor(bs, 0) + kstep_kmajor<N>(s), s > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  store_c<N>(c, acc);
}

// C[64 x N] = A B: A [64][K] row-major in device memory, taken into
// registers as A fragments; b a [K][N] tile read MN-major (P V and its kin).
template <int N, int K>
__global__ void __launch_bounds__(128)
rs_check_kernel(const bf16* __restrict__ a, const __grid_constant__ CUtensorMap map_b,
                float* c) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* bs = smem;
  uint64_t* bar = reinterpret_cast<uint64_t*>(bs + K * N * 2);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, K * N * 2);
    tma_load_tile<N, K>(bs, &map_b, bar, 0, 0, 0);
  }
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2), tg = lane & 3;
  uint32_t af[K / 16][4];
#pragma unroll
  for (int s = 0; s < K / 16; ++s) {
    const int col = s * 16 + tg * 2;
    af[s][0] = *reinterpret_cast<const uint32_t*>(a + r0 * K + col);
    af[s][1] = *reinterpret_cast<const uint32_t*>(a + (r0 + 8) * K + col);
    af[s][2] = *reinterpret_cast<const uint32_t*>(a + r0 * K + col + 8);
    af[s][3] = *reinterpret_cast<const uint32_t*>(a + (r0 + 8) * K + col + 8);
  }
  mbar_wait(bar, 0);
  float acc[N / 8][4];
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < K / 16; ++s)
    wgmma_rs(acc, af[s], desc_mnmajor<K>(bs) + kstep_mnmajor(s), s > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  fence_frag(af);
  store_c<N>(c, acc);
}

// C[64 x N] = A B with both operands in shared memory in either form: A
// K-major [64][K] or (kTransA) MN-major, the last 64 columns of a [K][kAW]
// tile (M^T read from M's rows; K2's k^T of the second 64 rows of Dk at kAW
// = 128); B K-major [N][K] or (kTransB) MN-major [K][N].
template <int kTransA, int kTransB, int N, int K, int kAW = 64>
__global__ void __launch_bounds__(128)
ss_t_check_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, float* c) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* as = smem;
  unsigned char* bs = smem + kAW * K * 2;
  uint64_t* bar = reinterpret_cast<uint64_t*>(bs + N * K * 2);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, (kAW + N) * K * 2);
    if (kTransA) tma_load_tile<kAW, K>(as, &map_a, bar, 0, 0, 0);
    else tma_load_tile<K, 64>(as, &map_a, bar, 0, 0, 0);
    if (kTransB) tma_load_tile<N, K>(bs, &map_b, bar, 0, 0, 0);
    else tma_load_tile<K, N>(bs, &map_b, bar, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  const unsigned char* a_panel = as + (kTransA ? (kAW / 64 - 1) * K * 128 : 0);
  float acc[N / 8][4];
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < K / 16; ++s)
    wgmma_ss<kTransA, kTransB>(
        acc,
        kTransA ? desc_mnmajor<K>(a_panel) + kstep_mnmajor(s)
                : desc_kmajor(as, 0) + kstep_kmajor<64>(s),
        kTransB ? desc_mnmajor<K>(bs) + kstep_mnmajor(s) : desc_kmajor(bs, 0) + kstep_kmajor<N>(s),
        s > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  store_c<N>(c, acc);
}

// K6's TF32 product on one tile: C[64 x 40] = A B with A = a^T, a a [32][64]
// float32 tile of S loaded by TMA as K6 loads its stages (a k-step of 8 rows
// a stage, in 128-byte swizzled panels of 32 columns) and read transposed
// into registers as K6 reads them, and B = b^T, b [40][32] float32 (M's rows,
// split into TF32 hi and lo by the threads into a K-major swizzled panel as
// K6 splits M). kPasses 3: hi hi + hi lo + lo hi (K6's float32 form); 1: hi
// hi alone, one TF32 product.
template <int kPasses>
__global__ void __launch_bounds__(128)
tf32_check_kernel(const __grid_constant__ CUtensorMap map_a, const float* __restrict__ b,
                  float* c) {
  constexpr int kN = 40, kK = 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* as = smem;                  // 4 k-steps x 2 panels of [8][32]
  unsigned char* bhi = smem + 8 * 1024;      // [40][32]
  unsigned char* blo = bhi + kN * 128;
  uint64_t* bar = reinterpret_cast<uint64_t*>(blo + kN * 128);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, 8 * 1024);
    for (int ks = 0; ks < kK / 8; ++ks)
      for (int p = 0; p < 2; ++p)
        tma_load_4d(as + (ks * 2 + p) * 1024, &map_a, bar, p * 32, ks * 8, 0, 0);
  }
  for (int e = threadIdx.x; e < kN * kK; e += 128) {
    uint32_t hi, lo;
    split_tf32(b[e], hi, lo);
    const int off = swizzle128_f32(e / kK, e % kK);
    *reinterpret_cast<uint32_t*>(bhi + off) = hi;
    *reinterpret_cast<uint32_t*>(blo + off) = lo;
  }
  fence_async_shared();
  __syncthreads();
  mbar_wait(bar, 0);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, tg = lane & 3;
  uint32_t ahi[kK / 8][4], alo[kK / 8][4];
#pragma unroll
  for (int ks = 0; ks < kK / 8; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = warp * 16 + g + 8 * (e & 1), j = tg + 4 * (e >> 1);
      split_tf32(*reinterpret_cast<const float*>(as + (ks * 2 + (r >> 5)) * 1024 +
                                                  swizzle128_f32(j, r & 31)),
                 ahi[ks][e], alo[ks][e]);
    }
  float acc[kN / 8][4];
  const uint64_t dhi = desc_kmajor(bhi, 0), dlo = desc_kmajor(blo, 0);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kK / 8; ++ks) {
    const uint64_t off = kstep_kmajor<kN>(ks);
    wgmma_tf32(acc, ahi[ks], dhi + off, ks > 0);
    if (kPasses == 3) {
      wgmma_tf32(acc, ahi[ks], dlo + off, 1);
      wgmma_tf32(acc, alo[ks], dhi + off, 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  fence_frag(ahi);
  fence_frag(alo);
  store_c<kN>(c, acc);
}

template <int kPasses>
int launch_tf32(const void* a, const void* b, float* c, cudaStream_t stream) {
  CUtensorMap ma;
  const int err = hopper_host::make_rows_map(&ma, a, 0, 1, 32, 64, 8);
  if (err) return err;
  const int smem = 8 * 1024 + 2 * 40 * 128 + 1024 + 64;
  auto kern = tf32_check_kernel<kPasses>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, 128, smem, stream>>>(ma, (const float*)b, c);
  return (int)cudaGetLastError();
}

template <int kARows, int N, int K>
int launch_ss(const void* a, const void* b, float* c, cudaStream_t stream) {
  CUtensorMap ma, mb;
  int err = hopper_host::make_tile_map(&ma, a, 1, kARows, 1, K, kARows);
  if (!err) err = hopper_host::make_tile_map(&mb, b, 1, N, 1, K, N);
  if (err) return err;
  const int smem = (kARows + N) * K * 2 + 1024 + 64;
  auto kern = ss_check_kernel<kARows, N, K>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, 128, smem, stream>>>(ma, mb, c);
  return (int)cudaGetLastError();
}

template <int N, int K>
int launch_rs(const void* a, const void* b, float* c, cudaStream_t stream) {
  CUtensorMap mb;
  const int err = hopper_host::make_tile_map(&mb, b, 1, K, 1, N, K);
  if (err) return err;
  const int smem = K * N * 2 + 1024 + 64;
  auto kern = rs_check_kernel<N, K>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, 128, smem, stream>>>((const bf16*)a, mb, c);
  return (int)cudaGetLastError();
}

template <int kTransA, int kTransB, int N, int K, int kAW = 64>
int launch_ss_t(const void* a, const void* b, float* c, cudaStream_t stream) {
  CUtensorMap ma, mb;
  int err = kTransA ? hopper_host::make_tile_map(&ma, a, 1, K, 1, kAW, K)
                    : hopper_host::make_tile_map(&ma, a, 1, 64, 1, K, 64);
  if (!err)
    err = kTransB ? hopper_host::make_tile_map(&mb, b, 1, K, 1, N, K)
                  : hopper_host::make_tile_map(&mb, b, 1, N, 1, K, N);
  if (err) return err;
  const int smem = (kAW + N) * K * 2 + 1024 + 64;
  auto kern = ss_t_check_kernel<kTransA, kTransB, N, K, kAW>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, 128, smem, stream>>>(ma, mb, c);
  return (int)cudaGetLastError();
}

}  // namespace

// ``layout`` picks the product (the kernels that use it in brackets):
//   0: ss, a [128][128] (rows 64..127), b [128][128]   (K9 S at D = 128)
//   1: ss, a [128][256] (rows 64..127), b [64][256]    (K9 S at D = 256)
//   2: ss, a [128][128] (rows 64..127), b [64][128]    (K9b dQ's S, dP at D = 128)
//   3: ss, a [64][128], b [128][128]                   (K9b dK/dV's S^T, dP^T at D = 128)
//   4: ss, a [64][256], b [64][256]                    (K9b's S^T, dP^T, S, dP at D = 256)
//   5: rs, a [64][128], b [128][128]                   (K9 P V, K9b's dV, dK at D = 128)
//   6: rs, a [64][64], b [64][256]                     (K9 P V, K9b's three at D = 256;
//                                                       K3 / dS at N <= 64)
//   7: rs, a [64][64], b [64][128]                     (K9b's dQ at D = 128)
//   8: ss, a [64][128], b [128][128] MN-major          (K2b's dv at Dk = 128)
//   9: ss, a [64][256], b [256][128] MN-major          (K2b's dv at Dk = 256)
//  10: ss, a [64][128], b [256][128]                   (K2b's dk at Dk = 256)
//  11: ss, a [64][64] MN-major, b [64][64] MN-major    (wide dS, 128 columns)
//  12: ss, a [64][64] MN-major, b [64][128] MN-major   (wide dS, 256 columns)
//  13: ss, a [64][64], b [64][64] MN-major             (wide K3, 128 columns)
//  14: ss, a [64][128] MN-major (its columns 64..127), b [64][128] MN-major
//                                                      (K2's second 64 rows of Dk)
//  15: tf32, a [32][64] float32 MN-major, b [40][32] float32, three products
//                                                      (K6's float32 form)
//  16: the same, one product (hi hi alone)
// An MN-major a [K][W] gives A = (a^T)[W - 64 .. W); an MN-major b [K][N]
// gives B = b (else B = b^T). Layouts 0-14 take bf16, 15 and 16 float32. c
// gets the float32 [64 x N] product. Returns a cudaError_t.
extern "C" int mhla_wgmma_check(int layout, const void* a, const void* b, float* c,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (layout) {
    case 0: return launch_ss<128, 128, 128>(a, b, c, s);
    case 1: return launch_ss<128, 64, 256>(a, b, c, s);
    case 2: return launch_ss<128, 64, 128>(a, b, c, s);
    case 3: return launch_ss<64, 128, 128>(a, b, c, s);
    case 4: return launch_ss<64, 64, 256>(a, b, c, s);
    case 5: return launch_rs<128, 128>(a, b, c, s);
    case 6: return launch_rs<256, 64>(a, b, c, s);
    case 7: return launch_rs<128, 64>(a, b, c, s);
    case 8: return launch_ss_t<0, 1, 128, 128>(a, b, c, s);
    case 9: return launch_ss_t<0, 1, 128, 256>(a, b, c, s);
    case 10: return launch_ss_t<0, 0, 256, 128>(a, b, c, s);
    case 11: return launch_ss_t<1, 1, 64, 64>(a, b, c, s);
    case 12: return launch_ss_t<1, 1, 128, 64>(a, b, c, s);
    case 13: return launch_ss_t<0, 1, 64, 64>(a, b, c, s);
    case 14: return launch_ss_t<1, 1, 128, 64, 128>(a, b, c, s);
    case 15: return launch_tf32<3>(a, b, c, s);
    case 16: return launch_tf32<1>(a, b, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
