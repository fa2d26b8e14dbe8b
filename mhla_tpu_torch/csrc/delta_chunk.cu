// K11: forward of the chunked (WY-form) gated delta rule for Hopper (sm_90a).
//
// Replaces _delta_fwd_kernel (mhla_tpu/kernels/delta_chunk_pallas.py:126),
// called through _delta_fused_fwd_impl (:475-535). Per chunk of C tokens
// and per head, with G the within-chunk inclusive cumsum of g and
// scale = Dk^-0.5:
//
//   A     = beta_i (k_i . k_j) exp(G_i - G_j), j < i      T = (I + A)^-1
//   u     = T (beta v);   w = T (beta e^G k)
//   v_eff = u - w S
//   o     = (q e^G scale) S + ((q k^T) exp(G_i - G_j) scale, j <= i) v_eff
//   S     = e^{G_last} S + (k e^{G_last - G})^T v_eff
//
// Two launches:
//
// delta_prep_kernel, grid (B*N, H), 256 threads: everything of a chunk that
//   does not depend on the state. kk = k k^T on the tensor cores (bf16 in,
//   float32 sums); A in float32 with its decays formed from differences of
//   G (exp(G_i - G_j), never e^G e^-G: e^-G overflows at delta-rule decay
//   magnitudes); T = (I + A)^-1 by forward substitution in float32 FMAs,
//   row by row, four threads per column of the row (C^3/6 multiply-adds,
//   not the 10 C^3 of the five Neumann squarings the TPU runs: the solve is
//   a cancelling sum that must not pass through bf16 or TF32); then
//   w = T (beta e^G k), P = (q k^T) exp(G_i - G_j) scale masked to j <= i,
//   qd = q e^G scale and kc = k e^{G_last - G}, each rounded to bf16 and
//   written per (chunk, head) as [B, N, H, C, C|Dk], together with T.
//
// delta_fwd_chain_kernel, grid (Dv/64, H, B), 256 threads: the sequential
//   part. The TPU carries S in VMEM across a sequential (batch, supertile)
//   grid; here one block owns one chain and loops over its chunks. The Dv
//   columns of the chain are independent (T, w, P, qd and kc depend on q,
//   k, g and beta only; v_eff, o and the update of S act column by column),
//   so each block owns a 64-column tile: B*H*Dv/64 blocks, 128 at the
//   training shape [8, 2048, 4, 128|256] on the H100's 132 SMs (one block
//   per SM: 150 KB of shared memory). Per chunk it reads the prep pass's
//   quantities (72 KB, L2-resident: the four tiles of a chain read the
//   same), forms u = T (beta v) for its tile, and runs the three chained
//   products v_eff = u - w bf16(S), o = qd bf16(S) + P bf16(v_eff) and
//   S = e^{G_last} S + kc^T bf16(v_eff) on the tensor cores, S in float32
//   shared memory. In the training form it writes bf16(S) at every chunk
//   entry, the backward's residual ([B, N, H, Dk, Dv], 67 MB per layer at
//   the training shape).
//
// Bound at [8, 2048, 4, 128|256] bf16: bytes. q, k, v and o are ~101 MB
// (0.030 ms at 3.35 TB/s); the products are ~20 GFLOP (0.021 ms at 989
// TFLOP/s bf16); the solve by substitution ~0.1 GFLOP of float32 FMAs.
// A chunk's tiles arrive by cp.async, every copy of the block in flight at
// once (synchronous 16-byte loads paid one L2 round trip each, 18 a thread
// per chunk). What this version does not do: overlap a chunk's loads with
// the previous chunk's products, wgmma, or TMA.
//
// Rounding points, those of the TPU kernel: T, w, P, qd, kc, beta v and
// beta e^G k in bf16; u and v_eff summed in float32, v_eff rounded before
// each product; S carried in float32 and rounded before each product. The
// plain version (kernels/delta_chunk.py delta_chunk_fwd_plain) does the same.

#include "delta_common.cuh"

using namespace delta;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

constexpr size_t kPrepSmem =
    (size_t)3 * kMaxC * kLdK * sizeof(bf16)      // q, k, beta e^G k
    + (size_t)kMaxC * kLdC * sizeof(bf16)        // T in bf16
    + (size_t)2 * kMaxC * kLdCf * sizeof(float)  // kk -> A -> qk; T in float32
    + (size_t)kWarps * 256 * sizeof(float)       // staging
    + (size_t)2 * kMaxC * sizeof(float);         // G, beta

// grid (B*N, H). q, k: [B, N*C, H, Dk] bf16; G, beta: [B, N*C, H] float32;
// tc, p: [B, N, H, C, C] bf16; w, qd, kc: [B, N, H, C, Dk] bf16.
__global__ void __launch_bounds__(kThreads)
delta_prep_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const float* __restrict__ G, const float* __restrict__ beta,
                  bf16* __restrict__ tc, bf16* __restrict__ w, bf16* __restrict__ p,
                  bf16* __restrict__ qd, bf16* __restrict__ kc, int C, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kMaxC * kLdK;
  bf16* ws = ks + kMaxC * kLdK;          // beta e^G k
  bf16* tcs = ws + kMaxC * kLdK;         // T in bf16
  float* af = reinterpret_cast<float*>(tcs + kMaxC * kLdC);  // kk -> A -> qk
  float* tf = af + kMaxC * kLdCf;        // T in float32
  float* stage = tf + kMaxC * kLdCf;
  float* gs = stage + kWarps * 256;
  float* bs = gs + kMaxC;

  const int warp = threadIdx.x >> 5;
  const int64_t bn = blockIdx.x;
  const int h = blockIdx.y;
  const int64_t ldq = (int64_t)H * kDk;
  const int64_t pc = bn * H + h;  // this (chunk, head) in the prep outputs
  const float scale = 1.0f / sqrtf((float)kDk);
  const int ct = C / kFrag;

  load_rows(qs, kLdK, q + (bn * C * H + h) * kDk, ldq, C, kDk);
  load_rows(ks, kLdK, k + (bn * C * H + h) * kDk, ldq, C, kDk);
  for (int r = threadIdx.x; r < C; r += blockDim.x) {
    gs[r] = G[(bn * C + r) * H + h];
    bs[r] = beta[(bn * C + r) * H + h];
  }
  sync_loads();

  // 1. kk = k k^T (blocks on and below the diagonal)
  for (int f = warp; f < ct * ct; f += kWarps) {
    const int fm = f / ct, fn = f % ct;
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    if (fn <= fm) mma_tile<false, true>(acc, ks, kLdK, ks, kLdK, fm * kFrag, fn * kFrag, kDk);
    wmma::store_matrix_sync(af + fm * kFrag * kLdCf + fn * kFrag, acc, kLdCf,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // 2. A = kk exp(G_i - G_j) beta_i, strictly lower; T = I
  for (int e = threadIdx.x; e < C * C; e += blockDim.x) {
    const int i = e / C, j = e % C;
    af[i * kLdCf + j] = j < i ? af[i * kLdCf + j] * expf(gs[i] - gs[j]) * bs[i] : 0.f;
    tf[i * kLdCf + j] = i == j ? 1.f : 0.f;
  }
  __syncthreads();

  // 3. T = (I + A)^-1 by forward substitution: T[i, j] = -sum_{j<=m<i}
  //    A[i, m] T[m, j] for j < i; four threads per column j, one row a step
  {
    const int j = threadIdx.x >> 2, part = threadIdx.x & 3;
    for (int i = 1; i < C; ++i) {
      float s = 0.f;
      if (j < i)
        for (int m = j + part; m < i; m += 4) s = fmaf(af[i * kLdCf + m], tf[m * kLdCf + j], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (part == 0 && j < i) tf[i * kLdCf + j] = -s;
      __syncthreads();
    }
  }

  // 4. T and beta e^G k in bf16
  for (int e = threadIdx.x; e < C * C; e += blockDim.x) {
    const int i = e / C, j = e % C;
    tcs[i * kLdC + j] = __float2bfloat16(tf[i * kLdCf + j]);
  }
  for (int e = threadIdx.x; e < C * kDk / 8; e += blockDim.x) {
    const int r = e / (kDk / 8), d = (e % (kDk / 8)) * 8;
    float x[8];
    load8(ks + r * kLdK + d, x);
    const float f = expf(gs[r]) * bs[r];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] *= f;
    store8(ws + r * kLdK + d, x);
  }
  __syncthreads();

  // 5. w = T (beta e^G k) -> global; qk = q k^T -> af; T -> global
  bf16* wg = w + pc * C * kDk;
  for (int f = warp; f < ct * (kDk / kFrag); f += kWarps) {
    const int fm = f / (kDk / kFrag), fn = f % (kDk / kFrag);
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    mma_tile<false, false>(acc, tcs, kLdC, ws, kLdK, fm * kFrag, fn * kFrag, C);
    store_bf16(acc, stage + warp * 256, wg + fm * kFrag * kDk + fn * kFrag, kDk);
  }
  for (int f = warp; f < ct * ct; f += kWarps) {
    const int fm = f / ct, fn = f % ct;
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    if (fn <= fm) mma_tile<false, true>(acc, qs, kLdK, ks, kLdK, fm * kFrag, fn * kFrag, kDk);
    wmma::store_matrix_sync(af + fm * kFrag * kLdCf + fn * kFrag, acc, kLdCf,
                            wmma::mem_row_major);
  }
  store_rows(tc + pc * C * C, C, tcs, kLdC, C, C);
  __syncthreads();

  // 6. P = qk exp(G_i - G_j) scale (j <= i), qd = q e^G scale, kc = k e^{G_last - G}
  bf16* pg = p + pc * C * C;
  for (int e = threadIdx.x; e < C * C; e += blockDim.x) {
    const int i = e / C, j = e % C;
    pg[e] = __float2bfloat16(j <= i ? af[i * kLdCf + j] * (expf(gs[i] - gs[j]) * scale) : 0.f);
  }
  bf16* qdg = qd + pc * C * kDk;
  bf16* kcg = kc + pc * C * kDk;
  for (int e = threadIdx.x; e < C * kDk / 8; e += blockDim.x) {
    const int r = e / (kDk / 8), d = (e % (kDk / 8)) * 8;
    float x[8];
    load8(qs + r * kLdK + d, x);
    const float fq = expf(gs[r]) * scale;
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] *= fq;
    store8(qdg + r * kDk + d, x);
    load8(ks + r * kLdK + d, x);
    const float fk = expf(gs[C - 1] - gs[r]);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] *= fk;
    store8(kcg + r * kDk + d, x);
  }
}

constexpr size_t kChainSmem =
    (size_t)kDk * kLdCf * sizeof(float)          // S
    + (size_t)kDk * kLdC * sizeof(bf16)          // bf16(S)
    + (size_t)4 * kMaxC * kLdC * sizeof(bf16)    // T, P, beta v, bf16(v_eff)
    + (size_t)3 * kMaxC * kLdK * sizeof(bf16)    // w, qd, kc
    + (size_t)kWarps * 256 * sizeof(float);      // staging

// grid (Dv / kTile, H, B). Prep outputs as above; v, o: [B, N*C, H, Dv]
// bf16; s0, s_final: [B, H, Dk, Dv] float32; states (or null):
// [B, N, H, Dk, Dv] bf16.
__global__ void __launch_bounds__(kThreads)
delta_fwd_chain_kernel(const bf16* __restrict__ tc, const bf16* __restrict__ w,
                       const bf16* __restrict__ p, const bf16* __restrict__ qd,
                       const bf16* __restrict__ kc, const bf16* __restrict__ v,
                       const float* __restrict__ G, const float* __restrict__ beta,
                       const float* __restrict__ s0, bf16* __restrict__ o,
                       float* __restrict__ s_final, bf16* __restrict__ states, int N, int C,
                       int H, int Dv) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sf = reinterpret_cast<float*>(smem);             // S [Dk, kTile]
  bf16* zc = reinterpret_cast<bf16*>(sf + kDk * kLdCf);   // bf16(S)
  bf16* tcs = zc + kDk * kLdC;
  bf16* ps = tcs + kMaxC * kLdC;
  bf16* vb = ps + kMaxC * kLdC;                           // bf16(beta v)
  bf16* ve = vb + kMaxC * kLdC;                           // bf16(v_eff)
  bf16* ws = ve + kMaxC * kLdC;
  bf16* qds = ws + kMaxC * kLdK;
  bf16* kcs = qds + kMaxC * kLdK;
  float* stage = reinterpret_cast<float*>(kcs + kMaxC * kLdK) + (threadIdx.x >> 5) * 256;

  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int64_t ldv = (int64_t)H * Dv;
  const int ct = C / kFrag;

  const float* s0c = s0 + ((int64_t)b * H + h) * kDk * Dv + col0;
  for (int e = threadIdx.x; e < kDk * kTile; e += blockDim.x)
    sf[(e / kTile) * kLdCf + e % kTile] = s0c[(int64_t)(e / kTile) * Dv + e % kTile];
  __syncthreads();

  for (int n = 0; n < N; ++n) {
    const int64_t bn = (int64_t)b * N + n, pc = bn * H + h;
    load_rows(tcs, kLdC, tc + pc * C * C, C, C, C);
    load_rows(ps, kLdC, p + pc * C * C, C, C, C);
    load_rows(ws, kLdK, w + pc * C * kDk, kDk, C, kDk);
    load_rows(qds, kLdK, qd + pc * C * kDk, kDk, C, kDk);
    load_rows(kcs, kLdK, kc + pc * C * kDk, kDk, C, kDk);
    const bf16* vc = v + (bn * C * H + h) * Dv + col0;
    for (int e = threadIdx.x; e < C * kTile / 8; e += blockDim.x) {
      const int r = e / (kTile / 8), c = (e % (kTile / 8)) * 8;
      float x[8];
      load8(vc + r * ldv + c, x);
      const float bt = beta[(bn * C + r) * H + h];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] *= bt;
      store8(vb + r * kLdC + c, x);
    }
    bf16* st = states ? states + pc * kDk * Dv + col0 : nullptr;
    for (int e = threadIdx.x; e < kDk * kTile / 8; e += blockDim.x) {
      const int r = e / (kTile / 8), c = (e % (kTile / 8)) * 8;
      float x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = sf[r * kLdCf + c + i];
      store8(zc + r * kLdC + c, x);
      if (st) store8(st + (int64_t)r * Dv + c, x);
    }
    const float el = expf(G[(bn * C + C - 1) * H + h]);
    sync_loads();

    // v_eff = T (beta v) - w bf16(S)
    for (int f = warp; f < ct * (kTile / kFrag); f += kWarps) {
      const int m0 = (f / (kTile / kFrag)) * kFrag, n0 = (f % (kTile / kFrag)) * kFrag;
      Acc u, ws_;
      wmma::fill_fragment(u, 0.0f);
      wmma::fill_fragment(ws_, 0.0f);
      mma_tile<false, false>(u, tcs, kLdC, vb, kLdC, m0, n0, C);
      mma_tile<false, false>(ws_, ws, kLdK, zc, kLdC, m0, n0, kDk);
#pragma unroll
      for (int i = 0; i < u.num_elements; ++i) u.x[i] -= ws_.x[i];
      store_bf16(u, stage, ve + m0 * kLdC + n0, kLdC);
    }
    __syncthreads();

    // o = qd bf16(S) + P bf16(v_eff); S = e^{G_last} S + kc^T bf16(v_eff)
    for (int f = warp; f < ct * (kTile / kFrag); f += kWarps) {
      const int m0 = (f / (kTile / kFrag)) * kFrag, n0 = (f % (kTile / kFrag)) * kFrag;
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
      mma_tile<false, false>(acc, qds, kLdK, zc, kLdC, m0, n0, kDk);
      mma_tile<false, false>(acc, ps, kLdC, ve, kLdC, m0, n0, C);
      store_bf16(acc, stage, o + ((bn * C + m0) * H + h) * Dv + col0 + n0, ldv);
    }
    for (int f = warp; f < (kDk / kFrag) * (kTile / kFrag); f += kWarps) {
      const int m0 = (f / (kTile / kFrag)) * kFrag, n0 = (f % (kTile / kFrag)) * kFrag;
      Acc acc;
      wmma::load_matrix_sync(acc, sf + m0 * kLdCf + n0, kLdCf, wmma::mem_row_major);
#pragma unroll
      for (int i = 0; i < acc.num_elements; ++i) acc.x[i] *= el;
      mma_tile<true, false>(acc, kcs, kLdK, ve, kLdC, m0, n0, C);
      wmma::store_matrix_sync(sf + m0 * kLdCf + n0, acc, kLdCf, wmma::mem_row_major);
    }
    __syncthreads();
  }

  float* sfin = s_final + ((int64_t)b * H + h) * kDk * Dv + col0;
  for (int e = threadIdx.x; e < kDk * kTile; e += blockDim.x)
    sfin[(int64_t)(e / kTile) * Dv + e % kTile] = sf[(e / kTile) * kLdCf + e % kTile];
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on the given
// stream, does not synchronise, and returns the launch's cudaError_t.
extern "C" {

int mhla_delta_prep(const void* q, const void* k, const void* G, const void* beta, void* tc,
                    void* w, void* p, void* qd, void* kc, int B, int N, int C, int H, int Dk,
                    void* stream) {
  if (Dk != kDk || C % kFrag || C > kMaxC) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(delta_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kPrepSmem);
  dim3 grid(B * N, H);
  delta_prep_kernel<<<grid, kThreads, kPrepSmem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const float*)G, (const float*)beta, (bf16*)tc,
      (bf16*)w, (bf16*)p, (bf16*)qd, (bf16*)kc, C, H);
  return (int)cudaGetLastError();
}

int mhla_delta_fwd_chain(const void* tc, const void* w, const void* p, const void* qd,
                         const void* kc, const void* v, const void* G, const void* beta,
                         const void* s0, void* o, void* s_final, void* states, int B, int N,
                         int C, int H, int Dv, void* stream) {
  if (Dv % kTile || C % kFrag || C > kMaxC) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(delta_fwd_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kChainSmem);
  dim3 grid(Dv / kTile, H, B);
  delta_fwd_chain_kernel<<<grid, kThreads, kChainSmem, (cudaStream_t)stream>>>(
      (const bf16*)tc, (const bf16*)w, (const bf16*)p, (const bf16*)qd, (const bf16*)kc,
      (const bf16*)v, (const float*)G, (const float*)beta, (const float*)s0, (bf16*)o,
      (float*)s_final, (bf16*)states, N, C, H, Dv);
  return (int)cudaGetLastError();
}

}  // extern "C"
