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
// delta_prep_kernel, one block (a warpgroup) per (chunk, head) item, three
//   on an SM: everything of a chunk that does not depend on the state. q and k
//   arrive by TMA; kk = k k^T and qk = q k^T on bf16 wgmma; A in float32
//   with its decays formed from differences of G on the accumulator
//   (exp(G_i - G_j), never e^G e^-G: e^-G overflows float32 at delta-rule
//   decay magnitudes); T = (I + A)^-1 in float32 FMAs (the solve is a
//   cancelling sum that must not pass through bf16 or TF32), blocked: the
//   four 16 x 16 diagonal blocks by forward substitution, one thread a
//   column, then the three block rows below, each two float32 products of
//   16 x 16 blocks, unrolled: 7 barriers where row-by-row substitution
//   takes 63. Then w = T (beta e^G k) on wgmma, P = qk exp(G_i - G_j) scale
//   (j <= i), qd = q e^G scale and kc = k e^{G_last - G}, each rounded to
//   bf16 into one record per item (delta_common.cuh), in the layout the
//   chain loads (qd and kc by 16-byte stores, the rest by bulk copies).
//
// delta_fwd_chain_kernel, one block per (batch row, head, 64-column Dv
//   panel): the sequential part. The TPU carries S in VMEM across a
//   sequential grid; here one consumer warpgroup walks the chain's chunks
//   and holds the transposed state S^T (the panel's 64 Dv rows by 128 Dk
//   columns) as wgmma accumulators, so every chained product reads the
//   state and v_eff from registers (wgmma's A operand from registers, the
//   accumulator of one product being the A fragments of the next):
//     v_eff^T = (beta v)^T T^T - bf16(S^T) w^T     (A: v^T by ldmatrix.trans)
//     o^T     = bf16(S^T) qd^T + bf16(v_eff^T) P^T
//     S^T     = e^{G_last} S^T + bf16(v_eff^T) kc
//   each B operand a tile of the chunk's record read in the orientation
//   wgmma takes (K-major or MN-major), no transposed copies. A producer warp
//   keeps the next chunk's record (one bulk copy) and v panel (TMA) in
//   flight in a two-stage mbarrier ring, so a chunk's loads overlap the
//   previous chunk's products. o and, in the training form, bf16(S) at
//   every chunk entry leave through stmatrix.trans into swizzled staging
//   tiles and TMA stores.
//
// Bound at [8, 2048, 4, 128|256] bf16: bytes. q, k, v and o and the entry
// states are ~168 MB (0.050 ms at 3.35 TB/s); the products are ~20 GFLOP
// (0.021 ms at 989 TFLOP/s bf16). The records (66 KB an item, 68 MB) are
// this design's own traffic, written once and read by the Dv / 64 chain
// blocks of a head from L2. The chain's time is its walk: B H Dv / 64 blocks
// (128 at the training shape) each walk N chunks, each chunk two dependent
// products.
//
// Rounding points, those of the TPU kernel: T, w, P, qd, kc, beta v and
// beta e^G k in bf16; u and v_eff summed in float32, v_eff rounded before
// each product; S carried in float32 and rounded before each product. The
// plain version (kernels/delta_chunk.py delta_chunk_fwd_plain) does the same.

#include "delta_common.cuh"

using namespace delta;

namespace {

constexpr int kLdA = kMaxC + 1;  // float row stride of A and T in the solve

// shared memory of the prep, byte offsets
struct PrepSmem {
  static constexpr int kQ = 0;               // q; then P and T in bf16
  static constexpr int kK = kQ + kCK;        // k, then beta e^G k
  static constexpr int kA = kK + kCK;        // A in float32; then w's tile
  static constexpr int kTf = kA + kMaxC * kLdA * 4;  // T in float32
  static constexpr int kX = kTf + kMaxC * kLdA * 4;  // a block row's partial products
  static constexpr int kG = kX + 16 * 48 * 4;        // G, beta
  static constexpr int kBar = kG + 2 * kMaxC * 4;
  static constexpr int kBytes = kBar + 16 + 1024;    // + alignment slack: three blocks an SM
  static_assert(kMaxC * kLdA * 4 >= kCK, "w's tile over A");
};

// x's two bf16 halves times f0 (low) and f1 (high), rounded back.
__device__ __forceinline__ uint32_t scale2(uint32_t x, float f0, float f1) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&x);
  return pack_bf16(__low2float(v) * f0, __high2float(v) * f1);
}

// grid B*N*H (item = (b N + n) H + h), 128 threads. maps: q, k [B, N*C, H,
// Dk] bf16, boxes of C tokens; G, beta [B, N*C, H] float32; rec: the
// records [B, N, H, kRecBytes].
__global__ void __launch_bounds__(128, 3)
delta_prep_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k, const float* __restrict__ G,
                  const float* __restrict__ beta, unsigned char* __restrict__ rec, int N, int C,
                  int H) {
  typedef PrepSmem L;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char *qs = sm + L::kQ, *ks = sm + L::kK, *ps = sm + L::kQ, *ts = sm + L::kQ + kCC,
                *wsm = sm + L::kA;
  float* af = reinterpret_cast<float*>(sm + L::kA);
  float* tf = reinterpret_cast<float*>(sm + L::kTf);
  float* xs = reinterpret_cast<float*>(sm + L::kX);
  float* gs = reinterpret_cast<float*>(sm + L::kG);
  float* bs = gs + kMaxC;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::kBar);

  const int tid = threadIdx.x;
  const int64_t item = blockIdx.x, bn = item / H;
  const int h = item % H, b = bn / N, n = bn % N;
  const float scale = 1.0f / sqrtf((float)kDk);
  unsigned char* out = rec + item * kRecBytes;

  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  if (C < kMaxC) {
    zero_tail(qs, 2, C, tid, 128);
    zero_tail(ks, 2, C, tid, 128);
  }
  if (tid < kMaxC) {
    gs[tid] = tid < C ? G[(bn * C + tid) * H + h] : 0.f;
    bs[tid] = tid < C ? beta[(bn * C + tid) * H + h] : 0.f;
  }
  fence_async_shared();
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, 2 * 2 * C * 128);
    tma_load_cols<kDk, kMaxC>(qs, &map_q, bar, 0, n * C, h, b);
    tma_load_cols<kDk, kMaxC>(ks, &map_k, bar, 0, n * C, h, b);
  }
  // the gates: beta (zero past C), e^{G_last}
  reinterpret_cast<float*>(out + kRecGates)[tid] =
      tid < kMaxC ? bs[tid] : (tid == kElOffset ? expf(gs[C - 1]) : 0.f);
  mbar_wait(bar, 0);

  // 1. kk = k k^T, qk = q k^T
  float kk[8][4], qk[8][4];
  {
    const uint64_t dk = desc_kmajor(ks, 0), dq = desc_kmajor(qs, 0);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kDk / 16; ++s)
      wgmma_ss(kk, dk + kstep_kmajor<kMaxC>(s), dk + kstep_kmajor<kMaxC>(s), s > 0);
#pragma unroll
    for (int s = 0; s < kDk / 16; ++s)
      wgmma_ss(qk, dq + kstep_kmajor<kMaxC>(s), dk + kstep_kmajor<kMaxC>(s), s > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(kk);
    fence_acc(qk);
  }

  // 2. A = kk exp(G_i - G_j) beta_i (j < i) in float32
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = acc_row(e), c = acc_col(i, e);
      af[r * kLdA + c] = c < r ? kk[i][e] * expf(gs[r] - gs[c]) * bs[r] : 0.f;
    }

  // 3. qd = q e^G scale and kc = k e^{G_last - G} straight to the record,
  //    beta e^G k over k: elementwise by row, so over the tiles' 16-byte
  //    chunks, in the record's layout
  const float gl = gs[C - 1];
  for (int e = tid; e < kCK / 16; e += 128) {
    const int off = e * 16, r = (off % kCC) / 128;
    float x[8], y[8];
    load8(qs + off, x);
    const float fq = expf(gs[r]) * scale;
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] *= fq;
    store8(out + kRecQd + off, x);
    load8(ks + off, x);
    const float fc = expf(gl - gs[r]), fw = expf(gs[r]) * bs[r];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      y[i] = x[i] * fc;
      x[i] *= fw;
    }
    store8(out + kRecKc + off, y);
    store8(ks + off, x);
  }
  __syncthreads();  // q is read: P goes over it

  // 4. P = qk exp(G_i - G_j) scale (j <= i) in bf16
  acc_to_panels<kMaxC>(ps, qk, [&](int r, int c, float x) {
    return c <= r ? x * (expf(gs[r] - gs[c]) * scale) : 0.f;
  });

  // 5. T = (I + A)^-1. The diagonal blocks T_II = (I + A_II)^-1 by forward
  //    substitution, one thread a column: x_i = -sum_{m < i} A_im x_m.
  if (tid < kMaxC) {
    const int o = (tid >> 4) * 16, c = tid & 15;
    float x[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < i; ++m) s = fmaf(af[(o + i) * kLdA + o + m], x[m], s);
      x[i] = i < c ? 0.f : (i == c ? 1.f : -s);
      tf[(o + i) * kLdA + o + c] = x[i];
    }
  }
  __syncthreads();
  // the blocks below the diagonal, block row by block row:
  // T_IJ = -T_II X_IJ, X_IJ = sum_{J <= M < I} A_IM T_MJ; thread tid takes
  // row (tid / 16 + 8 (kq % 2)), column tid % 16 of block J = kq / 2
  const int rr = tid >> 4, cc = tid & 15;
#pragma unroll
  for (int I = 1; I < 4; ++I) {
    const int o = 16 * I;
#pragma unroll
    for (int kq = 0; kq < 2 * I; ++kq) {
      const int J = kq >> 1, r = rr + 8 * (kq & 1);
      float s = 0.f;
#pragma unroll
      for (int m = 16 * J; m < o; ++m)
        s = fmaf(af[(o + r) * kLdA + m], tf[m * kLdA + 16 * J + cc], s);
      xs[r * 48 + 16 * J + cc] = s;
    }
    __syncthreads();
#pragma unroll
    for (int kq = 0; kq < 2 * I; ++kq) {
      const int J = kq >> 1, r = rr + 8 * (kq & 1);
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < 16; ++m)  // T_II is zero above its diagonal
        s = fmaf(tf[(o + r) * kLdA + o + m], xs[m * 48 + 16 * J + cc], s);
      tf[(o + r) * kLdA + 16 * J + cc] = -s;
    }
    __syncthreads();
  }

  // 6. T in bf16 (zero above the diagonal and past C)
  for (int e = tid; e < kMaxC * kMaxC / 2; e += 128) {
    const int r = e >> 5, c = (e & 31) * 2;
    const float t0 = c <= r && r < C ? tf[r * kLdA + c] : 0.f;
    const float t1 = c + 1 <= r && r < C ? tf[r * kLdA + c + 1] : 0.f;
    *reinterpret_cast<uint32_t*>(ts + swizzle128(r, c)) = pack_bf16(t0, t1);
  }
  fence_async_shared();
  __syncthreads();
  if (tid == 0) {
    bulk_store(out + kRecP, ps, kCC);
    bulk_store(out + kRecT, ts, kCC);
    tma_store_commit();
  }

  // 7. w = T (beta e^G k)
  float wa[16][4];
  {
    const uint64_t dt = desc_kmajor(ts, 0), db = desc_mnmajor<kMaxC>(ks);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kMaxC / 16; ++s)
      wgmma_ss<0, 1>(wa, dt + kstep_kmajor<kMaxC>(s), db + kstep_mnmajor(s), s > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(wa);
  }
  acc_to_panels<kDk>(wsm, wa);
  fence_async_shared();
  __syncthreads();
  if (tid == 0) {
    bulk_store(out + kRecW, wsm, kCK);
    tma_store_commit();
    tma_store_wait_all();
  }
}

// shared memory of the forward chain, byte offsets: a ring stage holds one
// chunk's record and its v panel
struct ChainSmem {
  static constexpr int kStages = 2;
  static constexpr int kV = kRecSpan;                // the v panel [64][64]
  static constexpr int kStage = kV + kCC;
  static constexpr int kO = kStages * kStage;        // o staging [2][64][64]
  static constexpr int kS = kO + 2 * kCC;            // entry-state staging [2][128][64]
  static constexpr int kBar = kS + 2 * 2 * kCC;
  static constexpr int kBytes = kBar + 64 + 1024;
  static_assert(kBytes <= kSmemLimit, "one block's shared memory");
};

// grid B*H*(Dv/64) (block = (b H + h) Dv/64 + panel), 160 threads: the
// consumer warpgroup, then the producer warp. maps: v (read), o (written)
// [B, N*C, H, Dv] bf16, boxes of 64 columns by C tokens; st: the entry
// states [B, N, H, Dk, Dv] bf16 as [B N H Dk] rows, boxes of 64 columns by
// 128 rows. rec: the prep's records; s0, s_final [B, H, Dk, Dv] float32.
__global__ void __launch_bounds__(160, 1)
delta_fwd_chain_kernel(const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_o,
                       const __grid_constant__ CUtensorMap map_st,
                       const unsigned char* __restrict__ rec, const float* __restrict__ s0,
                       float* __restrict__ s_final, int keep_states, int N, int C, int H,
                       int Dv) {
  typedef ChainSmem L;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + L::kStages;

  const int panels = Dv / kPanel;
  const int p = blockIdx.x % panels, h = blockIdx.x / panels % H, b = blockIdx.x / panels / H;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);  // every consumer thread releases the stage
    }
    fence_barrier_init();
  }
  if (C < kMaxC)
    for (int s = 0; s < L::kStages; ++s) zero_tail(sm + s * L::kStage + L::kV, 1, C, tid, 160);
  fence_async_shared();
  __syncthreads();

  if (tid >= 128) {  // the producer warp: its lane 0 keeps the ring full
    if (tid == 128)
      for (int n = 0; n < N; ++n) {
        const int s = n % L::kStages;
        mbar_wait(&empty[s], ((n / L::kStages) & 1) ^ 1);
        unsigned char* st = sm + s * L::kStage;
        const int64_t item = ((int64_t)b * N + n) * H + h;
        mbar_arrive_expect_tx(&full[s], kRecBytes + C * 128);
        bulk_load(st, rec + item * kRecBytes, kRecBytes, &full[s]);
        tma_load_4d(st + L::kV, &map_v, &full[s], p * kPanel, h, n * C, b);
      }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int64_t sbh = ((int64_t)b * H + h) * kDk * Dv + p * kPanel;
  // S^T: row = this panel's Dv column, column = Dk row
  float S[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[i][e] = s0[sbh + (int64_t)acc_col(i, e) * Dv + acc_row(e)];

  for (int n = 0; n < N; ++n) {
    const int s = n % L::kStages;
    const int64_t item = ((int64_t)b * N + n) * H + h;
    mbar_wait(&full[s], (n / L::kStages) & 1);
    const unsigned char* st = sm + s * L::kStage;
    const float* gt = reinterpret_cast<const float*>(st + kRecGates);

    // (beta v)^T as A fragments: v^T by ldmatrix.trans, times beta per token
    uint32_t va[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      ldsm_x4_t(va[ks], st + L::kV + swizzle128(x4_row(ks, lane), x4_col(warp, lane)));
      const int tk = 16 * ks + 2 * (lane & 3);
      va[ks][0] = scale2(va[ks][0], gt[tk], gt[tk + 1]);
      va[ks][1] = scale2(va[ks][1], gt[tk], gt[tk + 1]);
      va[ks][2] = scale2(va[ks][2], gt[tk + 8], gt[tk + 9]);
      va[ks][3] = scale2(va[ks][3], gt[tk + 8], gt[tk + 9]);
    }
    // bf16(S^T) as A fragments; in the training form also the entry state
    uint32_t sb[8][4];
    acc_frags<kDk>(sb, S);
    unsigned char* ss = sm + L::kS + s * 2 * kCC;
    if (keep_states)
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        stsm_x4_t(ss + swizzle128(x4_row(ks, lane), x4_col(warp, lane)), sb[ks]);

    // v_eff^T = (beta v)^T T^T - bf16(S^T) w^T;  o^T = bf16(S^T) qd^T
    float av[8][4], ao[8][4];
    const uint64_t dT = desc_kmajor(st + kRecT, 0), dW = desc_kmajor(st + kRecW, 0),
                   dQ = desc_kmajor(st + kRecQd, 0), dP = desc_kmajor(st + kRecP, 0),
                   dKc = desc_mnmajor<kMaxC>(st + kRecKc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs<0>(av, va[ks], dT + kstep_kmajor<kMaxC>(ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) wgmma_rs<0, 1>(av, sb[ks], dW + kstep_kmajor<kMaxC>(ks), 1);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) wgmma_rs<0>(ao, sb[ks], dQ + kstep_kmajor<kMaxC>(ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(av);
    fence_acc(ao);
    fence_frag(va);
    fence_frag(sb);

    // S^T = e^{G_last} S^T + bf16(v_eff^T) kc;  o^T += bf16(v_eff^T) P^T
    uint32_t vf[4][4];
    acc_frags<kMaxC>(vf, av);
    const float el = gt[kElOffset];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[i][e] *= el;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs<1>(S, vf[ks], dKc + kstep_mnmajor(ks), 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs<0>(ao, vf[ks], dP + kstep_kmajor<kMaxC>(ks), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(S);
    fence_acc(ao);
    fence_frag(vf);
    mbar_arrive(&empty[s]);

    // o = (o^T)^T through stmatrix.trans into [tokens][64] staging, then TMA
    unsigned char* os = sm + L::kO + s * kCC;
    uint32_t of[4][4];
    acc_frags<kMaxC>(of, ao);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      stsm_x4_t(os + swizzle128(x4_row(ks, lane), x4_col(warp, lane)), of[ks]);
    fence_async_shared();
    // the stores of the chunk before have read their staging (this chunk's
    // writes went to the other buffers; the next chunk's go to theirs)
    if (tid == 0) tma_store_wait_read<0>();
    named_sync(1, 128);
    if (tid == 0) {
      tma_store_4d_part(&map_o, os, p * kPanel, h, n * C, b);
      if (keep_states) tma_store_4d_part(&map_st, ss, p * kPanel, (int)(item * kDk), 0, 0);
      tma_store_commit();
    }
  }

  float* fin = s_final + sbh;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) fin[(int64_t)acc_col(i, e) * Dv + acc_row(e)] = S[i][e];
  if (tid == 0) tma_store_wait_all();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on the given
// stream, does not synchronise, and returns a cudaError_t.
extern "C" {

int mhla_delta_prep(const void* q, const void* k, const void* G, const void* beta, void* rec,
                    int B, int N, int C, int H, int Dk, void* stream) {
  if (Dk != kDk || C % 16 || C <= 0 || C > kMaxC) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  int err = hopper_host::resident_blocks((const void*)delta_prep_kernel, 128, PrepSmem::kBytes,
                                         &blocks);
  CUtensorMap map_q, map_k;
  if (!err) err = hopper_host::make_tile_map(&map_q, q, B, N * C, H, kDk, C);
  if (!err) err = hopper_host::make_tile_map(&map_k, k, B, N * C, H, kDk, C);
  if (err) return err;
  delta_prep_kernel<<<B * N * H, 128, PrepSmem::kBytes, (cudaStream_t)stream>>>(
      map_q, map_k, (const float*)G, (const float*)beta, (unsigned char*)rec, N, C, H);
  return (int)cudaGetLastError();
}

int mhla_delta_fwd_chain(const void* rec, const void* v, const void* s0, void* o, void* s_final,
                         void* states, int B, int N, int C, int H, int Dv, void* stream) {
  if (Dv % kPanel || Dv <= 0 || C % 16 || C <= 0 || C > kMaxC) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  int err = hopper_host::resident_blocks((const void*)delta_fwd_chain_kernel, 160,
                                         ChainSmem::kBytes, &blocks);
  CUtensorMap map_v, map_o, map_st;
  if (!err) err = hopper_host::make_tile_map(&map_v, v, B, N * C, H, Dv, C);
  if (!err) err = hopper_host::make_tile_map(&map_o, o, B, N * C, H, Dv, C);
  // without entry states the map is never read: any valid tensor will do
  if (!err)
    err = hopper_host::make_rows_map(&map_st, states ? states : o, 1, 1,
                                     states ? B * N * H * kDk : kDk, Dv, kDk);
  if (err) return err;
  delta_fwd_chain_kernel<<<B * H * (Dv / kPanel), 160, ChainSmem::kBytes, (cudaStream_t)stream>>>(
      map_v, map_o, map_st, (const unsigned char*)rec, (const float*)s0, (float*)s_final,
      states != nullptr, N, C, H, Dv);
  return (int)cudaGetLastError();
}

}  // extern "C"
