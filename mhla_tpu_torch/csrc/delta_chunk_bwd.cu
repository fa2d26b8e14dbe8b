// K11b: backward of the chunked (WY-form) gated delta rule for Hopper
// (sm_90a).
//
// Replaces _delta_bwd_kernel (mhla_tpu/kernels/delta_chunk_pallas.py:207),
// called through _delta_bwd_impl (:538-621). It gives dq, dk, dv, dG, dbeta
// and ds0 with respect to the normed q / k and the within-chunk cumsum G;
// the L2 norm and the cumsum are differentiated outside, as in JAX.
//
// The TPU walks supertiles in reverse on a sequential grid, carries the
// state cotangent dS in VMEM, replays the forward states from the
// supertile-entry residuals and forms every gradient of a chunk in the same
// step. Here the only sequential part is the dS chain, so it runs alone and
// hands each chunk's exit cotangent to a fully parallel gradients pass.
// After the forward's prep pass (delta_prep_kernel in delta_chunk.cu,
// recomputed: the records of T, w, P, qd, kc and the gates):
//
// delta_bwd_chain_kernel, one block per (batch row, head, 64-column Dv
//   panel), the forward chain's design in reverse: one consumer warpgroup
//   holds dS^T (64 Dv rows by 128 Dk columns) as wgmma accumulators and per
//   chunk forms
//     dv_eff^T = dO^T P + bf16(dS^T) kc^T
//     dS^T     = e^{G_last} dS^T + dO^T qd - bf16(dv_eff^T) w
//   (dO^T and P, qd, w read MN-major from shared memory, dS^T and dv_eff^T
//   from registers), fed by a producer warp through a two-stage ring (one
//   bulk copy of the record, a TMA load of the dO panel); bf16(dS) at every
//   chunk exit leaves by stmatrix.trans and a TMA store.
//
// delta_bwd_grads_kernel, one block per (chunk, head) item, two consumer
//   warpgroups, every product on bf16 wgmma over TMA tiles. The item's T, P,
//   w, kc, q and k arrive once; then the Dv panels of its entry state S, its
//   exit cotangent dS, v and dO stream through a two-stage ring, and per
//   panel warpgroup 0 forms u = T bf16(beta v) and v_eff = bf16(u - w S)
//   and sums dkc += v_eff dS^T and dw += dv_eff S^T, while warpgroup 1 forms
//   dv_eff = bf16(P^T dO + kc dS), dmu = T^T dv_eff (dv = bf16(beta dmu) out)
//   and sums dqd += dO S^T, dP += dO v_eff^T and dA_u += bf16(dmu) bf16(u)^T;
//   the bf16 tiles each needs of the other are handed over under named
//   barriers. Every sum over Dv stays in the accumulators. Then the rest of
//   the chunk's gradient in the same block: dmw = T^T bf16(-dw), dA = -(dA_u
//   + bf16(dmw) w^T), kk and qk recomputed, the pairwise terms with their
//   decays from differences of G, dq = dqd e^G scale + bf16(dP decay) k, dk
//   = dkc e^{G_last - G} + dmw beta e^G + dkk k + dkk^T k + dqk^T q, dG (row
//   sums minus column sums of the pairwise term, the last row taking the
//   decay of the carried state) and dbeta. Nothing but the outputs leaves
//   the block: no float32 partials in device memory.
//
// Every sum is taken in a fixed order (accumulators, fixed shuffles, fixed
// slots in shared memory): no atomics, so two runs give the same bits.
//
// Bound at [8, 2048, 4, 128|256] bf16: bytes. The bytes it must move (q, k,
// v, dO, dq, dk, dv, the saved entry states) are ~270 MB (0.08 ms at 3.35
// TB/s); the products ~60 GFLOP (0.06 ms at 989 TFLOP/s). The exit
// cotangents (67 MB written and read back) and the records are this
// design's own traffic.
//
// Rounding points are those of the TPU kernel (T, w, P, qd, kc, v_eff,
// dv_eff, u, dmu, dw, dmw, dkk and dqk in bf16 before their products; the
// products summed in float32); the saved states and exit cotangents are
// bf16. The plain version (kernels/delta_chunk.py delta_chunk_bwd_plain)
// does the same.

#include "delta_common.cuh"

using namespace delta;

namespace {

// shared memory of the reverse chain, byte offsets: a ring stage holds one
// chunk's record (T's slot unused) and its dO panel
struct BwdChainSmem {
  static constexpr int kStages = 2;
  static constexpr int kDo = kRecSpan;
  static constexpr int kStage = kDo + kCC;
  static constexpr int kX = kStages * kStage;  // exit staging [2][128][64]
  static constexpr int kBar = kX + 2 * 2 * kCC;
  static constexpr int kBytes = kBar + 64 + 1024;
  static_assert(kBytes <= kSmemLimit, "one block's shared memory");
};

// grid B*H*(Dv/64), 160 threads: the consumer warpgroup, then the producer
// warp. maps: dO [B, N*C, H, Dv] bf16, boxes of 64 columns by C tokens; ex:
// the exit cotangents [B, N, H, Dk, Dv] bf16 as rows (boxes of 64 x 128).
// rec: the prep's records; ds_final, ds0 [B, H, Dk, Dv] float32.
__global__ void __launch_bounds__(160, 1)
delta_bwd_chain_kernel(const __grid_constant__ CUtensorMap map_do,
                       const __grid_constant__ CUtensorMap map_ex,
                       const unsigned char* __restrict__ rec, const float* __restrict__ ds_final,
                       float* __restrict__ ds0, int N, int C, int H, int Dv) {
  typedef BwdChainSmem L;
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
      mbar_init(&empty[s], 128);
    }
    fence_barrier_init();
  }
  if (C < kMaxC)
    for (int s = 0; s < L::kStages; ++s) zero_tail(sm + s * L::kStage + L::kDo, 1, C, tid, 160);
  fence_async_shared();
  __syncthreads();

  if (tid >= 128) {  // the producer warp, chunks in reverse
    if (tid == 128)
      for (int i = 0; i < N; ++i) {
        const int n = N - 1 - i, s = i % L::kStages;
        mbar_wait(&empty[s], ((i / L::kStages) & 1) ^ 1);
        unsigned char* st = sm + s * L::kStage;
        const int64_t item = ((int64_t)b * N + n) * H + h;
        mbar_arrive_expect_tx(&full[s], kRecBytes - kRecP + C * 128);
        bulk_load(st + kRecP, rec + item * kRecBytes + kRecP, kRecBytes - kRecP, &full[s]);
        tma_load_4d(st + L::kDo, &map_do, &full[s], p * kPanel, h, n * C, b);
      }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int64_t sbh = ((int64_t)b * H + h) * kDk * Dv + p * kPanel;
  float dZ[16][4];  // dS^T
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dZ[i][e] = ds_final[sbh + (int64_t)acc_col(i, e) * Dv + acc_row(e)];

  for (int i = 0; i < N; ++i) {
    const int n = N - 1 - i, s = i % L::kStages;
    const int64_t item = ((int64_t)b * N + n) * H + h;
    mbar_wait(&full[s], (i / L::kStages) & 1);
    const unsigned char* st = sm + s * L::kStage;

    // bf16(dS^T) as A fragments, and the chunk's exit cotangent
    uint32_t db[8][4];
    acc_frags<kDk>(db, dZ);
    unsigned char* xs = sm + L::kX + s * 2 * kCC;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      stsm_x4_t(xs + swizzle128(x4_row(ks, lane), x4_col(warp, lane)), db[ks]);

    // dv_eff^T = dO^T P + bf16(dS^T) kc^T
    float adv[8][4];
    const uint64_t dDo = desc_mnmajor<kMaxC>(st + L::kDo), dP = desc_mnmajor<kMaxC>(st + kRecP),
                   dKc = desc_kmajor(st + kRecKc, 0), dQd = desc_mnmajor<kMaxC>(st + kRecQd),
                   dW = desc_mnmajor<kMaxC>(st + kRecW);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<1, 1>(adv, dDo + kstep_mnmajor(ks), dP + kstep_mnmajor(ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) wgmma_rs<0>(adv, db[ks], dKc + kstep_kmajor<kMaxC>(ks), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(adv);
    fence_frag(db);

    // dS^T = e^{G_last} dS^T + dO^T qd - bf16(dv_eff^T) w
    uint32_t dvf[4][4];
    acc_frags<kMaxC>(dvf, adv);
    const float el = reinterpret_cast<const float*>(st + kRecGates)[kElOffset];
#pragma unroll
    for (int i2 = 0; i2 < 16; ++i2)
#pragma unroll
      for (int e = 0; e < 4; ++e) dZ[i2][e] *= el;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<1, 1>(dZ, dDo + kstep_mnmajor(ks), dQd + kstep_mnmajor(ks), 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs<1, 1>(dZ, dvf[ks], dW + kstep_mnmajor(ks), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dZ);
    fence_frag(dvf);
    mbar_arrive(&empty[s]);

    fence_async_shared();
    if (tid == 0) tma_store_wait_read<0>();  // the chunk before's exit has been read
    named_sync(1, 128);
    if (tid == 0) tma_store_4d(&map_ex, xs, p * kPanel, (int)(item * kDk), 0, 0);
  }

  float* d0 = ds0 + sbh;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) d0[(int64_t)acc_col(i, e) * Dv + acc_row(e)] = dZ[i][e];
  if (tid == 0) tma_store_wait_all();
}

// shared memory of the gradients pass, byte offsets
struct GradsSmem {
  // the item's tiles, loaded once: T, P, w, kc from its record, q, k
  static constexpr int kT = 0, kP = kCC, kW = 2 * kCC, kKc = kW + kCK;
  static constexpr int kQ = kKc + kCK, kK = kQ + kCK;
  // the ring of Dv panels: S, dS [128][64], v, dO [64][64]
  static constexpr int kRing = kK + kCK;
  static constexpr int kS = 0, kZ = 2 * kCC, kV = 4 * kCC, kDo = 5 * kCC, kStage = 6 * kCC;
  // a panel's bf16 tiles: beta v, u, v_eff, dv_eff; dv's staging
  static constexpr int kBv = kRing + 2 * kStage;
  static constexpr int kUb = kBv + kCC, kVe = kUb + kCC, kDve = kVe + kCC, kDvs = kDve + kCC;
  // floats: G, beta, row sums of dG / dbeta by warpgroup, column sums of
  // the pairwise term by warp, warpgroup 0's block sums
  static constexpr int kF = kDvs + kCC;
  static constexpr int kBar = kF + (2 + 4 + 4 + 8) * 64 * 4;
  static constexpr int kBytes = kBar + 64 + 1024;
  // the final phase's tiles, over the ring: bf16(-dw), bf16(dmw), dkk, dqk,
  // dq's and dk's staging
  static constexpr int kNw = kRing, kDmw = kNw + kCK, kDkk = kDmw + kCK, kDqk = kDkk + kCC;
  static constexpr int kDqs = kDqk + kCC, kDks = kDqs + kCK;
  static_assert(kDks + kCK <= kBv, "the final phase's tiles over the ring");
  static_assert(kBytes <= kSmemLimit, "one block's shared memory");
};

// named barriers: 1, 2 within warpgroup 0, 1; 3 warpgroup 0 -> 1 (u and
// v_eff, then bf16(dmw)); 4 warpgroup 1 -> 0 (dv_eff, then dkk and dqk); 5
// both, at the end of a panel
constexpr int kBarWg0 = 1, kBarWg1 = 2, kBar01 = 3, kBar10 = 4, kBarAll = 5;

struct GradsArgs {
  const unsigned char* rec;
  const float* G;
  const float* beta;
  float* dg;
  float* dbeta;
  int N, C, H, Dv;
};

__device__ __forceinline__ float bf16_at(const unsigned char* tile, int off) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(tile + off));
}

// Quad sums of a thread's two row partials (rows acc_row(0), acc_row(2)),
// written by the quad's first lane into dst.
__device__ __forceinline__ void rows_out(float* dst, float r0, float r1) {
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    r0 += __shfl_xor_sync(0xffffffffu, r0, o);
    r1 += __shfl_xor_sync(0xffffffffu, r1, o);
  }
  if ((threadIdx.x & 3) == 0) {
    dst[acc_row(0)] = r0;
    dst[acc_row(2)] = r1;
  }
}

// grid B*N*H items, 256 threads: warpgroups 0 and 1. maps: q, k [B, N*C, H,
// Dk], v, dO [B, N*C, H, Dv] bf16 (read) and dq, dk, dv (written), boxes of
// 64 columns by C tokens; st, ex: the entry states and exit cotangents as
// rows (boxes of 64 x 128).
__global__ void __launch_bounds__(256, 1)
delta_bwd_grads_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const __grid_constant__ CUtensorMap map_st,
                       const __grid_constant__ CUtensorMap map_ex,
                       const __grid_constant__ CUtensorMap map_dq,
                       const __grid_constant__ CUtensorMap map_dk,
                       const __grid_constant__ CUtensorMap map_dv, const GradsArgs a) {
  typedef GradsSmem L;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = sm + L::kRing;
  float* gs = reinterpret_cast<float*>(sm + L::kF);
  float* bs = gs + 64;
  float* rowg = bs + 64;      // [2][64]
  float* rowb = rowg + 128;   // [2][64]
  float* colp = rowb + 128;   // [4][64]
  float* blk = colp + 256;    // [8]
  uint64_t* bar_item = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full = bar_item + 1;

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  const int64_t item = blockIdx.x, bn = item / a.H;
  const int h = item % a.H, b = bn / a.N, n = bn % a.N, C = a.C;
  const int panels = a.Dv / kPanel;
  const float scale = 1.0f / sqrtf((float)kDk);
  const unsigned char* rec = a.rec + item * kRecBytes;

  if (tid == 0) {
    mbar_init(bar_item, 1);
    for (int s = 0; s < 2; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  if (C < kMaxC) {
    zero_tail(sm + L::kQ, 2, C, tid, 256);
    zero_tail(sm + L::kK, 2, C, tid, 256);
    for (int s = 0; s < 2; ++s) {
      zero_tail(ring + s * L::kStage + L::kV, 1, C, tid, 256);
      zero_tail(ring + s * L::kStage + L::kDo, 1, C, tid, 256);
    }
  }
  if (tid < kMaxC) {
    gs[tid] = tid < C ? a.G[(bn * C + tid) * a.H + h] : 0.f;
    bs[tid] = tid < C ? a.beta[(bn * C + tid) * a.H + h] : 0.f;
  }
  fence_async_shared();
  __syncthreads();
  auto load_panel = [&](int pp) {
    unsigned char* st = ring + (pp & 1) * L::kStage;
    mbar_arrive_expect_tx(&full[pp & 1], 4 * kCC + 2 * C * 128);
    tma_load_4d(st + L::kS, &map_st, &full[pp & 1], pp * kPanel, (int)(item * kDk), 0, 0);
    tma_load_4d(st + L::kZ, &map_ex, &full[pp & 1], pp * kPanel, (int)(item * kDk), 0, 0);
    tma_load_4d(st + L::kV, &map_v, &full[pp & 1], pp * kPanel, h, n * C, b);
    tma_load_4d(st + L::kDo, &map_do, &full[pp & 1], pp * kPanel, h, n * C, b);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(bar_item, 2 * kCC + kCK + kCK + 2 * 2 * C * 128);
    bulk_load(sm + L::kT, rec + kRecT, 2 * kCC + kCK, bar_item);  // T, P, w
    bulk_load(sm + L::kKc, rec + kRecKc, kCK, bar_item);
    tma_load_cols<kDk, kMaxC>(sm + L::kQ, &map_q, bar_item, 0, n * C, h, b);
    tma_load_cols<kDk, kMaxC>(sm + L::kK, &map_k, bar_item, 0, n * C, h, b);
    load_panel(0);
    if (panels > 1) load_panel(1);
  }
  mbar_wait(bar_item, 0);

  unsigned char *T = sm + L::kT, *P = sm + L::kP, *W = sm + L::kW, *Kc = sm + L::kKc,
                *Q = sm + L::kQ, *K = sm + L::kK;
  unsigned char *bv = sm + L::kBv, *ub = sm + L::kUb, *ve = sm + L::kVe, *dve = sm + L::kDve,
                *dvs = sm + L::kDvs;
  const int r0 = acc_row(0), r1 = acc_row(2);

  if (wg == 0) {
    // ---- warpgroup 0: u, v_eff; sums dkc, dw; then dmw and dk
    float dkc[16][4], dw[16][4];
    float sdz = 0.f;  // sum of S * dS
    for (int pp = 0; pp < panels; ++pp) {
      const int s = pp & 1;
      mbar_wait(&full[s], (pp >> 1) & 1);
      unsigned char* st = ring + s * L::kStage;
      // bf16(beta v), elementwise by row over the v panel's 16-byte chunks
      for (int e = t; e < kCC / 16; e += 128) {
        float x[8];
        load8(st + L::kV + e * 16, x);
        const float bt = bs[(e * 16) / 128];
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] *= bt;
        store8(bv + e * 16, x);
      }
      fence_async_shared();
      named_sync(kBarWg0, 128);
      // u = T bf16(beta v), kept as bf16(u) for dA_u; v_eff = u - w S
      float u[8][4];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss<0, 1>(u, desc_kmajor(T, 0) + kstep_kmajor<kMaxC>(ks),
                       desc_mnmajor<kMaxC>(bv) + kstep_mnmajor(ks), ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(u);
      acc_to_panels<kMaxC>(ub, u);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        wgmma_ss<0, 1, 1>(u, desc_kmajor(W, 0) + kstep_kmajor<kMaxC>(ks),
                          desc_mnmajor<kDk>(st + L::kS) + kstep_mnmajor(ks), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(u);
      acc_to_panels<kMaxC>(ve, u);
      uint32_t vf[4][4];
      acc_frags<kMaxC>(vf, u);
      fence_async_shared();
      named_arrive(kBar01, 256);  // bf16(u), bf16(v_eff) -> warpgroup 1
      // dkc += v_eff dS^T; then, with dv_eff from warpgroup 1, dw += dv_eff S^T
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_rs<0>(dkc, vf[ks], desc_kmajor(st + L::kZ, 0) + kstep_kmajor<kDk>(ks),
                    pp > 0 || ks > 0);
      wgmma_commit();
      named_sync(kBar10, 256);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss(dw, desc_kmajor(dve, 0) + kstep_kmajor<kMaxC>(ks),
                 desc_kmajor(st + L::kS, 0) + kstep_kmajor<kDk>(ks), pp > 0 || ks > 0);
      wgmma_commit();
      // sum(S * dS) for the carried decay, while the products run
      for (int e = t; e < 2 * kCC / 16; e += 128) {
        float x[8], y[8];
        load8(st + L::kS + e * 16, x);
        load8(st + L::kZ + e * 16, y);
#pragma unroll
        for (int i = 0; i < 8; ++i) sdz = fmaf(x[i], y[i], sdz);
      }
      wgmma_wait<0>();
      fence_acc(dkc);
      fence_acc(dw);
      fence_frag(vf);
      named_sync(kBarAll, 256);  // the panel's tiles are read: its stage may be refilled
      if (tid == 0 && pp + 2 < panels) load_panel(pp + 2);
    }

    // dmw = T^T bf16(-dw), into dw
    unsigned char *nw = sm + L::kNw, *dmw = sm + L::kDmw;
    acc_to_panels<kDk>(nw, dw, [](int, int, float x) { return -x; });
    fence_async_shared();
    named_sync(kBarWg0, 128);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<1, 1>(dw, desc_mnmajor<kMaxC>(T) + kstep_mnmajor(ks),
                     desc_mnmajor<kMaxC>(nw) + kstep_mnmajor(ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dw);
    // kc = k e^{G_last - G}: dG -= dkc . kc, the carried decay += dkc . kc,
    // dk_x = dkc e^{G_last - G}; w = T (beta e^G k): dk_x += dmw beta e^G,
    // dbeta += dmw . k e^G, dG += dmw . beta e^G k
    const float gl = gs[C - 1];
    const float eg[2] = {expf(gs[r0]), expf(gs[r1])};
    const float ec[2] = {expf(gl - gs[r0]), expf(gl - gs[r1])};
    const float bt[2] = {bs[r0], bs[r1]};
    float gr[2] = {0.f, 0.f}, br[2] = {0.f, 0.f}, dgl = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const float kv = bf16_at(K, tile_off<kMaxC>(acc_row(e), acc_col(i, e)));
        const float m = dw[i][e], kneg = kv * eg[hf], kcf = kv * ec[hf];
        br[hf] += m * kneg;
        gr[hf] += m * kneg * bt[hf];
        gr[hf] -= dkc[i][e] * kcf;
        dgl = fmaf(dkc[i][e], kcf, dgl);
        dkc[i][e] = dkc[i][e] * ec[hf] + m * (eg[hf] * bt[hf]);
      }
    acc_to_panels<kDk>(dmw, dw);
    fence_async_shared();
    named_arrive(kBar01, 256);  // bf16(dmw) -> warpgroup 1
    rows_out(rowg, gr[0], gr[1]);
    rows_out(rowb, br[0], br[1]);
    // warpgroup 0's block sums: sum(S * dS) and the carried decay's dkc . kc
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sdz += __shfl_xor_sync(0xffffffffu, sdz, o);
      dgl += __shfl_xor_sync(0xffffffffu, dgl, o);
    }
    if (lane == 0) {
      blk[warp] = sdz;
      blk[4 + warp] = dgl;
    }
    // dk = dk_x + dkk k + dkk^T k + dqk^T q, with dkk and dqk from warpgroup 1
    named_sync(kBar10, 256);
    unsigned char *dkk = sm + L::kDkk, *dqk = sm + L::kDqk, *dks = sm + L::kDks;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<0, 1>(dkc, desc_kmajor(dkk, 0) + kstep_kmajor<kMaxC>(ks),
                     desc_mnmajor<kMaxC>(K) + kstep_mnmajor(ks), 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<1, 1>(dkc, desc_mnmajor<kMaxC>(dkk) + kstep_mnmajor(ks),
                     desc_mnmajor<kMaxC>(K) + kstep_mnmajor(ks), 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<1, 1>(dkc, desc_mnmajor<kMaxC>(dqk) + kstep_mnmajor(ks),
                     desc_mnmajor<kMaxC>(Q) + kstep_mnmajor(ks), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dkc);
    acc_to_panels<kDk>(dks, dkc);
    fence_async_shared();
    named_sync(kBarWg0, 128);
    if (t == 0) {
      tma_store_4d_part(&map_dk, dks, 0, h, n * C, b);
      tma_store_4d_part(&map_dk, dks + kCC, 64, h, n * C, b);
      tma_store_commit();
    }
  } else {
    // ---- warpgroup 1: dv_eff, dmu, dv; sums dqd, dP, dA_u; then dA, the
    //      pairwise terms and dq
    float dqd[16][4], dp[8][4], dau[8][4];
    float br[2] = {0.f, 0.f};  // dbeta's row sums of dmu . v
    for (int pp = 0; pp < panels; ++pp) {
      const int s = pp & 1;
      mbar_wait(&full[s], (pp >> 1) & 1);
      unsigned char* st = ring + s * L::kStage;
      // dv_eff = P^T dO + kc dS
      float dv[8][4];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss<1, 1>(dv, desc_mnmajor<kMaxC>(P) + kstep_mnmajor(ks),
                       desc_mnmajor<kMaxC>(st + L::kDo) + kstep_mnmajor(ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        wgmma_ss<0, 1>(dv, desc_kmajor(Kc, 0) + kstep_kmajor<kMaxC>(ks),
                       desc_mnmajor<kDk>(st + L::kZ) + kstep_mnmajor(ks), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dv);
      acc_to_panels<kMaxC>(dve, dv);
      fence_async_shared();
      named_arrive(kBar10, 256);  // bf16(dv_eff) -> warpgroup 0
      named_sync(kBarWg1, 128);
      // dmu = T^T bf16(dv_eff), into dv
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss<1, 1>(dv, desc_mnmajor<kMaxC>(T) + kstep_mnmajor(ks),
                       desc_mnmajor<kMaxC>(dve) + kstep_mnmajor(ks), ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dv);
      // dv = bf16(dmu beta) out; dbeta's row sums of dmu . v; bf16(dmu)
      acc_to_panels<kMaxC>(dvs, dv, [&](int r, int, float x) { return x * bs[r]; });
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          br[e >> 1] = fmaf(dv[i][e], bf16_at(st + L::kV, swizzle128(acc_row(e), acc_col(i, e))),
                            br[e >> 1]);
      uint32_t mf[4][4];
      acc_frags<kMaxC>(mf, dv);
      fence_async_shared();
      named_sync(kBarWg1, 128);
      if (t == 0) tma_store_4d(&map_dv, dvs, pp * kPanel, h, n * C, b);
      // dqd += dO S^T; then, with u and v_eff from warpgroup 0, dP += dO
      // v_eff^T and dA_u += bf16(dmu) bf16(u)^T
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss(dqd, desc_kmajor(st + L::kDo, 0) + kstep_kmajor<kMaxC>(ks),
                 desc_kmajor(st + L::kS, 0) + kstep_kmajor<kDk>(ks), pp > 0 || ks > 0);
      wgmma_commit();
      named_sync(kBar01, 256);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss(dp, desc_kmajor(st + L::kDo, 0) + kstep_kmajor<kMaxC>(ks),
                 desc_kmajor(ve, 0) + kstep_kmajor<kMaxC>(ks), pp > 0 || ks > 0);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_rs<0>(dau, mf[ks], desc_kmajor(ub, 0) + kstep_kmajor<kMaxC>(ks), pp > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dqd);
      fence_acc(dp);
      fence_acc(dau);
      fence_frag(mf);
      if (t == 0) tma_store_wait_read<0>();  // dv's staging is free again
      named_sync(kBarAll, 256);
    }

    // qd = q e^G scale: dG += dqd . qd; dq_x = dqd e^G scale
    const float fq[2] = {expf(gs[r0]) * scale, expf(gs[r1]) * scale};
    float gr[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float qv = bf16_at(Q, tile_off<kMaxC>(acc_row(e), acc_col(i, e)));
        gr[e >> 1] += dqd[i][e] * (qv * fq[e >> 1]);
        dqd[i][e] *= fq[e >> 1];
      }
    // qk = q k^T; dqk = bf16(dP di); the dP term of the pairwise sum into qk
    float qk[8][4];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kDk / 16; ++ks)
      wgmma_ss(qk, desc_kmajor(Q, 0) + kstep_kmajor<kMaxC>(ks),
               desc_kmajor(K, 0) + kstep_kmajor<kMaxC>(ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(qk);
    unsigned char *dkk = sm + L::kDkk, *dqk = sm + L::kDqk, *dqs = sm + L::kDqs;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = acc_row(e), c = acc_col(i, e);
        const float d0 = c <= r ? expf(gs[r] - gs[c]) * scale : 0.f;
        const float d1 = c + 1 <= r ? expf(gs[r] - gs[c + 1]) * scale : 0.f;
        *reinterpret_cast<uint32_t*>(dqk + swizzle128(r, c)) =
            pack_bf16(dp[i][e] * d0, dp[i][e + 1] * d1);
        qk[i][e] = dp[i][e] * (qk[i][e] * d0);
        qk[i][e + 1] = dp[i][e + 1] * (qk[i][e + 1] * d1);
      }
    // dA = -(dA_u + bf16(dmw) w^T), with bf16(dmw) from warpgroup 0; kk = k k^T
    named_sync(kBar01, 256);
    float kk[8][4];
    unsigned char* dmw = sm + L::kDmw;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kDk / 16; ++ks)
      wgmma_ss(dau, desc_kmajor(dmw, 0) + kstep_kmajor<kMaxC>(ks),
               desc_kmajor(W, 0) + kstep_kmajor<kMaxC>(ks), 1);
#pragma unroll
    for (int ks = 0; ks < kDk / 16; ++ks)
      wgmma_ss(kk, desc_kmajor(K, 0) + kstep_kmajor<kMaxC>(ks),
               desc_kmajor(K, 0) + kstep_kmajor<kMaxC>(ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dau);
    fence_acc(kk);
    // A = beta_i kk ds (j < i): dbeta += dA . kk ds; dkk = bf16(dA ds beta);
    // the pairwise term m = dA A + dP P: dG += row sums - column sums
    float cs[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = acc_row(e), c = acc_col(i, e), hf = e >> 1;
        float dkv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float da = -dau[i][e + j];
          const float dsv = c + j < r ? expf(gs[r] - gs[c + j]) : 0.f;
          const float kkds = kk[i][e + j] * dsv;
          br[hf] += da * kkds;
          dkv[j] = da * dsv * bs[r];
          const float m = da * kkds * bs[r] + qk[i][e + j];
          gr[hf] += m;
          if (hf == 0) cs[i][j] = m;
          else cs[i][j] += m;
        }
        *reinterpret_cast<uint32_t*>(dkk + swizzle128(r, c)) = pack_bf16(dkv[0], dkv[1]);
      }
    fence_async_shared();
    named_sync(kBarWg1, 128);
    named_arrive(kBar10, 256);  // dkk, dqk -> warpgroup 0
    // dq = dq_x + dqk k
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<0, 1>(dqd, desc_kmajor(dqk, 0) + kstep_kmajor<kMaxC>(ks),
                     desc_mnmajor<kMaxC>(K) + kstep_mnmajor(ks), 1);
    wgmma_commit();
    // column sums over the warp's 16 rows (lanes 4 apart), by warp
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v = cs[i][j];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 4) colp[warp * 64 + 8 * i + 2 * lane + j] = v;
      }
    rows_out(rowg + 64, gr[0], gr[1]);
    rows_out(rowb + 64, br[0], br[1]);
    wgmma_wait<0>();
    fence_acc(dqd);
    acc_to_panels<kDk>(dqs, dqd);
    fence_async_shared();
    named_sync(kBarWg1, 128);
    if (t == 0) {
      tma_store_4d_part(&map_dq, dqs, 0, h, n * C, b);
      tma_store_4d_part(&map_dq, dqs + kCC, 64, h, n * C, b);
      tma_store_commit();
    }
  }

  // dG and dbeta of the chunk's tokens, every sum in a fixed order
  __syncthreads();
  if (tid < C) {
    const int j = tid;
    float g = rowg[j] + rowg[64 + j] - (colp[j] + colp[64 + j] + colp[128 + j] + colp[192 + j]);
    if (j == C - 1) {
      const float sdz = blk[0] + blk[1] + blk[2] + blk[3];
      const float dgl = blk[4] + blk[5] + blk[6] + blk[7];
      g += expf(gs[C - 1]) * sdz + dgl;
    }
    a.dg[(bn * C + j) * a.H + h] = g;
    a.dbeta[(bn * C + j) * a.H + h] = rowb[j] + rowb[64 + j];
  }
  if (t == 0) tma_store_wait_all();
}

}  // namespace

extern "C" {

int mhla_delta_bwd_chain(const void* rec, const void* dout, const void* ds_final, void* exits,
                         void* ds0, int B, int N, int C, int H, int Dv, void* stream) {
  if (Dv % kPanel || Dv <= 0 || C % 16 || C <= 0 || C > kMaxC) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  int err = hopper_host::resident_blocks((const void*)delta_bwd_chain_kernel, 160,
                                         BwdChainSmem::kBytes, &blocks);
  CUtensorMap map_do, map_ex;
  if (!err) err = hopper_host::make_tile_map(&map_do, dout, B, N * C, H, Dv, C);
  if (!err) err = hopper_host::make_rows_map(&map_ex, exits, 1, 1, B * N * H * kDk, Dv, kDk);
  if (err) return err;
  delta_bwd_chain_kernel<<<B * H * (Dv / kPanel), 160, BwdChainSmem::kBytes,
                           (cudaStream_t)stream>>>(map_do, map_ex, (const unsigned char*)rec,
                                                   (const float*)ds_final, (float*)ds0, N, C, H,
                                                   Dv);
  return (int)cudaGetLastError();
}

int mhla_delta_bwd_grads(const void* q, const void* k, const void* v, const void* G,
                         const void* beta, const void* states, const void* exits,
                         const void* dout, const void* rec, void* dq, void* dk, void* dv,
                         void* dg, void* dbeta, int B, int N, int C, int H, int Dv,
                         void* stream) {
  if (Dv % kPanel || Dv <= 0 || C % 16 || C <= 0 || C > kMaxC) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  int err = hopper_host::resident_blocks((const void*)delta_bwd_grads_kernel, 256,
                                         GradsSmem::kBytes, &blocks);
  const int T = N * C;
  CUtensorMap mq, mk, mv, mdo, mst, mex, mdq, mdk, mdv;
  if (!err) err = hopper_host::make_tile_map(&mq, q, B, T, H, kDk, C);
  if (!err) err = hopper_host::make_tile_map(&mk, k, B, T, H, kDk, C);
  if (!err) err = hopper_host::make_tile_map(&mv, v, B, T, H, Dv, C);
  if (!err) err = hopper_host::make_tile_map(&mdo, dout, B, T, H, Dv, C);
  if (!err) err = hopper_host::make_rows_map(&mst, states, 1, 1, B * N * H * kDk, Dv, kDk);
  if (!err) err = hopper_host::make_rows_map(&mex, exits, 1, 1, B * N * H * kDk, Dv, kDk);
  if (!err) err = hopper_host::make_tile_map(&mdq, dq, B, T, H, kDk, C);
  if (!err) err = hopper_host::make_tile_map(&mdk, dk, B, T, H, kDk, C);
  if (!err) err = hopper_host::make_tile_map(&mdv, dv, B, T, H, Dv, C);
  if (err) return err;
  const GradsArgs args = {(const unsigned char*)rec, (const float*)G, (const float*)beta,
                          (float*)dg, (float*)dbeta, N, C, H, Dv};
  delta_bwd_grads_kernel<<<B * N * H, 256, GradsSmem::kBytes, (cudaStream_t)stream>>>(
      mq, mk, mv, mdo, mst, mex, mdq, mdk, mdv, args);
  return (int)cudaGetLastError();
}

}  // extern "C"
