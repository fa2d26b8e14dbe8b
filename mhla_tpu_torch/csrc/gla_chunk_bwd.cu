// K12b: backward of chunked gated linear attention (GLA) for Hopper (sm_90a).
//
// Replaces _gla_bwd_kernel (mhla_tpu/kernels/gla_chunk_pallas.py:160), called
// through _gla_bwd_impl (:376-461). Given K12's inputs (qd, kd, v of the
// compute dtype T, handed over as float32; e^{G_last} float32), its
// chunk-entry states S_n (float32), the output cotangent dO (T, as float32)
// and the final-state cotangent, it gives, all float32:
//
//   dS_n  = the cotangent of chunk n's exit state: dS_{N-1} = dS_final,
//           dS_{n-1} = e^{G_last, n} dS_n + qd_n^T dO_n;  ds0 = the last
//   dp    = T(mask(dO v^T))
//   dqd   = dp kd + dO T(S_n)^T
//   dkd   = dp^T qd + (v T(dS_n)^T) e^{G_last}
//   dv    = T(mask(qd kd^T))^T dO + kc T(dS_n)         kc = T(kd e^{G_last})
//   degl  = sum_Dv(S_n * dS_n) + sum_C((v T(dS_n)^T) * kd)
//
// The elementwise decay chains (qd = q e^G scale, kd = k e^-G, the cumsum)
// are differentiated outside, in PyTorch, as JAX does outside its kernel.
//
// Two launches, every product on the TF32 tensor cores (gla_common.cuh):
//
// 1. gla_state_kernel (gla_common.cuh), in reverse: the exit cotangents dS_n
//    and ds0, with qd^T dO computed per chunk in registers (never written).
//    Only this chain is sequential; the TPU kernel also replays the forward
//    chain from its supertile-entry states, which K12 saved whole.
// 2. gla_grads_kernel below: one block of two warpgroups per (chunk, head).
//    TF32 wgmma takes K-major operands only, so the products are written as
//    transposes where that puts a K-major operand on the B side:
//      s^T   = kd qd^T                  (B: qd)           once, stored T(mask)
//      dp   += dO v^T                   (B: v panel)      over the Dv panels
//      dqd^T += T(S) dO^T               (B: dO panel)     over the Dv panels
//      dkc^T += T(dS) v^T               (B: v panel)      over the Dv panels
//      dv^T  = dO^T s + dS'^T kc'^T     (B: s^T, kd)      per Dv panel
//      dqd^T += kd^T dp^T               (B: dp)           after the panels
//      dkd^T  = qd^T dp + dkc^T e^{G_last}  (B: dp^T)     after the panels
//    where in the float32 form dS'^T kc'^T = (dS^T e^{G_last}) kd^T (kd's
//    tile, split, serves as B; the same sum in another float32 order) and in
//    bf16 = T(dS)^T T(kd e^{G_last})^T exactly as the TPU kernel rounds it.
//    The warpgroups split dqd^T and dkc^T by Dk rows; warpgroup 0 takes s^T,
//    dp and sum S * dS, warpgroup 1 dv^T, each product whole (fewer and
//    wider wgmmas: K6 found one of N = 40 about as long as one of N = 80).
//    Each 64-column Dv panel comes in by TMA in two groups, v and dO, then S
//    and dS, each issued once the previous panel's products are done with
//    its tiles (S and dS during the previous panel's last product); every
//    sum over Dv (dp, dO S^T, v dS^T, S * dS) stays inside the block and
//    runs in a fixed order, as do the sums over C (dkd's decay term and
//    degl's second term, the latter across the four lanes of a row in a
//    fixed shuffle order). No atomics and no sum across blocks, so K12b is
//    bit-equal from run to run. 1,024 blocks at [8, 2048, 4, 128|256].
//
// Bound at [8, 2048, 4, 128|256], float32 (chip_smoke.py gla_work): 0.47 GB,
// 0.14 ms at 3.35 TB/s; 21.0 GFLOP, three TF32 products each, 0.127 ms at 495
// TFLOP/s: bytes. (On float32 FMAs outside the tensor cores the same work
// was 0.313 ms at 67 TFLOP/s, the bound of the kernel this one replaced.)
//
// The scalar-decay form (mhla_gla_bwd_scalar, one log-decay per head; see
// gla_chunk.cu) differentiates the difference form: the same two launches,
// the state pass forming T(q kScale e^{G}) per token, and the gradients
// block scaling its score and dp tiles by e^{G_i - G_j}; it returns the
// gradients of the undecayed q and k and of G per (token, head) (the
// formulas above gla_grads_kernel), the cumsum's reverse done outside.

#include "gla_common.cuh"

using namespace gla;

namespace {

template <int kC>
struct GradGeom {
  static constexpr int kTok = tile_bytes(kC, kDk);    // qd or kd: [C][128]
  static constexpr int kSq = tile_bytes(kC, kC);      // s^T, dp, dp^T: [C][C]
  static constexpr int kV = tile_bytes(kC, kPanel);   // v or dO panel: [C][64]
  static constexpr int kS = tile_bytes(kDk, kPanel);  // S or dS panel: [128][64]
  static constexpr int kPanelBytes = 4 * kV + 2 * kS;  // v, v lo, dO, dO lo, S, dS
  static_assert(2 * kTok <= kPanelBytes, "qd and its lo fit the panel region");
  static_assert(kTok + 4 * kSq <= kPanelBytes, "qd, dp and dp^T fit the panel region");
  // kScalar, after the panels: the products dp * s [C][C], the eight warps'
  // column sums of two products [2][8][C] and the tokens' dG [C], float32
  static constexpr int kScalarScratch = (kC * kC + 17 * kC) * 4;
  static_assert(kTok + 4 * kSq + kScalarScratch <= kPanelBytes, "the scalar form's sums fit");
  // s^T (hi, lo); kd's two tiles; the panel region; egl and degl's partial
  // sums; mbarriers; kScalar: G, kScale e^{G} and e^{G_last - G} of the
  // chunk's tokens; alignment
  static constexpr int kSmem =
      2 * kSq + 2 * kTok + kPanelBytes + 2 * kDk * 4 + 64 + 3 * kC * 4 + 1024;
  static_assert(kSmem <= kSmemLimit, "one block's shared memory");
};

// K12b's gradients. grid B * N * H, 256 threads. maps: [B, T, H, Dk] (qd,
// kd), [B, T, H, Dv] (v, dO), float32, boxes of 32 columns by C tokens;
// map_s, map_ds: the entry states and exit cotangents [B * N * H * Dk, Dv]
// float32, boxes of 32 columns by 128 rows. egl, degl: [B, N, H, Dk]; dqd,
// dkd: [B, T, H, Dk]; dv: [B, T, H, Dv]; float32.
//
// kScalar (one log-decay per head): the maps hold the undecayed q and k, egl
// is G [B, T, H] (the within-chunk cumsum) and degl takes dG [B, T, H], the
// gradient of G per (token, head); dqd and dkd take the gradients of the
// undecayed q and k. With e_t = kScale e^{G_t}, a_t = e^{G_last - G_t} and
// f_ij = kScale e^{G_i - G_j} (j <= i, the exponent taken only there): the
// scores s = T(q k^T * f), kc = T(k a), and the block's products run on
// dr = T(dp * f) in place of dp, q and k in place of qd and kd:
//   dq  = dr k + (dO T(S)^T) e         dk = dr^T q + (v T(dS)^T) a
//   dv  = s^T dO + kc T(dS)
//   dG_t = e_t sum_d (dO T(S)^T)_td q_td - a_t sum_d (v T(dS)^T)_td k_td
//          + sum_j P_tj - sum_i P_it        P = dp * s (the stored scores)
//   dG_last += sum_t a_t sum_d (v T(dS)^T)_td k_td + e^{G_last} sum(S * dS)
// The sums over d run across the eight warps (shuffles, then one row each in
// shared memory), those of P and the last ones by one thread each, all in a
// fixed order: bit-equal from run to run as the per-channel form.
template <bool kBf16, int kC, bool kScalar>
__global__ void __launch_bounds__(256, 1)
gla_grads_kernel(const __grid_constant__ CUtensorMap map_qd,
                 const __grid_constant__ CUtensorMap map_kd,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_do,
                 const __grid_constant__ CUtensorMap map_s,
                 const __grid_constant__ CUtensorMap map_ds, const float* __restrict__ egl,
                 float* __restrict__ dqd, float* __restrict__ dkd, float* __restrict__ dv,
                 float* __restrict__ degl, int N, int H, int Dv) {
  typedef GradGeom<kC> G;
  constexpr bool kSplit = !kBf16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* st_hi = reinterpret_cast<float*>(smem);  // s^T [j][i]
  float* st_lo = reinterpret_cast<float*>(smem + G::kSq);
  // float32: kd split in place (ka) and its lo (kb); bf16: kd (ka) and kc (kb)
  float* ka = reinterpret_cast<float*>(smem + 2 * G::kSq);
  float* kb = reinterpret_cast<float*>(smem + 2 * G::kSq + G::kTok);
  unsigned char* reg = smem + 2 * G::kSq + 2 * G::kTok;  // the panel region
  float* v_hi = reinterpret_cast<float*>(reg);
  float* v_lo = reinterpret_cast<float*>(reg + G::kV);
  float* do_hi = reinterpret_cast<float*>(reg + 2 * G::kV);
  float* do_lo = reinterpret_cast<float*>(reg + 3 * G::kV);
  float* s_t = reinterpret_cast<float*>(reg + 4 * G::kV);
  float* ds_t = reinterpret_cast<float*>(reg + 4 * G::kV + G::kS);
  float* qd_hi = reinterpret_cast<float*>(reg);  // before and after the panels
  float* qd_lo = reinterpret_cast<float*>(reg + G::kTok);
  float* dp_hi = reinterpret_cast<float*>(reg + G::kTok);  // after the panels: dp [i][j]
  float* dp_lo = reinterpret_cast<float*>(reg + G::kTok + G::kSq);
  float* dpt_hi = reinterpret_cast<float*>(reg + G::kTok + 2 * G::kSq);  // dp^T [j][i]
  float* dpt_lo = reinterpret_cast<float*>(reg + G::kTok + 3 * G::kSq);
  float* eg = reinterpret_cast<float*>(reg + G::kPanelBytes);
  float* dg_dv = eg + kDk;  // sum_Dv(S * dS)
  // qd and kd; a panel's v and dO; its S and dS; qd again at the end
  uint64_t* bars = reinterpret_cast<uint64_t*>(dg_dv + kDk);
  float* gs = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(bars) + 64);
  float* qf = gs + kC;  // kScalar: kScale e^{G}
  float* af = qf + kC;  // and e^{G_last - G}
  float* pp = reinterpret_cast<float*>(reg + G::kTok + 4 * G::kSq);  // after the panels: P
  float* red = pp + kC * kC;  // [2][8 warps][C]
  float* dgt = red + 16 * kC;  // dG [C]

  const int item = blockIdx.x;
  const int h = item % H, bn = item / H, n = bn % N, b = bn / N;
  const int t0 = n * kC, panels = Dv / kPanel;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  // a panel's loads in two groups, each issued as soon as the previous
  // panel's products are done with its tiles: v and dO (bars[1]), S and dS
  // (bars[2])
  auto issue_tokens = [&](int p) {
    mbar_arrive_expect_tx(&bars[1], 2 * G::kV);
    load_tokens<kPanel, kC>(v_hi, &map_v, &bars[1], p * kPanel, t0, h, b);
    load_tokens<kPanel, kC>(do_hi, &map_do, &bars[1], p * kPanel, t0, h, b);
  };
  auto issue_states = [&](int p) {
    mbar_arrive_expect_tx(&bars[2], 2 * G::kS);
    load_rows<kPanel, kDk>(s_t, &map_s, &bars[2], p * kPanel, item * kDk);
    load_rows<kPanel, kDk>(ds_t, &map_ds, &bars[2], p * kPanel, item * kDk);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(&bars[0], 2 * G::kTok);
    load_tokens<kDk, kC>(qd_hi, &map_qd, &bars[0], 0, t0, h, b);
    load_tokens<kDk, kC>(ka, &map_kd, &bars[0], 0, t0, h, b);
    issue_states(0);  // S and dS of panel 0 land beside qd and its lo
  }
  const int64_t tok0 = (int64_t)b * N * kC + t0;
  if constexpr (kScalar) {
    if (tid < kC) gs[tid] = egl[(tok0 + tid) * H + h];
    __syncthreads();
    if (tid < kC) {
      qf[tid] = kScale * expf(gs[tid]);
      af[tid] = expf(gs[kC - 1] - gs[tid]);
    }
  } else if (tid < kDk) {
    eg[tid] = egl[(int64_t)item * kDk + tid];
  }
  mbar_wait(&bars[0], 0);
  if constexpr (kSplit) {
    split_tile(qd_hi, qd_lo, G::kTok, tid, 256);
    split_tile(ka, kb, G::kTok, tid, 256);
  } else {
    __syncthreads();  // eg (af) is written
    for (int e = tid; e < kC * kDk; e += 256) {  // kc = T(kd e^{G_last}) (kScalar: T(k a))
      const int j = e / kDk, d = e % kDk;
      tile_at<kC>(kb, j, d) = rnd<true>(tile_at<kC>(ka, j, d) * (kScalar ? af[j] : eg[d]));
    }
  }
  fence_async_shared();
  __syncthreads();

  // kd (j, d) as an A operand: hi + lo (exact) in float32, the bf16 value else
  auto kd_at = [&](int j, int d) {
    return kSplit ? tile_at<kC>(ka, j, d) + tile_at<kC>(kb, j, d) : tile_at<kC>(ka, j, d);
  };
  const int d_half = wg * 64;  // this warpgroup's first Dk row of dqd^T and dkc^T

  // s^T [j][i] = kd qd^T (warpgroup 0), then T(mask) into s^T's tile
  if (wg == 0) {
    float acc[kC / 8][4];
    mma<kSplit, kDk / 8, kC>(
        acc, [&](int, int m, int k) { return m < kC ? kd_at(m, k) : 0.f; },
        desc_kmajor(qd_hi, 0), desc_kmajor(qd_lo, 0), false);
#pragma unroll
    for (int i = 0; i < kC / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = acc_row(e), ii = acc_col(i, e);
        float x = 0.f;
        if (j <= ii) x = kScalar ? acc[i][e] * (kScale * expf(gs[ii] - gs[j])) : acc[i][e];
        if (j < kC) put_b<kC, kSplit>(st_hi, st_lo, j, ii, rnd<kBf16>(x));
      }
  }
  fence_async_shared();
  __syncthreads();  // the panel region is free

  // warpgroup w: dqd^T and dkc^T at Dk rows [64 w, 64 w + 64); warpgroup 0
  // also dp over the panels and sum_Dv(S * dS), warpgroup 1 dv^T per panel
  float dq[kC / 8][4], dk[kC / 8][4], pw[kC / 8][4];  // pw: dp (warpgroup 0) or dv^T (1)
  float dg_part = 0.f;  // sum_Dv(S * dS) at row tid (warpgroup 0)
  const int64_t ldk = (int64_t)H * kDk, ldv = (int64_t)H * Dv;
  if (tid == 0) issue_tokens(0);
  for (int p = 0; p < panels; ++p) {
    mbar_wait(&bars[1], p & 1);
    if constexpr (kSplit) {
      split_tile(v_hi, v_lo, G::kV, tid, 256);
      split_tile(do_hi, do_lo, G::kV, tid, 256);
    }
    fence_async_shared();
    __syncthreads();
    auto do_at = [&](int i, int c) {
      return kSplit ? tile_at<kC>(do_hi, i, c) + tile_at<kC>(do_lo, i, c)
                    : tile_at<kC>(do_hi, i, c);
    };
    if (wg == 0)  // dp [i][j] += dO v^T
      mma<kSplit, kPanel / 8, kC>(
          pw, [&](int, int m, int k) { return m < kC ? do_at(m, k) : 0.f; },
          desc_kmajor(v_hi, 0), desc_kmajor(v_lo, 0), p > 0);
    mbar_wait(&bars[2], p & 1);
    if (wg == 0) {  // sum_Dv(S * dS), unrounded, row tid
#pragma unroll 8
      for (int c = 0; c < kPanel; ++c)
        dg_part = fmaf(tile_at<kDk>(s_t, tid, c), tile_at<kDk>(ds_t, tid, c), dg_part);
    }
    // dqd^T [this warpgroup's d][i] += T(S) dO^T
    mma<kSplit, kPanel / 8, kC>(
        dq, [&](int, int m, int k) { return rnd<kBf16>(tile_at<kDk>(s_t, d_half + m, k)); },
        desc_kmajor(do_hi, 0), desc_kmajor(do_lo, 0), p > 0);
    // dkc^T [d][j] += T(dS) v^T
    mma<kSplit, kPanel / 8, kC>(
        dk, [&](int, int m, int k) { return rnd<kBf16>(tile_at<kDk>(ds_t, d_half + m, k)); },
        desc_kmajor(v_hi, 0), desc_kmajor(v_lo, 0), p > 0);
    // dv^T [dv][j] = dS'^T kc'^T + dO^T s (warpgroup 1)
    if (wg == 1) {
      if constexpr (kSplit && kScalar) {  // (dS^T k^T) a, column j times a_j
        mma<true, kDk / 8, kC>(
            pw, [&](int, int m, int k) { return tile_at<kDk>(ds_t, k, m); }, desc_kmajor(ka, 0),
            desc_kmajor(kb, 0), false);
#pragma unroll
        for (int i = 0; i < kC / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = acc_col(i, e);
            pw[i][e] *= j < kC ? af[j] : 0.f;
          }
      } else if constexpr (kSplit)
        mma<true, kDk / 8, kC>(
            pw, [&](int, int m, int k) { return tile_at<kDk>(ds_t, k, m) * eg[k]; },
            desc_kmajor(ka, 0), desc_kmajor(kb, 0), false);
      else
        mma<false, kDk / 8, kC>(
            pw, [&](int, int m, int k) { return rnd<true>(tile_at<kDk>(ds_t, k, m)); },
            desc_kmajor(kb, 0), desc_kmajor(kb, 0), false);
    }
    __syncthreads();  // S and dS are read: the next panel's come in meanwhile
    if (tid == 0 && p + 1 < panels) issue_states(p + 1);
    if (wg == 1)
      mma<kSplit, kC / 8, kC>(
          pw, [&](int, int m, int k) { return do_at(k, m); }, desc_kmajor(st_hi, 0),
          desc_kmajor(st_lo, 0), true);
    __syncthreads();  // v and dO are read
    if (tid == 0 && p + 1 < panels) issue_tokens(p + 1);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < kC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int j = acc_col(i, e), c = p * kPanel + acc_row(e);
          dv[(tok0 + j) * ldv + (int64_t)h * Dv + c] = pw[i][e];
          dv[(tok0 + j + 1) * ldv + (int64_t)h * Dv + c] = pw[i][e + 1];
        }
    }
  }

  // after the panels: qd again, and T(mask(dp)) into dp [i][j] and dp^T [j][i]
  if (tid == 0) {
    mbar_arrive_expect_tx(&bars[3], G::kTok);
    load_tokens<kDk, kC>(qd_hi, &map_qd, &bars[3], 0, t0, h, b);
  }
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < kC / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = acc_row(e), j = acc_col(i, e);
        if (ii < kC) {
          float x = 0.f;
          if constexpr (kScalar) {  // dr = T(dp f) and P = dp s
            float p = 0.f;
            if (j <= ii) {
              float sc = tile_at<kC>(st_hi, j, ii);
              if constexpr (kSplit) sc += tile_at<kC>(st_lo, j, ii);
              p = pw[i][e] * sc;
              x = rnd<kBf16>(pw[i][e] * (kScale * expf(gs[ii] - gs[j])));
            }
            pp[ii * kC + j] = p;
          } else if (j <= ii) {
            x = rnd<kBf16>(pw[i][e]);
          }
          put_b<kC, kSplit>(dp_hi, dp_lo, ii, j, x);
          put_b<kC, kSplit>(dpt_hi, dpt_lo, j, ii, x);
        }
      }
    dg_dv[tid] = dg_part;
  }
  fence_async_shared();
  __syncthreads();
  mbar_wait(&bars[3], 0);

  if constexpr (kScalar) {
    // the sums over d of (dO T(S)^T) * q and (v T(dS)^T) * k per token: this
    // lane's two rows, the eight lanes of a column (xor 4, 8, 16), one row
    // of red per warp; then dq's part times e
    const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int i = 0; i < kC / 8; ++i)
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int c = acc_col(i, c2);
        float rq = 0.f, rk = 0.f;
        if (c < kC)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c2, d = d_half + acc_row(e);
            rq = fmaf(dq[i][e], tile_at<kC>(qd_hi, c, d), rq);
            rk = fmaf(dk[i][e], kd_at(c, d), rk);
          }
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          rq += __shfl_xor_sync(0xffffffffu, rq, m);
          rk += __shfl_xor_sync(0xffffffffu, rk, m);
        }
        if (lane < 4 && c < kC) {
          red[warp * kC + c] = rq;
          red[(8 + warp) * kC + c] = rk;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) dq[i][2 * r + c2] *= c < kC ? qf[c] : 0.f;
      }
  }

  // dqd^T [d][i] += kd^T dp^T
  mma<kSplit, kC / 8, kC>(
      dq, [&](int, int m, int k) { return kd_at(k, d_half + m); }, desc_kmajor(dp_hi, 0),
      desc_kmajor(dp_lo, 0), true);
  // dkd^T [d][j] = qd^T dp, plus dkc^T e^{G_last}
  float dkd_t[kC / 8][4];
  mma<kSplit, kC / 8, kC>(
      dkd_t, [&](int, int m, int k) { return tile_at<kC>(qd_hi, k, d_half + m); },
      desc_kmajor(dpt_hi, 0), desc_kmajor(dpt_lo, 0), false);

  float* dqb = dqd + tok0 * ldk + (int64_t)h * kDk;
  float* dkb = dkd + tok0 * ldk + (int64_t)h * kDk;
  float dg_c[2] = {0.f, 0.f};  // sum_C(dkc * kd) over this lane's columns, rows e = 0, 2
#pragma unroll
  for (int i = 0; i < kC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d_half + acc_row(e), c = acc_col(i, e);
      if (c < kC) {
        dqb[c * ldk + d] = dq[i][e];
        dkb[c * ldk + d] = dkd_t[i][e] + dk[i][e] * (kScalar ? af[c] : eg[d]);
        if constexpr (!kScalar) dg_c[e >> 1] = fmaf(dk[i][e], kd_at(c, d), dg_c[e >> 1]);
      }
    }
  if constexpr (kScalar) {
    __syncthreads();  // red and P are complete
    if (tid < kC) {  // token t = tid
      float rq = 0.f, rk = 0.f, row = 0.f, col = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) rq += red[w * kC + tid], rk += red[(8 + w) * kC + tid];
      for (int j = 0; j < kC; ++j) row += pp[tid * kC + j], col += pp[j * kC + tid];
      rk *= af[tid];
      dgt[tid] = rq * qf[tid] - rk + (row - col);
      red[tid] = rk;  // row 0 of red is read: a_t sum_d (v T(dS)^T) k for dG_last
    }
    __syncthreads();
    if (tid == 0) {
      float sk = 0.f, ss = 0.f;
      for (int t = 0; t < kC; ++t) sk += red[t];
      for (int d = 0; d < kDk; ++d) ss += dg_dv[d];
      dgt[kC - 1] += sk + expf(gs[kC - 1]) * ss;
    }
    __syncthreads();
    if (tid < kC) degl[(tok0 + tid) * H + h] = dgt[tid];
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // across the four lanes of a row, in a fixed order
    dg_c[r] += __shfl_xor_sync(0xffffffffu, dg_c[r], 1);
    dg_c[r] += __shfl_xor_sync(0xffffffffu, dg_c[r], 2);
  }
  if ((tid & 3) == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int d = d_half + acc_row(2 * r);
      degl[(int64_t)item * kDk + d] = dg_dv[d] + dg_c[r];
    }
}

template <bool kBf16, int kC, bool kScalar>
int launch_grads(const float* qd, const float* kd, const float* v, const float* egl,
                 const float* states, const float* dout, const float* exits, float* dqd,
                 float* dkd, float* dv, float* degl, int B, int N, int H, int Dv,
                 cudaStream_t stream) {
  typedef GradGeom<kC> G;
  auto kern = gla_grads_kernel<kBf16, kC, kScalar>;
  int blocks = 0;
  int err = hopper_host::resident_blocks((const void*)kern, 256, G::kSmem, &blocks);
  if (err) return err;
  CUtensorMap map_qd, map_kd, map_v, map_do, map_s, map_ds;
  const int T = N * kC;
  err = make_tokens_map(&map_qd, qd, B, T, H, kDk, kC);
  if (!err) err = make_tokens_map(&map_kd, kd, B, T, H, kDk, kC);
  if (!err) err = make_tokens_map(&map_v, v, B, T, H, Dv, kC);
  if (!err) err = make_tokens_map(&map_do, dout, B, T, H, Dv, kC);
  if (!err) err = hopper_host::make_rows_map(&map_s, states, 0, 1, B * N * H * kDk, Dv, kDk);
  if (!err) err = hopper_host::make_rows_map(&map_ds, exits, 0, 1, B * N * H * kDk, Dv, kDk);
  if (err) return err;
  kern<<<B * N * H, 256, G::kSmem, stream>>>(map_qd, map_kd, map_v, map_do, map_s, map_ds, egl,
                                             dqd, dkd, dv, degl, N, H, Dv);
  return (int)cudaGetLastError();
}

template <bool kBf16, int kC, bool kScalar>
int gla_bwd(const float* qd, const float* kd, const float* v, const float* egl,
            const float* states, const float* dout, const float* ds_final, float* exits,
            float* dqd, float* dkd, float* dv, float* degl, float* ds0, int B, int N, int H,
            int Dv, cudaStream_t stream) {
  int err = launch_state<kBf16, kC, false, kScalar>(qd, dout, egl, ds_final, exits, ds0, B, N,
                                                     H, Dv, stream);
  if (err) return err;
  return launch_grads<kBf16, kC, kScalar>(qd, kd, v, egl, states, dout, exits, dqd, dkd, dv,
                                          degl, B, N, H, Dv, stream);
}

template <bool kBf16, bool kScalar>
int gla_bwd_c(const float* qd, const float* kd, const float* v, const float* egl,
              const float* states, const float* dout, const float* ds_final, float* exits,
              float* dqd, float* dkd, float* dv, float* degl, float* ds0, int B, int N, int C,
              int H, int Dv, cudaStream_t stream) {
#define GLA_BWD(c)                                                                        \
  gla_bwd<kBf16, c, kScalar>(qd, kd, v, egl, states, dout, ds_final, exits, dqd, dkd, dv, \
                             degl, ds0, B, N, H, Dv, stream)
  switch (C) {
    case 16: return GLA_BWD(16);
    case 32: return GLA_BWD(32);
    case 48: return GLA_BWD(48);
    default: return GLA_BWD(64);
  }
#undef GLA_BWD
}

template <bool kScalar>
int gla_bwd_entry(const void* qd, const void* kd, const void* v, const void* egl,
                  const void* states, const void* dout, const void* ds_final, void* exits,
                  void* dqd, void* dkd, void* dv, void* degl, void* ds0, int B, int N, int C,
                  int H, int Dk, int Dv, int is_bf16, void* stream) {
  if (!shape_ok(C, Dk, Dv)) return (int)cudaErrorInvalidValue;
  auto f = gla_bwd_c<false, kScalar>;
  if (is_bf16) f = gla_bwd_c<true, kScalar>;
  return f((const float*)qd, (const float*)kd, (const float*)v, (const float*)egl,
           (const float*)states, (const float*)dout, (const float*)ds_final, (float*)exits,
           (float*)dqd, (float*)dkd, (float*)dv, (float*)degl, (float*)ds0, B, N, C, H, Dv,
           (cudaStream_t)stream);
}

}  // namespace

// Plain C entry points (loaded with ctypes): the two launches on the given
// stream, no synchronisation; return the first launch's cudaError_t. qd, kd:
// [B, N*C, H, Dk]; v, dout: [B, N*C, H, Dv] (a bf16 call's values as
// float32 copies; is_bf16 picks the bf16 rounding points and the one
// product); egl, degl: [B, N, H, Dk]; states, exits (scratch): [B, N, H, Dk,
// Dv]; ds_final, ds0: [B, H, Dk, Dv]; dqd, dkd: [B, N*C, H, Dk]; dv: [B, N*C,
// H, Dv]; float32.
extern "C" int mhla_gla_bwd(const void* qd, const void* kd, const void* v, const void* egl,
                            const void* states, const void* dout, const void* ds_final,
                            void* exits, void* dqd, void* dkd, void* dv, void* degl, void* ds0,
                            int B, int N, int C, int H, int Dk, int Dv, int is_bf16,
                            void* stream) {
  return gla_bwd_entry<false>(qd, kd, v, egl, states, dout, ds_final, exits, dqd, dkd, dv, degl,
                              ds0, B, N, C, H, Dk, Dv, is_bf16, stream);
}

// The scalar-decay form (one log-decay per head): q and k undecayed in place
// of qd and kd, the within-chunk cumsum G [B, N*C, H] in place of egl, and
// dG [B, N*C, H] in place of degl; dq and dk are the gradients of q and k.
extern "C" int mhla_gla_bwd_scalar(const void* q, const void* k, const void* v, const void* g,
                                   const void* states, const void* dout, const void* ds_final,
                                   void* exits, void* dq, void* dk, void* dv, void* dg,
                                   void* ds0, int B, int N, int C, int H, int Dk, int Dv,
                                   int is_bf16, void* stream) {
  return gla_bwd_entry<true>(q, k, v, g, states, dout, ds_final, exits, dq, dk, dv, dg, ds0, B,
                             N, C, H, Dk, Dv, is_bf16, stream);
}
