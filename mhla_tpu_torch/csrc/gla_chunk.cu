// K12: forward of chunked gated linear attention (GLA) for Hopper (sm_90a).
//
// Replaces _gla_fwd_kernel (mhla_tpu/kernels/gla_chunk_pallas.py:85), called
// through _gla_fused_fwd_impl (:331-373). Per chunk of C tokens and per head,
// with G the within-chunk inclusive cumsum of the per-key-channel log decay,
// qd = q e^G scale, kd = k e^-G and v (values of the compute dtype T, bf16
// or float32, handed over as float32), e^{G_last} float32 and S the
// chunk-entry state [Dk, Dv] float32:
//
//   kc = T(kd e^{G_last});   u = kc^T v
//   o  = T(mask(qd kd^T)) v + qd T(S)          mask: j <= i
//   S' = e^{G_last} S + u                      (row d decays by e^{G_last, d})
//
// Two launches, every product on the TF32 tensor cores (gla_common.cuh: split
// hi / lo to float32 accuracy in the float32 form, one exact product in bf16):
//
// 1. gla_state_kernel (gla_common.cuh), forward: one block per (batch row,
//    head, 64-column Dv panel) walks the chunks with its part of the state in
//    registers, computes each chunk's kc^T v there and writes each
//    chunk-entry state once, and the final state. The per-chunk products u
//    never reach device memory. 128 blocks at [8, 2048, 4, 128|256].
// 2. gla_readout_kernel below: one block (one warpgroup) per (chunk, head).
//    The TPU kernel's readout is o = T(s) v + qd T(S) with s the masked
//    scores; TF32 wgmma takes K-major operands only, so the block computes
//    o^T = v^T T(s)^T + T(S)^T qd^T, whose B operands are qd as loaded (read
//    along Dk) and the scores, which it writes itself: s^T = kd qd^T first (A
//    = kd from registers), masked, rounded and stored as s [i][j] (hi and
//    lo). Per 64-column Dv panel, A = v^T and T(S)^T come from registers,
//    read across the TMA-loaded v and S panels, which stream through two
//    buffers (the next panel's loads overlap this panel's products); kd's
//    tile lives in the second buffer until the scores are done.
//    1,024 blocks at [8, 2048, 4, 128|256], 4,096 at [1, 32768, 8, 128|128].
//
// The entry states stay in `states` for the backward (float32, every chunk's:
// 134 MB a layer at [8, 2048, 4, 128|256]; the TPU kernel saves only the
// supertile-entry states and replays the chain, :38-41).
//
// Bound at [8, 2048, 4, 128|256], float32 (the layer's form; chip_smoke.py
// gla_work): 0.34 GB with the entry states, 0.10 ms at 3.35 TB/s; 10.2 GFLOP,
// three TF32 products each for float32 accuracy, 0.062 ms at 495 TFLOP/s:
// bytes. (On float32 FMAs outside the tensor cores the same work was 0.153
// ms at 67 TFLOP/s, the bound of the kernel this one replaced.)
//
// The scalar-decay form (mhla_gla_fwd_scalar: one log-decay per head, the
// Mamba2 and simple GLA layers) computes the same function in difference
// form, so that no factor overflows: with G [B, T, H] and q, k undecayed,
//   o  = T(mask(q k^T kScale e^{G_i - G_j})) v + T(q kScale e^{G}) T(S)
//   S' = e^{G_last} S + T(k e^{G_last - G})^T v
// every exponent <= 0 (the factored kd = k e^{-G} overflows float32 once a
// chunk's summed log-decay falls below about -88, which Mamba2's decay,
// A dt with A up to 16, reaches). The state pass forms each token's factor
// in registers; the readout scales the raw score tile by e^{G_i - G_j}
// (the rows' and columns' G in shared memory) and rewrites its q tile into
// qd in place before the inter-chunk products. Same launches, tiles and
// rounding points otherwise.

#include "gla_common.cuh"

using namespace gla;

namespace {

template <int kC>
struct ReadGeom {
  static constexpr int kTok = tile_bytes(kC, kDk);       // qd or kd: [C][128]
  static constexpr int kSq = tile_bytes(kC, kC);         // s: [C][C]
  static constexpr int kV = tile_bytes(kC, kPanel);      // v panel: [C][64]
  static constexpr int kS = tile_bytes(kDk, kPanel);     // S panel: [128][64]
  static constexpr int kBuf = kV + kS;
  static_assert(kTok <= kBuf, "kd's tile fits a panel buffer");
  // mbarriers; kScalar: the chunk's G and q's factors kScale e^{G}; alignment
  static constexpr int kSmem = 2 * kTok + 2 * kSq + 2 * kBuf + 64 + 2 * kC * 4 + 1024;
  static_assert(kSmem <= kSmemLimit, "one block's shared memory");
};

// K12's readout. grid B * N * H, 128 threads. maps: [B, T, H, Dk] (qd, kd),
// [B, T, H, Dv] (v), float32, boxes of 32 columns by C tokens; map_s: the
// entry states [B * N * H * Dk, Dv] float32, boxes of 32 columns by 128 rows;
// o: [B, T, H, Dv] in OutT.
//
// kScalar (one log-decay per head; g: G [B, T, H] float32, the within-chunk
// cumsum): the maps hold the undecayed q and k. The scores are formed from
// the raw product, s[i][j] = T((q_i k_j) kScale e^{G_i - G_j}) for j <= i
// (the exponent taken only there, so it is <= 0), and the q tile is then
// rewritten in place as qd = T(q kScale e^{G}) for the inter-chunk term.
template <bool kBf16, int kC, typename OutT, bool kScalar>
__global__ void __launch_bounds__(128)
gla_readout_kernel(const __grid_constant__ CUtensorMap map_qd,
                   const __grid_constant__ CUtensorMap map_kd,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_s, const float* __restrict__ g,
                   OutT* __restrict__ o, int N, int H, int Dv) {
  typedef ReadGeom<kC> G;
  constexpr bool kSplit = !kBf16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* qd_hi = reinterpret_cast<float*>(smem);
  float* qd_lo = reinterpret_cast<float*>(smem + G::kTok);
  float* s_hi = reinterpret_cast<float*>(smem + 2 * G::kTok);
  float* s_lo = reinterpret_cast<float*>(smem + 2 * G::kTok + G::kSq);
  unsigned char* bufs = smem + 2 * G::kTok + 2 * G::kSq;
  uint64_t* bars = reinterpret_cast<uint64_t*>(bufs + 2 * G::kBuf);  // qd / kd, buffer 0, 1
  float* gs = reinterpret_cast<float*>(bufs + 2 * G::kBuf + 64);  // kScalar: G of the chunk
  float* qf = gs + kC;                                             // and kScale e^{G}
  float* kd = reinterpret_cast<float*>(bufs + G::kBuf);

  const int item = blockIdx.x;
  const int h = item % H, bn = item / H, n = bn % N, b = bn / N;
  const int t0 = n * kC, panels = Dv / kPanel;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
  }
  if constexpr (kScalar)
    if (tid < kC) {
      const float gt = g[((int64_t)b * N * kC + t0 + tid) * H + h];
      gs[tid] = gt;
      qf[tid] = kScale * expf(gt);
    }
  __syncthreads();
  auto issue_panel = [&](int p) {
    unsigned char* buf = bufs + (p & 1) * G::kBuf;
    mbar_arrive_expect_tx(&bars[1 + (p & 1)], G::kBuf);
    load_tokens<kPanel, kC>(buf, &map_v, &bars[1 + (p & 1)], p * kPanel, t0, h, b);
    load_rows<kPanel, kDk>(buf + G::kV, &map_s, &bars[1 + (p & 1)], p * kPanel, item * kDk);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(&bars[0], 2 * G::kTok);
    load_tokens<kDk, kC>(qd_hi, &map_qd, &bars[0], 0, t0, h, b);
    load_tokens<kDk, kC>(kd, &map_kd, &bars[0], 0, t0, h, b);
    issue_panel(0);
  }
  mbar_wait(&bars[0], 0);
  if constexpr (kSplit) split_tile(qd_hi, qd_lo, G::kTok, tid, 128);
  fence_async_shared();
  __syncthreads();

  // s^T [j][i] = kd qd^T (rows j past C zero), then T(mask(s)) into s [i][j]
  {
    float acc[kC / 8][4];
    mma<kSplit, kDk / 8, kC>(
        acc, [&](int, int m, int k) { return m < kC ? tile_at<kC>(kd, m, k) : 0.f; },
        desc_kmajor(qd_hi, 0), desc_kmajor(qd_lo, 0), false);
#pragma unroll
    for (int i = 0; i < kC / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = acc_row(e), ii = acc_col(i, e);
        float x = 0.f;
        if (j <= ii) x = kScalar ? acc[i][e] * (kScale * expf(gs[ii] - gs[j])) : acc[i][e];
        if (j < kC) put_b<kC, kSplit>(s_hi, s_lo, ii, j, rnd<kBf16>(x));
      }
  }
  fence_async_shared();
  __syncthreads();  // s written; kd read: buffer 1 is free
  if (tid == 0 && panels > 1) issue_panel(1);
  if constexpr (kScalar) {  // q -> qd = T(q kScale e^{G}), in place
    for (int e = tid; e < kC * kDk; e += 128) {
      const int i = e / kDk, d = e % kDk;
      float x = tile_at<kC>(qd_hi, i, d);
      if constexpr (kSplit) x += tile_at<kC>(qd_lo, i, d);
      put_b<kC, kSplit>(qd_hi, qd_lo, i, d, rnd<kBf16>(x * qf[i]));
    }
    fence_async_shared();
    __syncthreads();
  }

  const uint64_t sh = desc_kmajor(s_hi, 0), sl = desc_kmajor(s_lo, 0);
  const uint64_t qh = desc_kmajor(qd_hi, 0), ql = desc_kmajor(qd_lo, 0);
  const int64_t ldo = (int64_t)H * Dv;
  OutT* ob = o + ((int64_t)b * N * kC + t0) * ldo + (int64_t)h * Dv;
  for (int p = 0; p < panels; ++p) {
    mbar_wait(&bars[1 + (p & 1)], (p >> 1) & 1);
    const float* vt = reinterpret_cast<const float*>(bufs + (p & 1) * G::kBuf);
    const float* st = reinterpret_cast<const float*>(bufs + (p & 1) * G::kBuf + G::kV);
    // o^T [dv][i] = v^T T(s)^T + T(S)^T qd^T
    float acc[kC / 8][4];
    mma<kSplit, kC / 8, kC>(
        acc, [&](int, int m, int k) { return tile_at<kC>(vt, k, m); }, sh, sl, false);
    mma<kSplit, kDk / 8, kC>(
        acc, [&](int, int m, int k) { return rnd<kBf16>(tile_at<kDk>(st, k, m)); }, qh, ql,
        true);
    __syncthreads();  // every warp is done with this buffer
    if (tid == 0 && p + 2 < panels) issue_panel(p + 2);
#pragma unroll
    for (int i = 0; i < kC / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = acc[i][e];
        OutT* dst = ob + (int64_t)acc_col(i, e) * ldo + p * kPanel + acc_row(e);
        if constexpr (sizeof(OutT) == 2) *dst = __float2bfloat16(x);
        else *dst = x;
      }
  }
}

template <bool kBf16, int kC, typename OutT, bool kScalar>
int launch_readout(const float* qd, const float* kd, const float* v, const float* states,
                   const float* g, OutT* o, int B, int N, int H, int Dv, cudaStream_t stream) {
  typedef ReadGeom<kC> G;
  auto kern = gla_readout_kernel<kBf16, kC, OutT, kScalar>;
  int blocks = 0;
  int err = hopper_host::resident_blocks((const void*)kern, 128, G::kSmem, &blocks);
  if (err) return err;
  CUtensorMap map_qd, map_kd, map_v, map_s;
  const int T = N * kC;
  err = make_tokens_map(&map_qd, qd, B, T, H, kDk, kC);
  if (!err) err = make_tokens_map(&map_kd, kd, B, T, H, kDk, kC);
  if (!err) err = make_tokens_map(&map_v, v, B, T, H, Dv, kC);
  if (!err) err = hopper_host::make_rows_map(&map_s, states, 0, 1, B * N * H * kDk, Dv, kDk);
  if (err) return err;
  kern<<<B * N * H, 128, G::kSmem, stream>>>(map_qd, map_kd, map_v, map_s, g, o, N, H, Dv);
  return (int)cudaGetLastError();
}

// gate: e^{G_last} [B, N, H, Dk] or (kScalar) G [B, N*C, H]
template <bool kBf16, int kC, bool kScalar>
int gla_fwd(const float* qd, const float* kd, const float* v, const float* gate,
            const float* s0, void* o, float* s_final, float* states, int B, int N, int H, int Dv,
            cudaStream_t stream) {
  int err = launch_state<kBf16, kC, true, kScalar>(kd, v, gate, s0, states, s_final, B, N, H,
                                                    Dv, stream);
  if (err) return err;
  const float* g = kScalar ? gate : nullptr;
  if constexpr (kBf16)
    return launch_readout<true, kC, bf16, kScalar>(qd, kd, v, states, g, (bf16*)o, B, N, H, Dv,
                                                   stream);
  else
    return launch_readout<false, kC, float, kScalar>(qd, kd, v, states, g, (float*)o, B, N, H,
                                                     Dv, stream);
}

template <bool kBf16, bool kScalar>
int gla_fwd_c(const float* qd, const float* kd, const float* v, const float* gate,
              const float* s0, void* o, float* s_final, float* states, int B, int N, int C,
              int H, int Dv, cudaStream_t stream) {
#define GLA_FWD(c) \
  gla_fwd<kBf16, c, kScalar>(qd, kd, v, gate, s0, o, s_final, states, B, N, H, Dv, stream)
  switch (C) {
    case 16: return GLA_FWD(16);
    case 32: return GLA_FWD(32);
    case 48: return GLA_FWD(48);
    default: return GLA_FWD(64);
  }
#undef GLA_FWD
}

template <bool kScalar>
int gla_fwd_entry(const void* qd, const void* kd, const void* v, const void* gate,
                  const void* s0, void* o, void* s_final, void* states, int B, int N, int C,
                  int H, int Dk, int Dv, int is_bf16, void* stream) {
  if (!shape_ok(C, Dk, Dv)) return (int)cudaErrorInvalidValue;
  auto f = gla_fwd_c<false, kScalar>;
  if (is_bf16) f = gla_fwd_c<true, kScalar>;
  return f((const float*)qd, (const float*)kd, (const float*)v, (const float*)gate,
           (const float*)s0, o, (float*)s_final, (float*)states, B, N, C, H, Dv,
           (cudaStream_t)stream);
}

}  // namespace

// Plain C entry points (loaded with ctypes): the two launches on the given
// stream, no synchronisation; return the first launch's cudaError_t. qd, kd:
// [B, N*C, H, Dk]; v: [B, N*C, H, Dv]; egl: [B, N, H, Dk]; s0, s_final: [B,
// H, Dk, Dv]; states: [B, N, H, Dk, Dv]; all float32 (a bf16 call's inputs
// as float32 copies); o: [B, N*C, H, Dv] in the compute dtype (bf16 where
// is_bf16, which also picks the bf16 rounding points and the one product).
extern "C" int mhla_gla_fwd(const void* qd, const void* kd, const void* v, const void* egl,
                            const void* s0, void* o, void* s_final, void* states, int B, int N,
                            int C, int H, int Dk, int Dv, int is_bf16, void* stream) {
  return gla_fwd_entry<false>(qd, kd, v, egl, s0, o, s_final, states, B, N, C, H, Dk, Dv,
                              is_bf16, stream);
}

// The scalar-decay form (one log-decay per head): q and k undecayed in place
// of qd and kd, and the within-chunk cumsum G [B, N*C, H] float32 in place of
// egl; the rest as mhla_gla_fwd.
extern "C" int mhla_gla_fwd_scalar(const void* q, const void* k, const void* v, const void* g,
                                   const void* s0, void* o, void* s_final, void* states, int B,
                                   int N, int C, int H, int Dk, int Dv, int is_bf16,
                                   void* stream) {
  return gla_fwd_entry<true>(q, k, v, g, s0, o, s_final, states, B, N, C, H, Dk, Dv, is_bf16,
                             stream);
}
