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
// hands each chunk's exit cotangent to a fully parallel gradient pass. After
// the forward's prep pass (delta_prep_kernel, recomputed: T, w, P, qd, kc):
//
// delta_bwd_chain_kernel, grid (Dv/64, H, B), 256 threads: walks its chain
//   in reverse, dS carried in float32 shared memory, per chunk
//     dv_eff = P^T dO + kc bf16(dS);  dS = e^{G_last} dS + qd^T dO - w^T bf16(dv_eff)
//   and writes bf16(dS) at every chunk exit ([B, N, H, Dk, Dv], 67 MB per
//   layer at [8, 2048, 4, 128|256]) and ds0. Like the forward chain it owns a
//   64-column tile of Dv: 128 blocks at the training shape.
//
// delta_bwd_grads_a_kernel, grid (B*N, H), 512 threads: per chunk, with the
//   saved entry state S and the exit cotangent dS, walks Dv in tiles of 64
//   and forms u = T (beta v), v_eff = u - w S, dv_eff, dmu = T^T dv_eff,
//   dv = beta dmu, and accumulates every sum over Dv in registers (WMMA
//   accumulators, eight per warp): dkc = v_eff dS^T, dqd = dO S^T,
//   dw = dv_eff S^T, dP = dO v_eff^T, dA_u = dmu u^T; beta's row sums of
//   dmu v and sum(S * dS). These go to global memory in float32 (128 KB per
//   (chunk, head)).
//
// delta_bwd_grads_b_kernel, grid (B*N, H), 256 threads: the rest of the
//   chunk's gradient: dmw = T^T bf16(-dw), dA = -(dA_u + bf16(dmw) w^T),
//   the pairwise terms (kk and qk recomputed on the tensor cores, the decays
//   from differences of G), dq = dqd e^G scale + bf16(dP decay) k and
//   dk = dkc e^{G_last-G} + dmw beta e^G + dkk k + dkk^T k + dqk^T q, and
//   dG (row sums minus column sums of the pairwise term, the last row taking
//   the decay of the carried state) and dbeta.
//
// Every sum over Dv or over a chunk is taken in a fixed order (tile order,
// fixed shuffles, column sums by one thread each): no atomics, so two runs
// give the same bits, as K9b and K10b do.
//
// Bound at [8, 2048, 4, 128|256] bf16: operations, about three times K11's
// products (~60 GFLOP, 0.06 ms at 989 TFLOP/s); the bytes it must move (q,
// k, v, dO, dq, dk, dv and the saved states) are ~270 MB (0.08 ms). The
// float32 partials between the two gradient passes (134 MB) and the exit
// cotangents (67 MB) are this version's own traffic. Tiles arrive by
// cp.async, every copy of a block in flight at once.
//
// Rounding points are those of the TPU kernel (T, w, P, qd, kc, v_eff,
// dv_eff, u, dmu, dw, dmw, dkk and dqk in bf16 before their products; the
// products summed in float32); the saved states and exit cotangents are
// bf16. The plain version (kernels/delta_chunk.py delta_chunk_bwd_plain)
// does the same.

#include "delta_common.cuh"

using namespace delta;

namespace {

constexpr int kChainWarps = 8;
constexpr int kChainThreads = kChainWarps * 32;

constexpr size_t kBwdChainSmem =
    (size_t)kDk * kLdCf * sizeof(float)          // dS
    + (size_t)kDk * kLdC * sizeof(bf16)          // bf16(dS)
    + (size_t)3 * kMaxC * kLdC * sizeof(bf16)    // P, dO, bf16(dv_eff)
    + (size_t)3 * kMaxC * kLdK * sizeof(bf16)    // kc, qd, w
    + (size_t)kChainWarps * 256 * sizeof(float);

// grid (Dv / kTile, H, B). p: [B, N, H, C, C]; qd, w, kc: [B, N, H, C, Dk]
// bf16; dout: [B, N*C, H, Dv] bf16; G: [B, N*C, H]; ds_final, ds0:
// [B, H, Dk, Dv] float32; exits: [B, N, H, Dk, Dv] bf16.
__global__ void __launch_bounds__(kChainThreads)
delta_bwd_chain_kernel(const bf16* __restrict__ p, const bf16* __restrict__ qd,
                       const bf16* __restrict__ w, const bf16* __restrict__ kc,
                       const bf16* __restrict__ dout, const float* __restrict__ G,
                       const float* __restrict__ ds_final, bf16* __restrict__ exits,
                       float* __restrict__ ds0, int N, int C, int H, int Dv) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* dzf = reinterpret_cast<float*>(smem);
  bf16* dzc = reinterpret_cast<bf16*>(dzf + kDk * kLdCf);
  bf16* ps = dzc + kDk * kLdC;
  bf16* dos = ps + kMaxC * kLdC;
  bf16* dve = dos + kMaxC * kLdC;
  bf16* kcs = dve + kMaxC * kLdC;
  bf16* qds = kcs + kMaxC * kLdK;
  bf16* ws = qds + kMaxC * kLdK;
  float* stage = reinterpret_cast<float*>(ws + kMaxC * kLdK) + (threadIdx.x >> 5) * 256;

  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int64_t ldv = (int64_t)H * Dv;
  const int ct = C / kFrag;

  const float* dsc = ds_final + ((int64_t)b * H + h) * kDk * Dv + col0;
  for (int e = threadIdx.x; e < kDk * kTile; e += blockDim.x)
    dzf[(e / kTile) * kLdCf + e % kTile] = dsc[(int64_t)(e / kTile) * Dv + e % kTile];
  __syncthreads();

  for (int n = N - 1; n >= 0; --n) {
    const int64_t bn = (int64_t)b * N + n, pc = bn * H + h;
    load_rows(ps, kLdC, p + pc * C * C, C, C, C);
    load_rows(kcs, kLdK, kc + pc * C * kDk, kDk, C, kDk);
    load_rows(qds, kLdK, qd + pc * C * kDk, kDk, C, kDk);
    load_rows(ws, kLdK, w + pc * C * kDk, kDk, C, kDk);
    load_rows(dos, kLdC, dout + (bn * C * H + h) * Dv + col0, ldv, C, kTile);
    bf16* ex = exits + pc * kDk * Dv + col0;
    for (int e = threadIdx.x; e < kDk * kTile / 8; e += blockDim.x) {
      const int r = e / (kTile / 8), c = (e % (kTile / 8)) * 8;
      float x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = dzf[r * kLdCf + c + i];
      store8(dzc + r * kLdC + c, x);
      store8(ex + (int64_t)r * Dv + c, x);
    }
    const float el = expf(G[(bn * C + C - 1) * H + h]);
    sync_loads();

    // dv_eff = P^T dO + kc bf16(dS)
    for (int f = warp; f < ct * (kTile / kFrag); f += kChainWarps) {
      const int m0 = (f / (kTile / kFrag)) * kFrag, n0 = (f % (kTile / kFrag)) * kFrag;
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
      mma_tile<true, false>(acc, ps, kLdC, dos, kLdC, m0, n0, C);
      mma_tile<false, false>(acc, kcs, kLdK, dzc, kLdC, m0, n0, kDk);
      store_bf16(acc, stage, dve + m0 * kLdC + n0, kLdC);
    }
    __syncthreads();

    // dS = e^{G_last} dS + qd^T dO - w^T bf16(dv_eff)
    for (int f = warp; f < (kDk / kFrag) * (kTile / kFrag); f += kChainWarps) {
      const int m0 = (f / (kTile / kFrag)) * kFrag, n0 = (f % (kTile / kFrag)) * kFrag;
      Acc acc, wd;
      wmma::load_matrix_sync(acc, dzf + m0 * kLdCf + n0, kLdCf, wmma::mem_row_major);
#pragma unroll
      for (int i = 0; i < acc.num_elements; ++i) acc.x[i] *= el;
      mma_tile<true, false>(acc, qds, kLdK, dos, kLdC, m0, n0, C);
      wmma::fill_fragment(wd, 0.0f);
      mma_tile<true, false>(wd, ws, kLdK, dve, kLdC, m0, n0, C);
#pragma unroll
      for (int i = 0; i < acc.num_elements; ++i) acc.x[i] -= wd.x[i];
      wmma::store_matrix_sync(dzf + m0 * kLdCf + n0, acc, kLdCf, wmma::mem_row_major);
    }
    __syncthreads();
  }

  float* d0 = ds0 + ((int64_t)b * H + h) * kDk * Dv + col0;
  for (int e = threadIdx.x; e < kDk * kTile; e += blockDim.x)
    d0[(int64_t)(e / kTile) * Dv + e % kTile] = dzf[(e / kTile) * kLdCf + e % kTile];
}

constexpr int kAWarps = 16;
constexpr int kAThreads = kAWarps * 32;

constexpr size_t kGradsASmem =
    (size_t)8 * kMaxC * kLdC * sizeof(bf16)      // T, P, v, bf16(beta v)|bf16(dmu), dO, u, v_eff, dv_eff
    + (size_t)2 * kMaxC * kLdK * sizeof(bf16)    // w, kc
    + (size_t)2 * kDk * kLdC * sizeof(bf16)      // S, dS (one Dv tile)
    + (size_t)kMaxC * kLdCf * sizeof(float)      // dmu
    + (size_t)kAWarps * 256 * sizeof(float)      // staging
    + (size_t)(kMaxC + kMaxWarps) * sizeof(float);

// grid (B*N, H). v, dout, dv: [B, N*C, H, Dv] bf16; beta: [B, N*C, H];
// states, exits: [B, N, H, Dk, Dv] bf16; tc, p: [B, N, H, C, C] bf16; w, kc:
// [B, N, H, C, Dk] bf16; out: dkc, dqd, dw [B, N, H, C, Dk], dp, dau
// [B, N, H, C, C], dbeta_part [B, N, H, C], dgl_part [B, N, H], float32.
__global__ void __launch_bounds__(kAThreads)
delta_bwd_grads_a_kernel(const bf16* __restrict__ v, const float* __restrict__ beta,
                         const bf16* __restrict__ states, const bf16* __restrict__ exits,
                         const bf16* __restrict__ dout, const bf16* __restrict__ tc,
                         const bf16* __restrict__ w, const bf16* __restrict__ p,
                         const bf16* __restrict__ kc, float* __restrict__ dkc_out,
                         float* __restrict__ dqd_out, float* __restrict__ dw_out,
                         float* __restrict__ dp_out, float* __restrict__ dau_out,
                         float* __restrict__ dbeta_out, float* __restrict__ dgl_out,
                         bf16* __restrict__ dv_out, int C, int H, int Dv) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* tcs = reinterpret_cast<bf16*>(smem);
  bf16* ps = tcs + kMaxC * kLdC;
  bf16* vs = ps + kMaxC * kLdC;
  bf16* vb = vs + kMaxC * kLdC;  // bf16(beta v), then bf16(dmu)
  bf16* dos = vb + kMaxC * kLdC;
  bf16* uc = dos + kMaxC * kLdC;
  bf16* ve = uc + kMaxC * kLdC;
  bf16* dve = ve + kMaxC * kLdC;
  bf16* ws = dve + kMaxC * kLdC;
  bf16* kcs = ws + kMaxC * kLdK;
  bf16* s_in = kcs + kMaxC * kLdK;
  bf16* dz = s_in + kDk * kLdC;
  float* dmu = reinterpret_cast<float*>(dz + kDk * kLdC);
  float* stage = dmu + kMaxC * kLdCf + (threadIdx.x >> 5) * 256;
  float* bs = dmu + kMaxC * kLdCf + kAWarps * 256;
  float* red = bs + kMaxC;

  const int warp = threadIdx.x >> 5;
  const int64_t bn = blockIdx.x;
  const int h = blockIdx.y;
  const int64_t pc = bn * H + h;
  const int64_t ldv = (int64_t)H * Dv;
  const int ct = C / kFrag;
  constexpr int kt = kTile / kFrag;  // 16-column tiles across a Dv tile
  constexpr int dt = kDk / kFrag;    // 16-column tiles across Dk

  load_rows(tcs, kLdC, tc + pc * C * C, C, C, C);
  load_rows(ps, kLdC, p + pc * C * C, C, C, C);
  load_rows(ws, kLdK, w + pc * C * kDk, kDk, C, kDk);
  load_rows(kcs, kLdK, kc + pc * C * kDk, kDk, C, kDk);
  for (int r = threadIdx.x; r < C; r += blockDim.x) bs[r] = beta[(bn * C + r) * H + h];

  // the sums over Dv, in registers: tiles warp and warp + 16 of the [C, Dk]
  // ones, tile warp of the [C, C] ones
  Acc acc_kc[2], acc_qd[2], acc_w[2], acc_p, acc_au;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    wmma::fill_fragment(acc_kc[i], 0.0f);
    wmma::fill_fragment(acc_qd[i], 0.0f);
    wmma::fill_fragment(acc_w[i], 0.0f);
  }
  wmma::fill_fragment(acc_p, 0.0f);
  wmma::fill_fragment(acc_au, 0.0f);
  const int row = threadIdx.x >> 3, cgrp = (threadIdx.x & 7) * 8;  // elementwise [C, kTile]
  float drow = 0.f, dgl = 0.f;

  for (int col0 = 0; col0 < Dv; col0 += kTile) {
    const bf16* st = states + pc * kDk * Dv + col0;
    const bf16* ex = exits + pc * kDk * Dv + col0;
    load_rows(s_in, kLdC, st, Dv, kDk, kTile);
    load_rows(dz, kLdC, ex, Dv, kDk, kTile);
    load_rows(vs, kLdC, v + (bn * C * H + h) * Dv + col0, ldv, C, kTile);
    load_rows(dos, kLdC, dout + (bn * C * H + h) * Dv + col0, ldv, C, kTile);
    sync_loads();
    if (row < C) {
      float x[8];
      load8(vs + row * kLdC + cgrp, x);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] *= bs[row];
      store8(vb + row * kLdC + cgrp, x);
    }
    for (int e = threadIdx.x; e < kDk * kTile / 8; e += blockDim.x) {
      const int r = e / (kTile / 8), c = (e % (kTile / 8)) * 8;
      float a[8], d[8];
      load8(s_in + r * kLdC + c, a);
      load8(dz + r * kLdC + c, d);
#pragma unroll
      for (int i = 0; i < 8; ++i) dgl = fmaf(a[i], d[i], dgl);
    }
    __syncthreads();

    // u = T bf16(beta v); v_eff = u - w S; dv_eff = P^T dO + kc dS (one tile a warp)
    if (warp < ct * kt) {
      const int m0 = (warp / kt) * kFrag, n0 = (warp % kt) * kFrag;
      Acc u, wsv, dv;
      wmma::fill_fragment(u, 0.0f);
      wmma::fill_fragment(wsv, 0.0f);
      wmma::fill_fragment(dv, 0.0f);
      mma_tile<false, false>(u, tcs, kLdC, vb, kLdC, m0, n0, C);
      store_bf16(u, stage, uc + m0 * kLdC + n0, kLdC);
      mma_tile<false, false>(wsv, ws, kLdK, s_in, kLdC, m0, n0, kDk);
#pragma unroll
      for (int i = 0; i < u.num_elements; ++i) u.x[i] -= wsv.x[i];
      store_bf16(u, stage, ve + m0 * kLdC + n0, kLdC);
      mma_tile<true, false>(dv, ps, kLdC, dos, kLdC, m0, n0, C);
      mma_tile<false, false>(dv, kcs, kLdK, dz, kLdC, m0, n0, kDk);
      store_bf16(dv, stage, dve + m0 * kLdC + n0, kLdC);
    }
    __syncthreads();

    // dmu = T^T bf16(dv_eff)
    if (warp < ct * kt) {
      const int m0 = (warp / kt) * kFrag, n0 = (warp % kt) * kFrag;
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
      mma_tile<true, false>(acc, tcs, kLdC, dve, kLdC, m0, n0, C);
      wmma::store_matrix_sync(dmu + m0 * kLdCf + n0, acc, kLdCf, wmma::mem_row_major);
    }
    __syncthreads();

    // dv = bf16(beta dmu); beta's row sums of dmu v; bf16(dmu)
    if (row < C) {
      float m[8], x[8], d[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) m[i] = dmu[row * kLdCf + cgrp + i];
      load8(vs + row * kLdC + cgrp, x);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        drow = fmaf(m[i], x[i], drow);
        d[i] = m[i] * bs[row];
      }
      store8(dv_out + ((bn * C + row) * H + h) * Dv + col0 + cgrp, d);
      store8(vb + row * kLdC + cgrp, m);
    }
    __syncthreads();

    // the sums over Dv: dkc += v_eff dS^T, dqd += dO S^T, dw += dv_eff S^T,
    // dP += dO v_eff^T, dA_u += dmu u^T
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = warp + kAWarps * i;
      if (t < ct * dt) {
        const int m0 = (t / dt) * kFrag, n0 = (t % dt) * kFrag;
        mma_tile<false, true>(acc_kc[i], ve, kLdC, dz, kLdC, m0, n0, kTile);
        mma_tile<false, true>(acc_qd[i], dos, kLdC, s_in, kLdC, m0, n0, kTile);
        mma_tile<false, true>(acc_w[i], dve, kLdC, s_in, kLdC, m0, n0, kTile);
      }
    }
    if (warp < ct * ct) {
      const int m0 = (warp / ct) * kFrag, n0 = (warp % ct) * kFrag;
      mma_tile<false, true>(acc_p, dos, kLdC, ve, kLdC, m0, n0, kTile);
      mma_tile<false, true>(acc_au, vb, kLdC, uc, kLdC, m0, n0, kTile);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = warp + kAWarps * i;
    if (t < ct * dt) {
      const int64_t off = pc * C * kDk + (t / dt) * kFrag * kDk + (t % dt) * kFrag;
      wmma::store_matrix_sync(dkc_out + off, acc_kc[i], kDk, wmma::mem_row_major);
      wmma::store_matrix_sync(dqd_out + off, acc_qd[i], kDk, wmma::mem_row_major);
      wmma::store_matrix_sync(dw_out + off, acc_w[i], kDk, wmma::mem_row_major);
    }
  }
  if (warp < ct * ct) {
    const int64_t off = pc * C * C + (warp / ct) * kFrag * C + (warp % ct) * kFrag;
    wmma::store_matrix_sync(dp_out + off, acc_p, C, wmma::mem_row_major);
    wmma::store_matrix_sync(dau_out + off, acc_au, C, wmma::mem_row_major);
  }
  drow += __shfl_xor_sync(0xffffffffu, drow, 4);
  drow += __shfl_xor_sync(0xffffffffu, drow, 2);
  drow += __shfl_xor_sync(0xffffffffu, drow, 1);
  if ((threadIdx.x & 7) == 0 && row < C) dbeta_out[pc * C + row] = drow;
  const float tot = block_sum(dgl, red);
  if (threadIdx.x == 0) dgl_out[pc] = tot;
}

constexpr int kBWarps = 8;
constexpr int kBThreads = kBWarps * 32;
constexpr int kF1Floats = (kMaxC * kLdKf > 2 * kMaxC * kLdCf) ? kMaxC * kLdKf : 2 * kMaxC * kLdCf;

constexpr size_t kGradsBSmem =
    (size_t)3 * kMaxC * kLdK * sizeof(bf16)      // q, k, bf16(-dw) then bf16(dmw)
    + (size_t)2 * kMaxC * kLdKf * sizeof(float)  // dq and dk's elementwise terms
    + (size_t)kF1Floats * sizeof(float)          // dmw, then kk and qk
    + (size_t)kMaxC * kLdCf * sizeof(float)      // dA, then the pairwise term
    + (size_t)2 * kMaxC * kLdC * sizeof(bf16)    // bf16(dkk), bf16(dqk)
    + (size_t)kBWarps * 256 * sizeof(float)      // staging
    + (size_t)(4 * kMaxC + kMaxWarps) * sizeof(float);

// grid (B*N, H). q, k, dq, dk: [B, N*C, H, Dk] bf16; G, beta, dg, dbeta:
// [B, N*C, H] float32; tc: [B, N, H, C, C] and w: [B, N, H, C, Dk] bf16;
// the partials of delta_bwd_grads_a_kernel.
__global__ void __launch_bounds__(kBThreads)
delta_bwd_grads_b_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const float* __restrict__ G, const float* __restrict__ beta,
                         const bf16* __restrict__ tc, const bf16* __restrict__ w,
                         const float* __restrict__ dkc, const float* __restrict__ dqd,
                         const float* __restrict__ dw, const float* __restrict__ dp,
                         const float* __restrict__ dau, const float* __restrict__ dbeta_part,
                         const float* __restrict__ dgl_part, bf16* __restrict__ dq_out,
                         bf16* __restrict__ dk_out, float* __restrict__ dg_out,
                         float* __restrict__ dbeta_out, int C, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kMaxC * kLdK;
  bf16* dwc = ks + kMaxC * kLdK;
  float* xq = reinterpret_cast<float*>(dwc + kMaxC * kLdK);
  float* xk = xq + kMaxC * kLdKf;
  float* f1 = xk + kMaxC * kLdKf;
  float* da = f1 + kF1Floats;
  bf16* dkk = reinterpret_cast<bf16*>(da + kMaxC * kLdCf);
  bf16* dqk = dkk + kMaxC * kLdC;
  float* stage = reinterpret_cast<float*>(dqk + kMaxC * kLdC) + (threadIdx.x >> 5) * 256;
  float* gs = reinterpret_cast<float*>(dqk + kMaxC * kLdC) + kBWarps * 256;
  float* bs = gs + kMaxC;
  float* dgr = bs + kMaxC;
  float* dbr = dgr + kMaxC;
  float* red = dbr + kMaxC;

  const int warp = threadIdx.x >> 5;
  const int64_t bn = blockIdx.x;
  const int h = blockIdx.y;
  const int64_t pc = bn * H + h;
  const int64_t ldq = (int64_t)H * kDk;
  const float scale = 1.0f / sqrtf((float)kDk);
  const int ct = C / kFrag;
  constexpr int dt = kDk / kFrag;

  load_rows(qs, kLdK, q + (bn * C * H + h) * kDk, ldq, C, kDk);
  load_rows(ks, kLdK, k + (bn * C * H + h) * kDk, ldq, C, kDk);
  for (int r = threadIdx.x; r < C; r += blockDim.x) {
    gs[r] = G[(bn * C + r) * H + h];
    bs[r] = beta[(bn * C + r) * H + h];
  }
  const float* dqdg = dqd + pc * C * kDk;
  const float* dkcg = dkc + pc * C * kDk;
  const float* dwg = dw + pc * C * kDk;
  for (int e = threadIdx.x; e < C * kDk / 4; e += blockDim.x) {
    const int r = e / (kDk / 4), c = (e % (kDk / 4)) * 4;
    cp_async16(xq + r * kLdKf + c, dqdg + r * kDk + c);
    cp_async16(xk + r * kLdKf + c, dkcg + r * kDk + c);
  }
  sync_loads();

  // each row is four threads, each a quarter of the row's columns
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  float dg_acc = 0.f, db_acc = 0.f, dgl_acc = 0.f;
  const float eg = row < C ? expf(gs[row]) : 0.f;
  const float ec = row < C ? expf(gs[C - 1] - gs[row]) : 0.f;
  const float btr = row < C ? bs[row] : 0.f;

  // 1. qd = q e^G scale, kc = k e^{G_last - G}: dG gets dqd . qd - dkc . kc,
  //    the carried decay dkc . kc; dq_x = dqd e^G scale, dk_x = dkc e^{G_last - G};
  //    bf16(-dw)
  if (row < C) {
    for (int d = part * (kDk / 4); d < (part + 1) * (kDk / 4); ++d) {
      const float qv = __bfloat162float(qs[row * kLdK + d]);
      const float kv = __bfloat162float(ks[row * kLdK + d]);
      const float a = xq[row * kLdKf + d], c = xk[row * kLdKf + d];
      const float kcf = kv * ec;
      dg_acc += a * (qv * (eg * scale)) - c * kcf;
      dgl_acc = fmaf(c, kcf, dgl_acc);
      xq[row * kLdKf + d] = a * (eg * scale);
      xk[row * kLdKf + d] = c * ec;
      dwc[row * kLdK + d] = __float2bfloat16(-dwg[row * kDk + d]);
    }
  }
  __syncthreads();

  // 2. dmw = T^T bf16(-dw)
  const bf16* tcg = tc + pc * C * C;
  for (int f = warp; f < ct * dt; f += kBWarps) {
    const int m0 = (f / dt) * kFrag, n0 = (f % dt) * kFrag;
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    mma_tile<true, false>(acc, tcg, C, dwc, kLdK, m0, n0, C);
    wmma::store_matrix_sync(f1 + m0 * kLdKf + n0, acc, kLdKf, wmma::mem_row_major);
  }
  __syncthreads();

  // 3. w = T (beta e^G k): dk_x += dmw beta e^G, dbeta += dmw . k e^G,
  //    dG += dmw . beta e^G k; bf16(dmw)
  if (row < C) {
    for (int d = part * (kDk / 4); d < (part + 1) * (kDk / 4); ++d) {
      const float m = f1[row * kLdKf + d];
      const float kneg = __bfloat162float(ks[row * kLdK + d]) * eg;
      xk[row * kLdKf + d] += m * (eg * btr);
      db_acc += m * kneg;
      dg_acc += m * kneg * btr;
      dwc[row * kLdK + d] = __float2bfloat16(m);
    }
  }
  __syncthreads();

  // 4. dA = -(dA_u + bf16(dmw) w^T); kk = k k^T and qk = q k^T into f1
  float* kkf = f1;
  float* qkf = f1 + kMaxC * kLdCf;
  const bf16* wg = w + pc * C * kDk;
  const float* daug = dau + pc * C * C;
  for (int f = warp; f < ct * ct; f += kBWarps) {
    const int m0 = (f / ct) * kFrag, n0 = (f % ct) * kFrag;
    Acc acc, kk, qk;
    wmma::load_matrix_sync(acc, daug + m0 * C + n0, C, wmma::mem_row_major);
    mma_tile<false, true>(acc, dwc, kLdK, wg, kDk, m0, n0, kDk);
#pragma unroll
    for (int i = 0; i < acc.num_elements; ++i) acc.x[i] = -acc.x[i];
    wmma::store_matrix_sync(da + m0 * kLdCf + n0, acc, kLdCf, wmma::mem_row_major);
    wmma::fill_fragment(kk, 0.0f);
    wmma::fill_fragment(qk, 0.0f);
    if (n0 <= m0) {
      mma_tile<false, true>(kk, ks, kLdK, ks, kLdK, m0, n0, kDk);
      mma_tile<false, true>(qk, qs, kLdK, ks, kLdK, m0, n0, kDk);
    }
    wmma::store_matrix_sync(kkf + m0 * kLdCf + n0, kk, kLdCf, wmma::mem_row_major);
    wmma::store_matrix_sync(qkf + m0 * kLdCf + n0, qk, kLdCf, wmma::mem_row_major);
  }
  __syncthreads();

  // 5. the pairwise terms, A = beta_i kk exp(G_i - G_j) (j < i) and
  //    P = qk exp(G_i - G_j) scale (j <= i): dbeta += dA . kk ds,
  //    dkk = bf16(dA ds beta), dqk = bf16(dP di), m = dA A + dP P -> dA's place
  const float* dpg = dp + pc * C * C;
  if (row < C) {
    const int span = (C + 3) / 4;
    for (int j = part * span; j < min(C, (part + 1) * span); ++j) {
      const float dsv = j < row ? expf(gs[row] - gs[j]) : 0.f;
      const float div = j <= row ? expf(gs[row] - gs[j]) * scale : 0.f;
      const float dav = da[row * kLdCf + j], dpv = dpg[row * C + j];
      const float kkds = kkf[row * kLdCf + j] * dsv;
      db_acc += dav * kkds;
      dkk[row * kLdC + j] = __float2bfloat16(dav * dsv * btr);
      dqk[row * kLdC + j] = __float2bfloat16(dpv * div);
      const float m = dav * kkds * btr + dpv * (qkf[row * kLdCf + j] * div);
      dg_acc += m;
      da[row * kLdCf + j] = m;
    }
  }
  dg_acc += __shfl_xor_sync(0xffffffffu, dg_acc, 1);
  dg_acc += __shfl_xor_sync(0xffffffffu, dg_acc, 2);
  db_acc += __shfl_xor_sync(0xffffffffu, db_acc, 1);
  db_acc += __shfl_xor_sync(0xffffffffu, db_acc, 2);
  if (part == 0 && row < C) {
    dgr[row] = dg_acc;
    dbr[row] = db_acc;
  }
  __syncthreads();

  // 6. dq = dq_x + dqk k;  dk = dk_x + dkk k + dkk^T k + dqk^T q
  for (int f = warp; f < ct * dt; f += kBWarps) {
    const int m0 = (f / dt) * kFrag, n0 = (f % dt) * kFrag;
    Acc acc;
    wmma::load_matrix_sync(acc, xq + m0 * kLdKf + n0, kLdKf, wmma::mem_row_major);
    mma_tile<false, false>(acc, dqk, kLdC, ks, kLdK, m0, n0, C);
    store_bf16(acc, stage, dq_out + ((bn * C + m0) * H + h) * kDk + n0, ldq);
    wmma::load_matrix_sync(acc, xk + m0 * kLdKf + n0, kLdKf, wmma::mem_row_major);
    mma_tile<false, false>(acc, dkk, kLdC, ks, kLdK, m0, n0, C);
    mma_tile<true, false>(acc, dkk, kLdC, ks, kLdK, m0, n0, C);
    mma_tile<true, false>(acc, dqk, kLdC, qs, kLdK, m0, n0, C);
    store_bf16(acc, stage, dk_out + ((bn * C + m0) * H + h) * kDk + n0, ldq);
  }

  // 7. dG = row sums - column sums of m (+ the carried decay on the last
  //    row); dbeta
  const float dgl = block_sum(dgl_acc, red);
  if (threadIdx.x < C) {
    const int j = threadIdx.x;
    float col = 0.f;
    for (int i = 0; i < C; ++i) col += da[i * kLdCf + j];
    float g = dgr[j] - col;
    if (j == C - 1) g += expf(gs[C - 1]) * dgl_part[pc] + dgl;
    dg_out[(bn * C + j) * H + h] = g;
    dbeta_out[(bn * C + j) * H + h] = dbr[j] + dbeta_part[pc * C + j];
  }
}

}  // namespace

extern "C" {

int mhla_delta_bwd_chain(const void* p, const void* qd, const void* w, const void* kc,
                         const void* dout, const void* G, const void* ds_final, void* exits,
                         void* ds0, int B, int N, int C, int H, int Dv, void* stream) {
  if (Dv % kTile || C % kFrag || C > kMaxC) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(delta_bwd_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kBwdChainSmem);
  dim3 grid(Dv / kTile, H, B);
  delta_bwd_chain_kernel<<<grid, kChainThreads, kBwdChainSmem, (cudaStream_t)stream>>>(
      (const bf16*)p, (const bf16*)qd, (const bf16*)w, (const bf16*)kc, (const bf16*)dout,
      (const float*)G, (const float*)ds_final, (bf16*)exits, (float*)ds0, N, C, H, Dv);
  return (int)cudaGetLastError();
}

int mhla_delta_bwd_grads(const void* q, const void* k, const void* v, const void* G,
                         const void* beta, const void* states, const void* exits,
                         const void* dout, const void* tc, const void* w, const void* p,
                         const void* kc, void* dkc, void* dqd, void* dw, void* dp, void* dau,
                         void* dbeta_part, void* dgl_part, void* dq, void* dk, void* dv,
                         void* dg, void* dbeta, int B, int N, int C, int H, int Dv,
                         void* stream) {
  if (Dv % kTile || C % kFrag || C > kMaxC) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(delta_bwd_grads_a_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kGradsASmem);
  cudaFuncSetAttribute(delta_bwd_grads_b_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kGradsBSmem);
  dim3 grid(B * N, H);
  delta_bwd_grads_a_kernel<<<grid, kAThreads, kGradsASmem, (cudaStream_t)stream>>>(
      (const bf16*)v, (const float*)beta, (const bf16*)states, (const bf16*)exits,
      (const bf16*)dout, (const bf16*)tc, (const bf16*)w, (const bf16*)p, (const bf16*)kc,
      (float*)dkc, (float*)dqd, (float*)dw, (float*)dp, (float*)dau, (float*)dbeta_part,
      (float*)dgl_part, (bf16*)dv, C, H, Dv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  delta_bwd_grads_b_kernel<<<grid, kBThreads, kGradsBSmem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const float*)G, (const float*)beta, (const bf16*)tc,
      (const bf16*)w, (const float*)dkc, (const float*)dqd, (const float*)dw,
      (const float*)dp, (const float*)dau, (const float*)dbeta_part, (const float*)dgl_part,
      (bf16*)dq, (bf16*)dk, (float*)dg, (float*)dbeta, C, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
