// K8b and K5b for Hopper (sm_90a): the video island's 3-D block permutation
// with rotate-half RoPE, in both directions, in one kernel.
//
// Replaces _blockify_kernel (mhla_tpu/kernels/mhla_block_pallas.py:261, K8b:
// flat [B, T, F] -> blocked [B, N, C, F]) and _unblockify_kernel (:273, K5b:
// blocked -> flat), both run by the pallas_call of _blockify_pallas (:361).
// Per token row of F = H Dh features, in float32:
//   y  = x
//   y1 = x1 c1 + x2 (s1 sign),  y2 = x2 c2 + x1 (s2 sign)   per head, with the
//        head's halves x1, x2 and the token's [Dh] table rows (c, s) (RoPE)
//   y += add                    (K5b only: a second blocked tensor, no RoPE)
// written in out's dtype at the row's place on the other side of the
// permutation (fb p1 hb p2 wb p3) -> (fb hb wb)(p1 p2 p3). The products and
// sums are __fmul_rn / __fadd_rn in the order of the plain version
// (kernels/mhla_block.py blockify_plain, unblockify_plain), no contraction;
// nothing is summed across rows, so two runs are bit-equal.
//
// Bound: bytes. Each input byte read once and each output byte written once
// (Wan2.1-1.3B's [1, 31,500, 1,536] float32 with the tables: 419 MB, 0.125 ms
// at 3.35 TB/s), a few operations an element. The Triton kernel this
// replaces moved 4 rows of one head a program, so it read the [T, Dh] tables
// once per head (12 x 32 MB) and spent a program's index arithmetic on 1 KB.
// Here:
// - A token's F features are contiguous on both sides, and the pw positions
//   of a block along W are consecutive flat tokens, so a run of up to pw rows
//   is one contiguous span on both sides (on the blocked side a whole tile
//   is). The permutation is an address per run; the bulk-copy engine
//   (cp.async.bulk, no tensor map) moves whole rows, 6 KB each in float32 at
//   Wan's width.
// - Persistent blocks (two an SM at the main path's sizes) walk tiles of
//   consecutive blocked rows. A producer thread keeps a ring of input stages
//   in flight (x's rows, add's rows, the tile's cos and sin rows), each
//   completing on its mbarrier. Eight consumer warps rotate every head of a
//   row from the token's one table row in shared memory (16-byte accesses in
//   float32), add and cast into one of three output stages; a storer thread
//   of its own warp stores each filled stage by bulk stores and hands a
//   stage back once cp.async.bulk.wait_group.read says its store has read
//   it, so no consumer waits on a store. A pure copy (no tables, no add,
//   x's dtype out: K5b on v's gradient) skips the consumers: the storer
//   stores the input stage as it landed.
// - The tables are read once in all: a token's row serves its H heads.
// - Tiles are small (one or two rows) where the consumers transform the
//   rows, so a tile's items finish soon after it lands; whole runs (five
//   rows at Wan's layout) for a pure copy. The wrapper plans them
//   (kernels/mhla_block.py _permute_plan), from timings of every form on
//   the card (PERF.md, section 6): each form then moves 2.6-2.8 TB/s, about
//   what a pure copy of the same bytes does (0.140 ms for K5b's 387 MB).
// An operand whose rows are not 16-byte aligned in address, stride or size
// (a column range at an odd offset, rows of 24 bytes) is read or written by
// the consumers' own loads and stores in this kernel, element by element;
// one that does not fit the stages, by their own vector accesses. The
// wrapper decides which (_permute_flags, _permute_plan); the main path's
// shapes (Dh = 128, F % 128 == 0) move every operand by bulk copies.

#include <cuda_fp16.h>

#include <algorithm>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int kConsumers = 256;            // eight consumer warps
constexpr int kThreads = kConsumers + 64;  // a producer warp and a storer warp
constexpr int kOutStages = 3;
constexpr int kStoresInFlight = 2;  // bulk stores still reading their stages, at most
constexpr int kMaxInStages = 8;
constexpr int kBarrierBytes = (2 * kMaxInStages + 2 * kOutStages) * 8;
static_assert(kStoresInFlight >= 1 && kStoresInFlight <= kOutStages,
              "a consumer waits for the store kOutStages tiles back");
constexpr int kSmemLimit = 232448;  // 227 KB a block

// element types, as the wrapper codes them
enum : int { kF32 = 0, kBF16 = 1, kF16 = 2 };
// which operands move by bulk copies; kFlatRuns: a run's flat rows are
// contiguous (the flat side's token stride is F); kDirect (set here): some
// operand moves by the threads' own loads or stores; kAlign*: the operand's
// rows are 16-byte aligned (a bulk copy can take them; the threads take them
// by vector accesses where they move them themselves); kPass: a pure copy
// (no tables, no add, x's dtype out), stored from the input stage as loaded
enum : int {
  kBulkX = 1, kBulkAdd = 2, kBulkTables = 4, kBulkOut = 8, kFlatRuns = 16, kDirect = 32,
  kAlignX = 64, kAlignAdd = 128, kAlignTables = 256, kAlignOut = 512, kPass = 1024
};

struct Args {
  const unsigned char* x;
  const unsigned char* add;  // null: none
  const float* cos;          // null: no RoPE
  const float* sin;
  unsigned char* out;
  long long flat_b, flat_t;  // the flat side's strides, elements (x's in K8b, out's in K5b)
  long long rows_total;      // B T
  long long tiles;
  int T, C, F, Dh;
  int lay_hw, lay_w, pf, ph, pw, grid_h, grid_w;
  float sin_sign;
  int x_code, add_code, out_code;
  int inverse, flags, rows, stages;
  int off_add, off_cos, off_sin;  // byte offsets in an input stage
  int in_stage, out_stage;        // bytes
};

__host__ __device__ __forceinline__ int esize(int code) { return code == kF32 ? 4 : 2; }

// Flat token of position pos of block blk.
__device__ __forceinline__ int token(const Args& a, int blk, int pos) {
  const int fb = blk / a.lay_hw, hb = blk % a.lay_hw / a.lay_w, wb = blk % a.lay_w;
  const int p1 = pos / (a.ph * a.pw), p2 = pos / a.pw % a.ph, p3 = pos % a.pw;
  return ((fb * a.pf + p1) * a.grid_h + hb * a.ph + p2) * a.grid_w + wb * a.pw + p3;
}

__device__ __forceinline__ void locate(const Args& a, long long g, int& b, int& tok) {
  b = (int)(g / a.T);
  const int rem = (int)(g - (long long)b * a.T);
  tok = token(a, rem / a.C, rem % a.C);
}

// fn(r, b, tok, len) for each copy of the tile of blocked rows [g0, g0 + n):
// len rows from stage row r on (blocked row g0 + r, flat token tok of batch
// row b), contiguous on both sides: the rest of a run of pw tokens along W
// within the tile, or one row where the flat side's rows are not
// contiguous. kernels/mhla_block.py permute_walk mirrors it.
template <typename Fn>
__device__ __forceinline__ void walk_tile(const Args& a, long long g0, int n, Fn&& fn) {
  for (int r = 0; r < n;) {
    int b, tok;
    locate(a, g0 + r, b, tok);
    const int pos = (int)((g0 + r) % a.C);
    const int len = (a.flags & kFlatRuns) ? min(a.pw - pos % a.pw, n - r) : 1;
    fn(r, b, tok, len);
    r += len;
  }
}

// V neighbouring elements at column col of a row (shared or device memory:
// generic addresses), as float32; by one vector access where ``vec`` (the
// row 16-byte aligned), else element by element.
template <int V>
__device__ __forceinline__ void load_v(float (&v)[V], const unsigned char* row, int col, int code,
                                       bool vec) {
  if (code == kF32) {
    const float* p = reinterpret_cast<const float*>(row) + col;
    if constexpr (V == 4) {
      if (vec) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  } else if (code == kBF16) {
    const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(row) + col;
    if constexpr (V == 4) {
      if (vec) {
        const uint2 t = *reinterpret_cast<const uint2*>(p);
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
        v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  } else {
    const __half* p = reinterpret_cast<const __half*>(row) + col;
    if constexpr (V == 4) {
      if (vec) {
        const uint2 t = *reinterpret_cast<const uint2*>(p);
        const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&t.x));
        const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&t.y));
        v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __half2float(p[i]);
  }
}

// The same for stores, rounding to nearest even as torch's casts do.
template <int V>
__device__ __forceinline__ void store_v(unsigned char* row, int col, const float (&v)[V], int code,
                                        bool vec) {
  if (code == kF32) {
    float* p = reinterpret_cast<float*>(row) + col;
    if constexpr (V == 4) {
      if (vec) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  } else if (code == kBF16) {
    __nv_bfloat16* p = reinterpret_cast<__nv_bfloat16*>(row) + col;
    if constexpr (V == 4) {
      if (vec) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                  *reinterpret_cast<const uint32_t*>(&hi));
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(v[i]);
  } else {
    __half* p = reinterpret_cast<__half*>(row) + col;
    if constexpr (V == 4) {
      if (vec) {
        const __half2 lo = __floats2half2_rn(v[0], v[1]);
        const __half2 hi = __floats2half2_rn(v[2], v[3]);
        *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                  *reinterpret_cast<const uint32_t*>(&hi));
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2half_rn(v[i]);
  }
}

// V: features a consumer thread takes from each half of a head at a time
// (4; 1 where Dh / 2 is 1 or 2).
template <int V>
__global__ void __launch_bounds__(kThreads, 2) permute_kernel(const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  unsigned char* out_sm = sm + a.stages * a.in_stage;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_sm + kOutStages * a.out_stage);
  uint64_t* empty = full + kMaxInStages;
  uint64_t* out_full = empty + kMaxInStages;
  uint64_t* out_empty = out_full + kOutStages;
  const bool pass = a.flags & kPass;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], pass ? 1 : kConsumers / 32);  // the storer, or each consumer warp
    }
    for (int k = 0; k < kOutStages; ++k) {
      mbar_init(&out_full[k], kConsumers / 32);
      mbar_init(&out_empty[k], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const bool bulk_x = a.flags & kBulkX, bulk_add = a.flags & kBulkAdd,
             bulk_tables = a.flags & kBulkTables, bulk_out = a.flags & kBulkOut;
  const bool vec_x = a.flags & kAlignX, vec_add = a.flags & kAlignAdd,
             vec_tables = a.flags & kAlignTables, vec_out = a.flags & kAlignOut;
  const int xs = esize(a.x_code), os = esize(a.out_code), tbl_row = a.Dh * 4;
  const long long x_row = (long long)a.F * xs, out_row = (long long)a.F * os,
                  add_row = a.add ? (long long)a.F * esize(a.add_code) : 0;

  if (warp == kConsumers / 32) {  // the producer warp: its first lane keeps the ring full
    if (lane == 0) {
      int it = 0;
      for (long long tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++it) {
        const int s = it % a.stages;
        mbar_wait(&empty[s], ((it / a.stages) & 1) ^ 1);
        const long long g0 = tile * a.rows;
        const int n = (int)min((long long)a.rows, a.rows_total - g0);
        unsigned char* st = sm + s * a.in_stage;
        const long long bytes = (bulk_x ? n * x_row : 0) + (bulk_add ? n * add_row : 0) +
                                (bulk_tables ? 2LL * n * tbl_row : 0);
        mbar_arrive_expect_tx(&full[s], (uint32_t)bytes);
        if (a.inverse) {  // x and add are blocked: the tile is one span
          if (bulk_x) bulk_load(st, a.x + g0 * x_row, (uint32_t)(n * x_row), &full[s]);
          if (bulk_add)
            bulk_load(st + a.off_add, a.add + g0 * add_row, (uint32_t)(n * add_row), &full[s]);
        }
        if ((bulk_x && !a.inverse) || bulk_tables)
          walk_tile(a, g0, n, [&](int r, int b, int tok, int len) {
            if (bulk_x && !a.inverse)
              bulk_load(st + r * x_row, a.x + (b * a.flat_b + (long long)tok * a.flat_t) * xs,
                        (uint32_t)(len * x_row), &full[s]);
            if (bulk_tables) {
              bulk_load(st + a.off_cos + r * tbl_row, a.cos + (long long)tok * a.Dh,
                        (uint32_t)(len * tbl_row), &full[s]);
              bulk_load(st + a.off_sin + r * tbl_row, a.sin + (long long)tok * a.Dh,
                        (uint32_t)(len * tbl_row), &full[s]);
            }
          });
      }
    }
    return;
  }

  if (warp == kConsumers / 32 + 1) {  // the storer warp: its first lane stores each tile
    if (lane == 0 && bulk_out) {
      int it = 0;
      for (long long tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++it) {
        const long long g0 = tile * a.rows;
        const int n = (int)min((long long)a.rows, a.rows_total - g0);
        // a pure copy (kPass) stores the input stage as it arrived
        const int s = pass ? it % a.stages : it % kOutStages;
        uint64_t* ready = pass ? &full[s] : &out_full[s];
        mbar_wait(ready, (it / (pass ? a.stages : kOutStages)) & 1);
        const unsigned char* src = pass ? sm + s * a.in_stage : out_sm + s * a.out_stage;
        if (!a.inverse)  // blocked out: the tile is one span
          bulk_store(a.out + g0 * out_row, src, (uint32_t)(n * out_row));
        else
          walk_tile(a, g0, n, [&](int r, int b, int tok, int len) {
            bulk_store(a.out + (b * a.flat_b + (long long)tok * a.flat_t) * os, src + r * out_row,
                       (uint32_t)(len * out_row));
          });
        tma_store_commit();
        // the store kStoresInFlight - 1 tiles back has read its stage: hand
        // that stage back
        tma_store_wait_read<kStoresInFlight - 1>();
        const int back = it - (kStoresInFlight - 1);
        if (back >= 0) {
          if (pass)
            mbar_arrive(&empty[back % a.stages]);
          else
            mbar_arrive(&out_empty[back % kOutStages]);
        }
      }
      tma_store_wait_all();
    }
    return;
  }
  if (pass) return;

  // the consumer warps: this thread's items of a tile are (row r, item q of a
  // row's per_row) from (r0, q0) on, kConsumers apart; an item is V features
  // of each half of head q / hv (hv a power of two: no division in the loop)
  const int half = a.Dh / 2, hv = half / V, hv_shift = __ffs(hv) - 1, per_row = a.F / (2 * V);
  const int dr = kConsumers / per_row, dq = kConsumers % per_row;
  const int r0 = tid / per_row, q0 = tid % per_row;
  int it = 0;
  for (long long tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++it) {
    const int s = it % a.stages, k = it % kOutStages;
    const long long g0 = tile * a.rows;
    const int n = (int)min((long long)a.rows, a.rows_total - g0);
    const unsigned char* st = sm + s * a.in_stage;
    unsigned char* ot = out_sm + k * a.out_stage;
    if (bulk_out) mbar_wait(&out_empty[k], ((it / kOutStages) & 1) ^ 1);
    mbar_wait(&full[s], (it / a.stages) & 1);

    // the operands' rows of the row at hand (in a stage, or where they lie,
    // kDirect), formed again only where a thread's items move on to a new row
    int row = -1;
    const unsigned char *xr = nullptr, *ar = nullptr, *cr = nullptr, *sr = nullptr;
    unsigned char* orow = nullptr;
    for (int r = r0, q = q0; r < n;) {
      if (r != row) {
        row = r;
        const long long g = g0 + r;
        int b = 0, tok = 0;
        if (a.flags & kDirect) locate(a, g, b, tok);
        const long long flat = b * a.flat_b + (long long)tok * a.flat_t;  // elements
        xr = bulk_x ? st + r * x_row : a.x + (a.inverse ? g * a.F : flat) * xs;
        ar = bulk_add ? st + a.off_add + r * add_row : a.add + g * add_row;
        cr = bulk_tables ? st + a.off_cos + r * tbl_row
                         : reinterpret_cast<const unsigned char*>(a.cos + (long long)tok * a.Dh);
        sr = bulk_tables ? st + a.off_sin + r * tbl_row
                         : reinterpret_cast<const unsigned char*>(a.sin + (long long)tok * a.Dh);
        orow = bulk_out ? ot + r * out_row : a.out + (a.inverse ? flat : g * a.F) * os;
      }
      const int j = (q & (hv - 1)) * V, c1 = (q >> hv_shift) * a.Dh + j, c2 = c1 + half;
      float y1[V], y2[V];
      load_v<V>(y1, xr, c1, a.x_code, vec_x);
      load_v<V>(y2, xr, c2, a.x_code, vec_x);
      if (a.cos != nullptr) {
        float k1[V], k2[V], s1[V], s2[V];
        load_v<V>(k1, cr, j, kF32, vec_tables);
        load_v<V>(k2, cr, j + half, kF32, vec_tables);
        load_v<V>(s1, sr, j, kF32, vec_tables);
        load_v<V>(s2, sr, j + half, kF32, vec_tables);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float x1 = y1[i], x2 = y2[i];
          const float sn1 = __fmul_rn(s1[i], a.sin_sign), sn2 = __fmul_rn(s2[i], a.sin_sign);
          y1[i] = __fadd_rn(__fmul_rn(x1, k1[i]), __fmul_rn(x2, sn1));
          y2[i] = __fadd_rn(__fmul_rn(x2, k2[i]), __fmul_rn(x1, sn2));
        }
      }
      if (a.add != nullptr) {  // blocked, like x (K5b)
        float a1[V], a2[V];
        load_v<V>(a1, ar, c1, a.add_code, vec_add);
        load_v<V>(a2, ar, c2, a.add_code, vec_add);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          y1[i] = __fadd_rn(y1[i], a1[i]);
          y2[i] = __fadd_rn(y2[i], a2[i]);
        }
      }
      store_v<V>(orow, c1, y1, a.out_code, vec_out);
      store_v<V>(orow, c2, y2, a.out_code, vec_out);
      r += dr, q += dq;
      if (q >= per_row) q -= per_row, ++r;
    }
    // this warp is done with the input stage, and its rows of the output
    // stage are visible to the storer's bulk store
    if (bulk_out) fence_async_shared();
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&empty[s]);
      if (bulk_out) mbar_arrive(&out_full[k]);
    }
  }
}

int round128(long long n) { return (int)((n + 127) / 128 * 128); }

template <int V>
int launch(const Args& a, int smem, cudaStream_t stream) {
  int blocks = 0;
  const int err =
      hopper_host::resident_blocks((const void*)permute_kernel<V>, kThreads, smem, &blocks);
  if (err != 0) return err;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = (int)std::min<long long>(a.tiles, blocks);
  permute_kernel<V><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// K8b (inverse 0: flat x [B, T, F] with element strides flat_b, flat_t ->
// blocked out [B, N, C, F]) and K5b (inverse 1: blocked x and add ->
// contiguous flat out). cos / sin: [T, Dh] float32 or null; add: null or
// blocked; codes 0 float32, 1 bf16, 2 fp16 (add_code unread without add).
// flags: the operands that move by bulk copies and kFlatRuns (see above);
// rows: token rows a tile; stages: input stages. Launches on ``stream``,
// does not synchronise, returns the launch's cudaError_t.
extern "C" int mhla_permute(const void* x, const void* add, const void* cos, const void* sin,
                            void* out, int B, int T, int C, int F, int Dh, long long flat_b,
                            long long flat_t, int lay_h, int lay_w, int pf, int ph, int pw,
                            int grid_h, int grid_w, float sin_sign, int x_code, int add_code,
                            int out_code, int inverse, int flags, int rows, int stages,
                            void* stream) {
  const bool rope = cos != nullptr;
  if (B < 1 || C < 1 || T < C || T % C || Dh < 2 || Dh % 2 || F % Dh || rows < 1 || stages < 1 ||
      stages > kMaxInStages || pw < 1 || C % pw || (rope && sin == nullptr) ||
      x_code < 0 || x_code > 2 || out_code < 0 || out_code > 2 ||
      (add != nullptr && (add_code < 0 || add_code > 2 || !inverse)))
    return (int)cudaErrorInvalidValue;
  if (!rope) flags &= ~(kBulkTables | kAlignTables);
  if (add == nullptr) flags &= ~(kBulkAdd | kAlignAdd);
  // a bulk-copied operand is an aligned one
  if ((flags & (kBulkX | kBulkAdd | kBulkTables | kBulkOut)) & ~(flags / (kAlignX / kBulkX)))
    return (int)cudaErrorInvalidValue;
  if (inverse) flags |= kFlatRuns;  // out is contiguous
  // a bulk copy or a vector access takes 16-byte aligned addresses and sizes only
  const auto al = [](long long v) { return v % 16 == 0; };
  const auto al_ptr = [&](const void* p) { return al((long long)reinterpret_cast<uintptr_t>(p)); };
  const long long xs = esize(x_code);
  if (((flags & kAlignX) &&
       !(al_ptr(x) && al(F * xs) && (inverse || (al(flat_b * xs) && al(flat_t * xs))))) ||
      ((flags & kAlignAdd) && !(al_ptr(add) && al((long long)F * esize(add_code)))) ||
      ((flags & kAlignTables) && !(al_ptr(cos) && al_ptr(sin) && al(Dh * 4LL))) ||
      ((flags & kAlignOut) && !(al_ptr(out) && al((long long)F * esize(out_code)))))
    return (int)cudaErrorMisalignedAddress;
  if (!inverse && (flags & kFlatRuns) && flat_t != F) return (int)cudaErrorInvalidValue;
  if ((flags & kPass) && (rope || add != nullptr || x_code != out_code || !(flags & kBulkX) ||
                          !(flags & kBulkOut) || stages < kStoresInFlight))
    return (int)cudaErrorInvalidValue;
  if (!(flags & kBulkX) || !(flags & kBulkOut) || (add && !(flags & kBulkAdd)) ||
      (rope && !(flags & kBulkTables)))
    flags |= kDirect;

  Args a;
  a.x = static_cast<const unsigned char*>(x);
  a.add = static_cast<const unsigned char*>(add);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.out = static_cast<unsigned char*>(out);
  a.flat_b = flat_b, a.flat_t = flat_t;
  a.rows_total = (long long)B * T;
  a.tiles = (a.rows_total + rows - 1) / rows;
  a.T = T, a.C = C, a.F = F, a.Dh = Dh;
  a.lay_hw = lay_h * lay_w, a.lay_w = lay_w, a.pf = pf, a.ph = ph, a.pw = pw;
  a.grid_h = grid_h, a.grid_w = grid_w;
  a.sin_sign = sin_sign;
  a.x_code = x_code, a.add_code = add_code, a.out_code = out_code;
  a.inverse = inverse, a.flags = flags, a.rows = rows, a.stages = stages;
  // an input stage: [x rows][add rows][cos rows][sin rows], each part that moves
  // by bulk copies 128-byte aligned (kernels/mhla_block.py _permute_smem mirrors it)
  const int x_part = (flags & kBulkX) ? round128((long long)rows * F * esize(x_code)) : 0;
  const int add_part = (flags & kBulkAdd) ? round128((long long)rows * F * esize(add_code)) : 0;
  const int tbl_part = (flags & kBulkTables) ? round128((long long)rows * Dh * 4) : 0;
  a.off_add = x_part;
  a.off_cos = x_part + add_part;
  a.off_sin = a.off_cos + tbl_part;
  a.in_stage = a.off_sin + tbl_part;
  a.out_stage = (flags & kBulkOut) && !(flags & kPass)
                    ? round128((long long)rows * F * esize(out_code)) : 0;
  const long long smem = (long long)stages * a.in_stage + (long long)kOutStages * a.out_stage +
                         kBarrierBytes + 128;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return (Dh / 2) % 4 == 0 ? launch<4>(a, (int)smem, st) : launch<1>(a, (int)smem, st);
}
