// Flash attention backward on Hopper's tensor cores in split TF32: bulk
// asynchronous copies, mbarriers, wgmma and warp specialisation (sm_90a).
//
// The Hopper design of the two backward kernels of
// mxnet_tpu/ops/pallas_kernels.py that ring attention runs on every hop
// (parallel/ring_attention.py, the backward ring):
//
//   mxtt_flash_dq_wgmma  <- _fa_dq_kernel  (:171, called by flash_dq, :314)
//   mxtt_flash_dkv_wgmma <- _fa_dkv_kernel (:226, called by flash_dkv, :345)
//
// flash_attention.cu keeps the CUDA-core design of both for the head dims
// this one does not take or is slower at (ops/pallas_kernels.py,
// flash_design: D % 4 == 0 up to 32 come here, dk/dv from D = 12); the
// forward's own split-TF32 design is flash_fwd_wgmma.cu, and the pieces
// both share are in flash_wgmma.cuh.  Both compute what the
// Pallas bodies compute, with their guards:
//   s = q.k * scale; p = exp(s - lse) where the pair (q row i, k row j) is
//   valid, else 0 (valid: i < Tq, j < Tk, and j <= i when causal, both
//   aligned at position 0); dp = dO.v; ds = p (dp - delta), 0 where not
//   valid; dq = sum_j ds k * scale; dv = sum_i p dO; dk = sum_i ds q * scale.
//   Rows past the ragged ends are zeros, so no unloaded row is ever
//   multiplied (and -1e30 never appears: p is selected, not masked through
//   the score).
//
// Numerics: float32 in and out, to the contract of the CUDA-core design
// (1e-4 against the plain version).  TF32 keeps 10 mantissa bits, so every
// operand x is split into hi = x with its low 13 bits cleared and lo = x - hi
// with its low 13 bits cleared: truncation, so both are exact tf32 values and
// the tensor cores read exactly what was written.  Each product is the sum
// hi.hi + hi.lo + lo.hi in f32 accumulators ("3xTF32"; the dropped lo.lo
// term and lo's own truncation are ~2^-20 of a product).  expf stays IEEE:
// no --use_fast_math.
//
// What bounds it on an H100: operations.  The ring path (D = 16, chunks of
// 512; hop 0 causal over BH 512, hop 1 full over BH 256) visits 134,348,800
// (q, k) pairs per layer.  dkv does four products of 2 D flops per pair (s,
// dp, dv, dk), dq three (s, dp, dq); three TF32 passes each at 495 TFLOP/s
// dense give 0.104 / 0.078 ms per layer, against 0.259 / 0.195 ms for the
// same products once on the f32 CUDA cores, which is where the CUDA-core
// design stops.  Bytes (q, k, v, dO in, dq or dk, dv out: ~100 MB per layer)
// take ~0.03 ms.  The non-matrix work per pair (the recompute of p with its
// expf, ds, the splits of the register operands) is issued by the same
// warps that feed the tensor cores, and at D = 16 every wgmma is small
// (K = 8, N <= 64), so what holds the design back is latency: each
// consumer warpgroup alternates between waiting on its wgmma group and
// recomputing p and ds.  The design:
//
// - Blocks.  dkv is k-major: a block owns 128 keys of one bh (two consumer
//   warpgroups of 64) and walks the queries in tiles of 32; dq is q-major:
//   128 queries, walking the keys in tiles of 64.  Every output element is
//   summed by one warpgroup in a fixed order: no atomics, reruns are
//   bitwise.  Causal blocks skip the tiles wholly on the masked side and
//   mask only the tiles the diagonal or a ragged end crosses.  A flat grid
//   of (tile, bh), the heaviest causal tiles first.  (A persistent grid was
//   measured slower: its static split of causal tiles is unbalanced.)
// - Warp specialisation.  Warpgroup 0 produces: one thread keeps up to 8
//   streamed tiles (q, dO for dkv; k, v for dq) in flight by cp.async.bulk
//   into a ring of raw slots; all 128 threads split each landed tile into
//   its hi / lo copies in the layouts wgmma reads, into a ring of stages on
//   `full` / `empty` mbarriers.  Warpgroups 1 and 2 consume.  setmaxnreg
//   gives the producer 56 registers and the consumers 224.
// - Products.  wgmma m64nNk8 .tf32 takes B from shared memory K-major (no
//   transpose bit for 32-bit types) and A from registers.  x = s, y = dp
//   (dkv: s^T = k.q^T, dp^T = v.dO^T) take the block's own rows as A,
//   loaded and split once per block into each thread's fragments, and the
//   row-major tiles as B as they lie.  dv += p^T dO, dk += ds^T q and dq +=
//   ds k contract over the tile's rows, so their B tiles (dO^T, q^T, k^T)
//   are written transposed by the producer; their A operand is x or y,
//   recomputed into p / ds and split in registers.  The accumulator holds
//   columns (2t, 2t + 1) of each 8-column block where the A fragment wants
//   (t, t + 4), so that contraction index is permuted within each group of
//   8 as [0, 2, 4, 6, 1, 3, 5, 7], in A (for free: a0..a3 = d0, d2, d1, d3)
//   and in the transposed B tile alike.  Passes go pass by pass over the
//   k-steps, the products over the tile into NA independent accumulators,
//   so consecutive wgmmas rarely wait on each other.
// - Pipelining.  Per tile a consumer warpgroup waits for one wgmma group
//   (the products over the previous tile and x, y of this one), recomputes
//   p and ds, and issues the next group.  Its loop bounds and its barrier
//   arrivals are uniform across the warpgroup (the warpgroup index is
//   broadcast by a shuffle, the waits spin inside the asm, one lane per
//   warp arrives by a predicate), so ptxas keeps the wgmmas asynchronous.
// - Shared memory.  Every B tile is K-major with the 64-byte swizzle: the K
//   axis in atoms of 16 floats (64-byte rows, 8-row groups of 512 bytes, the
//   16-byte chunk of a row XORed with bits 1-2 of the row), the layout TMA
//   writes with CU_TENSOR_MAP_SWIZZLE_64B and sw_desc<64> names.  The
//   producer writes it with 16-byte stores.
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_runtime.h>

#include "sm90.cuh"
#include "flash_wgmma.cuh"

namespace {

constexpr int BM = 128;              // the block's own rows
constexpr int THREADS = 384;         // producer, 2 consumers
constexpr int MAX_STAGES = 4;
constexpr int MAX_RAW = 8;
constexpr int SMEM_LIMIT = 232448;   // bytes of shared memory a block may use
constexpr int PASSES = 3;            // hi.hi, hi.lo, lo.hi

// bytes of one copy of a streamed tile and of a stage of the ring
template <int DP, int BT, bool DKV> struct Sizes {
  static constexpr int TILE = BT * DP * 4;
  // dkv: q, dO hi / lo, q^T, dO^T hi / lo, then lse and delta;
  // dq: k, v hi / lo, k^T hi / lo
  static constexpr int STAGE =
      DKV ? (8 * TILE + 2 * BT * 4 + 1023) / 1024 * 1024 : 6 * TILE;
  static constexpr int RAW = 2 * TILE;   // two raw tiles (q, dO or k, v)
};

// x = A_x B_x^T and y = A_y B_y^T over DP (dkv: k.q^T and v.dO^T; dq:
// q.k^T and dO.v^T), pass by pass with x and y alternating, so that
// consecutive wgmmas accumulate into different registers.  A: the own
// rows' fragments; B: the stage's row-major tiles (x's hi, lo at st, y's
// two copies on).
template <int DP, int BT, bool DKV>
__device__ __forceinline__ void mma_xy(float (&x)[BT / 2], float (&y)[BT / 2],
                                       const Own<DP>& ax, const Own<DP>& ay,
                                       uint64_t st) {
  using Z = Sizes<DP, BT, DKV>;
#pragma unroll
  for (int ps = 0; ps < PASSES; ++ps) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const uint64_t b = st + (ps == 1 ? Z::TILE / 16 : 0);
      const int acc = ps + kk > 0;
      Rs<BT>::run(x, ps == 2 ? ax.lo[kk] : ax.hi[kk], tile_desc(b, BT, kk),
                  acc);
      Rs<BT>::run(y, ps == 2 ? ay.lo[kk] : ay.hi[kk],
                  tile_desc(b + 2 * Z::TILE / 16, BT, kk), acc);
    }
  }
}

// p and ds of one (q, k) pair from its score accumulator s and dp
__device__ __forceinline__ void recompute(float s, float dp, float lse,
                                          float delta, float scale,
                                          bool valid, float& p, float& ds) {
  p = valid ? expf(s * scale - lse) : 0.f;
  ds = valid ? p * (dp - delta) : 0.f;
}

// p, ds of a tile from x = s, y = dp, split into hi / lo (p only for
// dkv).  Accumulator e of the thread: own row row_lo + r + 8 ((e / 2) %
// 2), streamed column c0 + 8 (e / 4) + 2 t + e % 2.  MASK: the diagonal or
// a ragged end crosses the tile.  lse / delta: dkv per column (rows[],
// rows[BT + .]), dq per own row (lr[], dr[]).
template <int BT, bool DKV, bool MASK>
__device__ __forceinline__ void recompute_tile(
    const float (&x)[BT / 2], const float (&y)[BT / 2], const float* rows,
    const float (&lr)[2], const float (&dr)[2], float scale, int r, int t,
    int row_lo, int c0, int Tq, int Tk, int causal, uint32_t (&ph)[BT / 2],
    uint32_t (&pl)[BT / 2], uint32_t (&sh)[BT / 2], uint32_t (&sl)[BT / 2]) {
#pragma unroll
  for (int nb = 0; nb < BT / 8; ++nb) {
    const int col = nb * 8 + 2 * t;
    float2 cl = make_float2(0.f, 0.f), cd = cl;
    if (DKV) {
      cl = *reinterpret_cast<const float2*>(rows + col);
      cd = *reinterpret_cast<const float2*>(rows + BT + col);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = nb * 4 + 2 * h + c;
        bool valid = true;
        if (MASK) {
          const int own_i = row_lo + r + 8 * h, str_i = c0 + col + c;
          const int qi = DKV ? str_i : own_i, kj = DKV ? own_i : str_i;
          valid = qi < Tq && kj < Tk && (!causal || qi >= kj);
        }
        const float l = DKV ? (c ? cl.y : cl.x) : lr[h];
        const float dl = DKV ? (c ? cd.y : cd.x) : dr[h];
        float p, ds;
        recompute(x[e], y[e], l, dl, scale, valid, p, ds);
        if (DKV) {
          ph[e] = hi_of(p);
          pl[e] = lo_of(p);
        }
        sh[e] = hi_of(ds);
        sl[e] = lo_of(ds);
      }
    }
  }
}

// rows row0 + r (+ 8) of the sum of NA (64 x DP) accumulators, times mul,
// into the (., D) matrix out, rows past `rows` and columns past D dropped
template <int DP, int NA>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[NA][DP / 2],
                                           int row0, int rows, int D, int r,
                                           int t, float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r + 8 * h;
    if (row >= rows) continue;
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      const int col = nb * 8 + 2 * t;
      float2 v = make_float2(0.f, 0.f);
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        v.x += acc[a][nb * 4 + 2 * h];
        v.y += acc[a][nb * 4 + 2 * h + 1];
      }
      if (col < D)
        *reinterpret_cast<float2*>(out + (long long)row * D + col) =
            make_float2(v.x * mul, v.y * mul);
    }
  }
}

// One block: (own tile, bh) of the flat grid, the heaviest causal tile of
// each bh first (dkv's first keys, dq's last queries).  DKV: own = keys
// (k, v), streamed = queries (q, dO with lse, delta) in tiles of BT rows;
// else own = queries (q, dO), streamed = keys (k, v).  out0 / out1 = dk /
// dv, or dq.  NA independent accumulators per output.
template <int DP, bool DKV, int BT, int NA>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_wgmma_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ out0, float* __restrict__ out1,
                       int Tq, int Tk, int D, float scale, int causal,
                       int n_own, int S, int R) {
  using Z = Sizes<DP, BT, DKV>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ __align__(8) uint64_t raw_full[MAX_RAW];

  const long long bh = blockIdx.x / n_own;
  const int tile = blockIdx.x % n_own;
  const int own0 = (DKV ? tile : n_own - 1 - tile) * BM;
  const int T_own = DKV ? Tk : Tq, T_str = DKV ? Tq : Tk;
  // the streamed rows this block visits: [first, last)
  const int first = DKV && causal ? min(own0, Tq) : 0;
  const int last = !DKV && causal ? min(Tk, own0 + BM) : T_str;
  const int n = (last - first + BT - 1) / BT;

  uint8_t* const stages =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const raws = stages + S * Z::STAGE;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(&full[s]), 1);     // the producer, once filled
      mbar_init(smem_u32(&empty[s]), 8);    // one arrival per consumer warp
    }
    for (int r = 0; r < R; ++r) mbar_init(smem_u32(&raw_full[r]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    reg_dealloc<56>();
    const int tid = threadIdx.x;
    const float* const sa = DKV ? q : k;   // the streamed pair
    const float* const sb = DKV ? dout : v;
    // thread 0 keeps R streamed tiles in flight, R ahead of the splits:
    // each a contiguous run of rows (D % 4 == 0: whole 16-byte units)
    // into raw slot i % R, complete on raw_full
    auto issue = [&](int i) {
      const int row0 = first + i * BT;
      const int bytes = min(BT, T_str - row0) * D * 4;
      const uint32_t bar = smem_u32(&raw_full[i % R]);
      const long long off = (bh * T_str + row0) * D;
      uint8_t* const dst = raws + (i % R) * Z::RAW;
      mbar_expect_tx(bar, 2 * bytes);
      bulk_load(smem_u32(dst), sa + off, bytes, bar);
      bulk_load(smem_u32(dst + Z::TILE), sb + off, bytes, bar);
    };
    if (tid == 0)
      for (int i = 0; i < min(R, n); ++i) issue(i);
    // dkv: thread tid < 2 BT carries lse (tid < BT) or delta of row
    // tid % BT of the tile, read one tile ahead
    auto row_of = [&](int i) {
      const int e = tid % BT, row = first + i * BT + e;
      const float* src = tid < BT ? lse : delta;
      return DKV && tid < 2 * BT && i < n && row < Tq ? src[bh * Tq + row]
                                                      : 0.f;
    };
    float ahead = row_of(0);
    for (int i = 0; i < n; ++i) {
      const int s = i % S, r = i % R;
      const int row0 = first + i * BT;
      const int valid = min(BT, T_str - row0);
      const float cur = ahead;
      ahead = row_of(i + 1);
      mbar_wait(smem_u32(&raw_full[r]), (i / R) & 1);
      mbar_wait(smem_u32(&empty[s]), ((i / S) & 1) ^ 1);
      const float* ra = reinterpret_cast<const float*>(raws + r * Z::RAW);
      const float* rb = ra + Z::TILE / 4;
      uint8_t* const st = stages + s * Z::STAGE;
      split_rows<DP, BT>(ra, valid, D, st, st + Z::TILE, tid);
      split_rows<DP, BT>(rb, valid, D, st + 2 * Z::TILE, st + 3 * Z::TILE,
                         tid);
      split_cols<DP, BT>(ra, valid, D, st + 4 * Z::TILE, st + 5 * Z::TILE,
                         tid);
      if (DKV) {
        split_cols<DP, BT>(rb, valid, D, st + 6 * Z::TILE, st + 7 * Z::TILE,
                           tid);
        if (tid < 2 * BT) reinterpret_cast<float*>(st + 8 * Z::TILE)[tid] = cur;
      }
      fence_async_smem();
      warpgroup_sync(1);   // the stage is written, raw slot r is read
      if (tid == 0) {
        mbar_arrive(smem_u32(&full[s]));
        if (i + R < n) issue(i + R);
      }
    }
    return;
  }

  reg_alloc<224>();
  // The consumers: warpgroup cw owns rows own0 + 64 cw .. + 63.  Per tile i
  // it waits for one wgmma group, the products over tile i - 1 and x, y of
  // tile i; recomputes p, ds of tile i; then issues the products over tile
  // i and x, y of tile i + 1 as the next group.  The warpgroup index is
  // broadcast from lane 0, so the compiler knows every value derived from
  // it is uniform across the warpgroup.
  const int ct = threadIdx.x - 128;
  const int cw = __shfl_sync(0xffffffffu, ct >> 7, 0);
  const int warp = (ct >> 5) & 3, lane = ct & 31;
  const int r = 16 * warp + (lane >> 2), t = lane & 3;
  const int row_lo = own0 + 64 * cw;   // the warpgroup's first own row
  const uint64_t st_d = sw_desc<64>(smem_u32(stages));
  // dkv: dk, dv; dq: dq (acc1 unused)
  float acc0[NA][DP / 2], acc1[NA][DP / 2];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) acc0[a][e] = acc1[a][e] = 0.f;
    // zeroed here, not sunk next to the first wgmma that reads them
    fence_regs(acc0[a]);
    fence_regs(acc1[a]);
  }
  // dq: lse and delta of the thread's two rows
  float lr[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};
  if (!DKV) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row_lo + r + 8 * h;
      if (i < Tq) {
        lr[h] = lse[bh * Tq + i];
        dr[h] = delta[bh * Tq + i];
      }
    }
  }
  // the tiles this warpgroup computes, [lo, hi): it passes a causal
  // prefix (dkv: queries all before its keys) or suffix (dq: keys all
  // after its queries), and every tile when it owns no row
  auto skip = [&](int i) {
    const int c0 = first + i * BT;
    return causal && (DKV ? c0 + BT - 1 < row_lo : c0 > row_lo + 63);
  };
  int lo = 0, hi = row_lo < T_own ? n : 0;
  while (lo < hi && skip(lo)) ++lo;
  while (hi > lo && skip(hi - 1)) --hi;
  auto release = [&](int i) { warp_arrive(smem_u32(&empty[i % S]), lane); };
  auto pass = [&](int i) {
    wait_phase(smem_u32(&full[i % S]), (i / S) & 1);
    release(i);
  };
  for (int i = 0; i < lo; ++i) pass(i);
  if (lo < hi) {
    // the A operands of x and y: the warpgroup's own rows of k, v (dkv) or
    // q, dO (dq), split once
    Own<DP> ax, ay;
    load_own<DP>(ax, (DKV ? k : q) + bh * T_own * D, row_lo, T_own, D, r, t);
    load_own<DP>(ay, (DKV ? v : dout) + bh * T_own * D, row_lo, T_own, D, r,
                 t);
    float x[BT / 2], y[BT / 2];
    uint32_t ph[BT / 2], pl[BT / 2], sh[BT / 2], sl[BT / 2];
#pragma unroll
    for (int e = 0; e < BT / 2; ++e) x[e] = y[e] = 0.f;
    fence_regs(x);
    fence_regs(y);
    wait_phase(smem_u32(&full[lo % S]), (lo / S) & 1);
    wgmma_fence();
    mma_xy<DP, BT, DKV>(x, y, ax, ay, st_d + (lo % S) * Z::STAGE / 16);
    wgmma_commit();
    // one step per tile; the last (MORE false) issues no next x, y, so no
    // path leaves the accumulators to a copy while wgmmas are in flight
    auto step = [&](int i, auto more) {
      wgmma_wait<0>();
      fence_regs(x);
      fence_regs(y);
      if (i > lo) release(i - 1);
      const int c0 = first + i * BT;
      const uint64_t st = st_d + (i % S) * Z::STAGE / 16;
      const float* rows = reinterpret_cast<const float*>(
          stages + (i % S) * Z::STAGE + 8 * Z::TILE);
      const bool mask = (causal && (DKV ? c0 < row_lo + 64
                                        : c0 + BT - 1 > row_lo)) ||
                        c0 + BT > T_str || row_lo + 64 > T_own;
      if (mask)
        recompute_tile<BT, DKV, true>(x, y, rows, lr, dr, scale, r, t, row_lo,
                                      c0, Tq, Tk, causal, ph, pl, sh, sl);
      else
        recompute_tile<BT, DKV, false>(x, y, rows, lr, dr, scale, r, t,
                                       row_lo, c0, Tq, Tk, causal, ph, pl, sh,
                                       sl);
      wgmma_fence();
      // dkv: dk += ds^T q and dv += p^T dO (B = q^T, dO^T); dq: dq += ds k
      // (B = k^T)
      mma_rs<PASSES, DP, BT, NA>(acc0, sh, sl, st + 4 * Z::TILE / 16,
                                 st + 5 * Z::TILE / 16);
      if (DKV)
        mma_rs<PASSES, DP, BT, NA>(acc1, ph, pl, st + 6 * Z::TILE / 16,
                                   st + 7 * Z::TILE / 16);
      if (decltype(more)::value) {
        wait_phase(smem_u32(&full[(i + 1) % S]), ((i + 1) / S) & 1);
        mma_xy<DP, BT, DKV>(x, y, ax, ay,
                            st_d + ((i + 1) % S) * Z::STAGE / 16);
      }
      wgmma_commit();
    };
    for (int i = lo; i < hi - 1; ++i) step(i, std::true_type());
    step(hi - 1, std::false_type());
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      fence_regs(acc0[a]);
      if (DKV) fence_regs(acc1[a]);
    }
    fence_regs(sh);
    fence_regs(sl);
    if (DKV) {
      fence_regs(ph);
      fence_regs(pl);
    }
    release(hi - 1);
  }
  for (int i = hi; i < n; ++i) pass(i);

  if (DKV) {
    store_rows<DP, NA>(out0 + bh * T_own * D, acc0, row_lo, Tk, D, r, t,
                       scale);
    store_rows<DP, NA>(out1 + bh * T_own * D, acc1, row_lo, Tk, D, r, t,
                       1.f);
  } else {
    store_rows<DP, NA>(out0 + bh * T_own * D, acc0, row_lo, Tq, D, r, t,
                       scale);
  }
}

template <int DP, bool DKV, int BT, int NA>
int launch(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* delta, float* out0, float* out1,
           int bh, int tq, int tk, int d, float scale, int causal,
           cudaStream_t st) {
  using Z = Sizes<DP, BT, DKV>;
  // up to MAX_STAGES stages beside the static barriers, the alignment
  // slack and two raw slots; then as many raw slots as fit, up to
  // MAX_RAW, so the copies run that many tiles ahead of the splits
  const int room = SMEM_LIMIT - 2048;
  int stages = (room - 2 * Z::RAW) / Z::STAGE;
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  int raw = (room - stages * Z::STAGE) / Z::RAW;
  if (raw > MAX_RAW) raw = MAX_RAW;
  const int smem = stages * Z::STAGE + raw * Z::RAW + 1024;
  auto kern = flash_bwd_wgmma_kernel<DP, DKV, BT, NA>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_own = ((DKV ? tk : tq) + BM - 1) / BM;
  const long long grid = (long long)n_own * bh;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)grid, THREADS, smem, st>>>(q, k, v, dout, lse, delta, out0,
                                             out1, tq, tk, d, scale, causal,
                                             n_own, stages, raw);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout, dq: (bh, tq, d); k, v: (bh, tk, d); lse, delta: (bh, tq);
// contiguous f32, q, k, v and dout 16-byte aligned, d % 4 == 0, d <= 32.
// Returns the launch's cudaError_t (0 on success).
extern "C" int mxtt_flash_dq_wgmma(const float* q, const float* k,
                                   const float* v, const float* dout,
                                   const float* lse, const float* delta,
                                   float* dq, int bh, int tq, int tk, int d,
                                   float scale, int causal, void* stream) {
  const void* ptrs[4] = {q, k, v, dout};
  if (!takes(ptrs, 4, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || tq <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d <= 16
             ? launch<16, false, 64, 4>(q, k, v, dout, lse, delta, dq,
                                        nullptr, bh, tq, tk, d, scale,
                                        causal, st)
             : launch<32, false, 64, 2>(q, k, v, dout, lse, delta, dq,
                                        nullptr, bh, tq, tk, d, scale,
                                        causal, st);
}

// dk, dv: (bh, tk, d); the rest as above.
extern "C" int mxtt_flash_dkv_wgmma(const float* q, const float* k,
                                    const float* v, const float* dout,
                                    const float* lse, const float* delta,
                                    float* dk, float* dv, int bh, int tq,
                                    int tk, int d, float scale, int causal,
                                    void* stream) {
  const void* ptrs[4] = {q, k, v, dout};
  if (!takes(ptrs, 4, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || tk <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d <= 16 ? launch<16, true, 32, 2>(q, k, v, dout, lse, delta, dk, dv,
                                           bh, tq, tk, d, scale, causal, st)
                 : launch<32, true, 32, 1>(q, k, v, dout, lse, delta, dk, dv,
                                           bh, tq, tk, d, scale, causal, st);
}
