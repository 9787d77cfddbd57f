// Flash attention on bfloat16 operands on Hopper's tensor cores: TMA into an
// mbarrier ring, bf16 wgmma with A from registers and B as it lies, warp
// specialisation (sm_90a).
//
// The Hopper design of the three kernels of mxnet_tpu/ops/pallas_kernels.py
// on bf16 q, k, v and dO, which ring attention runs on every hop of the bf16
// TransformerLM step (parallel/ring_attention.py):
//
//   mxtt_flash_fwd_wgmma_bf16 <- _fa_kernel     (:62, called by
//                                _flash_attention_fwd_impl, :146)
//   mxtt_flash_dq_wgmma_bf16  <- _fa_dq_kernel  (:171, called by
//                                flash_dq, :314)
//   mxtt_flash_dkv_wgmma_bf16 <- _fa_dkv_kernel (:226, called by
//                                flash_dkv, :345)
//
// flash_attention.cu keeps the CUDA-core bf16 route (mxtt_flash_*_bf16) for
// the head dims this one does not take (ops/pallas_kernels.py,
// flash_design).  Both compute what the Pallas bodies compute on bf16
// operands, with their guards:
//   forward: s = q.k * scale, masked entries -1e30 (never -inf): keys past
//   Tk, and key j > query i when causal (both aligned at position 0); the
//   online softmax m_new = max(m, rowmax s), m_safe = 0 while m_new is
//   still the mask value, corr = 0 while m is, p = 0 where s <= -5e29; at
//   the end denom = max(l, 1e-30), out = acc / denom and lse = m +
//   log(denom), so a row that saw no key keeps lse = -1e30 + log(1e-30);
//   backward: p = exp(s - lse) where the pair (q row i, k row j) is valid,
//   else 0 (valid: i < Tq, j < Tk, j <= i when causal), dp = dO.v, ds = p
//   (dp - delta), 0 where not valid; dq = sum_j ds k * scale, dv = sum_i p
//   dO, dk = sum_i ds q * scale.
//   Rows past the ragged ends are zeros in shared memory (the TMA box's
//   out-of-bounds fill) or in the own rows' fragments, so no unloaded row is
//   ever multiplied.
//
// Numerics, the reference's on bf16 operands: every product accumulates in
// f32, the products with the f32 probabilities take p or ds in f32 (the
// reference widens them), lse stays f32, and each output is rounded to
// bf16 once.  q, k, v and dO are exact in bf16, so s = q.k^T, dp = dO.v^T
// (and s^T = k.q^T, dp^T = v.dO^T) is one bf16 wgmma pass with f32
// accumulation.  In p.v, ds.k, p^T.dO and ds^T.q the f32 operand x (p or
// ds) is split into PARTS bf16 values, hi = bf16(x), lo = bf16(x - hi)
// (each difference exact in f32), and the products of the parts with the
// exact bf16 operand are summed in f32: two parts keep x to ~2^-17 of
// itself, far inside the contract of one bf16 ulp of the plain version,
// which tests/test_torch_flash_bf16_wgmma.py's emulation holds at two parts
// (and shows one part missing).  The softmax is flash_wgmma.cuh's
// softmax_tile, as in the split-TF32 forward: s rounded times the scale,
// 2^x of one FMA on the SFU; the backward's recompute is IEEE expf; logf
// and the division stay IEEE: no --use_fast_math.
//
// What bounds it on an H100: operations.  At the ring path (D = 16, chunks
// of 512; hop 0 causal over BH 512, hop 1 full over BH 256: 134,348,800
// (q, k) pairs per layer) the non-matrix f32 work per pair (the softmax or
// the recompute, the splits) outweighs the bf16 products (one pass of 2 D
// flops per exact product, PARTS per mixed one, at 989 TFLOP/s dense); the
// bytes (q, k, v, dO in and the outputs at 2 bytes, lse and delta at 4:
// ~52 MB per layer forward, ~66 MB dq, ~78 MB dk/dv) take 0.016-0.023 ms.
// At D = 16 every wgmma is small (K = 16, N <= 64), so what holds the
// design back is latency, as in the split-TF32 designs.  The design:
//
// - Blocks and pipelining: the split-TF32 designs' (flash_fwd_wgmma.cu,
//   flash_bwd_wgmma.cu).  The forward and dq are q-major, 128 queries a
//   block (two consumer warpgroups of 64) walking the keys in tiles of 64
//   (DQ_BT for dq); dk/dv is k-major, 128 keys a block walking the queries
//   in tiles of 32.  Every output element is summed by one warpgroup in a
//   fixed order: reruns are bitwise.  Causal blocks skip the tiles wholly
//   on the masked side; a warpgroup masks only the tiles the diagonal or a
//   ragged end crosses.  Per tile a consumer warpgroup waits for one wgmma
//   group (the products over the previous tile and the scores of this one),
//   runs the softmax or the recompute, and issues the next group.
// - Loads.  Exact operands need no split, so there is no split pass and no
//   second ring: one producer thread keeps up to STAGES tiles in flight
//   by TMA (a 3-D map (D, T, BH), boxes of 8 columns by the tile's rows)
//   straight into the layout wgmma reads, on `full` / `empty` mbarriers.
//   The producer warpgroup's other threads write lse and delta of each
//   streamed tile into its stage (dk/dv; dq keeps its own rows' lse and
//   delta in registers).  setmaxnreg gives the producer 56 registers and
//   the consumers 224.
// - Layout.  A tile of R rows is held unswizzled as column chunks: chunk c
//   (columns 8 c .. 8 c + 7, 16 bytes a row) of row j at c R 16 + 16 j, the
//   box TMA writes.  Its 8-row by 16-byte core matrices make it a K-major B
//   (the product contracts over the columns: k for s = q.k^T, v for dp =
//   dO.v^T, q and dO for s^T and dp^T) and, through 16-bit wgmma's
//   transpose bit, an MN-major B (the product contracts over the rows: v in
//   p.v, k in ds.k, dO in p^T.dO, q in ds^T.q) as it lies: the producer
//   writes no transposed copy.  Chunks past D (D = 8 or 24 padded to 16 or
//   32) are zeroed once and never loaded.
// - Products.  wgmma m64nNk16 .bf16 with A from registers.  The scores take
//   the warpgroup's own rows (q, and dO for dq; k and v for dk/dv) as A,
//   loaded once per block.  The mixed products take p or ds straight from
//   the score accumulator: its element pairs (e, e + 1) of each 8-element
//   group are the A fragment of the next product's k-steps with no
//   permutation (see sm90.cuh), so a split is a pair of cvt.rn.bf16x2 and a
//   subtraction.  They sum into NA independent accumulators, part by part,
//   so consecutive wgmmas rarely accumulate into the same registers.
// - dq, measured slower on an H100 (PERF.md): key tiles of 128 (DQ_BT;
//   chip_smoke.py times both), and two wgmma groups per tile (s, dp of the
//   next tile, then dq over this one, waited on with wait_group 1 and ds
//   split into two alternating buffers, so that the recompute overlaps
//   dq's products: ptxas injected warpgroup.arrive (C7519) around them).
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"
#include "flash_wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;              // the block's own rows
constexpr int THREADS = 384;         // producer, 2 consumers
constexpr int STAGES = 8;            // tiles in flight
constexpr int FWD_BT = 64;           // keys per streamed tile (forward)
constexpr int DKV_BT = 32;           // queries per streamed tile (dk/dv)
constexpr int DQ_BT = 64;            // keys per streamed tile (dq)
constexpr int DQ_NA = 2;             // dq's independent accumulators
constexpr int PARTS = 2;             // bf16 parts of p and ds: hi, lo

// wgmma m64nNk16 bf16, A from registers, B K-major (TB 0) or MN-major (TB
// 1), by N
template <int N, int TB> struct Bf16;
template <int TB> struct Bf16<16, TB> {
  static __device__ __forceinline__ void run(float (&d)[8],
      const uint32_t (&a)[4], uint64_t b, int acc) {
    wgmma_bf16_rs_n16<TB>(d, a, b, acc);
  }
};
template <int TB> struct Bf16<32, TB> {
  static __device__ __forceinline__ void run(float (&d)[16],
      const uint32_t (&a)[4], uint64_t b, int acc) {
    wgmma_bf16_rs_n32<TB>(d, a, b, acc);
  }
};
template <int TB> struct Bf16<64, TB> {
  static __device__ __forceinline__ void run(float (&d)[32],
      const uint32_t (&a)[4], uint64_t b, int acc) {
    wgmma_bf16_rs_n64<TB>(d, a, b, acc);
  }
};

// descriptors of k-step kk of a column-chunked tile of R rows at `addr`:
// K-major (the product contracts over the columns, 16 a step: two chunks,
// R 16 bytes apart; 8-row groups 128 bytes apart) and MN-major (over the
// rows, 16 a step: two 8-row groups 128 bytes apart; chunks R 16 bytes
// apart along N)
__device__ __forceinline__ uint64_t kmajor(uint32_t addr, int R, int kk) {
  return il_desc(addr + kk * 2 * R * 16, R * 16, 128);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr, int R, int kk) {
  return il_desc(addr + kk * 256, 128, R * 16);
}

// A fragments of the warpgroup's 64 own rows of a (rows, D) bf16 matrix:
// rows row0 + r (+ 8), columns 16 kk + 2 t (+ 1) and 16 kk + 8 + 2 t (+ 1),
// zeros past either end
template <int DP>
__device__ __forceinline__ void load_frag(uint32_t (&a)[DP / 4],
                                          const bf16* src, int row0,
                                          int rows, int D, int r, int t) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + r + 8 * (j & 1);
      const int col = 16 * kk + 2 * t + 8 * (j >> 1);
      a[4 * kk + j] =
          row < rows && col < D
              ? *reinterpret_cast<const uint32_t*>(src + (long long)row * D +
                                                   col)
              : 0u;
    }
  }
}

// x (a 64 x 2 NV accumulator, as p or ds) split into PARTS bf16 A
// fragments: part 0 = bf16(x), each next part bf16 of what the earlier
// ones leave (exact in f32); pairs (e, e + 1) packed low, high
template <int NV>
__device__ __forceinline__ void split_bf16(const float (&x)[NV],
                                           uint32_t (&parts)[PARTS][NV / 2]) {
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) {
    float a = x[2 * i], b = x[2 * i + 1];
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      parts[p][i] = *reinterpret_cast<const uint32_t*>(&h);
      const float2 f = __bfloat1622float2(h);
      a -= f.x;
      b -= f.y;
    }
  }
}

// acc[kk % NA] += X[:, rows 16 kk ..] T[rows 16 kk .., :] over the R rows
// of a streamed tile T (MN-major at `tile`), part by part: X's parts as A
template <int DP, int R, int NA>
__device__ __forceinline__ void mma_parts(float (&acc)[NA][DP / 2],
                                          const uint32_t (&x)[PARTS][R / 4],
                                          uint32_t tile) {
#pragma unroll
  for (int p = 0; p < PARTS; ++p) {
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      const uint32_t a[4] = {x[p][4 * kk], x[p][4 * kk + 1], x[p][4 * kk + 2],
                             x[p][4 * kk + 3]};
      Bf16<DP, 1>::run(acc[kk % NA], a, mnmajor(tile, R, kk), 1);
    }
  }
}

// rows row0 + r (+ 8) of the sum of NA (64 x DP) accumulators, times mul,
// rounded to bf16, into the (., D) matrix out; rows past `rows` and columns
// past D dropped
template <int DP, int NA>
__device__ __forceinline__ void store_bf16(bf16* out,
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
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * D + col) =
            __floats2bfloat162_rn(v.x * mul, v.y * mul);
    }
  }
}

// barriers and the ring, shared by both kernels: STAGES stages of `stage`
// bytes from `stages` (128-byte aligned), chunks past D zeroed when D < DP
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          uint8_t* stages, int stage,
                                          bool pad) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);     // the producer's expect_tx
      mbar_init(smem_u32(&empty[s]), 8);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (pad) {
    for (int i = threadIdx.x; i < STAGES * stage / 16; i += THREADS)
      reinterpret_cast<uint4*>(stages)[i] = make_uint4(0u, 0u, 0u, 0u);
    fence_async_smem();   // before TMA and wgmma, in the async proxy
  }
  __syncthreads();
}

// one streamed tile of two operands into a stage: chunks 0 .. D / 8 - 1 of
// rows row0 .. row0 + R - 1 of bh, zeros past T
template <int R>
__device__ __forceinline__ void load_pair(const CUtensorMap* a,
                                          const CUtensorMap* b, uint8_t* dst,
                                          int tile, uint32_t bar, int D,
                                          int row0, int bh) {
  mbar_expect_tx(bar, 2 * (D / 8) * R * 16);
  for (int c = 0; c < D / 8; ++c) {
    tma_load_3d(smem_u32(dst + c * R * 16), a, bar, 8 * c, row0, bh);
    tma_load_3d(smem_u32(dst + tile + c * R * 16), b, bar, 8 * c, row0, bh);
  }
}

// s = q.k^T over DP: A q's own fragments, B the stage's k tile (K-major)
template <int DP>
__device__ __forceinline__ void mma_s(float (&s)[FWD_BT / 2],
                                      const uint32_t (&aq)[DP / 4],
                                      uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t a[4] = {aq[4 * kk], aq[4 * kk + 1], aq[4 * kk + 2],
                           aq[4 * kk + 3]};
    Bf16<FWD_BT, 0>::run(s, a, kmajor(tile, FWD_BT, kk), kk > 0);
  }
}

// The forward.  One block: (query tile, bh) of the flat grid, the last
// queries of each bh first.  NA independent output accumulators.
template <int DP, int NA>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const bf16* __restrict__ q, bf16* __restrict__ out,
                      float* __restrict__ lse, int Tq, int Tk, int D,
                      float scale, int causal, int n_own) {
  constexpr int BT = FWD_BT, S = STAGES;
  constexpr int TILE = BT * DP * 2;    // bytes of one tile: k, then v
  constexpr int STAGE = 2 * TILE;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];

  const int bh = blockIdx.x / n_own;
  const int q0 = (n_own - 1 - (int)(blockIdx.x % n_own)) * BM;
  // the key tiles this block visits: [0, n)
  const int last = causal ? min(Tk, q0 + BM) : Tk;
  const int n = (last + BT - 1) / BT;
  uint8_t* const stages =
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  init_ring(full, empty, stages, STAGE, D < DP);
  const int wg = threadIdx.x >> 7;

  if (wg == 0) {
    reg_dealloc<56>();
    // one thread keeps the ring full: tile i (k and v) into stage i % S
    if (threadIdx.x == 0) {
      for (int i = 0; i < n; ++i) {
        const int s = i % S;
        mbar_wait(smem_u32(&empty[s]), ((i / S) & 1) ^ 1);
        load_pair<BT>(&kmap, &vmap, stages + s * STAGE, TILE,
                      smem_u32(&full[s]), D, i * BT, bh);
      }
    }
    return;
  }

  reg_alloc<224>();
  // The consumers: warpgroup cw owns queries q0 + 64 cw .. + 63.  The
  // warpgroup index is broadcast from lane 0, so the compiler knows every
  // value derived from it is uniform across the warpgroup.
  const int ct = threadIdx.x - 128;
  const int cw = __shfl_sync(0xffffffffu, ct >> 7, 0);
  const int warp = (ct >> 5) & 3, lane = ct & 31;
  const int r = 16 * warp + (lane >> 2), t = lane & 3;
  const int row_lo = q0 + 64 * cw;   // the warpgroup's first own row
  const uint32_t st0 = smem_u32(stages);
  float o[NA][DP / 2];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) o[a][e] = 0.f;
    // zeroed here, not sunk next to the first wgmma that reads them
    fence_regs(o[a]);
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // the tiles this warpgroup computes, [0, hi): causal, none wholly past its
  // last row; none when it owns no row
  const int hi = row_lo >= Tq ? 0
                 : causal     ? min(n, (row_lo + 63) / BT + 1)
                              : n;
  auto release = [&](int i) { warp_arrive(smem_u32(&empty[i % S]), lane); };
  if (hi > 0) {
    uint32_t aq[DP / 4];
    load_frag<DP>(aq, q + (long long)bh * Tq * D, row_lo, Tq, D, r, t);
    // s: the tile's scores, then p in place; pp: p split, the A operand of
    // p.v
    float s[BT / 2];
    uint32_t pp[PARTS][BT / 4];
#pragma unroll
    for (int e = 0; e < BT / 2; ++e) s[e] = 0.f;
    fence_regs(s);
    wait_phase(smem_u32(&full[0]), 0);
    wgmma_fence();
    mma_s<DP>(s, aq, st0);
    wgmma_commit();
    // one step per tile: wait for the group of p.v over tile i - 1 and s of
    // tile i, run the softmax, then issue p.v over tile i and s of tile i +
    // 1 as the next group.  The last step (MORE false) issues no next s.
    auto step = [&](int i, auto more) {
      wgmma_wait<0>();
      fence_regs(s);
#pragma unroll
      for (int a = 0; a < NA; ++a) fence_regs(o[a]);
#pragma unroll
      for (int p = 0; p < PARTS; ++p) fence_regs(pp[p]);
      if (i > 0) release(i - 1);
      const int c0 = i * BT;
      float corr[2];
      if (c0 + BT > Tk || (causal && c0 + BT - 1 > row_lo))
        softmax_tile<BT, true>(s, m, l, corr, scale, row_lo, r, t, c0, Tk,
                               causal);
      else
        softmax_tile<BT, false>(s, m, l, corr, scale, row_lo, r, t, c0, Tk,
                                causal);
#pragma unroll
      for (int a = 0; a < NA; ++a) {
#pragma unroll
        for (int e = 0; e < DP / 2; ++e) o[a][e] *= corr[(e >> 1) & 1];
      }
      split_bf16<BT / 2>(s, pp);
      wgmma_fence();
      const uint32_t st = st0 + (i % S) * STAGE;
      mma_parts<DP, BT, NA>(o, pp, st + TILE);
      if (decltype(more)::value) {
        wait_phase(smem_u32(&full[(i + 1) % S]), ((i + 1) / S) & 1);
        mma_s<DP>(s, aq, st0 + ((i + 1) % S) * STAGE);
      }
      wgmma_commit();
    };
    for (int i = 0; i < hi - 1; ++i) step(i, std::true_type());
    step(hi - 1, std::false_type());
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(o[a]);
#pragma unroll
    for (int p = 0; p < PARTS; ++p) fence_regs(pp[p]);
    fence_regs(s);
    release(hi - 1);
  }
  // tiles this warpgroup skips still pass through its barriers
  for (int i = hi; i < n; ++i) {
    wait_phase(smem_u32(&full[i % S]), (i / S) & 1);
    release(i);
  }

  // out = acc / max(l, 1e-30) rounded to bf16, lse = m + log(denom), l
  // summed over the quad; rows past Tq and columns past D dropped
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + r + 8 * h;
    if (row >= Tq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    bf16* const orow = out + ((long long)bh * Tq + row) * D;
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      const int col = nb * 8 + 2 * t;
      float2 x = make_float2(0.f, 0.f);
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        x.x += o[a][nb * 4 + 2 * h];
        x.y += o[a][nb * 4 + 2 * h + 1];
      }
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x.x / denom, x.y / denom);
    }
    if (t == 0) lse[(long long)bh * Tq + row] = m[h] + logf(denom);
  }
}

// p^T and ds^T of a tile from x = s^T, y = dp^T, split into PARTS bf16
// fragments each.  Accumulator e of the thread: own key row_lo + r + 8 ((e
// / 2) % 2), streamed query c0 + 8 (e / 4) + 2 t + e % 2, whose lse and
// delta are rows[.] and rows[BT + .].  MASK: the diagonal or a ragged end
// crosses the tile.
template <int BT, bool MASK>
__device__ __forceinline__ void recompute_tile(
    const float (&x)[BT / 2], const float (&y)[BT / 2], const float* rows,
    float scale, int r, int t, int row_lo, int c0, int Tq, int Tk,
    int causal, uint32_t (&pp)[PARTS][BT / 4], uint32_t (&sp)[PARTS][BT / 4]) {
  float p[BT / 2], ds[BT / 2];
#pragma unroll
  for (int nb = 0; nb < BT / 8; ++nb) {
    const int col = nb * 8 + 2 * t;
    const float2 cl = *reinterpret_cast<const float2*>(rows + col);
    const float2 cd = *reinterpret_cast<const float2*>(rows + BT + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = nb * 4 + 2 * h + c;
        bool valid = true;
        if (MASK) {
          const int kj = row_lo + r + 8 * h, qi = c0 + col + c;
          valid = qi < Tq && kj < Tk && (!causal || qi >= kj);
        }
        const float lr = c ? cl.y : cl.x, dr = c ? cd.y : cd.x;
        p[e] = valid ? expf(x[e] * scale - lr) : 0.f;
        ds[e] = valid ? p[e] * (y[e] - dr) : 0.f;
      }
    }
  }
  split_bf16<BT / 2>(p, pp);
  split_bf16<BT / 2>(ds, sp);
}

// x = s^T = k.q^T and y = dp^T = v.dO^T over DP, k-step by k-step with x
// and y alternating: A the own rows of k / v, B the stage's q / dO tiles
// (K-major)
template <int DP>
__device__ __forceinline__ void mma_xy(float (&x)[DKV_BT / 2],
                                       float (&y)[DKV_BT / 2],
                                       const uint32_t (&ak)[DP / 4],
                                       const uint32_t (&av)[DP / 4],
                                       uint32_t st) {
  constexpr int TILE = DKV_BT * DP * 2;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t a[4] = {ak[4 * kk], ak[4 * kk + 1], ak[4 * kk + 2],
                           ak[4 * kk + 3]};
    const uint32_t b[4] = {av[4 * kk], av[4 * kk + 1], av[4 * kk + 2],
                           av[4 * kk + 3]};
    Bf16<DKV_BT, 0>::run(x, a, kmajor(st, DKV_BT, kk), kk > 0);
    Bf16<DKV_BT, 0>::run(y, b, kmajor(st + TILE, DKV_BT, kk), kk > 0);
  }
}

// dk / dv.  One block: (key tile, bh) of the flat grid, the first keys of
// each bh (the heaviest causal tiles) first; the queries streamed in tiles
// of DKV_BT rows, q and dO with lse and delta.  NA independent accumulators
// per output.
template <int DP, int NA>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap domap,
                      const bf16* __restrict__ k, const bf16* __restrict__ v,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int Tq, int Tk, int D,
                      float scale, int causal, int n_own) {
  constexpr int BT = DKV_BT, S = STAGES;
  constexpr int TILE = BT * DP * 2;    // bytes of one tile: q, then dO
  constexpr int STAGE = 2 * TILE + 2 * BT * 4;   // then lse, delta
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];

  const int bh = blockIdx.x / n_own;
  const int own0 = (int)(blockIdx.x % n_own) * BM;
  // the queries this block visits: [first, Tq); causal, none before its
  // first key
  const int first = causal ? min(own0, Tq) : 0;
  const int n = (Tq - first + BT - 1) / BT;
  uint8_t* const stages =
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  init_ring(full, empty, stages, STAGE, D < DP);
  const int wg = threadIdx.x >> 7;

  if (wg == 0) {
    reg_dealloc<56>();
    const int tid = threadIdx.x;
    // thread tid < 2 BT carries lse (tid < BT) or delta of query tid % BT
    // of a tile, read one tile ahead; thread 0 issues the tile's copies
    // once they are written
    auto row_of = [&](int i) {
      const int row = first + i * BT + tid % BT;
      const float* src = tid < BT ? lse : delta;
      return tid < 2 * BT && i < n && row < Tq
                 ? src[(long long)bh * Tq + row]
                 : 0.f;
    };
    float ahead = row_of(0);
    for (int i = 0; i < n; ++i) {
      const int s = i % S;
      const float cur = ahead;
      ahead = row_of(i + 1);
      uint8_t* const st = stages + s * STAGE;
      mbar_wait(smem_u32(&empty[s]), ((i / S) & 1) ^ 1);
      if (tid < 2 * BT) reinterpret_cast<float*>(st + 2 * TILE)[tid] = cur;
      warpgroup_sync(1);   // the stage's rows are written
      if (tid == 0)
        load_pair<BT>(&qmap, &domap, st, TILE, smem_u32(&full[s]), D,
                      first + i * BT, bh);
    }
    return;
  }

  reg_alloc<224>();
  // The consumers: warpgroup cw owns keys own0 + 64 cw .. + 63.  Per tile i
  // it waits for one wgmma group, the products over tile i - 1 and x, y of
  // tile i; recomputes p, ds of tile i; then issues the products over tile
  // i and x, y of tile i + 1 as the next group.
  const int ct = threadIdx.x - 128;
  const int cw = __shfl_sync(0xffffffffu, ct >> 7, 0);
  const int warp = (ct >> 5) & 3, lane = ct & 31;
  const int r = 16 * warp + (lane >> 2), t = lane & 3;
  const int row_lo = own0 + 64 * cw;   // the warpgroup's first own key
  const uint32_t st0 = smem_u32(stages);
  float acc_k[NA][DP / 2], acc_v[NA][DP / 2];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) acc_k[a][e] = acc_v[a][e] = 0.f;
    fence_regs(acc_k[a]);
    fence_regs(acc_v[a]);
  }
  // the tiles this warpgroup computes, [lo, hi): causal, none wholly before
  // its first key; every tile passes when it owns no key
  auto skip = [&](int i) {
    return causal && first + i * BT + BT - 1 < row_lo;
  };
  int lo = 0, hi = row_lo < Tk ? n : 0;
  while (lo < hi && skip(lo)) ++lo;
  auto release = [&](int i) { warp_arrive(smem_u32(&empty[i % S]), lane); };
  auto pass = [&](int i) {
    wait_phase(smem_u32(&full[i % S]), (i / S) & 1);
    release(i);
  };
  for (int i = 0; i < lo; ++i) pass(i);
  if (lo < hi) {
    uint32_t ak[DP / 4], av[DP / 4];
    load_frag<DP>(ak, k + (long long)bh * Tk * D, row_lo, Tk, D, r, t);
    load_frag<DP>(av, v + (long long)bh * Tk * D, row_lo, Tk, D, r, t);
    float x[BT / 2], y[BT / 2];
    uint32_t pp[PARTS][BT / 4], sp[PARTS][BT / 4];
#pragma unroll
    for (int e = 0; e < BT / 2; ++e) x[e] = y[e] = 0.f;
    fence_regs(x);
    fence_regs(y);
    wait_phase(smem_u32(&full[lo % S]), (lo / S) & 1);
    wgmma_fence();
    mma_xy<DP>(x, y, ak, av, st0 + (lo % S) * STAGE);
    wgmma_commit();
    auto step = [&](int i, auto more) {
      wgmma_wait<0>();
      fence_regs(x);
      fence_regs(y);
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        fence_regs(acc_k[a]);
        fence_regs(acc_v[a]);
      }
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {
        fence_regs(pp[p]);
        fence_regs(sp[p]);
      }
      if (i > lo) release(i - 1);
      const int c0 = first + i * BT;
      const uint32_t st = st0 + (i % S) * STAGE;
      const float* rows = reinterpret_cast<const float*>(
          stages + (i % S) * STAGE + 2 * TILE);
      const bool mask = (causal && c0 < row_lo + 64) || c0 + BT > Tq ||
                        row_lo + 64 > Tk;
      if (mask)
        recompute_tile<BT, true>(x, y, rows, scale, r, t, row_lo, c0, Tq, Tk,
                                 causal, pp, sp);
      else
        recompute_tile<BT, false>(x, y, rows, scale, r, t, row_lo, c0, Tq,
                                  Tk, causal, pp, sp);
      wgmma_fence();
      // dv += p^T dO, dk += ds^T q (B: the dO and q tiles, MN-major)
      mma_parts<DP, BT, NA>(acc_v, pp, st + TILE);
      mma_parts<DP, BT, NA>(acc_k, sp, st);
      if (decltype(more)::value) {
        wait_phase(smem_u32(&full[(i + 1) % S]), ((i + 1) / S) & 1);
        mma_xy<DP>(x, y, ak, av, st0 + ((i + 1) % S) * STAGE);
      }
      wgmma_commit();
    };
    for (int i = lo; i < hi - 1; ++i) step(i, std::true_type());
    step(hi - 1, std::false_type());
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      fence_regs(acc_k[a]);
      fence_regs(acc_v[a]);
    }
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
      fence_regs(pp[p]);
      fence_regs(sp[p]);
    }
    release(hi - 1);
  }
  for (int i = hi; i < n; ++i) pass(i);

  const long long off = (long long)bh * Tk * D;
  store_bf16<DP, NA>(dk + off, acc_k, row_lo, Tk, D, r, t, scale);
  store_bf16<DP, NA>(dv + off, acc_v, row_lo, Tk, D, r, t, 1.f);
}

// ds of a key tile from s and dp, in place in s, split into PARTS bf16
// fragments.  Accumulator e of the thread: own query row_lo + r + 8 ((e /
// 2) % 2), whose lse and delta are lr[.] and dr[.], streamed key c0 + 8 (e
// / 4) + 2 t + e % 2.  MASK: the diagonal or a ragged end crosses the tile.
template <int BT, bool MASK>
__device__ __forceinline__ void recompute_dq(
    float (&s)[BT / 2], const float (&dp)[BT / 2], const float (&lr)[2],
    const float (&dr)[2], float scale, int r, int t, int row_lo, int c0,
    int Tq, int Tk, int causal, uint32_t (&sp)[PARTS][BT / 4]) {
#pragma unroll
  for (int nb = 0; nb < BT / 8; ++nb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = nb * 4 + 2 * h + c;
        bool valid = true;
        if (MASK) {
          const int qi = row_lo + r + 8 * h, kj = c0 + nb * 8 + 2 * t + c;
          valid = qi < Tq && kj < Tk && (!causal || qi >= kj);
        }
        const float p = valid ? expf(s[e] * scale - lr[h]) : 0.f;
        s[e] = valid ? p * (dp[e] - dr[h]) : 0.f;
      }
    }
  }
  split_bf16<BT / 2>(s, sp);
}

// s = q.k^T and dp = dO.v^T over DP, by k-step and by 64 keys with s and
// dp alternating: A the own rows' q / dO fragments, B the stage's k / v
// tiles of BT keys (K-major)
template <int DP, int BT>
__device__ __forceinline__ void mma_sdp(float (&s)[BT / 2],
                                        float (&dp)[BT / 2],
                                        const uint32_t (&aq)[DP / 4],
                                        const uint32_t (&ado)[DP / 4],
                                        uint32_t st) {
  constexpr int TILE = BT * DP * 2;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t a[4] = {aq[4 * kk], aq[4 * kk + 1], aq[4 * kk + 2],
                           aq[4 * kk + 3]};
    const uint32_t b[4] = {ado[4 * kk], ado[4 * kk + 1], ado[4 * kk + 2],
                           ado[4 * kk + 3]};
#pragma unroll
    for (int h = 0; h < BT / 64; ++h) {
      float (&sh)[32] = *reinterpret_cast<float (*)[32]>(s + 32 * h);
      float (&dh)[32] = *reinterpret_cast<float (*)[32]>(dp + 32 * h);
      const uint32_t k64 = st + h * 64 * 16;   // keys 64 h .. 64 h + 63
      Bf16<64, 0>::run(sh, a, kmajor(k64, BT, kk), kk > 0);
      Bf16<64, 0>::run(dh, b, kmajor(k64 + TILE, BT, kk), kk > 0);
    }
  }
}

// dq.  One block: (query tile, bh) of the flat grid, the last queries of
// each bh (the heaviest causal tiles) first; the keys streamed in tiles of
// BT rows, k and v.  NA independent accumulators.
template <int DP, int BT, int NA>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_bf16_kernel(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const bf16* __restrict__ q,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     int Tq, int Tk, int D, float scale, int causal,
                     int n_own) {
  constexpr int S = STAGES;
  constexpr int TILE = BT * DP * 2;    // bytes of one tile: k, then v
  constexpr int STAGE = 2 * TILE;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];

  const int bh = blockIdx.x / n_own;
  const int q0 = (n_own - 1 - (int)(blockIdx.x % n_own)) * BM;
  // the key tiles this block visits: [0, n)
  const int last = causal ? min(Tk, q0 + BM) : Tk;
  const int n = (last + BT - 1) / BT;
  uint8_t* const stages =
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  init_ring(full, empty, stages, STAGE, D < DP);
  const int wg = threadIdx.x >> 7;

  if (wg == 0) {
    reg_dealloc<56>();
    // one thread keeps the ring full: tile i (k and v) into stage i % S
    if (threadIdx.x == 0) {
      for (int i = 0; i < n; ++i) {
        const int s = i % S;
        mbar_wait(smem_u32(&empty[s]), ((i / S) & 1) ^ 1);
        load_pair<BT>(&kmap, &vmap, stages + s * STAGE, TILE,
                      smem_u32(&full[s]), D, i * BT, bh);
      }
    }
    return;
  }

  reg_alloc<224>();
  // The consumers: warpgroup cw owns queries q0 + 64 cw .. + 63.  Per tile i
  // it waits for one wgmma group, dq over tile i - 1 and s, dp of tile i;
  // recomputes ds of tile i; then issues dq over tile i and s, dp of tile i
  // + 1 as the next group.
  const int ct = threadIdx.x - 128;
  const int cw = __shfl_sync(0xffffffffu, ct >> 7, 0);
  const int warp = (ct >> 5) & 3, lane = ct & 31;
  const int r = 16 * warp + (lane >> 2), t = lane & 3;
  const int row_lo = q0 + 64 * cw;   // the warpgroup's first own query
  const uint32_t st0 = smem_u32(stages);
  float acc[NA][DP / 2];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) acc[a][e] = 0.f;
    fence_regs(acc[a]);
  }
  // the tiles this warpgroup computes, [0, hi): causal, none wholly past its
  // last query; none when it owns no query.  The producer loads, and every
  // consumer warp releases, all n.
  const int hi = row_lo >= Tq ? 0
                 : causal     ? min(n, (row_lo + 63) / BT + 1)
                              : n;
  auto release = [&](int i) { warp_arrive(smem_u32(&empty[i % S]), lane); };
  if (hi > 0) {
    uint32_t aq[DP / 4], ado[DP / 4];
    load_frag<DP>(aq, q + (long long)bh * Tq * D, row_lo, Tq, D, r, t);
    load_frag<DP>(ado, dout + (long long)bh * Tq * D, row_lo, Tq, D, r, t);
    // lse and delta of the thread's two own rows
    float lr[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + r + 8 * h;
      if (row < Tq) {
        lr[h] = lse[(long long)bh * Tq + row];
        dr[h] = delta[(long long)bh * Tq + row];
      }
    }
    // s: the tile's scores, then ds in place; sp: ds split, the A operand
    // of dq += ds k
    float s[BT / 2], dp[BT / 2];
    uint32_t sp[PARTS][BT / 4];
#pragma unroll
    for (int e = 0; e < BT / 2; ++e) s[e] = dp[e] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wait_phase(smem_u32(&full[0]), 0);
    wgmma_fence();
    mma_sdp<DP, BT>(s, dp, aq, ado, st0);
    wgmma_commit();
    // the last step (MORE false) issues no next s, dp
    auto step = [&](int i, auto more) {
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int a = 0; a < NA; ++a) fence_regs(acc[a]);
#pragma unroll
      for (int p = 0; p < PARTS; ++p) fence_regs(sp[p]);
      if (i > 0) release(i - 1);
      const int c0 = i * BT;
      if (c0 + BT > Tk || (causal && c0 + BT - 1 > row_lo))
        recompute_dq<BT, true>(s, dp, lr, dr, scale, r, t, row_lo, c0, Tq,
                               Tk, causal, sp);
      else
        recompute_dq<BT, false>(s, dp, lr, dr, scale, r, t, row_lo, c0, Tq,
                                Tk, causal, sp);
      wgmma_fence();
      const uint32_t st = st0 + (i % S) * STAGE;
      // dq += ds k: B the k tile, MN-major
      mma_parts<DP, BT, NA>(acc, sp, st);
      if (decltype(more)::value) {
        wait_phase(smem_u32(&full[(i + 1) % S]), ((i + 1) / S) & 1);
        mma_sdp<DP, BT>(s, dp, aq, ado, st0 + ((i + 1) % S) * STAGE);
      }
      wgmma_commit();
    };
    for (int i = 0; i < hi - 1; ++i) step(i, std::true_type());
    step(hi - 1, std::false_type());
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(acc[a]);
#pragma unroll
    for (int p = 0; p < PARTS; ++p) fence_regs(sp[p]);
    fence_regs(s);
    fence_regs(dp);
    release(hi - 1);
  }
  // tiles this warpgroup skips still pass through its barriers
  for (int i = hi; i < n; ++i) {
    wait_phase(smem_u32(&full[i % S]), (i / S) & 1);
    release(i);
  }

  store_bf16<DP, NA>(dq + (long long)bh * Tq * D, acc, row_lo, Tq, D, r, t,
                     scale);
}

// the dynamic shared memory of a ring of `stage`-byte stages, with the
// alignment slack
constexpr int ring_bytes(int stage) { return STAGES * stage + 128; }

// a (bh, T, D) bf16 tensor as a 3-D TMA map (D innermost), boxes of 8
// columns by `box` rows of one bh, zeros outside
bool encode(CUtensorMap* map, const void* base, int bh, int T, int D,
            int box) {
  static const EncodeTiled tiled =
      reinterpret_cast<EncodeTiled>(entry_point("cuTensorMapEncodeTiled"));
  if (tiled == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)(T > 0 ? T : 1),
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)(T > 0 ? T : 1) * D * 2};
  const cuuint32_t boxes[3] = {8, (cuuint32_t)box, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
               const_cast<void*>(base), dims, strides, boxes, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// D % 8 == 0 from 8 to 32 (rows of whole 16-byte chunks for the TMA
// boxes; wider rows outgrow the consumers' registers), the operands 16-byte
// aligned (TMA's global addresses)
bool takes_bf16(const void* const* ptrs, int n, int d) {
  if (d < 8 || d > 32 || d % 8 != 0) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  return true;
}

template <int DP, int NA>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* out,
               float* lse, int bh, int tq, int tk, int d, float scale,
               int causal, cudaStream_t st) {
  CUtensorMap kmap, vmap;
  if (!encode(&kmap, k, bh, tk, d, FWD_BT) ||
      !encode(&vmap, v, bh, tk, d, FWD_BT))
    return (int)cudaErrorInvalidValue;
  const int smem = ring_bytes(2 * FWD_BT * DP * 2);
  auto kern = flash_fwd_bf16_kernel<DP, NA>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_own = (tq + BM - 1) / BM;
  const long long grid = (long long)n_own * bh;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)grid, THREADS, smem, st>>>(kmap, vmap, q, out, lse, tq,
                                             tk, d, scale, causal, n_own);
  return (int)cudaGetLastError();
}

template <int DP, int NA>
int launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
               const float* lse, const float* delta, bf16* dk, bf16* dv,
               int bh, int tq, int tk, int d, float scale, int causal,
               cudaStream_t st) {
  CUtensorMap qmap, domap;
  if (!encode(&qmap, q, bh, tq, d, DKV_BT) ||
      !encode(&domap, dout, bh, tq, d, DKV_BT))
    return (int)cudaErrorInvalidValue;
  const int smem = ring_bytes(2 * DKV_BT * DP * 2 + 2 * DKV_BT * 4);
  auto kern = flash_dkv_bf16_kernel<DP, NA>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_own = (tk + BM - 1) / BM;
  const long long grid = (long long)n_own * bh;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)grid, THREADS, smem, st>>>(qmap, domap, k, v, lse, delta,
                                             dk, dv, tq, tk, d, scale,
                                             causal, n_own);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
              const float* lse, const float* delta, bf16* dq, int bh, int tq,
              int tk, int d, float scale, int causal, cudaStream_t st) {
  constexpr int BT = DQ_BT, NA = DQ_NA;
  CUtensorMap kmap, vmap;
  if (!encode(&kmap, k, bh, tk, d, BT) || !encode(&vmap, v, bh, tk, d, BT))
    return (int)cudaErrorInvalidValue;
  const int smem = ring_bytes(2 * BT * DP * 2);
  auto kern = flash_dq_bf16_kernel<DP, BT, NA>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_own = (tq + BM - 1) / BM;
  const long long grid = (long long)n_own * bh;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)grid, THREADS, smem, st>>>(kmap, vmap, q, dout, lse, delta,
                                             dq, tq, tk, d, scale, causal,
                                             n_own);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (bh, tq, d); k, v: (bh, tk, d); contiguous bf16, 16-byte aligned,
// d % 8 == 0 from 8 to 32; lse: (bh, tq) f32.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int mxtt_flash_fwd_wgmma_bf16(const bf16* q, const bf16* k,
                                         const bf16* v, bf16* out, float* lse,
                                         int bh, int tq, int tk, int d,
                                         float scale, int causal,
                                         void* stream) {
  const void* ptrs[3] = {q, k, v};
  if (!takes_bf16(ptrs, 3, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || tq <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d <= 16 ? launch_fwd<16, 4>(q, k, v, out, lse, bh, tq, tk, d, scale,
                                     causal, st)
                 : launch_fwd<32, 2>(q, k, v, out, lse, bh, tq, tk, d, scale,
                                     causal, st);
}

// q, dout: (bh, tq, d); k, v, dk, dv: (bh, tk, d); lse, delta: (bh, tq)
// f32; the rest as above.
extern "C" int mxtt_flash_dkv_wgmma_bf16(const bf16* q, const bf16* k,
                                         const bf16* v, const bf16* dout,
                                         const float* lse, const float* delta,
                                         bf16* dk, bf16* dv, int bh, int tq,
                                         int tk, int d, float scale,
                                         int causal, void* stream) {
  const void* ptrs[4] = {q, k, v, dout};
  if (!takes_bf16(ptrs, 4, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || tk <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d <= 16 ? launch_dkv<16, 2>(q, k, v, dout, lse, delta, dk, dv, bh,
                                     tq, tk, d, scale, causal, st)
                 : launch_dkv<32, 1>(q, k, v, dout, lse, delta, dk, dv, bh,
                                     tq, tk, d, scale, causal, st);
}

// dq: (bh, tq, d) bf16; the rest as for dk / dv.
extern "C" int mxtt_flash_dq_wgmma_bf16(const bf16* q, const bf16* k,
                                        const bf16* v, const bf16* dout,
                                        const float* lse, const float* delta,
                                        bf16* dq, int bh, int tq, int tk,
                                        int d, float scale, int causal,
                                        void* stream) {
  const void* ptrs[4] = {q, k, v, dout};
  if (!takes_bf16(ptrs, 4, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || tq <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d <= 16 ? launch_dq<16>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d,
                                 scale, causal, st)
                 : launch_dq<32>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d,
                                 scale, causal, st);
}
