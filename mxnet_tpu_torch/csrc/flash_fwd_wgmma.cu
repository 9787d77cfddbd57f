// Flash attention forward on Hopper's tensor cores in split TF32: bulk
// asynchronous copies, mbarriers, wgmma and warp specialisation (sm_90a).
//
// The Hopper design of the forward kernel of mxnet_tpu/ops/pallas_kernels.py
// that ring attention runs on every hop (parallel/ring_attention.py):
//
//   mxtt_flash_fwd_wgmma <- _fa_kernel (:62, called by
//                           _flash_attention_fwd_impl, :146)
//
// flash_attention.cu keeps the CUDA-core design (mxtt_flash_fwd) for the
// head dims this one does not take or is slower at (ops/pallas_kernels.py,
// flash_design).  This one computes what the Pallas body computes, with its
// guards, over (BH, Tq, D) queries and (BH, Tk, D) keys / values:
//   s = q.k * scale, masked entries -1e30 (never -inf): keys past Tk, and
//   key j > query i when causal (both aligned at position 0); per tile of
//   keys the online softmax m_new = max(m, rowmax s), m_safe = 0 while
//   m_new is still the mask value, corr = 0 while m is, p = 0 where s <=
//   -5e29, l = l corr + rowsum p, acc = acc corr + p.v; at the end denom =
//   max(l, 1e-30), out = acc / denom and lse = m + log(denom), so a row that
//   saw no key keeps lse = -1e30 + log(1e-30), the guard the ring's combine
//   relies on.  Rows of k and v past Tk are zeros in shared memory, so no
//   unloaded row is ever multiplied (the Pallas body's :100-103 guard).
//
// Numerics: float32 in and out, to the contract of the CUDA-core design
// (1e-5 against the plain version).  Both products are split TF32 (see
// flash_wgmma.cuh): hi.hi + hi.lo + lo.hi in f32 accumulators.  s is
// scaled by one rounded multiply, as the reference rounds s * scale before
// it subtracts the max; p and corr are 2^x of one FMA on the SFU
// (softmax_tile): an IEEE expf per pair was the largest cost of this
// kernel's first version.  logf and the division stay IEEE: no
// --use_fast_math.
//
// What bounds it on an H100: operations.  The ring path (D = 16, chunks of
// 512; hop 0 causal over BH 512, hop 1 full over BH 256) visits 134,348,800
// (q, k) pairs per layer, each two products of 2 D flops (s and p.v): three
// TF32 passes at 495 TFLOP/s dense give 0.052 ms per layer, against 0.130
// ms for the same products once on the f32 CUDA cores, where the CUDA-core
// design stops.  Bytes (q, k, v in, out and lse out: ~100 MB per layer)
// take ~0.03 ms.  The softmax per pair (the scale, the running max, 2^x,
// the row sum, the split of p) is issued by the warps that feed the tensor
// cores, and at D = 16 every wgmma is small (K = 8, N <= 64), so what holds
// the design back is latency.  The design:
//
// - Blocks.  q-major: a block owns 128 queries of one bh (two consumer
//   warpgroups of 64 rows) and walks the keys in tiles of 64.  Every output
//   row is summed by one warpgroup in a fixed order: reruns are bitwise.
//   Causal blocks stop at the tile holding their last query; a warpgroup
//   skips the tiles wholly past its own last row and masks only the tiles
//   the diagonal or the ragged end crosses.  A flat grid of (q-tile, bh),
//   the heaviest causal tiles (the last queries) first.
// - Warp specialisation.  Warpgroup 0 produces: one thread keeps up to 8
//   (k, v) tiles in flight by cp.async.bulk into a ring of raw slots; all
//   128 threads split each landed tile into hi / lo copies, k as it lies
//   (s = q.k^T contracts over D: K-major already) and v transposed (out +=
//   p.v contracts over the keys, and 32-bit wgmma has no transpose bit),
//   into a ring of stages on `full` / `empty` mbarriers.  Warpgroups 1 and
//   2 consume.  setmaxnreg gives the producer 56 registers and the
//   consumers 224.
// - Products.  s = q.k^T is wgmma m64n64k8 .tf32 with q's own rows as A,
//   loaded and split once per block; out += p.v is m64nDk8 with p as A,
//   split in registers straight from the score accumulator in the permuted
//   contraction order of mma_rs, into NA independent accumulators.
// - Pipelining.  Per tile a consumer warpgroup waits for one wgmma group
//   (p.v over the previous tile and s of this one), runs the softmax, and
//   issues p.v over this tile and s of the next as the next group; the
//   other consumer warpgroup's softmax fills the tensor cores meanwhile.
//   (Issuing s of tile i + 1 before the softmax of tile i, into a second
//   score buffer, was slower on the card: see PERF.md.)  Its loop bounds
//   and its barrier arrivals are uniform across the warpgroup (the
//   warpgroup index is broadcast by a shuffle, the waits spin inside the
//   asm, one lane per warp arrives by a predicate, the last step is
//   peeled), so ptxas keeps the wgmmas asynchronous.
//
// The online softmax of a tile (softmax_tile) is flash_wgmma.cuh's, shared
// with the bf16 design (flash_bf16_wgmma.cu).
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_runtime.h>

#include "flash_wgmma.cuh"

namespace {

constexpr int BM = 128;              // queries per block
constexpr int BT = 64;               // keys per streamed tile
constexpr int THREADS = 384;         // producer, 2 consumers
constexpr int MAX_STAGES = 4;
constexpr int MAX_RAW = 8;
constexpr int SMEM_LIMIT = 232448;   // bytes of shared memory a block may use
constexpr int PASSES = 3;            // hi.hi, hi.lo, lo.hi

// bytes of one copy of a streamed tile, of a stage of the ring (k hi / lo,
// v^T hi / lo) and of a raw slot (k, v)
template <int DP> struct Sizes {
  static constexpr int TILE = BT * DP * 4;
  static constexpr int STAGE = 4 * TILE;
  static constexpr int RAW = 2 * TILE;
};

// s = q.k^T over DP, pass by pass: A q's own fragments, B the stage's k tile
// (hi at st, lo after it)
template <int DP>
__device__ __forceinline__ void mma_s(float (&s)[BT / 2], const Own<DP>& aq,
                                      uint64_t st) {
#pragma unroll
  for (int ps = 0; ps < PASSES; ++ps) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const uint64_t b = st + (ps == 1 ? Sizes<DP>::TILE / 16 : 0);
      Rs<BT>::run(s, ps == 2 ? aq.lo[kk] : aq.hi[kk], tile_desc(b, BT, kk),
                  ps + kk > 0);
    }
  }
}

// One block: (query tile, bh) of the flat grid, the last queries of each bh
// first.  NA independent output accumulators.
template <int DP, int NA>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, int Tq, int Tk, int D,
                       float scale, int causal, int n_own, int S, int R) {
  using Z = Sizes<DP>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ __align__(8) uint64_t raw_full[MAX_RAW];

  const long long bh = blockIdx.x / n_own;
  const int q0 = (n_own - 1 - (int)(blockIdx.x % n_own)) * BM;
  // the key tiles this block visits: [0, n)
  const int last = causal ? min(Tk, q0 + BM) : Tk;
  const int n = (last + BT - 1) / BT;

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
    // thread 0 keeps R tiles in flight, R ahead of the splits: each a
    // contiguous run of rows of k and of v (D % 4 == 0: whole 16-byte
    // units) into raw slot i % R, complete on raw_full
    auto issue = [&](int i) {
      const int row0 = i * BT;
      const int bytes = min(BT, Tk - row0) * D * 4;
      const uint32_t bar = smem_u32(&raw_full[i % R]);
      const long long off = (bh * Tk + row0) * D;
      uint8_t* const dst = raws + (i % R) * Z::RAW;
      mbar_expect_tx(bar, 2 * bytes);
      bulk_load(smem_u32(dst), k + off, bytes, bar);
      bulk_load(smem_u32(dst + Z::TILE), v + off, bytes, bar);
    };
    if (tid == 0)
      for (int i = 0; i < min(R, n); ++i) issue(i);
    for (int i = 0; i < n; ++i) {
      const int s = i % S, r = i % R;
      const int valid = min(BT, Tk - i * BT);
      mbar_wait(smem_u32(&raw_full[r]), (i / R) & 1);
      mbar_wait(smem_u32(&empty[s]), ((i / S) & 1) ^ 1);
      const float* rk = reinterpret_cast<const float*>(raws + r * Z::RAW);
      const float* rv = rk + Z::TILE / 4;
      uint8_t* const st = stages + s * Z::STAGE;
      split_rows<DP, BT>(rk, valid, D, st, st + Z::TILE, tid);
      split_cols<DP, BT>(rv, valid, D, st + 2 * Z::TILE, st + 3 * Z::TILE,
                         tid);
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
  // The consumers: warpgroup cw owns queries q0 + 64 cw .. + 63.  The
  // warpgroup index is broadcast from lane 0, so the compiler knows every
  // value derived from it is uniform across the warpgroup.
  const int ct = threadIdx.x - 128;
  const int cw = __shfl_sync(0xffffffffu, ct >> 7, 0);
  const int warp = (ct >> 5) & 3, lane = ct & 31;
  const int r = 16 * warp + (lane >> 2), t = lane & 3;
  const int row_lo = q0 + 64 * cw;   // the warpgroup's first own row
  const uint64_t st_d = sw_desc<64>(smem_u32(stages));
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
    Own<DP> aq;
    load_own<DP>(aq, q + bh * Tq * D, row_lo, Tq, D, r, t);
    // s: the tile's scores, then p in place; ph / pl: p split, the A
    // operand of p.v
    float s[BT / 2];
    uint32_t ph[BT / 2], pl[BT / 2];
#pragma unroll
    for (int e = 0; e < BT / 2; ++e) s[e] = 0.f;
    fence_regs(s);
    wait_phase(smem_u32(&full[0]), 0);
    wgmma_fence();
    mma_s<DP>(s, aq, st_d);
    wgmma_commit();
    // one step per tile: wait for the group of p.v over tile i - 1 and s of
    // tile i, run the softmax, then issue p.v over tile i and s of tile i +
    // 1 as the next group.  The last step (MORE false) issues no next s.
    auto step = [&](int i, auto more) {
      wgmma_wait<0>();
      fence_regs(s);
#pragma unroll
      for (int a = 0; a < NA; ++a) fence_regs(o[a]);
      fence_regs(ph);
      fence_regs(pl);
      if (i > 0) release(i - 1);
      const int c0 = i * BT;
      float corr[2];
      if (c0 + BT > Tk || (causal && c0 + BT - 1 > row_lo))
        softmax_tile<BT, true>(s, m, l, corr, scale, row_lo, r, t, c0,
                               Tk, causal);
      else
        softmax_tile<BT, false>(s, m, l, corr, scale, row_lo, r, t, c0,
                                Tk, causal);
#pragma unroll
      for (int a = 0; a < NA; ++a) {
#pragma unroll
        for (int e = 0; e < DP / 2; ++e) o[a][e] *= corr[(e >> 1) & 1];
      }
#pragma unroll
      for (int e = 0; e < BT / 2; ++e) {
        ph[e] = hi_of(s[e]);
        pl[e] = lo_of(s[e]);
      }
      wgmma_fence();
      const uint64_t st = st_d + (i % S) * Z::STAGE / 16;
      mma_rs<PASSES, DP, BT, NA>(o, ph, pl, st + 2 * Z::TILE / 16,
                                 st + 3 * Z::TILE / 16);
      if (decltype(more)::value) {
        wait_phase(smem_u32(&full[(i + 1) % S]), ((i + 1) / S) & 1);
        mma_s<DP>(s, aq, st_d + ((i + 1) % S) * Z::STAGE / 16);
      }
      wgmma_commit();
    };
    for (int i = 0; i < hi - 1; ++i) step(i, std::true_type());
    step(hi - 1, std::false_type());
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(o[a]);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(s);
    release(hi - 1);
  }
  // tiles this warpgroup skips still pass through its barriers
  for (int i = hi; i < n; ++i) {
    wait_phase(smem_u32(&full[i % S]), (i / S) & 1);
    release(i);
  }

  // out = acc / max(l, 1e-30), lse = m + log(denom), l summed over the
  // quad; rows past Tq and columns past D dropped
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
    float* const orow = out + (bh * Tq + row) * D;
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
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(x.x / denom, x.y / denom);
    }
    if (t == 0) lse[bh * Tq + row] = m[h] + logf(denom);
  }
}

template <int DP, int NA>
int launch(const float* q, const float* k, const float* v, float* out,
           float* lse, int bh, int tq, int tk, int d, float scale, int causal,
           cudaStream_t st) {
  using Z = Sizes<DP>;
  // up to MAX_STAGES stages (at least 2: a consumer holds tile i while it
  // waits for tile i + 1) beside the static barriers, the alignment slack
  // and two raw slots; then as many raw slots as fit, up to MAX_RAW, so the
  // copies run that many tiles ahead of the splits
  const int room = SMEM_LIMIT - 2048;
  int stages = (room - 2 * Z::RAW) / Z::STAGE;
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  int raw = (room - stages * Z::STAGE) / Z::RAW;
  if (raw > MAX_RAW) raw = MAX_RAW;
  const int smem = stages * Z::STAGE + raw * Z::RAW + 1024;
  auto kern = flash_fwd_wgmma_kernel<DP, NA>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_own = (tq + BM - 1) / BM;
  const long long grid = (long long)n_own * bh;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)grid, THREADS, smem, st>>>(q, k, v, out, lse, tq, tk, d,
                                             scale, causal, n_own, stages,
                                             raw);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (bh, tq, d); k, v: (bh, tk, d); lse: (bh, tq); contiguous f32,
// q, k and v 16-byte aligned, d % 4 == 0, d <= 32.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int mxtt_flash_fwd_wgmma(const float* q, const float* k,
                                    const float* v, float* out, float* lse,
                                    int bh, int tq, int tk, int d,
                                    float scale, int causal, void* stream) {
  const void* ptrs[3] = {q, k, v};
  if (!takes(ptrs, 3, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || tq <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d <= 16 ? launch<16, 4>(q, k, v, out, lse, bh, tq, tk, d, scale,
                                 causal, st)
                 : launch<32, 2>(q, k, v, out, lse, bh, tq, tk, d, scale,
                                 causal, st);
}
