// int8 matmul with the requantize epilogue fused, on Hopper's asynchronous
// tensor-core path: TMA, mbarriers, wgmma and warp specialisation (sm_90a).
//
// The Hopper design of `_qmm_requant_kernel` (mxnet_tpu/ops/pallas_kernels.py:436,
// called by `qmm_requant` at :488), kernel B8; `qmm_requant.cu` keeps the
// mma.sync design for the shapes this one does not take:
//
//   out[m, n] = clip(rint(relu(f32(acc[m, n]) * scale + bias[n])), -127, 127)
//   acc[m, n] = sum_k x[m, k] * w[n, k]          (exact int32)
//
// x is int8 (M, K) with row stride ldx, w int8 (N, K) (the port's OHWI 1x1
// weight, reshaped), bias float32 (N,), out int8 (M, N).  Both operands are
// K-major in memory, as int8 wgmma needs them: nothing is repacked.  The
// epilogue is the mma.sync design's: __fmul_rn then __fadd_rn (no FMA),
// relu, rintf (half to even), the clip.  Takes what a TMA tensor map can
// describe: K % 16 == 0, ldx % 16 == 0, 16-byte aligned x and w.
//
// What bounds it on this card: bytes.  ResNet-50's 1x1 convolutions `a`
// at batch 256 move ~1.53 GB per forward (x read once, the int8 output
// written once) against ~0.36 T int8 operations: 0.456 ms at 3.35 TB/s
// against 0.18 ms at 1,979 TOP/s.  The 56^2 and 28^2 stages (M = 802,816
// and 200,704, N = 64 and 128) are pure streaming; at 14^2 (K = 1024,
// N = 256) the intensity, 2N = 512 operations a byte, nears the card's
// ridge (~590), so the issue of wgmma starts to matter there.  The design:
//
// - Tiles.  128 rows x BN columns (BN = 64 where N <= 64, else 128), two
//   consumer warpgroups of 64 rows each, wgmma m64nBNk32 s8.s8.s32 straight
//   from shared memory.  K is walked in BKB-byte steps (128 where K > 64,
//   with the 128-byte swizzle; else 64 with the 64-byte one).  BN = 256
//   would hold 128 accumulators a thread, all the registers a thread of a
//   512-thread block has: ptxas refuses it.
// - Loads: one producer thread, all by TMA, completing on the stage's
//   `full` mbarrier.  The x tile is a 2-D box of the (M, K) byte matrix
//   with row stride ldx, the w tile a box of (N, K); rows past M and N and
//   columns past K read zero, so nothing is padded in memory.
// - The weight stays resident where it fits: if the block's slice (BN rows
//   x K) leaves room for a ring of 4, the block loads it once (16 KB at
//   56^2, 64 KB at 28^2, 128 KB at 14^2) and the ring carries x alone; the
//   grid is then a multiple of the N tiles, so each block keeps one N tile.
//   At K = 2048 (7^2) w streams through the ring with x.
// - The ring.  As many stages as fit (4 to 8), released on an `empty`
//   mbarrier, so the loads run ahead of the math across tile boundaries:
//   at 56^2 and 28^2 the ring is what keeps enough bytes in flight to
//   reach HBM's rate.
// - The persistent grid walks the tiles with N fastest, so the N tiles of
//   one row tile run on neighbouring blocks at the same time and the
//   second read of an x tile comes from L2.
// - The consumers apply the epilogue to their accumulators and stage the
//   int8 tile in one of two output buffers in shared memory (one where
//   two would cost the resident weight); warpgroup 3, the storer, writes
//   it with coalesced 16-byte stores (byte stores only at a ragged N edge)
//   while the consumers go on with the next tile into the other buffer,
//   and loads each tile's bias ahead of them.
// - At BN = 64 two blocks share an SM, so one block's epilogue overlaps
//   the other's loads.  No split-K and no atomics: a rerun is bitwise.
#include <climits>
#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int BM = 128;              // rows per tile
constexpr int THREADS = 512;         // producer, 2 consumers, storer
constexpr int MAX_STAGES = 8;
constexpr int MIN_STAGES = 4;        // the least ring a resident weight keeps
constexpr int SMEM_LIMIT = 232448;   // bytes of shared memory a block may use

template <int BN> struct Mma;
template <> struct Mma<64> {
  static __device__ __forceinline__ void run(int (&d)[32], uint64_t a,
                                             uint64_t b) {
    wgmma_s8_n64(d, a, b);
  }
};
template <> struct Mma<128> {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t a,
                                             uint64_t b) {
    wgmma_s8_n128(d, a, b);
  }
};

// bytes of one row of the staged output tile: 16 bytes of padding spread
// the rows over the shared-memory banks
__host__ __device__ constexpr int out_pitch(int bn) { return bn + 16; }

// one output buffer beside the ring: a staged output tile and its bias
__host__ __device__ constexpr int out_bytes(int bn) {
  return BM * out_pitch(bn) + bn * 4;
}

__host__ __device__ constexpr int ctas_per_sm(int bn) {
  return bn == 64 ? 2 : 1;
}

// The epilogue of one accumulator, its int8 code in the low byte of the
// result: v = f32(acc) * scale + bias rounded twice, relu, then the clip
// to +-127 and the rounding half to even.  The bounds are integers, so
// clipping first is the same as clipping the rounded value; adding
// 1.5 * 2^23, where a float's ulp is 1, rounds half to even as rintf does
// and leaves the integer in the low bits of the sum's encoding.  One FADD
// takes the place of rintf and a float-to-int conversion.
__device__ __forceinline__ int requant(int acc, float scale, float bias,
                                       int relu) {
  float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  if (relu) v = fmaxf(v, 0.0f);
  v = fminf(fmaxf(v, -127.0f), 127.0f);
  return __float_as_int(__fadd_rn(v, 12582912.0f));
}

template <int BN, int BKB>
__global__ void __launch_bounds__(THREADS, ctas_per_sm(BN))
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ bias, int8_t* __restrict__ out,
                 int M, int N, int K, int n_tiles, int tiles, int S,
                 int resident, int nbuf, float scale, int relu) {
  constexpr int A_BYTES = BM * BKB;
  constexpr int B_BYTES = BN * BKB;
  constexpr int NACC = BN / 2;
  constexpr int PITCH = out_pitch(BN);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ __align__(8) uint64_t out_full[2], out_empty[2], w_full;

  const int nk = (K + BKB - 1) / BKB;
  // a stage holds the x tile and, unless the block's weight slice is
  // resident (loaded once, after the ring), the w tile
  const int stage = resident ? A_BYTES : A_BYTES + B_BYTES;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t wres = base + S * stage;
  // nbuf output buffers (1 or 2), each a staged tile and its bias: tile
  // i of the block goes through buffer i % nbuf
  uint8_t* const outs = smem_raw + (base - raw) + S * stage +
                        (resident ? nk * B_BYTES : 0);
  auto staged = [&](int b) { return outs + b * out_bytes(BN); };
  auto vec = [&](int b) {
    return reinterpret_cast<float*>(staged(b) + BM * PITCH);
  };
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // full: the producer's expect_tx of the stage; empty: one arrival per
      // consumer warp
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 8);
    }
    // out_full: every consumer thread; out_empty: every storer thread
    for (int b = 0; b < 2; ++b) {
      mbar_init(smem_u32(&out_full[b]), 256);
      mbar_init(smem_u32(&out_empty[b]), 128);
    }
    mbar_init(smem_u32(&w_full), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // The producer, one thread: per step the x tile and, unless resident,
    // the w tile, both by TMA, both completing on the stage's full barrier.
    if (threadIdx.x != 0) return;
    if (resident) {
      // the grid is a multiple of n_tiles: every tile of this block has
      // the same N tile
      const uint32_t bar = smem_u32(&w_full);
      mbar_expect_tx(bar, nk * B_BYTES);
      for (int step = 0; step < nk; ++step)
        tma_load_2d(wres + step * B_BYTES, &wmap, bar, step * BKB,
                    (blockIdx.x % n_tiles) * BN);
    }
    int s = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
      for (int step = 0; step < nk; ++step) {
        mbar_wait(smem_u32(&empty[s]), phase ^ 1);
        const uint32_t a = base + s * stage, bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, stage);
        tma_load_2d(a, &xmap, bar, step * BKB, m0);
        if (!resident)
          tma_load_2d(a + A_BYTES, &wmap, bar, step * BKB, n0);
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  if (wg == 3) {
    // The storer: the bias of each tile ahead of the consumers, and each
    // staged output tile out in 16-byte chunks of its rows (byte stores
    // only where a chunk crosses N or the rows are not 16-byte aligned).
    // Its arrival on out_empty[b] says: the tile buffer b held is out, and
    // the bias of the next tile it takes is in vec(b).
    const int t = threadIdx.x - 384;
    constexpr int CHUNKS = BN / 16;
    const bool whole_rows = N % 16 == 0;
    auto load_vec = [&](int tile, int b) {
      const int n0 = (tile % n_tiles) * BN;
      if (t < BN)
        vec(b)[t] = tile < tiles && n0 + t < N ? bias[n0 + t] : 0.0f;
    };
    for (int b = 0; b < nbuf; ++b) load_vec(blockIdx.x + b * gridDim.x, b);
    warpgroup_sync(3);
    for (int b = 0; b < nbuf; ++b) mbar_arrive(smem_u32(&out_empty[b]));
    int i = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
      const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
      const int valid = N - n0 < BN ? N - n0 : BN;
      const int b = i % nbuf;
      mbar_wait(smem_u32(&out_full[b]), (i / nbuf) & 1);
      int8_t* const o = out + n0;
      for (int q = t; q < BM * CHUNKS; q += 128) {
        const int r = q / CHUNKS, b0 = (q - r * CHUNKS) * 16;
        if (m0 + r >= M || b0 >= valid) continue;
        int8_t* g = o + (long long)(m0 + r) * N + b0;
        const uint8_t* sp = staged(b) + r * PITCH + b0;
        if (whole_rows && b0 + 16 <= valid) {
          *reinterpret_cast<int4*>(g) = *reinterpret_cast<const int4*>(sp);
        } else {
          for (int b = 0; b < 16 && b0 + b < valid; ++b)
            g[b] = static_cast<int8_t>(sp[b]);
        }
      }
      load_vec(tile + nbuf * gridDim.x, b);
      warpgroup_sync(3);   // the staged tile is read, the bias written
      mbar_arrive(smem_u32(&out_empty[b]));
    }
    return;
  }

  // The consumers: warpgroup cw (0 or 1) multiplies rows 64 cw .. 64 cw + 63
  // of the tile, applies the epilogue to its accumulators with the two
  // roundings, stages the int8 result for the storer and goes on.
  const int ct = threadIdx.x - 128, cw = ct >> 7;
  const int warp = (ct >> 5) & 3, lane = ct & 31;
  int s = 0, phase = 0, i = 0;
  if (resident) mbar_wait(smem_u32(&w_full), 0);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
    int acc[NACC];
#pragma unroll
    for (int e = 0; e < NACC; ++e) acc[e] = 0;
    int prev = -1;
    for (int step = 0; step < nk; ++step) {
      mbar_wait(smem_u32(&full[s]), phase);
      const uint32_t a = base + s * stage;
      const uint32_t b = resident ? wres + step * B_BYTES : a + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKB / 32; ++kk)
        Mma<BN>::run(acc, sw_desc<BKB>(a + cw * 64 * BKB + kk * 32),
                     sw_desc<BKB>(b + kk * 32));
      wgmma_commit();
      // one group stays in flight: the previous step's is done, so its
      // stage goes back to the producer
      wgmma_wait<1>();
      if (prev >= 0 && lane == 0) mbar_arrive(smem_u32(&empty[prev]));
      prev = s;
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(smem_u32(&empty[prev]));

    // accumulator e: row rw (+8 for e % 4 >= 2), column (e / 4) * 8 +
    // (lane % 4) * 2 + e % 2
    const int ob = i % nbuf;
    mbar_wait(smem_u32(&out_empty[ob]), (i / nbuf) & 1);
    const float* const bv = vec(ob);
    const int rw = cw * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const int col = jn * 8 + (lane & 3) * 2;
      const float2 b = *reinterpret_cast<const float2*>(bv + col);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q0 = requant(acc[jn * 4 + hh * 2], scale, b.x, relu);
        const int q1 = requant(acc[jn * 4 + hh * 2 + 1], scale, b.y, relu);
        // the two codes' low bytes, side by side
        *reinterpret_cast<unsigned short*>(staged(ob) +
                                           (rw + hh * 8) * PITCH + col) =
            static_cast<unsigned short>(__byte_perm(q0, q1, 0x0040));
      }
    }
    mbar_arrive(smem_u32(&out_full[ob]));
  }
}

template <int BN, int BKB>
int launch(const void* x, long long ldx, const void* w, const float* bias,
           int8_t* out, int M, int N, int K, float scale, int relu,
           cudaStream_t s) {
  constexpr int A_BYTES = BM * BKB, B_BYTES = BN * BKB;
  static const EncodeTiled tiled =
      reinterpret_cast<EncodeTiled>(entry_point("cuTensorMapEncodeTiled"));
  const int sms = sm_count();
  if (tiled == nullptr || sms == 0) return (int)cudaErrorNotSupported;
  const CUtensorMapSwizzle swz =
      BKB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint32_t ones[2] = {1, 1};
  // x as a (M, K) byte matrix with row stride ldx, boxes of BKB bytes of K
  // by BM rows; w as (N, K), boxes of BKB by BN; zero outside
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t xstrides[1] = {(cuuint64_t)ldx};
  const cuuint32_t xbox[2] = {BKB, BM};
  if (tiled(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(x),
            xdims, xstrides, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t wdims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t wstrides[1] = {(cuuint64_t)K};
  const cuuint32_t wbox[2] = {BKB, BN};
  if (tiled(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w),
            wdims, wstrides, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  // The deepest ring that fits beside the output buffers, the static
  // barriers and the alignment slack.  Two output buffers, so that the
  // storer drains one while the consumers fill the other, and the weight
  // slice resident, if that leaves a ring of MIN_STAGES and every block
  // can keep one N tile; else the resident slice with one buffer; else two
  // buffers and w streamed through the ring.
  const int n_tiles = (N + BN - 1) / BN;
  const int nk = (K + BKB - 1) / BKB;
  const long long slots = (long long)sms * ctas_per_sm(BN);
  auto room = [&](int nbuf) {
    return SMEM_LIMIT / ctas_per_sm(BN) - 2048 - nbuf * out_bytes(BN);
  };
  auto keeps_w = [&](int nbuf) {
    return n_tiles <= slots && (room(nbuf) - nk * B_BYTES) / A_BYTES >=
                                   MIN_STAGES;
  };
  const int nbuf = keeps_w(2) || !keeps_w(1) ? 2 : 1;
  const int resident = keeps_w(nbuf);
  int stages = resident ? (room(nbuf) - nk * B_BYTES) / A_BYTES
                        : room(nbuf) / (A_BYTES + B_BYTES);
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = stages * (resident ? A_BYTES : A_BYTES + B_BYTES) +
                   (resident ? nk * B_BYTES : 0) + nbuf * out_bytes(BN) +
                   1024;
  auto kern = qmm_wgmma_kernel<BN, BKB>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)((M + BM - 1) / BM) * n_tiles;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  long long grid = tiles < slots ? tiles : slots;
  if (resident) grid -= grid % n_tiles;   // each block keeps one N tile
  kern<<<(unsigned)grid, THREADS, smem, s>>>(xmap, wmap, bias, out, M, N, K,
                                             n_tiles, (int)tiles, stages,
                                             resident, nbuf, scale, relu);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_k(const void* x, long long ldx, const void* w, const float* bias,
             int8_t* out, int M, int N, int K, float scale, int relu,
             cudaStream_t s) {
  // 128-byte K steps where K is longer than 64, else 64
  return K > 64 ? launch<BN, 128>(x, ldx, w, bias, out, M, N, K, scale, relu,
                                  s)
                : launch<BN, 64>(x, ldx, w, bias, out, M, N, K, scale, relu,
                                 s);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  x is (M, K) with row
// stride ldx, w (N, K) contiguous, bias (N,), out (M, N) contiguous; the
// caller promises K % 16 == 0, ldx % 16 == 0 and 16-byte aligned x and w.
extern "C" int mxtt_qmm_wgmma(const void* x, long long ldx, const void* w,
                              const void* bias, void* out, int M, int N,
                              int K, float scale, int relu, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 16 != 0 || ldx % 16 != 0 || ldx < K ||
      M > INT_MAX - BM || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  int8_t* op = static_cast<int8_t*>(out);
  return N > 64 ? launch_k<128>(x, ldx, w, bp, op, M, N, K, scale, relu, s)
                : launch_k<64>(x, ldx, w, bp, op, M, N, K, scale, relu, s);
}
