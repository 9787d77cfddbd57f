// Implicit-GEMM 3x3 convolution with a fused affine epilogue on Hopper's
// asynchronous tensor-core path: TMA (im2col and tiled), mbarriers, wgmma
// and warp specialisation (sm_90a).
//
// The Hopper design of `_conv3x3_kernel` (mxnet_tpu/ops/pallas_kernels.py:596,
// called by `conv3x3_epilogue` at :732), kernel B9, for its int8 and bf16
// routes; `conv3x3_epilogue.cu` keeps the mma.sync design for the shapes
// this one does not take, and for the float32 route:
//
//   out[p, o] = cast(relu(f32(acc[p, o]) * scale[o] + shift[o]))
//   acc[p, o] = sum_{dy, dx, c} x[n, h + dy - 1, w + dx - 1, c] * wk[o, dy, dx, c]
//
// x is NHWC, wk the HWIO weight repacked by the wrapper to a K-contiguous
// (Cout, 9*Cin) matrix, k = (dy*3 + dx)*Cin + c.  int8 sums exactly in
// int32 (wgmma m64nNk32 s8.s8.s32), bf16 in float32 (m64nNk16 bf16 ->
// f32); the epilogue is the mma.sync design's: __fmul_rn then __fadd_rn
// (no FMA), relu, then rintf (half to even) and a clip to +-127 for an
// int8 output, round to nearest even for bf16, as is for float32.
// Takes: Cin * itemsize % 64 == 0 (a tap's channels are whole 64- or
// 128-byte rows of the swizzle that TMA writes and wgmma reads) and
// 16-byte aligned x and wk.
//
// What bounds it on this card.  A ResNet-50 bottleneck 3x3 at batch 256
// does 59.2 G multiply-adds: 0.060 ms at 989 bf16 TFLOP/s (0.030 ms at
// 1,979 int8 TOP/s) against 0.015-0.031 ms for its 51-103 MB of input and
// output at 3.35 TB/s: operations.  Only wgmma reaches that rate, and only
// if the tiles reach shared memory as fast as it consumes them: a 128-row
// tile rereads each row of x once per tap and the weight once per tile,
// 24-32 KB per K step.  The design:
//
// - Tiles.  128 output positions x BN channels (BN = 128 where Cout > 64,
//   else 64).  A persistent grid walks them in order, the Cout tiles of
//   one position tile next to each other, so x's tap reuse and its reuse
//   across Cout tiles stay in L2, and a grid of the SM count has no tail
//   wave.
// - K walk.  Steps of BKB bytes (128 where Cin * itemsize is a multiple
//   of 128, else 64): a BKB-byte slice of one tap's channels, taps
//   fastest, so neighbouring steps reread the same rows of x shifted by a
//   pixel or a row.
// - Loads: one producer thread, all by TMA, completing on the stage's
//   `full` mbarrier.  The patch tile A comes by TMA in im2col mode: the
//   tensor map reads x as (channel bytes, W, H, N) with the bounding box
//   [-1, W - 2] x [-1, H - 2] of a same-padded 3x3 window, so a box of BM
//   consecutive output positions starts at the base pixel (w - 1, h - 1,
//   n) of the first and shifts every pixel by the tap (dx, dy); taps
//   outside the image and rows past M read zero, and nothing is padded or
//   im2col'd in memory.  The weight tile B is a plain 2-D box of the
//   (Cout, 9*Cin) byte matrix (rows past Cout read zero).  Both land in
//   the BKB-byte swizzle that wgmma reads.  (Gathered instead by
//   cp.async 16-byte copies from 128 producer threads, A's loads held
//   the kernel back far more: PERF.md, section 6.)
// - The ring.  As many stages as fit beside the staged output tile (4 to
//   8), released on an `empty` mbarrier, so loads run up to S - 2 steps
//   ahead of the math, across tile boundaries too.  With a single Cout
//   tile (Cout <= BN) every tile needs the same weight boxes: if a ring
//   of 4 still fits, the block loads its weight slice once and keeps it
//   (the int8 56^2 x 64 stage: 36 KB), and the ring carries A alone.
// - Warpgroups 1 and 2, the consumers, each own 64 rows of the tile and
//   issue BKB / 32 wgmma per step straight from shared memory (32 bytes
//   of K each, both operands K-major, which int8 wgmma requires), keeping
//   one wgmma group in flight; the accumulators never leave registers
//   until the epilogue, which applies the two roundings to them and
//   stages the output tile in shared memory.
// - Warpgroup 3, the storer, writes each staged tile to the NHWC output
//   with coalesced 16-byte stores (byte stores only at a ragged Cout edge)
//   while the consumers go on with the next tile, and loads each tile's
//   scale and shift ahead of them.
// - At BN = 64 two blocks share an SM, so one block's tile change
//   overlaps the other's multiplies; at BN = 128 one block.  No split-K
//   and no atomics: a rerun is bitwise.
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int BM = 128;              // output positions per block

enum { IN_INT8 = 0, IN_BF16 = 1 };
enum { OUT_INT8 = 0, OUT_BF16 = 1, OUT_F32 = 2 };

// TMA in im2col mode: pixelsPerColumn consecutive pixels of the bounding
// box from base pixel (w, h, n), each shifted by (dx, dy), channel bytes
// [c, c + channelsPerPixel); pixels outside the image read zero
__device__ __forceinline__ void tma_load_im2col(uint32_t dst,
                                                const CUtensorMap* map,
                                                uint32_t bar, int c, int w,
                                                int h, int n, int dx,
                                                int dy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w),
      "r"(h), "r"(n), "h"((unsigned short)dx), "h"((unsigned short)dy)
      : "memory");
}

template <bool INT8, int BN> struct Mma;
template <> struct Mma<false, 64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    wgmma_bf16_n64(d, a, b);
  }
};
template <> struct Mma<false, 128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    wgmma_bf16_n128(d, a, b);
  }
};
template <> struct Mma<true, 64> {
  static __device__ __forceinline__ void run(int (&d)[32], uint64_t a,
                                             uint64_t b) {
    wgmma_s8_n64(d, a, b);
  }
};
template <> struct Mma<true, 128> {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t a,
                                             uint64_t b) {
    wgmma_s8_n128(d, a, b);
  }
};

// warpgroup 0 (one thread of it) loads, 1 and 2 multiply, 3 stores
constexpr int THREADS = 512;
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;   // bytes of shared memory a block may use

// bytes of one row of the staged output tile: 16 bytes of padding spread
// the rows over the shared-memory banks
__host__ __device__ constexpr int out_pitch(int bn, int oes) {
  return bn * oes + 16;
}

// shared memory beside the ring: the staged output tile, then scale and
// shift of two tiles
__host__ __device__ constexpr int side_bytes(int bn, int oes) {
  return BM * out_pitch(bn, oes) + 4 * bn * 4;
}

// blocks resident on one SM: two at BN = 64, whose tiles are short (9
// steps at Cin = 64), so that one block's epilogue and tile changes
// overlap the other's multiplies
__host__ __device__ constexpr int ctas_per_sm(int bn) {
  return bn == 64 ? 2 : 1;
}

template <bool INT8, int BN, int BKB>
__global__ void __launch_bounds__(THREADS, ctas_per_sm(BN))
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, void* __restrict__ out,
                     int H, int W, int M, int Cin, int Cout, int n_tiles,
                     int tiles, int S, int resident, int out_type,
                     int relu) {
  using Acc = typename std::conditional<INT8, int, float>::type;
  constexpr int ES = INT8 ? 1 : 2;
  constexpr int A_BYTES = BM * BKB;
  constexpr int B_BYTES = BN * BKB;
  constexpr int NACC = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ __align__(8) uint64_t out_full, out_empty, w_full;

  // K is walked in BKB-byte slices of one tap's channels, taps fastest, so
  // neighbouring steps reread the same rows of x shifted by a pixel or a
  // row: step = slice * 9 + tap
  const int kpt = Cin * ES;
  const int nk = 9 * (kpt / BKB);
  // a stage holds the patch tile and, unless the block's whole weight
  // slice is resident (one Cout tile: loaded once, after the ring), the
  // weight tile
  const int stage = resident ? A_BYTES : A_BYTES + B_BYTES;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t wres = base + S * stage;
  const int oes = out_type == OUT_F32 ? 4 : (out_type == OUT_BF16 ? 2 : 1);
  const int pitch = out_pitch(BN, oes);
  uint8_t* const staged = smem_raw + (base - raw) + S * stage +
                          (resident ? nk * B_BYTES : 0);
  // vec[b] holds scale, then shift, of the tiles of parity b
  float* const vec = reinterpret_cast<float*>(staged + BM * pitch);
  const long long row_bytes = (long long)Cout * oes;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // full: the producer's expect_tx of the stage; empty: one arrival per
      // consumer warp
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 8);
    }
    // out_full: every consumer thread; out_empty: every storer thread
    mbar_init(smem_u32(&out_full), 256);
    mbar_init(smem_u32(&out_empty), 128);
    mbar_init(smem_u32(&w_full), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // The producer, one thread: per step the patch tile A by TMA in im2col
    // mode (128 consecutive output positions from the base pixel (w - 1,
    // h - 1, n) of the tile's first, shifted by the tap (dx, dy); taps
    // outside the image and rows past M read zero, so nothing is padded
    // or im2col'd in memory) and the weight tile B by tiled TMA (rows past
    // Cout read zero), both completing on the stage's full barrier.
    if (threadIdx.x != 0) return;
    if (resident) {
      const uint32_t bar = smem_u32(&w_full);
      mbar_expect_tx(bar, nk * B_BYTES);
      for (int step = 0; step < nk; ++step)
        tma_load_2d(wres + step * B_BYTES, &wmap, bar,
                    (step % 9) * kpt + (step / 9) * BKB, 0);
    }
    int s = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
      const int n = m0 / (H * W), hw = m0 - n * (H * W);
      const int h = hw / W, w = hw - h * W;
      for (int step = 0; step < nk; ++step) {
        mbar_wait(smem_u32(&empty[s]), phase ^ 1);
        const uint32_t a = base + s * stage, bar = smem_u32(&full[s]);
        const int tap = step % 9, c = (step / 9) * BKB;
        mbar_expect_tx(bar, stage);
        tma_load_im2col(a, &xmap, bar, c, w - 1, h - 1, n, tap % 3, tap / 3);
        if (!resident)
          tma_load_2d(a + A_BYTES, &wmap, bar, tap * kpt + c, n0);
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  if (wg == 3) {
    // The storer: scale and shift of each tile ahead of the consumers, and
    // each staged output tile out in 16-byte chunks of its rows (byte
    // stores only where a chunk crosses Cout or the rows are not 16-byte
    // aligned).  Its arrival on out_empty for tile i says: tile i - 1 is
    // out, and the vectors of tile i are in vec[i & 1].
    const int t = threadIdx.x - 384;
    const int chunks = BN * oes / 16;
    const bool whole_rows = row_bytes % 16 == 0;
    auto load_vec = [&](int tile, int b) {
      const int n0 = (tile % n_tiles) * BN;
      if (t < BN) {
        const bool in = tile < tiles && n0 + t < Cout;
        vec[b * 2 * BN + t] = in ? scale[n0 + t] : 0.0f;
        vec[b * 2 * BN + BN + t] = in ? shift[n0 + t] : 0.0f;
      }
    };
    load_vec(blockIdx.x, 0);
    warpgroup_sync(3);
    mbar_arrive(smem_u32(&out_empty));
    int i = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
      const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
      const int valid = (Cout - n0 < BN ? Cout - n0 : BN) * oes;
      mbar_wait(smem_u32(&out_full), i & 1);
      uint8_t* const o = static_cast<uint8_t*>(out) + (long long)n0 * oes;
      for (int q = t; q < BM * chunks; q += 128) {
        const int r = q / chunks, b0 = (q - r * chunks) * 16;
        if (m0 + r >= M || b0 >= valid) continue;
        uint8_t* g = o + (long long)(m0 + r) * row_bytes + b0;
        const uint8_t* sp = staged + r * pitch + b0;
        if (whole_rows && b0 + 16 <= valid) {
          *reinterpret_cast<int4*>(g) = *reinterpret_cast<const int4*>(sp);
        } else {
          for (int b = 0; b < 16 && b0 + b < valid; ++b) g[b] = sp[b];
        }
      }
      load_vec(tile + gridDim.x, (i + 1) & 1);
      warpgroup_sync(3);   // the staged tile is read, the vectors written
      mbar_arrive(smem_u32(&out_empty));
    }
    return;
  }

  // The consumers: warpgroup cw (0 or 1) multiplies rows 64 cw .. 64 cw +
  // 63 of the tile, applies the epilogue to its accumulators with the two
  // roundings, stages the result for the storer and goes on.
  const int ct = threadIdx.x - 128, cw = ct >> 7;
  const int warp = (ct >> 5) & 3, lane = ct & 31;
  int s = 0, phase = 0, i = 0;
  if (resident) mbar_wait(smem_u32(&w_full), 0);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
    Acc acc[NACC];
#pragma unroll
    for (int e = 0; e < NACC; ++e) acc[e] = Acc(0);
    int prev = -1;
    for (int step = 0; step < nk; ++step) {
      mbar_wait(smem_u32(&full[s]), phase);
      const uint32_t a = base + s * stage;
      const uint32_t b = resident ? wres + step * B_BYTES : a + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKB / 32; ++kk)
        Mma<INT8, BN>::run(acc, sw_desc<BKB>(a + cw * 64 * BKB + kk * 32),
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
    mbar_wait(smem_u32(&out_empty), i & 1);
    const float* const sc = vec + (i & 1) * 2 * BN;
    const int rw = cw * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const int col = jn * 8 + (lane & 3) * 2;
      const float2 k = *reinterpret_cast<const float2*>(sc + col);
      const float2 b = *reinterpret_cast<const float2*>(sc + BN + col);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (INT8)
            v[e] = __int2float_rn(acc[jn * 4 + hh * 2 + e]);
          else
            v[e] = acc[jn * 4 + hh * 2 + e];
          v[e] = __fadd_rn(__fmul_rn(v[e], e ? k.y : k.x), e ? b.y : b.x);
          if (relu) v[e] = fmaxf(v[e], 0.0f);
        }
        uint8_t* dst = staged + (rw + hh * 8) * pitch + col * oes;
        if (out_type == OUT_INT8) {
          char2 q;
          q.x = static_cast<signed char>(
              __float2int_rn(fminf(fmaxf(rintf(v[0]), -127.0f), 127.0f)));
          q.y = static_cast<signed char>(
              __float2int_rn(fminf(fmaxf(rintf(v[1]), -127.0f), 127.0f)));
          *reinterpret_cast<char2*>(dst) = q;
        } else if (out_type == OUT_BF16) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __halves2bfloat162(__float2bfloat16_rn(v[0]),
                                 __float2bfloat16_rn(v[1]));
        } else {
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
        }
      }
    }
    mbar_arrive(smem_u32(&out_full));
  }
}

typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);


template <bool INT8, int BN, int BKB>
int launch(const void* x, const void* wk, const float* scale,
           const float* shift, void* out, int N, int H, int W, int Cin,
           int Cout, int out_type, int relu, cudaStream_t s) {
  constexpr int ES = INT8 ? 1 : 2;
  constexpr int A_BYTES = BM * BKB, B_BYTES = BN * BKB;
  static const EncodeTiled tiled =
      reinterpret_cast<EncodeTiled>(entry_point("cuTensorMapEncodeTiled"));
  static const EncodeIm2col im2col =
      reinterpret_cast<EncodeIm2col>(entry_point("cuTensorMapEncodeIm2col"));
  const int sms = sm_count();
  if (tiled == nullptr || im2col == nullptr || sms == 0)
    return (int)cudaErrorNotSupported;
  const CUtensorMapSwizzle swz =
      BKB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  // x as bytes (Cin * itemsize, W, H, N), read as the im2col boxes of a
  // 3x3 same-padded convolution: base pixels (w - 1, h - 1) over the
  // bounding box [-1, W - 2] x [-1, H - 2], BKB channel bytes of BM
  // pixels per box
  CUtensorMap xmap;
  const cuuint64_t kpt = (cuuint64_t)Cin * ES;
  const cuuint64_t xdims[4] = {kpt, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)N};
  const cuuint64_t xstrides[3] = {kpt, kpt * W, kpt * W * H};
  const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
  if (im2col(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x),
             xdims, xstrides, lower, upper, BKB, BM, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  // the weight as a (Cout, 9*Cin*itemsize) byte matrix, boxes of BKB bytes
  // of K by BN rows, zero outside
  CUtensorMap wmap;
  const cuuint64_t wdims[2] = {9 * kpt, (cuuint64_t)Cout};
  const cuuint64_t wstrides[1] = {9 * kpt};
  const cuuint32_t wbox[2] = {BKB, BN};
  if (tiled(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wk),
            wdims, wstrides, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  // the deepest ring that fits beside the staged tile, the vectors, the
  // static barriers and the alignment slack.  With one Cout tile the
  // weight slice stays resident if that leaves a ring of 4 or more: every
  // tile would reread the same boxes.
  const int oes = out_type == OUT_F32 ? 4 : (out_type == OUT_BF16 ? 2 : 1);
  const int n_tiles = (Cout + BN - 1) / BN;
  const int nk = 9 * (int)(kpt / BKB);
  const int room = SMEM_LIMIT / ctas_per_sm(BN) - 2048 - side_bytes(BN, oes);
  const int resident =
      n_tiles == 1 && (room - nk * B_BYTES) / A_BYTES >= 4;
  int stages = resident ? (room - nk * B_BYTES) / A_BYTES
                        : room / (A_BYTES + B_BYTES);
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = stages * (resident ? A_BYTES : A_BYTES + B_BYTES) +
                   (resident ? nk * B_BYTES : 0) + side_bytes(BN, oes) +
                   1024;
  auto kern = conv3x3_wgmma_kernel<INT8, BN, BKB>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int M = N * H * W;
  const long long tiles = (long long)((M + BM - 1) / BM) * n_tiles;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long slots = (long long)sms * ctas_per_sm(BN);
  const int grid = (int)(tiles < slots ? tiles : slots);
  kern<<<grid, THREADS, smem, s>>>(xmap, wmap, scale, shift, out, H, W, M,
                                   Cin, Cout, n_tiles, (int)tiles, stages,
                                   resident, out_type, relu);
  return (int)cudaGetLastError();
}

template <bool INT8, int BN>
int launch_k(const void* x, const void* wk, const float* scale,
             const float* shift, void* out, int N, int H, int W, int Cin,
             int Cout, int out_type, int relu, cudaStream_t s) {
  // 128-byte K steps where the channel bytes of a tap allow, else 64
  return Cin * (INT8 ? 1 : 2) % 128 == 0
             ? launch<INT8, BN, 128>(x, wk, scale, shift, out, N, H, W, Cin,
                                     Cout, out_type, relu, s)
             : launch<INT8, BN, 64>(x, wk, scale, shift, out, N, H, W, Cin,
                                    Cout, out_type, relu, s);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  in_type: 0 int8, 1
// bf16 (x and wk alike); out_type: 0 int8, 1 bf16, 2 f32.  x is
// (N, H, W, Cin) and wk (Cout, 9 * Cin), both contiguous; the caller
// promises Cin * itemsize % 64 == 0, 16-byte aligned x and wk, and
// N * H * W < 2^31.
extern "C" int mxtt_conv3x3_wgmma(const void* x, const void* wk,
                                  const void* scale, const void* shift,
                                  void* out, int N, int H, int W, int Cin,
                                  int Cout, int in_type, int out_type,
                                  int relu, void* stream) {
  const long long M = (long long)N * H * W;
  if (M <= 0 || Cout <= 0) return 0;
  const int es = in_type == IN_INT8 ? 1 : 2;
  if ((in_type != IN_INT8 && in_type != IN_BF16) || out_type < OUT_INT8 ||
      out_type > OUT_F32 || Cin <= 0 || Cin * es % 64 != 0 ||
      M > INT_MAX - BM || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wk) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scale);
  const float* hp = static_cast<const float*>(shift);
  const bool wide = Cout > 64;
  if (in_type == IN_INT8)
    return wide ? launch_k<true, 128>(x, wk, sp, hp, out, N, H, W, Cin,
                                      Cout, out_type, relu, s)
                : launch_k<true, 64>(x, wk, sp, hp, out, N, H, W, Cin,
                                     Cout, out_type, relu, s);
  return wide ? launch_k<false, 128>(x, wk, sp, hp, out, N, H, W, Cin, Cout,
                                     out_type, relu, s)
              : launch_k<false, 64>(x, wk, sp, hp, out, N, H, W, Cin, Cout,
                                    out_type, relu, s);
}
