// Implicit-GEMM 3x3 convolution with a fused affine epilogue, for Hopper
// (sm_90a).
//
// The port of `_conv3x3_kernel` (mxnet_tpu/ops/pallas_kernels.py:596,
// called by `conv3x3_epilogue` at :732), kernel B9, in its mma.sync
// design.  The wrapper routes int8 and bf16 calls with Cin * itemsize %
// 64 == 0 (every ResNet-50 3x3 among them) to the wgmma design of
// `conv3x3_wgmma.cu`; this one takes the rest (Cin 3, int8 Cin 8-48,
// bf16 Cin 8-24, unaligned x) and the float32 route:
//
//   out[p, o] = cast(relu(f32(acc[p, o]) * scale[o] + shift[o]))
//   acc[p, o] = sum_{dy, dx, c} x[n, h + dy - 1, w + dx - 1, c] * wk[o, dy, dx, c]
//
// p = (n, h, w) runs over the N*H*W output positions of the NHWC input x
// (stride 1, same padding: taps outside the image read zero); wk is the
// HWIO weight repacked by the wrapper to (Cout, 3, 3, Cin), i.e. a
// K-contiguous (Cout, 9*Cin) matrix with k = (dy*3 + dx)*Cin + c, the
// reference's im2col order.  Routes, by the type of x and w:
//   int8  exact int32 sums, mma.sync m16n8k32 s8.s8.s32;
//   bf16  float32 sums, mma.sync m16n8k16 bf16.bf16.f32;
//   f32   float32 sums by FFMA on the CUDA cores (never TF32: the
//         reference's f32 route is a float32 dot).
// The epilogue rounds twice (__fmul_rn then __fadd_rn, so no FMA is
// contracted, as the reference's graph spells it), applies relu, and
// writes int8 (rintf, half to even, then clip to +-127: only there),
// bf16 (round to nearest even) or f32.
//
// What bounds it: operations, but for the first ResNet-50 stage.  At
// batch 256 each bottleneck 3x3 does 59.2 G multiply-adds x 2; at the
// card's 1,979 int8 TOP/s (989 bf16 TFLOP/s) that is 0.030 ms (0.060 ms),
// against 51-103 MB of input and output (0.015-0.031 ms at 3.35 TB/s).
// The design keeps the patch matrix and the accumulator out of device
// memory, as the TPU kernel kept them in VMEM: each block gathers its
// A tile (output positions x a slice of the 9*Cin receptive field)
// straight from x into shared memory and never materialises the im2col;
// x is never padded or copied, and its 9-fold reuse across taps (and
// across the Cout tiles of one position tile, walked fastest) goes
// through L2.
//
// Design (simple and exact; the asynchronous, pipelined path is
// `conv3x3_wgmma.cu`'s): one block of 256 threads owns a
// 128-position x 64-channel output tile and walks the flattened K = 9*Cin
// in steps of 64 bytes (64 int8, 32 bf16 or 16 f32 elements), staging the
// gathered A tile and the weight tile in shared memory.  With vec16 every
// 16-byte chunk lies inside one tap (Cin * itemsize % 16 == 0) and is
// loaded whole; otherwise elements are loaded one by one.  Out-of-image
// taps, a ragged K tail, and rows or channels past the matrix are
// zero-filled, so no shape needs padding.  Each warp computes a 32 x 32
// sub-tile; the int8 and bf16 mma fragments have the same byte layout
// (32 bytes of K per step), so both routes share the fragment loads.
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;        // output positions per block
constexpr int BN = 64;         // output channels per block
constexpr int BKB = 64;        // bytes of K per step
constexpr int LDS = BKB + 16;  // shared row stride in bytes: conflict-free
constexpr int THREADS = 256;
constexpr int CHUNKS = BKB / 16;

enum { IN_INT8 = 0, IN_BF16 = 1, IN_F32 = 2 };
enum { OUT_INT8 = 0, OUT_BF16 = 1, OUT_F32 = 2 };

// raw storage type of one element of each route: staging copies bits only
template <int ES> struct Raw;
template <> struct Raw<1> { using T = uint8_t; };
template <> struct Raw<2> { using T = uint16_t; };
template <> struct Raw<4> { using T = uint32_t; };

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One output position of the tile: its offset in x (elements) and (h, w).
struct Pos {
  long long base;
  int h, w;
  bool valid;
};

__device__ __forceinline__ Pos decode(long long p, long long M, int H, int W,
                                      int Cin) {
  Pos r;
  r.valid = p < M;
  const int hw = (int)(p % ((long long)H * W));
  r.h = hw / W;
  r.w = hw - r.h * W;
  r.base = p * Cin;
  return r;
}

// Offset in x (elements) of tap element k = tap * Cin + c for position q,
// or -1 where the tap falls outside the image or k is past K.
__device__ __forceinline__ long long tap_offset(const Pos& q, int k, int K,
                                                int H, int W, int Cin) {
  if (!q.valid || k >= K) return -1;
  const int tap = k / Cin, c = k - tap * Cin;
  const int dy = tap / 3, dx = tap - dy * 3;
  const int hs = q.h + dy - 1, ws = q.w + dx - 1;
  if (hs < 0 || hs >= H || ws < 0 || ws >= W) return -1;
  return q.base + (long long)((dy - 1) * W + (dx - 1)) * Cin + c;
}

template <int ES, bool VEC>
__device__ __forceinline__ void stage_a(uint8_t* as,
                                        const uint8_t* __restrict__ x,
                                        const Pos (&rows)[BM * CHUNKS / THREADS],
                                        long long m0, long long M, int k0,
                                        int K, int H, int W, int Cin) {
  using T = typename Raw<ES>::T;
  constexpr int BKE = BKB / ES;
  if (VEC) {
    // a thread's chunk column is fixed; its rows were decoded up front
    const int j = threadIdx.x % CHUNKS;
#pragma unroll
    for (int i = 0; i < BM * CHUNKS / THREADS; ++i) {
      const int r = threadIdx.x / CHUNKS + i * (THREADS / CHUNKS);
      const long long off =
          tap_offset(rows[i], k0 + j * (16 / ES), K, H, W, Cin);
      int4 v = make_int4(0, 0, 0, 0);
      if (off >= 0) v = *reinterpret_cast<const int4*>(x + off * ES);
      *reinterpret_cast<int4*>(as + r * LDS + j * 16) = v;
    }
  } else {
    for (int e = threadIdx.x; e < BM * BKE; e += THREADS) {
      const int r = e / BKE, kk = e - r * BKE;
      const Pos q = decode(m0 + r, M, H, W, Cin);
      const long long off = tap_offset(q, k0 + kk, K, H, W, Cin);
      reinterpret_cast<T*>(as + r * LDS)[kk] =
          off >= 0 ? reinterpret_cast<const T*>(x)[off] : T(0);
    }
  }
}

// Stage rows [n0, n0 + BN) x K-columns [k0, k0 + BKB bytes) of the
// (Cout, K) weight matrix, zero outside.
template <int ES, bool VEC>
__device__ __forceinline__ void stage_b(uint8_t* bs,
                                        const uint8_t* __restrict__ wk,
                                        int n0, int Cout, int k0, int K) {
  using T = typename Raw<ES>::T;
  constexpr int BKE = BKB / ES;
  if (VEC) {
    for (int c = threadIdx.x; c < BN * CHUNKS; c += THREADS) {
      const int r = c / CHUNKS, j = c % CHUNKS;
      const int n = n0 + r, k = k0 + j * (16 / ES);
      int4 v = make_int4(0, 0, 0, 0);
      if (n < Cout && k < K)
        v = *reinterpret_cast<const int4*>(wk + ((long long)n * K + k) * ES);
      *reinterpret_cast<int4*>(bs + r * LDS + j * 16) = v;
    }
  } else {
    for (int e = threadIdx.x; e < BN * BKE; e += THREADS) {
      const int r = e / BKE, kk = e - r * BKE;
      const int n = n0 + r, k = k0 + kk;
      reinterpret_cast<T*>(bs + r * LDS)[kk] =
          (n < Cout && k < K)
              ? reinterpret_cast<const T*>(wk)[(long long)n * K + k]
              : T(0);
    }
  }
}

__device__ __forceinline__ void store(void* out, long long i, float v,
                                      int out_type) {
  switch (out_type) {
    case OUT_INT8:
      v = fminf(fmaxf(rintf(v), -127.0f), 127.0f);
      static_cast<int8_t*>(out)[i] = static_cast<int8_t>(__float2int_rn(v));
      break;
    case OUT_BF16:
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
      break;
    default:
      static_cast<float*>(out)[i] = v;
  }
}

template <int IN, bool VEC>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ wk,
               const float* __restrict__ scale,
               const float* __restrict__ shift, void* __restrict__ out,
               int N, int H, int W, int Cin, int Cout, int n_tiles,
               int out_type, int relu) {
  constexpr int ES = IN == IN_INT8 ? 1 : (IN == IN_BF16 ? 2 : 4);
  constexpr int BKE = BKB / ES;
  using Acc = typename std::conditional<IN == IN_INT8, int, float>::type;
  __shared__ __align__(16) uint8_t as[BM * LDS];
  __shared__ __align__(16) uint8_t bs[BN * LDS];

  const long long M = (long long)N * H * W;
  const int K = 9 * Cin;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;  // mma group and thread in group

  Pos rows[BM * CHUNKS / THREADS];
  if (VEC) {
#pragma unroll
    for (int i = 0; i < BM * CHUNKS / THREADS; ++i)
      rows[i] = decode(m0 + threadIdx.x / CHUNKS + i * (THREADS / CHUNKS), M,
                       H, W, Cin);
  }

  Acc acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = Acc(0);

  for (int k0 = 0; k0 < K; k0 += BKE) {
    stage_a<ES, VEC>(as, x, rows, m0, M, k0, K, H, W, Cin);
    stage_b<ES, VEC>(bs, wk, n0, Cout, k0, K);
    __syncthreads();
    if constexpr (IN == IN_F32) {
      const float* af = reinterpret_cast<const float*>(as);
      const float* bf = reinterpret_cast<const float*>(bs);
      constexpr int LDF = LDS / 4;
#pragma unroll 4
      for (int kk = 0; kk < BKE; ++kk) {
        float a[2][2], b[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            a[mt][hh] = af[(wm + mt * 16 + g + hh * 8) * LDF + kk];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            b[nt][e] = bf[(wn + nt * 8 + t * 2 + e) * LDF + kk];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mt][nt][e] =
                  fmaf(a[mt][e >> 1], b[nt][e & 1], acc[mt][nt][e]);
      }
    } else {
#pragma unroll
      for (int kb = 0; kb < BKB; kb += 32) {
        unsigned a[2][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // A fragment: rows g / g+8, bytes t*4.. and 16+t*4.. of the step
          const uint8_t* p = as + (wm + mt * 16 + g) * LDS + kb + t * 4;
          a[mt][0] = *reinterpret_cast<const unsigned*>(p);
          a[mt][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDS);
          a[mt][2] = *reinterpret_cast<const unsigned*>(p + 16);
          a[mt][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDS + 16);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          // B fragment (column-major): column g, bytes t*4.. and 16+t*4..
          const uint8_t* p = bs + (wn + nt * 8 + g) * LDS + kb + t * 4;
          b[nt][0] = *reinterpret_cast<const unsigned*>(p);
          b[nt][1] = *reinterpret_cast<const unsigned*>(p + 16);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if constexpr (IN == IN_INT8)
              mma_s8(acc[mt][nt], a[mt], b[nt]);
            else
              mma_bf16(acc[mt][nt], a[mt], b[nt]);
          }
      }
    }
    __syncthreads();
  }

  // accumulator layout: element e of tile (mt, nt) is row g (+8 for e >= 2),
  // column t*2 + (e & 1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long r = m0 + wm + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int c = n0 + wn + nt * 8 + t * 2 + (e & 1);
        if (r < M && c < Cout) {
          float a;
          if constexpr (IN == IN_INT8)
            a = __int2float_rn(acc[mt][nt][e]);
          else
            a = acc[mt][nt][e];
          float v = __fadd_rn(__fmul_rn(a, scale[c]), shift[c]);
          if (relu) v = fmaxf(v, 0.0f);
          store(out, r * Cout + c, v, out_type);
        }
      }
}

template <int IN>
void launch(dim3 grid, cudaStream_t s, int vec16, const uint8_t* x,
            const uint8_t* wk, const float* scale, const float* shift,
            void* out, int N, int H, int W, int Cin, int Cout, int n_tiles,
            int out_type, int relu) {
  if (vec16)
    conv3x3_kernel<IN, true><<<grid, THREADS, 0, s>>>(
        x, wk, scale, shift, out, N, H, W, Cin, Cout, n_tiles, out_type, relu);
  else
    conv3x3_kernel<IN, false><<<grid, THREADS, 0, s>>>(
        x, wk, scale, shift, out, N, H, W, Cin, Cout, n_tiles, out_type, relu);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  in_type: 0 int8, 1
// bf16, 2 f32 (x and w alike); out_type: 0 int8, 1 bf16, 2 f32.
// vec16 != 0 promises Cin * itemsize % 16 == 0 and 16-byte aligned x and
// wk.  x is (N, H, W, Cin) and wk (Cout, 9 * Cin), both contiguous.
extern "C" int mxtt_conv3x3_epilogue(const void* x, const void* wk,
                                     const void* scale, const void* shift,
                                     void* out, int N, int H, int W, int Cin,
                                     int Cout, int in_type, int out_type,
                                     int relu, int vec16, void* stream) {
  const long long M = (long long)N * H * W;
  if (M <= 0 || Cout <= 0) return 0;
  if (in_type < IN_INT8 || in_type > IN_F32 || out_type < OUT_INT8 ||
      out_type > OUT_F32 || Cin <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (Cout + BN - 1) / BN;
  const long long tiles = ((M + BM - 1) / BM) * n_tiles;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(wk);
  const float* sp = static_cast<const float*>(scale);
  const float* hp = static_cast<const float*>(shift);
  if (in_type == IN_INT8)
    launch<IN_INT8>(grid, s, vec16, xp, wp, sp, hp, out, N, H, W, Cin, Cout,
                    n_tiles, out_type, relu);
  else if (in_type == IN_BF16)
    launch<IN_BF16>(grid, s, vec16, xp, wp, sp, hp, out, N, H, W, Cin, Cout,
                    n_tiles, out_type, relu);
  else
    launch<IN_F32>(grid, s, vec16, xp, wp, sp, hp, out, N, H, W, Cin, Cout,
                   n_tiles, out_type, relu);
  return (int)cudaGetLastError();
}
