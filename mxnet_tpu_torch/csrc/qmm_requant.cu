// int8 matmul with the requantize epilogue fused, for Hopper (sm_90a).
//
// The port of `_qmm_requant_kernel` (mxnet_tpu/ops/pallas_kernels.py:436,
// called by `qmm_requant` at :488), kernel B8, in its mma.sync design: the
// shapes a TMA tensor map cannot describe (K or the row stride of x not a
// multiple of 16, or unaligned operands).  Every other call, ResNet-50's
// 1x1 convolutions among them, takes the wgmma design of qmm_wgmma.cu:
//
//   out[m, n] = clip(rint(relu(f32(acc[m, n]) * scale + bias[n])), -127, 127)
//   acc[m, n] = sum_k x[m, k] * w[n, k]          (exact int32)
//
// x is int8 (M, K) with row stride ldx, w int8 (N, K) K-contiguous (the
// port's OHWI 1x1 weight, reshaped), bias float32 (N,), out int8 (M, N).
//
// What bounds it: bytes.  On ResNet-50's 1x1 convolutions K is 64-2048
// and N 64-512, so a forward moves ~1.5 GB through it against ~0.36 T
// int8 operations: ~0.45 ms at 3.35 TB/s against ~0.18 ms at 1,979 TOP/s.
// The design keeps the int32 accumulator in registers (it never touches
// device memory, as it never left VMEM on the TPU) and reads each x row
// once per 64-column tile of w; tiles of x are walked fastest along N so
// the same rows are reread from L2, not from HBM.
//
// Design (simple and exact; the wgmma design pipelines the loads):
// one block of 128 threads owns a 64 x 64 output tile and loops over K in
// steps of 64, staging the x and w tiles in shared memory (16-byte loads
// when K and the strides allow, byte loads otherwise; rows and columns
// past the matrix are zero-filled, so ragged M, N and K need no padding).
// Each warp computes a 32 x 32 sub-tile with mma.sync m16n8k32
// s8.s8.s32.  The epilogue rounds twice (__fmul_rn then __fadd_rn: no FMA
// contraction, as the reference computes it) and rounds half to even
// (rintf), then clips and stores int8.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int LDS = BK + 16;  // shared row stride in bytes: conflict-free
constexpr int THREADS = 128;

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [r0, r0 + 64) x columns [k0, k0 + 64) of the row-major int8
// matrix g (rows x cols, row stride ld) into s (64 x LDS), zero outside.
template <bool VEC>
__device__ __forceinline__ void stage(int8_t* s, const int8_t* __restrict__ g,
                                      long long ld, int rows, int cols,
                                      int r0, int k0) {
  if (VEC) {
    // cols, ld and g are multiples of 16: a 16-byte chunk is all in or out
    for (int c = threadIdx.x; c < 64 * (BK / 16); c += THREADS) {
      const int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
      const int gr = r0 + r, gk = k0 + kc;
      int4 v = make_int4(0, 0, 0, 0);
      if (gr < rows && gk < cols)
        v = *reinterpret_cast<const int4*>(g + (long long)gr * ld + gk);
      *reinterpret_cast<int4*>(s + r * LDS + kc) = v;
    }
  } else {
    for (int c = threadIdx.x; c < 64 * BK; c += THREADS) {
      const int r = c / BK, kk = c % BK;
      const int gr = r0 + r, gk = k0 + kk;
      s[r * LDS + kk] =
          (gr < rows && gk < cols) ? g[(long long)gr * ld + gk] : int8_t(0);
    }
  }
}

__device__ __forceinline__ int8_t requant(int acc, float scale, float bias,
                                          int relu) {
  float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  if (relu) v = fmaxf(v, 0.0f);
  v = fminf(fmaxf(rintf(v), -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(v));
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
qmm_requant_kernel(const int8_t* __restrict__ x, long long ldx,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ bias, int8_t* __restrict__ out,
                   int M, int N, int K, int n_tiles, float scale, int relu) {
  __shared__ __align__(16) int8_t xs[BM * LDS];
  __shared__ __align__(16) int8_t ws[BN * LDS];
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;  // mma group and thread in group

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage<VEC>(xs, x, ldx, M, K, m0, k0);
    stage<VEC>(ws, w, K, N, K, n0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // A fragment: rows g / g+8, bytes t*4.. and 16+t*4.. of the k-step
        const int8_t* p = xs + (wm + mt * 16 + g) * LDS + kk + t * 4;
        a[mt][0] = *reinterpret_cast<const unsigned*>(p);
        a[mt][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDS);
        a[mt][2] = *reinterpret_cast<const unsigned*>(p + 16);
        a[mt][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        // B fragment (column-major): column g, bytes t*4.. and 16+t*4..
        const int8_t* p = ws + (wn + nt * 8 + g) * LDS + kk + t * 4;
        b[nt][0] = *reinterpret_cast<const unsigned*>(p);
        b[nt][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
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
        const int r = m0 + wm + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int c = n0 + wn + nt * 8 + t * 2 + (e & 1);
        if (r < M && c < N)
          out[(long long)r * N + c] =
              requant(acc[mt][nt][e], scale, bias[c], relu);
      }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  vec16 != 0 promises
// K % 16 == 0, ldx % 16 == 0 and 16-byte aligned x and w.
extern "C" int mxtt_qmm_requant(const void* x, long long ldx, const void* w,
                                const void* bias, void* out, int M, int N,
                                int K, float scale, int relu, int vec16,
                                void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int n_tiles = (N + BN - 1) / BN;
  const long long tiles = (long long)((M + BM - 1) / BM) * n_tiles;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* bp = static_cast<const float*>(bias);
  int8_t* op = static_cast<int8_t*>(out);
  if (vec16)
    qmm_requant_kernel<true><<<grid, THREADS, 0, s>>>(
        xp, ldx, wp, bp, op, M, N, K, n_tiles, scale, relu);
  else
    qmm_requant_kernel<false><<<grid, THREADS, 0, s>>>(
        xp, ldx, wp, bp, op, M, N, K, n_tiles, scale, relu);
  return (int)cudaGetLastError();
}
