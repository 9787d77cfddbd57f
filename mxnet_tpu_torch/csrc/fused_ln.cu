// LayerNorm forward over the last dim, f32: the Hopper port of the TPU
// kernel `_fused_ln_kernel` (mxnet_tpu/ops/fused_optimizer.py:315, called
// from `_ln_fwd_impl`).  It computes the Pallas body:
//   mu = mean(x);  var = mean((x - mu)^2);
//   out = (x - mu) * rsqrt(var + eps) * scale + bias
// with the variance centred on the mean (never E[x^2] - mu^2).
//
// What bounds it on an H100.  Its bytes: at the width the TransformerLM
// serves (d = 128) a row is 512 bytes in and 512 bytes out for ~8 flops
// per element, far below the ~20 flops/byte where f32 CUDA cores would
// become the limit.  But the decode step calls it on 1-8 rows, where the
// bytes take nanoseconds and the call is latency: the launch, then the
// chain of dependent steps inside the kernel.  So the design reads x once
// and writes out once, one warp per row with the row in registers (lanes
// strided over the columns, neighbouring lanes on neighbouring addresses),
// the mean and then the centred sum of squares each a 5-level
// `__shfl_xor_sync` tree, and keeps the chain to one memory round trip:
// x, scale and bias are all loaded at the top, before the trees, so the
// call does not wait on x and then again on the parameters.  That round
// trip is most of what the kernel adds to a launch.
//
// Three more parts were built and measured against that one on the card,
// and are slower at the decode and prefill shapes, so they stay as
// variants (mxnet_tpu_torch/tools/ln_ablate.py):
//   - `kVec4`: where d % 4 == 0 and every pointer is 16-byte aligned, a
//     lane owns runs of 4 contiguous columns and moves them as one float4
//     (lane l holds float4 l, l + 32, ... of the row);
//   - `kMerge`: one shuffle tree that merges each lane's (count, mean,
//     M2), Chan's parallel form with three independent shuffles a level,
//     in an order symmetric in the two lanes (every lane ends with the
//     same bits), in place of the two dependent trees;
//   - `kRowWarps`: warps per block from the row count (one warp a block
//     up to kSpreadRows rows, so a few rows spread over several SMs), in
//     place of eight.
// Rows past d = 32 * kMaxPerLane take a variant that re-reads the row
// from memory (L1/L2-resident) for each pass.
//
// Each part is a bit of `parts`; kShipped is the set the main path runs
// (`mxtt_fused_ln_forward`).  `mxtt_fused_ln_forward_parts` runs any
// other set, for that tool and chip_smoke.py only; with no part set it is
// the design this one replaced (the parameters loaded after the trees).
//
// What is not carried over from the TPU kernel: the zero-pad of the rows
// to a 256-row block and the (1, d) scale/bias BlockSpecs are TPU tiling;
// here the grid covers the rows and the ragged edge (rows and columns) is
// masked.
//
// Built by mxnet_tpu_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (mxnet_tpu_torch/ops/fused_optimizer.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum : int {
  kEarlyParams = 1,   // scale and bias loaded with x, before the reductions
  kVec4 = 2,          // float4 accesses where d and the pointers allow
  kMerge = 4,         // one (count, mean, M2) tree instead of two trees
  kRowWarps = 8,      // warps per block from the row count, not 8
};
constexpr int kShipped = kEarlyParams;

constexpr int kMaxWarps = 8;
constexpr int kMaxPerLane = 32;   // register-resident rows up to d = 1024
// calls of at most this many rows take one warp a block: about one block
// per SM
constexpr int kSpreadRows = 128;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Column of value j of a lane: runs of 4 under kVec (values j..j+3 of the
// lane are float4 (j / 4) * 32 + lane of the row), else j * 32 + lane.
template <bool kVec>
__device__ __forceinline__ int column(int j, int lane) {
  return kVec ? (((j >> 2) * 32 + lane) << 2) + (j & 3) : j * 32 + lane;
}

// One warp a row, kPerLane values a lane in registers.
template <int kPerLane, bool kVec, bool kEarly, bool kMergeTree>
__global__ void ln_fwd_regs(const float* __restrict__ x,
                            const float* __restrict__ scale,
                            const float* __restrict__ bias,
                            float* __restrict__ out, int rows, int d,
                            float eps) {
  static_assert(!kVec || kPerLane % 4 == 0, "float4 runs");
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;   // whole warp exits together
  const float* xr = x + row * d;
  constexpr int kP = kEarly ? kPerLane : 1;
  float v[kPerLane], sc[kP], bi[kP];
  if constexpr (kVec) {
#pragma unroll
    for (int j = 0; j < kPerLane; j += 4) {
      const int c = column<true>(j, lane);
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), p = a, q = a;
      if (c < d) {
        a = *reinterpret_cast<const float4*>(xr + c);
        if constexpr (kEarly) {
          p = *reinterpret_cast<const float4*>(scale + c);
          q = *reinterpret_cast<const float4*>(bias + c);
        }
      }
      v[j] = a.x; v[j + 1] = a.y; v[j + 2] = a.z; v[j + 3] = a.w;
      if constexpr (kEarly) {
        sc[j] = p.x; sc[j + 1] = p.y; sc[j + 2] = p.z; sc[j + 3] = p.w;
        bi[j] = q.x; bi[j + 1] = q.y; bi[j + 2] = q.z; bi[j + 3] = q.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int c = column<false>(j, lane);
      v[j] = c < d ? xr[c] : 0.f;
      if constexpr (kEarly) {
        sc[j] = c < d ? scale[c] : 0.f;
        bi[j] = c < d ? bias[c] : 0.f;
      }
    }
  }
  const float inv_d = 1.f / (float)d;
  float mu, rstd;
  if constexpr (kMergeTree) {
    // this lane's count, mean and centred sum of squares
    float n = 0.f, s = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      if (column<kVec>(j, lane) < d) { n += 1.f; s += v[j]; }
    float m = n > 0.f ? s / n : 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const float dv = v[j] - m;
      if (column<kVec>(j, lane) < d) m2 += dv * dv;
    }
    // merge with the lane `off` away: mean (n m + nb mb) / (n + nb), M2
    // m2 + m2b + delta^2 n nb / (n + nb).  Equal counts (every level of a
    // row that fills the lanes evenly, as d = 128 does) take the form
    // without a division.  Every term is symmetric in the two lanes (the
    // products summed by intrinsics, which are never contracted into an
    // FMA that would round one side only), so both end with the same bits.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float nb = __shfl_xor_sync(0xffffffffu, n, off);
      const float mb = __shfl_xor_sync(0xffffffffu, m, off);
      const float m2b = __shfl_xor_sync(0xffffffffu, m2, off);
      const float nt = n + nb;
      const float delta = mb - m;
      float w = 0.f;
      if (n == nb) {
        m = __fmul_rn(__fadd_rn(m, mb), 0.5f);
        w = __fmul_rn(n, 0.5f);
      } else if (nt > 0.f) {
        m = __fdiv_rn(__fadd_rn(__fmul_rn(n, m), __fmul_rn(nb, mb)), nt);
        w = __fdiv_rn(__fmul_rn(n, nb), nt);
      }
      m2 = __fadd_rn(__fadd_rn(m2, m2b),
                     __fmul_rn(__fmul_rn(delta, delta), w));
      n = nt;
    }
    mu = m;
    rstd = rsqrtf(m2 * inv_d + eps);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) v[j] -= mu;
  } else {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) s += v[j];
    mu = warp_sum(s) * inv_d;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const float xc = column<kVec>(j, lane) < d ? v[j] - mu : 0.f;
      v[j] = xc;
      ss += xc * xc;
    }
    rstd = rsqrtf(warp_sum(ss) * inv_d + eps);
  }
  float* orow = out + row * d;
  if constexpr (kVec) {
#pragma unroll
    for (int j = 0; j < kPerLane; j += 4) {
      const int c = column<true>(j, lane);
      if (c >= d) continue;
      float4 p, q;
      if constexpr (kEarly) {
        p = make_float4(sc[j], sc[j + 1], sc[j + 2], sc[j + 3]);
        q = make_float4(bi[j], bi[j + 1], bi[j + 2], bi[j + 3]);
      } else {
        p = *reinterpret_cast<const float4*>(scale + c);
        q = *reinterpret_cast<const float4*>(bias + c);
      }
      *reinterpret_cast<float4*>(orow + c) = make_float4(
          v[j] * rstd * p.x + q.x, v[j + 1] * rstd * p.y + q.y,
          v[j + 2] * rstd * p.z + q.z, v[j + 3] * rstd * p.w + q.w);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int c = column<false>(j, lane);
      if (c < d) {
        if constexpr (kEarly)
          orow[c] = v[j] * rstd * sc[j] + bi[j];
        else
          orow[c] = v[j] * rstd * scale[c] + bias[c];
      }
    }
  }
}

__global__ void ln_fwd_reread(const float* __restrict__ x,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias,
                              float* __restrict__ out, int rows, int d,
                              float eps) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += xr[c];
  const float inv_d = 1.f / (float)d;
  const float mu = warp_sum(s) * inv_d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float xc = xr[c] - mu;
    ss += xc * xc;
  }
  const float rstd = rsqrtf(warp_sum(ss) * inv_d + eps);
  float* orow = out + row * d;
  for (int c = lane; c < d; c += 32)
    orow[c] = (xr[c] - mu) * rstd * scale[c] + bias[c];
}

struct Args {
  const float *x, *scale, *bias;
  float* out;
  int rows, d;
  float eps;
};

template <int kPerLane, bool kVec, bool kEarly, bool kMergeTree>
void launch_regs(const Args& a, dim3 grid, dim3 block, cudaStream_t st) {
  ln_fwd_regs<kPerLane, kVec, kEarly, kMergeTree><<<grid, block, 0, st>>>(
      a.x, a.scale, a.bias, a.out, a.rows, a.d, a.eps);
}

// the register-resident kernel whose per-lane count covers the row
// (float4 runs hold at least 4 values a lane)
template <bool kVec, bool kEarly, bool kMergeTree>
void launch_sized(const Args& a, dim3 grid, dim3 block, cudaStream_t st) {
  const int per_lane = (a.d + 31) / 32;
  if constexpr (!kVec) {
    if (per_lane <= 1)
      return launch_regs<1, kVec, kEarly, kMergeTree>(a, grid, block, st);
    if (per_lane <= 2)
      return launch_regs<2, kVec, kEarly, kMergeTree>(a, grid, block, st);
  }
  if (per_lane <= 4)
    launch_regs<4, kVec, kEarly, kMergeTree>(a, grid, block, st);
  else if (per_lane <= 8)
    launch_regs<8, kVec, kEarly, kMergeTree>(a, grid, block, st);
  else if (per_lane <= 16)
    launch_regs<16, kVec, kEarly, kMergeTree>(a, grid, block, st);
  else
    launch_regs<kMaxPerLane, kVec, kEarly, kMergeTree>(a, grid, block, st);
}

template <bool kVec>
void launch_parts(const Args& a, int parts, dim3 grid, dim3 block,
                  cudaStream_t st) {
  const bool early = parts & kEarlyParams, merge = parts & kMerge;
  if (early && merge)
    launch_sized<kVec, true, true>(a, grid, block, st);
  else if (early)
    launch_sized<kVec, true, false>(a, grid, block, st);
  else if (merge)
    launch_sized<kVec, false, true>(a, grid, block, st);
  else
    launch_sized<kVec, false, false>(a, grid, block, st);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// x, out: (rows, d) contiguous f32; scale, bias: (d,) f32; `parts`: a set
// of the design's parts (the enum above).  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int mxtt_fused_ln_forward_parts(const float* x, const float* scale,
                                           const float* bias, float* out,
                                           int rows, int d, float eps,
                                           void* stream, int parts) {
  if (rows <= 0) return 0;
  int warps = kMaxWarps;
  if (parts & kRowWarps) {
    const int want = (rows + kSpreadRows - 1) / kSpreadRows;
    warps = want < kMaxWarps ? want : kMaxWarps;
  }
  const dim3 block(32 * warps);
  const dim3 grid((rows + warps - 1) / warps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{x, scale, bias, out, rows, d, eps};
  if (d > 32 * kMaxPerLane) {
    ln_fwd_reread<<<grid, block, 0, st>>>(x, scale, bias, out, rows, d, eps);
  } else if ((parts & kVec4) && d % 4 == 0 && aligned16(x) &&
             aligned16(scale) && aligned16(bias) && aligned16(out)) {
    launch_parts<true>(a, parts, grid, block, st);
  } else {
    launch_parts<false>(a, parts, grid, block, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The main path: the shipped set of parts.
extern "C" int mxtt_fused_ln_forward(const float* x, const float* scale,
                                     const float* bias, float* out,
                                     int rows, int d, float eps,
                                     void* stream) {
  return mxtt_fused_ln_forward_parts(x, scale, bias, out, rows, d, eps,
                                     stream, kShipped);
}

// The set of parts the main path runs (for the tools that time the
// others against it).
extern "C" int mxtt_fused_ln_shipped_parts() { return kShipped; }
