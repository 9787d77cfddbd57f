// LayerNorm forward over the last dim, f32: the Hopper port of the TPU
// kernel `_fused_ln_kernel` (mxnet_tpu/ops/fused_optimizer.py:315, called
// from `_ln_fwd_impl`).  It computes the Pallas body exactly:
//   mu = mean(x);  var = mean((x - mu)^2);
//   out = (x - mu) * rsqrt(var + eps) * scale + bias
// with the centred variance taken in a second pass (never E[x^2] - mu^2).
//
// What bounds it on an H100: device-memory bytes.  At the width the
// TransformerLM serves (d = 128) a row is 512 bytes in and 512 bytes out
// for ~8 flops per element, far below the ~20 flops/byte where f32 CUDA
// cores would become the limit.  So the design reads x once and writes
// out once: one warp per row, lanes striding over d (neighbouring lanes on
// neighbouring addresses), the row's values held in registers across the
// two reductions, which are warp shuffles (no shared memory, no block
// barrier).  Rows past d = 32 * kMaxPerLane take a variant that re-reads
// the row from memory (L1/L2-resident) for each pass.
//
// What is not carried over from the TPU kernel: the zero-pad of the rows
// to a 256-row block and the (1, d) scale/bias BlockSpecs are TPU tiling;
// here the grid covers ceil(rows / warps-per-block) blocks and the ragged
// edge (rows and columns) is masked.
//
// Built by mxnet_tpu_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (mxnet_tpu_torch/ops/fused_optimizer.py).
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPerLane = 32;   // register-resident rows up to d = 1024

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int kPerLane>
__global__ void ln_fwd_regs(const float* __restrict__ x,
                            const float* __restrict__ scale,
                            const float* __restrict__ bias,
                            float* __restrict__ out, int rows, int d,
                            float eps) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;   // whole warp exits together
  const float* xr = x + row * d;
  float v[kPerLane];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int c = j * 32 + lane;
    v[j] = c < d ? xr[c] : 0.f;
    s += v[j];
  }
  const float inv_d = 1.f / (float)d;
  const float mu = warp_sum(s) * inv_d;
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int c = j * 32 + lane;
    const float xc = c < d ? v[j] - mu : 0.f;
    v[j] = xc;
    ss += xc * xc;
  }
  const float rstd = rsqrtf(warp_sum(ss) * inv_d + eps);
  float* orow = out + row * d;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int c = j * 32 + lane;
    if (c < d) orow[c] = v[j] * rstd * scale[c] + bias[c];
  }
}

__global__ void ln_fwd_reread(const float* __restrict__ x,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias,
                              float* __restrict__ out, int rows, int d,
                              float eps) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
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

}  // namespace

// x, out: (rows, d) contiguous f32; scale, bias: (d,) f32.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mxtt_fused_ln_forward(const float* x, const float* scale,
                                     const float* bias, float* out,
                                     int rows, int d, float eps,
                                     void* stream) {
  if (rows <= 0) return 0;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_lane = (d + 31) / 32;
  if (per_lane <= 1)
    ln_fwd_regs<1><<<grid, block, 0, st>>>(x, scale, bias, out, rows, d, eps);
  else if (per_lane <= 2)
    ln_fwd_regs<2><<<grid, block, 0, st>>>(x, scale, bias, out, rows, d, eps);
  else if (per_lane <= 4)
    ln_fwd_regs<4><<<grid, block, 0, st>>>(x, scale, bias, out, rows, d, eps);
  else if (per_lane <= 8)
    ln_fwd_regs<8><<<grid, block, 0, st>>>(x, scale, bias, out, rows, d, eps);
  else if (per_lane <= 16)
    ln_fwd_regs<16><<<grid, block, 0, st>>>(x, scale, bias, out, rows, d, eps);
  else if (per_lane <= kMaxPerLane)
    ln_fwd_regs<kMaxPerLane><<<grid, block, 0, st>>>(x, scale, bias, out,
                                                     rows, d, eps);
  else
    ln_fwd_reread<<<grid, block, 0, st>>>(x, scale, bias, out, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}
