// Fused optimizer updates over a flat f32 parameter space: the Hopper port
// of the TPU kernels in mxnet_tpu/ops/fused_optimizer.py, each reached
// there through `_flat_call` (the pl.pallas_call at :211):
//   mxtt_fused_sgd      <- `_fused_sgd_kernel`     (:141, `fused_sgd`)
//   mxtt_fused_sgd_mom  <- `_fused_sgd_mom_kernel` (:151, `fused_sgd_momentum`)
//   mxtt_fused_adam     <- `_fused_adam_kernel`    (:165, `fused_adam`)
// Each computes its Pallas body's expression in the same order of
// operations, the gradient prepared as `_prep_g` (:134) does:
//   g = clip((rescale_grad * inv_scale) * g)      (clip < 0 disables)
//   SGD      w' = (1 - lr*wd)*w - lr*g
//   SGD+mom  m' = momentum*m - (lr*wd)*w - lr*g;   w' = w + m'
//   Adam     g = (rescale_grad*inv_scale)*g + wd*w, then clip;
//            m' = b1*m + (1-b1)*g;  v' = b2*v + (1-b2)*g*g;
//            w' = w - (lr_t*m') / (sqrt(v') + eps)
// The scalars [lr, inv_scale, ok] come as a pointer to three floats in
// device memory, the counterpart of the (1, 3) SMEM operand: a loss-scaled
// step can compute `ok` on the device and never sync the host for it.
// With ok == 0 every element is written back unchanged (select-skip), so
// a skipped step is a bitwise no-op.  A zero (w, g, m, v) stays zero.
//
// What bounds it on an H100: device-memory bytes.  Per element SGD reads
// w, g and writes w (12 bytes) for ~5 flops; SGD+momentum moves 20 bytes,
// Adam 28, for at most ~15 flops: two orders of magnitude below the
// ~20 flops/byte where the f32 CUDA cores would become the limit.  So the
// design makes one pass: each element is read once and written once, in
// place (the Pallas aliases {1:0, 3:1, 4:2}), with 16-byte float4 loads
// and stores when every pointer is 16-byte aligned and a scalar loop for
// the rest.  A grid-stride loop over n replaces the TPU's (rows, 128)
// padding and BlockSpec tiling: the ragged tail is masked, never padded.
//
// Built by mxnet_tpu_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (no --use_fast_math: Adam's sqrtf and division stay IEEE) and bound
// with ctypes (mxnet_tpu_torch/ops/fused_optimizer.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 blocks of 256 per SM

struct SgdArgs {
  float wd, rescale, clip;
};
struct SgdMomArgs {
  float momentum, wd, rescale, clip;
};
struct AdamArgs {
  float beta1, beta2, one_minus_beta1, one_minus_beta2, epsilon, wd, rescale,
      clip;
};

// jnp.clip(g, -c, c) == min(max(g, -c), c), NaN propagating
__device__ __forceinline__ float clip_g(float g, float c) {
  if (c >= 0.f) {
    g = g < -c ? -c : g;
    g = g > c ? c : g;
  }
  return g;
}

__device__ __forceinline__ void sgd_elem(float& w, float g, const SgdArgs& a,
                                         float lr, float scale, float one_m,
                                         bool ok) {
  const float gg = clip_g(scale * g, a.clip);
  const float nw = one_m * w - lr * gg;
  w = ok ? nw : w;
}

__device__ __forceinline__ void sgd_mom_elem(float& w, float& m, float g,
                                             const SgdMomArgs& a, float lr,
                                             float lrwd, float scale,
                                             bool ok) {
  const float gg = clip_g(scale * g, a.clip);
  const float nm = a.momentum * m - lrwd * w - lr * gg;
  const float nw = w + nm;
  w = ok ? nw : w;
  m = ok ? nm : m;
}

__device__ __forceinline__ void adam_elem(float& w, float& m, float& v,
                                          float g, const AdamArgs& a,
                                          float lr_t, float scale, bool ok) {
  const float gg = clip_g(scale * g + a.wd * w, a.clip);
  const float nm = a.beta1 * m + a.one_minus_beta1 * gg;
  const float nv = a.beta2 * v + a.one_minus_beta2 * (gg * gg);
  const float nw = w - (lr_t * nm) / (sqrtf(nv) + a.epsilon);
  w = ok ? nw : w;
  m = ok ? nm : m;
  v = ok ? nv : v;
}

// kVec: float4 over the first n/4 groups (pointers 16-byte aligned), then
// the scalar tail; otherwise scalar over all n
template <bool kVec>
__global__ void sgd_kernel(float* __restrict__ w, const float* __restrict__ g,
                           long long n, const float* __restrict__ s,
                           SgdArgs a) {
  const float lr = s[0], scale = a.rescale * s[1];
  const bool ok = s[2] > 0.f;
  const float one_m = 1.f - lr * a.wd;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long start = 0;
  if (kVec) {
    const long long n4 = n >> 2;
    float4* w4 = reinterpret_cast<float4*>(w);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (long long j = i; j < n4; j += stride) {
      float4 wv = w4[j];
      const float4 gv = g4[j];
      sgd_elem(wv.x, gv.x, a, lr, scale, one_m, ok);
      sgd_elem(wv.y, gv.y, a, lr, scale, one_m, ok);
      sgd_elem(wv.z, gv.z, a, lr, scale, one_m, ok);
      sgd_elem(wv.w, gv.w, a, lr, scale, one_m, ok);
      w4[j] = wv;
    }
    start = n4 << 2;
  }
  for (long long j = start + i; j < n; j += stride) {
    float wv = w[j];
    sgd_elem(wv, g[j], a, lr, scale, one_m, ok);
    w[j] = wv;
  }
}

template <bool kVec>
__global__ void sgd_mom_kernel(float* __restrict__ w,
                               const float* __restrict__ g,
                               float* __restrict__ m, long long n,
                               const float* __restrict__ s, SgdMomArgs a) {
  const float lr = s[0], scale = a.rescale * s[1];
  const bool ok = s[2] > 0.f;
  const float lrwd = lr * a.wd;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long start = 0;
  if (kVec) {
    const long long n4 = n >> 2;
    float4* w4 = reinterpret_cast<float4*>(w);
    float4* m4 = reinterpret_cast<float4*>(m);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (long long j = i; j < n4; j += stride) {
      float4 wv = w4[j], mv = m4[j];
      const float4 gv = g4[j];
      sgd_mom_elem(wv.x, mv.x, gv.x, a, lr, lrwd, scale, ok);
      sgd_mom_elem(wv.y, mv.y, gv.y, a, lr, lrwd, scale, ok);
      sgd_mom_elem(wv.z, mv.z, gv.z, a, lr, lrwd, scale, ok);
      sgd_mom_elem(wv.w, mv.w, gv.w, a, lr, lrwd, scale, ok);
      w4[j] = wv;
      m4[j] = mv;
    }
    start = n4 << 2;
  }
  for (long long j = start + i; j < n; j += stride) {
    float wv = w[j], mv = m[j];
    sgd_mom_elem(wv, mv, g[j], a, lr, lrwd, scale, ok);
    w[j] = wv;
    m[j] = mv;
  }
}

template <bool kVec>
__global__ void adam_kernel(float* __restrict__ w, const float* __restrict__ g,
                            float* __restrict__ m, float* __restrict__ v,
                            long long n, const float* __restrict__ s,
                            AdamArgs a) {
  const float lr_t = s[0], scale = a.rescale * s[1];
  const bool ok = s[2] > 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long start = 0;
  if (kVec) {
    const long long n4 = n >> 2;
    float4* w4 = reinterpret_cast<float4*>(w);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (long long j = i; j < n4; j += stride) {
      float4 wv = w4[j], mv = m4[j], vv = v4[j];
      const float4 gv = g4[j];
      adam_elem(wv.x, mv.x, vv.x, gv.x, a, lr_t, scale, ok);
      adam_elem(wv.y, mv.y, vv.y, gv.y, a, lr_t, scale, ok);
      adam_elem(wv.z, mv.z, vv.z, gv.z, a, lr_t, scale, ok);
      adam_elem(wv.w, mv.w, vv.w, gv.w, a, lr_t, scale, ok);
      w4[j] = wv;
      m4[j] = mv;
      v4[j] = vv;
    }
    start = n4 << 2;
  }
  for (long long j = start + i; j < n; j += stride) {
    float wv = w[j], mv = m[j], vv = v[j];
    adam_elem(wv, mv, vv, g[j], a, lr_t, scale, ok);
    w[j] = wv;
    m[j] = mv;
    v[j] = vv;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

dim3 grid_for(long long n, bool vec) {
  const long long work = vec ? (n >> 2) + 3 : n;   // +3: the scalar tail
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return dim3(static_cast<unsigned>(blocks));
}

}  // namespace

// All arrays flat, contiguous f32 of n elements, updated in place; `s`
// points to [lr, inv_scale, ok] in device memory.  clip < 0 disables
// clipping.  Each launches on `stream` and returns cudaGetLastError().
extern "C" int mxtt_fused_sgd(float* w, const float* g, long long n,
                              const float* s, float wd, float rescale,
                              float clip, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SgdArgs a{wd, rescale, clip};
  const bool vec = aligned16(w) && aligned16(g);
  if (vec)
    sgd_kernel<true><<<grid_for(n, true), kThreads, 0, st>>>(w, g, n, s, a);
  else
    sgd_kernel<false><<<grid_for(n, false), kThreads, 0, st>>>(w, g, n, s, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mxtt_fused_sgd_mom(float* w, const float* g, float* m,
                                  long long n, const float* s,
                                  float momentum, float wd, float rescale,
                                  float clip, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SgdMomArgs a{momentum, wd, rescale, clip};
  const bool vec = aligned16(w) && aligned16(g) && aligned16(m);
  if (vec)
    sgd_mom_kernel<true><<<grid_for(n, true), kThreads, 0, st>>>(w, g, m, n,
                                                                 s, a);
  else
    sgd_mom_kernel<false><<<grid_for(n, false), kThreads, 0, st>>>(w, g, m,
                                                                   n, s, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mxtt_fused_adam(float* w, const float* g, float* m, float* v,
                               long long n, const float* s, float beta1,
                               float beta2, float one_minus_beta1,
                               float one_minus_beta2, float epsilon,
                               float wd, float rescale, float clip,
                               void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AdamArgs a{beta1, beta2, one_minus_beta1, one_minus_beta2,
                   epsilon, wd, rescale, clip};
  const bool vec = aligned16(w) && aligned16(g) && aligned16(m) &&
                   aligned16(v);
  if (vec)
    adam_kernel<true><<<grid_for(n, true), kThreads, 0, st>>>(w, g, m, v, n,
                                                              s, a);
  else
    adam_kernel<false><<<grid_for(n, false), kThreads, 0, st>>>(w, g, m, v,
                                                                n, s, a);
  return static_cast<int>(cudaGetLastError());
}
