// Flash attention over (BH, T, D) f32: the Hopper port of the three TPU
// kernels of mxnet_tpu/ops/pallas_kernels.py that ring attention runs on
// every hop (parallel/ring_attention.py):
//
//   mxtt_flash_fwd  <- _fa_kernel      (:62, via _flash_attention_fwd_impl /
//                      flash_forward_with_lse): out and the per-row
//                      logsumexp lse, online softmax over K tiles;
//   mxtt_flash_dq   <- _fa_dq_kernel   (:171, via flash_dq): dq with P
//                      recomputed from (q, k, lse);
//   mxtt_flash_dkv  <- _fa_dkv_kernel  (:226, via flash_dkv): dk and dv on a
//                      k-major grid, the same recompute.
//
// Each computes what its Pallas body computes, with its guards:
//   s = q.k * scale, masked entries -1e30 (never -inf): positions past
//   the ragged end of q or k, and kpos > qpos in causal mode (q and k
//   aligned at position 0);
//   forward: m_safe = 0 and corr = 0 while the running max is still the
//   mask value, p = 0 where s <= -5e29, denom = max(l, 1e-30),
//   o = acc / denom, lse = m + log(denom);
//   dq:  p = exp(s - lse), dp = dO.v, ds = p (dp - delta),
//        dq = sum ds k * scale;
//   dkv: dv = sum p dO, dk = sum ds q * scale  (delta = rowsum(dO * O)).
// Rows past the ragged ends are loaded as zeros, so no unloaded V (or K,
// Q, dO) row is ever multiplied (the Pallas kernels' :100-103 guard).
//
// What is not carried over: the TPU grid runs in order on one core, so
// the Pallas kernels carry m / l / acc (or dq / dk / dv) in VMEM scratch
// across a sequential grid axis.  Here blocks run in parallel and in no
// order, so each block owns one (bh, q-tile) (forward, dq) or one
// (bh, k-tile) (dkv) and loops over the other axis itself, staging its
// tiles in shared memory.  dkv keeps the k-major split: every output
// element is written once by one thread, so there are no atomics and two
// runs are bitwise equal.  The (BH, 8, T) sublane broadcast of lse is a TPU
// tile artifact: lse and delta are plain (BH, T) here.
//
// What bounds it on an H100: operations.  At the ring path's shapes
// (T = 512 per chunk, D = 16) a (bh) pairing does 4*T*T*D flops forward
// on 3*T*D + T*D floats, ~170 flops per byte moved, far above the ~20
// flops/byte where f32 CUDA cores stop waiting on HBM.  The design keeps
// the work on CUDA-core FMAs (a simple first kernel: no tensor cores,
// no TMA): G threads own one row (G = 1 up to D = 32, 2 at 64, 4 at 128),
// holding their D/G slice of q (forward, dq) or k and v (dkv) and the
// accumulators in registers; the other operand's tiles (32 rows) sit in
// shared memory, where every lane of a warp reads the same row, a
// broadcast.  A row's partial dot products meet through G-lane shuffles.
// Causal blocks skip the K tiles (Q tiles for dkv) that lie wholly on the
// masked side of the diagonal.  D is padded to 8, 16, 32, 64 or 128 with
// zeros (exact: 0 * 0 adds nothing); D > 128 is refused.
//
// expf / logf stay IEEE: no --use_fast_math.  Built by
// mxnet_tpu_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (mxnet_tpu_torch/ops/pallas_kernels.py).  Each entry
// point launches on `stream`, allocates nothing, and returns
// cudaGetLastError() (0 on success).
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;      // _NEG_INF of the Pallas kernels
constexpr float kHalfNegInf = -5e29f;  // _NEG_INF / 2
constexpr int kThreads = 128;
constexpr int kTile = 32;              // rows per shared-memory tile
constexpr int kMaxD = 128;

// sum over the G lanes that own one row (G divides 32, groups aligned)
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows row0 .. row0 + kTile - 1 of a (rows, D) matrix into dst[kTile][DP],
// zeros past the matrix's last row and past column D
template <int DP>
__device__ __forceinline__ void load_tile(float (*dst)[DP],
                                          const float* __restrict__ src,
                                          int row0, int rows, int D) {
  for (int e = threadIdx.x; e < kTile * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    const int row = row0 + r;
    dst[r][c] = (row < rows && c < D) ? src[(long)row * D + c] : 0.f;
  }
}

template <int DG>
__device__ __forceinline__ float dot_slice(const float* a,
                                           const float* __restrict__ b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < DG / 4; ++i) {
    const float4 x = b4[i];
    s = fmaf(a[4 * i], x.x, s);
    s = fmaf(a[4 * i + 1], x.y, s);
    s = fmaf(a[4 * i + 2], x.z, s);
    s = fmaf(a[4 * i + 3], x.w, s);
  }
  return s;
}

template <int DG>
__device__ __forceinline__ void axpy_slice(float* acc, float p,
                                           const float* __restrict__ b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll
  for (int i = 0; i < DG / 4; ++i) {
    const float4 x = b4[i];
    acc[4 * i] = fmaf(p, x.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(p, x.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(p, x.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(p, x.w, acc[4 * i + 3]);
  }
}

template <int DG>
__device__ __forceinline__ void load_row(float* dst,
                                         const float* __restrict__ row,
                                         bool valid, int c0, int D) {
#pragma unroll
  for (int d = 0; d < DG; ++d)
    dst[d] = (valid && c0 + d < D) ? row[c0 + d] : 0.f;
}

// ---------------------------------------------------------------------------
// forward: one block per (bh, q-tile of kThreads / G rows)
// ---------------------------------------------------------------------------
template <int DP, int G>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Tq, int Tk, int D, float scale,
                 int causal) {
  constexpr int DG = DP / G;
  constexpr int BQ = kThreads / G;
  __shared__ __align__(16) float ks[kTile][DP];
  __shared__ __align__(16) float vs[kTile][DP];
  const long bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int sub = threadIdx.x % G;
  const int c0 = sub * DG;
  const int qi = q0 + threadIdx.x / G;
  const bool qvalid = qi < Tq;
  float qr[DG], acc[DG];
  load_row<DG>(qr, q + (bh * Tq + qi) * D, qvalid, c0, D);
#pragma unroll
  for (int d = 0; d < DG; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;
  const float* kb = k + bh * Tk * D;
  const float* vb = v + bh * Tk * D;
  // causal: keys past the block's last row are masked for every row
  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<DP>(ks, kb, k0, Tk, D);
    load_tile<DP>(vs, vb, k0, Tk, D);
    __syncthreads();
    float s[kTile];
    float mt = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float dot = group_sum<G>(dot_slice<DG>(qr, &ks[j][c0])) * scale;
      const int kj = k0 + j;
      const bool valid = kj < Tk && (!causal || qi >= kj);
      s[j] = valid ? dot : kNegInf;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float m_safe = m_new <= kHalfNegInf ? 0.f : m_new;
    const float corr = m <= kHalfNegInf ? 0.f : expf(m - m_safe);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      s[j] = s[j] <= kHalfNegInf ? 0.f : expf(s[j] - m_safe);
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int d = 0; d < DG; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kTile; ++j) axpy_slice<DG>(acc, s[j], &vs[j][c0]);
    m = m_new;
  }
  if (!qvalid) return;
  const float denom = fmaxf(l, 1e-30f);
  float* orow = o + (bh * Tq + qi) * D;
#pragma unroll
  for (int d = 0; d < DG; ++d)
    if (c0 + d < D) orow[c0 + d] = acc[d] / denom;
  if (sub == 0) lse[bh * Tq + qi] = m + logf(denom);
}

// ---------------------------------------------------------------------------
// dq: one block per (bh, q-tile), a loop over K tiles
// ---------------------------------------------------------------------------
template <int DP, int G>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                int Tq, int Tk, int D, float scale, int causal) {
  constexpr int DG = DP / G;
  constexpr int BQ = kThreads / G;
  __shared__ __align__(16) float ks[kTile][DP];
  __shared__ __align__(16) float vs[kTile][DP];
  const long bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int sub = threadIdx.x % G;
  const int c0 = sub * DG;
  const int qi = q0 + threadIdx.x / G;
  const bool qvalid = qi < Tq;
  float qr[DG], dor[DG], acc[DG];
  load_row<DG>(qr, q + (bh * Tq + qi) * D, qvalid, c0, D);
  load_row<DG>(dor, dout + (bh * Tq + qi) * D, qvalid, c0, D);
#pragma unroll
  for (int d = 0; d < DG; ++d) acc[d] = 0.f;
  const float lse_i = qvalid ? lse[bh * Tq + qi] : 0.f;
  const float delta_i = qvalid ? delta[bh * Tq + qi] : 0.f;
  const float* kb = k + bh * Tk * D;
  const float* vb = v + bh * Tk * D;
  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<DP>(ks, kb, k0, Tk, D);
    load_tile<DP>(vs, vb, k0, Tk, D);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float s = group_sum<G>(dot_slice<DG>(qr, &ks[j][c0])) * scale;
      const float dp = group_sum<G>(dot_slice<DG>(dor, &vs[j][c0]));
      const int kj = k0 + j;
      const bool valid = qvalid && kj < Tk && (!causal || qi >= kj);
      const float p = valid ? expf(s - lse_i) : 0.f;
      const float ds = valid ? p * (dp - delta_i) : 0.f;
      axpy_slice<DG>(acc, ds, &ks[j][c0]);
    }
  }
  if (!qvalid) return;
  float* row = dq + (bh * Tq + qi) * D;
#pragma unroll
  for (int d = 0; d < DG; ++d)
    if (c0 + d < D) row[c0 + d] = acc[d] * scale;
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (bh, k-tile), a loop over Q tiles (k-major)
// ---------------------------------------------------------------------------
template <int DP, int G>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int Tq, int Tk, int D, float scale,
                 int causal) {
  constexpr int DG = DP / G;
  constexpr int BK = kThreads / G;
  __shared__ __align__(16) float qs[kTile][DP];
  __shared__ __align__(16) float dos[kTile][DP];
  __shared__ float lses[kTile];
  __shared__ float dels[kTile];
  const long bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int sub = threadIdx.x % G;
  const int c0 = sub * DG;
  const int kj = k0 + threadIdx.x / G;
  const bool kvalid = kj < Tk;
  float kr[DG], vr[DG], dka[DG], dva[DG];
  load_row<DG>(kr, k + (bh * Tk + kj) * D, kvalid, c0, D);
  load_row<DG>(vr, v + (bh * Tk + kj) * D, kvalid, c0, D);
#pragma unroll
  for (int d = 0; d < DG; ++d) dka[d] = dva[d] = 0.f;
  const float* qb = q + bh * Tq * D;
  const float* db = dout + bh * Tq * D;
  // causal: queries before the block's first key see none of its keys
  const int q_begin = causal ? min(k0, Tq) : 0;
  for (int qt = q_begin; qt < Tq; qt += kTile) {
    __syncthreads();
    load_tile<DP>(qs, qb, qt, Tq, D);
    load_tile<DP>(dos, db, qt, Tq, D);
    if (threadIdx.x < kTile) {
      const int row = qt + threadIdx.x;
      lses[threadIdx.x] = row < Tq ? lse[bh * Tq + row] : 0.f;
      dels[threadIdx.x] = row < Tq ? delta[bh * Tq + row] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      const float s = group_sum<G>(dot_slice<DG>(kr, &qs[i][c0])) * scale;
      const float dp = group_sum<G>(dot_slice<DG>(vr, &dos[i][c0]));
      const int qi = qt + i;
      const bool valid = kvalid && qi < Tq && (!causal || qi >= kj);
      const float p = valid ? expf(s - lses[i]) : 0.f;
      const float ds = valid ? p * (dp - dels[i]) : 0.f;
      axpy_slice<DG>(dva, p, &dos[i][c0]);
      axpy_slice<DG>(dka, ds, &qs[i][c0]);
    }
  }
  if (!kvalid) return;
  float* dkrow = dk + (bh * Tk + kj) * D;
  float* dvrow = dv + (bh * Tk + kj) * D;
#pragma unroll
  for (int d = 0; d < DG; ++d) {
    if (c0 + d < D) {
      dkrow[c0 + d] = dka[d] * scale;
      dvrow[c0 + d] = dva[d];
    }
  }
}

// the padded width DP and the lanes per row G for a head dim D
template <template <int, int> class Launch, typename... Args>
int dispatch(int D, Args... args) {
  if (D <= 8) return Launch<8, 1>::run(args...);
  if (D <= 16) return Launch<16, 1>::run(args...);
  if (D <= 32) return Launch<32, 1>::run(args...);
  if (D <= 64) return Launch<64, 2>::run(args...);
  return Launch<128, 4>::run(args...);
}

template <int DP, int G>
struct Fwd {
  static int run(const float* q, const float* k, const float* v, float* o,
                 float* lse, int bh, int tq, int tk, int d, float scale,
                 int causal, cudaStream_t st) {
    const dim3 grid(bh, (tq + kThreads / G - 1) / (kThreads / G));
    flash_fwd_kernel<DP, G><<<grid, kThreads, 0, st>>>(q, k, v, o, lse, tq,
                                                       tk, d, scale, causal);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int DP, int G>
struct Dq {
  static int run(const float* q, const float* k, const float* v,
                 const float* dout, const float* lse, const float* delta,
                 float* dq, int bh, int tq, int tk, int d, float scale,
                 int causal, cudaStream_t st) {
    const dim3 grid(bh, (tq + kThreads / G - 1) / (kThreads / G));
    flash_dq_kernel<DP, G><<<grid, kThreads, 0, st>>>(
        q, k, v, dout, lse, delta, dq, tq, tk, d, scale, causal);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int DP, int G>
struct Dkv {
  static int run(const float* q, const float* k, const float* v,
                 const float* dout, const float* lse, const float* delta,
                 float* dk, float* dv, int bh, int tq, int tk, int d,
                 float scale, int causal, cudaStream_t st) {
    const dim3 grid(bh, (tk + kThreads / G - 1) / (kThreads / G));
    flash_dkv_kernel<DP, G><<<grid, kThreads, 0, st>>>(
        q, k, v, dout, lse, delta, dk, dv, tq, tk, d, scale, causal);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// q, o: (bh, tq, d); k, v: (bh, tk, d); lse: (bh, tq); contiguous f32.
extern "C" int mxtt_flash_fwd(const float* q, const float* k, const float* v,
                              float* o, float* lse, int bh, int tq, int tk,
                              int d, float scale, int causal, void* stream) {
  if (d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || tq <= 0) return 0;
  return dispatch<Fwd>(d, q, k, v, o, lse, bh, tq, tk, d, scale, causal,
                       static_cast<cudaStream_t>(stream));
}

// dq: (bh, tq, d); dout like q; lse, delta: (bh, tq).
extern "C" int mxtt_flash_dq(const float* q, const float* k, const float* v,
                             const float* dout, const float* lse,
                             const float* delta, float* dq, int bh, int tq,
                             int tk, int d, float scale, int causal,
                             void* stream) {
  if (d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || tq <= 0) return 0;
  return dispatch<Dq>(d, q, k, v, dout, lse, delta, dq, bh, tq, tk, d,
                      scale, causal, static_cast<cudaStream_t>(stream));
}

// dk, dv: (bh, tk, d).
extern "C" int mxtt_flash_dkv(const float* q, const float* k, const float* v,
                              const float* dout, const float* lse,
                              const float* delta, float* dk, float* dv,
                              int bh, int tq, int tk, int d, float scale,
                              int causal, void* stream) {
  if (d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || tk <= 0) return 0;
  return dispatch<Dkv>(d, q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d,
                       scale, causal, static_cast<cudaStream_t>(stream));
}
