// Flash attention over (BH, T, D) f32 or bf16: the Hopper port of the three
// TPU kernels of mxnet_tpu/ops/pallas_kernels.py that ring attention runs on
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
// no TMA): G threads own one row (G = 1 up to D = 32, 2 at 64, 4 at 128,
// 8 above), each holding D/G of its columns (every G-th float4 of the
// row, so that the G lanes read consecutive ones: no bank conflict) of
// q (forward, dq) or k and v (dkv) and the accumulators in registers;
// the other operand's tiles (32 rows, 16 above D = 128) sit in shared
// memory, where the row groups of a warp read the same row, a
// broadcast.  A row's partial dot products meet through G-lane
// shuffles.  Causal blocks skip the K tiles (Q tiles for
// dkv) that lie wholly on the masked side of the diagonal.  D is padded
// to 8, 16, 32, 64, 128, 192 or 256 with zeros (exact: 0 * 0 adds
// nothing).
//
// Any head dim above 256 runs the wide kernels: D in chunks of 256, the
// registers holding one chunk of a row.  The scores (and dp) are summed
// over the chunks; the output (dq, dk / dv) is made one chunk per pass
// over the keys (queries), each pass recomputing the scores.  The
// forward's first pass takes the running max and the sum of exponentials
// alone; each later pass sums exp(s - m) v over one chunk and divides by
// the same denominator, as the Pallas body does at the end.
//
// Sizes: every row offset is 64-bit ((bh * T + i) * D), and the blocks
// walk a flat 64-bit index of (bh, tile) pairs, so no product of BH, T
// and D is bounded by int.  mxtt_flash_simt_shape reports the padded
// width, lanes per row, tile rows and chunks chosen for a head dim
// (ops/pallas_kernels.py simt_launch_shape is the same table).
//
// The element type: every kernel is a template over the type of q, k, v,
// dO and the outputs (o, dq, dk, dv), instantiated for float and for
// __nv_bfloat16 (the mxtt_flash_*_bf16 entries, the reference kernels on
// bf16 operands: out_shape q.dtype, dq/dk/dv cast to the input dtype).
// Only the loads and stores convert: a bf16 operand is widened to f32 as it
// is loaded into registers or shared memory, every product, the softmax
// and the sums run in f32 as for float, and each output element is rounded
// to nearest-even once, as it is stored.  lse and delta are f32 for both.
// A bf16 x bf16 product is exact in f32, so s = q.k has no rounding beyond
// the f32 sum, as the reference's preferred_element_type=float32 dot.
//
// expf / logf stay IEEE: no --use_fast_math.  Built by
// mxnet_tpu_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (mxnet_tpu_torch/ops/pallas_kernels.py).  Each entry
// point launches on `stream`, allocates nothing, and returns
// cudaGetLastError() (0 on success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// the element type's widening load and rounding store
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void put(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

constexpr float kNegInf = -1e30f;      // _NEG_INF of the Pallas kernels
constexpr float kHalfNegInf = -5e29f;  // _NEG_INF / 2
constexpr int kThreads = 128;
constexpr int kWide = 256;             // the chunk of D above 256
constexpr int kMaxGrid = 1 << 20;      // blocks launched; each walks more

// sum over the G lanes that own one row (G divides 32, groups aligned)
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows row0 .. row0 + TR - 1, columns d0 .. d0 + DP - 1 of a (rows, D)
// matrix into dst[TR][DP], zeros past the matrix's last row and column
template <int DP, int TR, typename T>
__device__ __forceinline__ void load_tile(float (*dst)[DP],
                                          const T* __restrict__ src,
                                          int row0, int rows, int D,
                                          int d0 = 0) {
  for (int e = threadIdx.x; e < TR * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    const int row = row0 + r;
    dst[r][c] = (row < rows && d0 + c < D)
                    ? to_f(src[(long long)row * D + d0 + c]) : 0.f;
  }
}

// A row's D columns are float4 units; lane `sub` of the row's G lanes holds
// units sub, sub + G, sub + 2G, ... (DG / 4 of them), so the G lanes of a
// row read consecutive units of a shared-memory row: no bank conflict.
template <int DG, int G>
__device__ __forceinline__ float dot_slice(const float* a,
                                           const float* __restrict__ b,
                                           int sub) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < DG / 4; ++i) {
    const float4 x = b4[i * G + sub];
    s = fmaf(a[4 * i], x.x, s);
    s = fmaf(a[4 * i + 1], x.y, s);
    s = fmaf(a[4 * i + 2], x.z, s);
    s = fmaf(a[4 * i + 3], x.w, s);
  }
  return s;
}

template <int DG, int G>
__device__ __forceinline__ void axpy_slice(float* acc, float p,
                                           const float* __restrict__ b,
                                           int sub) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll
  for (int i = 0; i < DG / 4; ++i) {
    const float4 x = b4[i * G + sub];
    acc[4 * i] = fmaf(p, x.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(p, x.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(p, x.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(p, x.w, acc[4 * i + 3]);
  }
}

// register d of lane sub holds column ((d / 4) G + sub) 4 + d % 4
template <int G>
__device__ __forceinline__ int col_of(int d, int sub) {
  return ((d / 4) * G + sub) * 4 + d % 4;
}

template <int DG, int G, typename T>
__device__ __forceinline__ void load_row(float* dst,
                                         const T* __restrict__ row,
                                         bool valid, int sub, int D) {
#pragma unroll
  for (int d = 0; d < DG; ++d) {
    const int c = col_of<G>(d, sub);
    dst[d] = (valid && c < D) ? to_f(row[c]) : 0.f;
  }
}

template <int DG, int G, typename T>
__device__ __forceinline__ void store_row(T* __restrict__ row,
                                          const float* acc, float mul,
                                          bool divide, int sub, int D) {
#pragma unroll
  for (int d = 0; d < DG; ++d) {
    const int c = col_of<G>(d, sub);
    if (c < D) put(row + c, divide ? acc[d] / mul : acc[d] * mul);
  }
}

// ---------------------------------------------------------------------------
// forward: one block per (bh, q-tile of kThreads / G rows)
// ---------------------------------------------------------------------------
template <int DP, int G, int TR, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Tq, int Tk, int D, float scale,
                 int causal, long long n_bh, long long n_blocks) {
  constexpr int DG = DP / G;
  constexpr int BQ = kThreads / G;
  __shared__ __align__(16) float ks[TR][DP];
  __shared__ __align__(16) float vs[TR][DP];
  const int sub = threadIdx.x % G;
  for (long long b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const long long bh = b % n_bh;
    const int q0 = static_cast<int>(b / n_bh) * BQ;
    const int qi = q0 + threadIdx.x / G;
    const bool qvalid = qi < Tq;
    float qr[DG], acc[DG];
    load_row<DG, G>(qr, q + (bh * Tq + qi) * D, qvalid, sub, D);
#pragma unroll
    for (int d = 0; d < DG; ++d) acc[d] = 0.f;
    float m = kNegInf, l = 0.f;
    const T* kb = k + bh * Tk * D;
    const T* vb = v + bh * Tk * D;
    // causal: keys past the block's last row are masked for every row
    const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
    for (int k0 = 0; k0 < k_end; k0 += TR) {
      __syncthreads();
      load_tile<DP, TR>(ks, kb, k0, Tk, D);
      load_tile<DP, TR>(vs, vb, k0, Tk, D);
      __syncthreads();
      float s[TR];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        const float dot =
            group_sum<G>(dot_slice<DG, G>(qr, ks[j], sub)) * scale;
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
      for (int j = 0; j < TR; ++j) {
        s[j] = s[j] <= kHalfNegInf ? 0.f : expf(s[j] - m_safe);
        psum += s[j];
      }
      l = l * corr + psum;
#pragma unroll
      for (int d = 0; d < DG; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < TR; ++j) axpy_slice<DG, G>(acc, s[j], vs[j], sub);
      m = m_new;
    }
    if (qvalid) {
      const float denom = fmaxf(l, 1e-30f);
      store_row<DG, G>(o + (bh * Tq + qi) * D, acc, denom, true, sub, D);
      if (sub == 0) lse[bh * Tq + qi] = m + logf(denom);
    }
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (bh, q-tile), a loop over K tiles
// ---------------------------------------------------------------------------
template <int DP, int G, int TR, typename T>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq,
                int Tq, int Tk, int D, float scale, int causal,
                long long n_bh, long long n_blocks) {
  constexpr int DG = DP / G;
  constexpr int BQ = kThreads / G;
  __shared__ __align__(16) float ks[TR][DP];
  __shared__ __align__(16) float vs[TR][DP];
  const int sub = threadIdx.x % G;
  for (long long b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const long long bh = b % n_bh;
    const int q0 = static_cast<int>(b / n_bh) * BQ;
    const int qi = q0 + threadIdx.x / G;
    const bool qvalid = qi < Tq;
    float qr[DG], dor[DG], acc[DG];
    load_row<DG, G>(qr, q + (bh * Tq + qi) * D, qvalid, sub, D);
    load_row<DG, G>(dor, dout + (bh * Tq + qi) * D, qvalid, sub, D);
#pragma unroll
    for (int d = 0; d < DG; ++d) acc[d] = 0.f;
    const float lse_i = qvalid ? lse[bh * Tq + qi] : 0.f;
    const float delta_i = qvalid ? delta[bh * Tq + qi] : 0.f;
    const T* kb = k + bh * Tk * D;
    const T* vb = v + bh * Tk * D;
    const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
    for (int k0 = 0; k0 < k_end; k0 += TR) {
      __syncthreads();
      load_tile<DP, TR>(ks, kb, k0, Tk, D);
      load_tile<DP, TR>(vs, vb, k0, Tk, D);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < TR; ++j) {
        const float s =
            group_sum<G>(dot_slice<DG, G>(qr, ks[j], sub)) * scale;
        const float dp = group_sum<G>(dot_slice<DG, G>(dor, vs[j], sub));
        const int kj = k0 + j;
        const bool valid = qvalid && kj < Tk && (!causal || qi >= kj);
        const float p = valid ? expf(s - lse_i) : 0.f;
        const float ds = valid ? p * (dp - delta_i) : 0.f;
        axpy_slice<DG, G>(acc, ds, ks[j], sub);
      }
    }
    if (qvalid)
      store_row<DG, G>(dq + (bh * Tq + qi) * D, acc, scale, false, sub, D);
  }
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (bh, k-tile), a loop over Q tiles (k-major)
// ---------------------------------------------------------------------------
template <int DP, int G, int TR, typename T>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int Tq, int Tk, int D, float scale,
                 int causal, long long n_bh, long long n_blocks) {
  constexpr int DG = DP / G;
  constexpr int BK = kThreads / G;
  __shared__ __align__(16) float qs[TR][DP];
  __shared__ __align__(16) float dos[TR][DP];
  __shared__ float lses[TR];
  __shared__ float dels[TR];
  const int sub = threadIdx.x % G;
  for (long long b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const long long bh = b % n_bh;
    const int k0 = static_cast<int>(b / n_bh) * BK;
    const int kj = k0 + threadIdx.x / G;
    const bool kvalid = kj < Tk;
    float kr[DG], vr[DG], dka[DG], dva[DG];
    load_row<DG, G>(kr, k + (bh * Tk + kj) * D, kvalid, sub, D);
    load_row<DG, G>(vr, v + (bh * Tk + kj) * D, kvalid, sub, D);
#pragma unroll
    for (int d = 0; d < DG; ++d) dka[d] = dva[d] = 0.f;
    const T* qb = q + bh * Tq * D;
    const T* db = dout + bh * Tq * D;
    // causal: queries before the block's first key see none of its keys
    const int q_begin = causal ? min(k0, Tq) : 0;
    for (int qt = q_begin; qt < Tq; qt += TR) {
      __syncthreads();
      load_tile<DP, TR>(qs, qb, qt, Tq, D);
      load_tile<DP, TR>(dos, db, qt, Tq, D);
      if (threadIdx.x < TR) {
        const int row = qt + threadIdx.x;
        lses[threadIdx.x] = row < Tq ? lse[bh * Tq + row] : 0.f;
        dels[threadIdx.x] = row < Tq ? delta[bh * Tq + row] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < TR; ++i) {
        const float s =
            group_sum<G>(dot_slice<DG, G>(kr, qs[i], sub)) * scale;
        const float dp = group_sum<G>(dot_slice<DG, G>(vr, dos[i], sub));
        const int qi = qt + i;
        const bool valid = kvalid && qi < Tq && (!causal || qi >= kj);
        const float p = valid ? expf(s - lses[i]) : 0.f;
        const float ds = valid ? p * (dp - dels[i]) : 0.f;
        axpy_slice<DG, G>(dva, p, dos[i], sub);
        axpy_slice<DG, G>(dka, ds, qs[i], sub);
      }
    }
    if (kvalid) {
      store_row<DG, G>(dk + (bh * Tk + kj) * D, dka, scale, false, sub, D);
      store_row<DG, G>(dv + (bh * Tk + kj) * D, dva, 1.f, false, sub, D);
    }
  }
}

// ---------------------------------------------------------------------------
// the wide kernels (D > 256): D in chunks of DC, one chunk of a row in
// registers; scores summed over the chunks, outputs one chunk per pass
// ---------------------------------------------------------------------------

// s[j] (+)= the chunks' q.k (or dO.v) of row x against rows r0 .. r0 +
// TR - 1 of y, chunk by chunk through tile; x's chunk is reloaded per
// chunk.  Syncs inside: every thread of the block calls it.
template <int DC, int G, int TR, typename T>
__device__ __forceinline__ void chunk_dots(float* s, float (*tile)[DC],
                                           const T* __restrict__ x,
                                           bool xvalid,
                                           const T* __restrict__ y,
                                           int r0, int rows, int D, int sub) {
  constexpr int DG = DC / G;
#pragma unroll
  for (int j = 0; j < TR; ++j) s[j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += DC) {
    float xr[DG];
    load_row<DG, G>(xr, x + d0, xvalid, sub, D - d0);
    __syncthreads();
    load_tile<DC, TR>(tile, y, r0, rows, D, d0);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TR; ++j)
      s[j] += group_sum<G>(dot_slice<DG, G>(xr, tile[j], sub));
  }
}

template <int DC, int G, int TR, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const T* __restrict__ q,
                      const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int Tq, int Tk, int D,
                      float scale, int causal, long long n_bh,
                      long long n_blocks) {
  constexpr int DG = DC / G;
  constexpr int BQ = kThreads / G;
  __shared__ __align__(16) float ts[TR][DC];
  const int sub = threadIdx.x % G;
  for (long long b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const long long bh = b % n_bh;
    const int q0 = static_cast<int>(b / n_bh) * BQ;
    const int qi = q0 + threadIdx.x / G;
    const bool qvalid = qi < Tq;
    const T* qrow = q + (bh * Tq + qi) * D;
    const T* kb = k + bh * Tk * D;
    const T* vb = v + bh * Tk * D;
    const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
    // pass 0: the running max and the sum of exponentials
    float m = kNegInf, l = 0.f;
    for (int k0 = 0; k0 < k_end; k0 += TR) {
      float s[TR];
      chunk_dots<DC, G, TR>(s, ts, qrow, qvalid, kb, k0, Tk, D, sub);
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        const int kj = k0 + j;
        const bool valid = kj < Tk && (!causal || qi >= kj);
        s[j] = valid ? s[j] * scale : kNegInf;
        mt = fmaxf(mt, s[j]);
      }
      const float m_new = fmaxf(m, mt);
      const float m_safe = m_new <= kHalfNegInf ? 0.f : m_new;
      const float corr = m <= kHalfNegInf ? 0.f : expf(m - m_safe);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < TR; ++j)
        psum += s[j] <= kHalfNegInf ? 0.f : expf(s[j] - m_safe);
      l = l * corr + psum;
      m = m_new;
    }
    const float m_safe = m <= kHalfNegInf ? 0.f : m;
    const float denom = fmaxf(l, 1e-30f);
    // one pass per chunk of the output
    for (int d0 = 0; d0 < D; d0 += DC) {
      float acc[DG];
#pragma unroll
      for (int d = 0; d < DG; ++d) acc[d] = 0.f;
      for (int k0 = 0; k0 < k_end; k0 += TR) {
        float s[TR];
        chunk_dots<DC, G, TR>(s, ts, qrow, qvalid, kb, k0, Tk, D, sub);
#pragma unroll
        for (int j = 0; j < TR; ++j) {
          const int kj = k0 + j;
          const bool valid = kj < Tk && (!causal || qi >= kj);
          const float sj = valid ? s[j] * scale : kNegInf;
          s[j] = sj <= kHalfNegInf ? 0.f : expf(sj - m_safe);
        }
        __syncthreads();
        load_tile<DC, TR>(ts, vb, k0, Tk, D, d0);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < TR; ++j) axpy_slice<DG, G>(acc, s[j], ts[j], sub);
      }
      if (qvalid)
        store_row<DG, G>(o + (bh * Tq + qi) * D + d0, acc, denom, true, sub,
                      D - d0);
    }
    if (qvalid && sub == 0) lse[bh * Tq + qi] = m + logf(denom);
  }
}

template <int DC, int G, int TR, typename T>
__global__ void __launch_bounds__(kThreads)
flash_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     int Tq, int Tk, int D, float scale, int causal,
                     long long n_bh, long long n_blocks) {
  constexpr int DG = DC / G;
  constexpr int BQ = kThreads / G;
  __shared__ __align__(16) float ts[TR][DC];
  const int sub = threadIdx.x % G;
  for (long long b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const long long bh = b % n_bh;
    const int q0 = static_cast<int>(b / n_bh) * BQ;
    const int qi = q0 + threadIdx.x / G;
    const bool qvalid = qi < Tq;
    const T* qrow = q + (bh * Tq + qi) * D;
    const T* dorow = dout + (bh * Tq + qi) * D;
    const float lse_i = qvalid ? lse[bh * Tq + qi] : 0.f;
    const float delta_i = qvalid ? delta[bh * Tq + qi] : 0.f;
    const T* kb = k + bh * Tk * D;
    const T* vb = v + bh * Tk * D;
    const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
    for (int d0 = 0; d0 < D; d0 += DC) {
      float acc[DG];
#pragma unroll
      for (int d = 0; d < DG; ++d) acc[d] = 0.f;
      for (int k0 = 0; k0 < k_end; k0 += TR) {
        float s[TR], dp[TR];
        chunk_dots<DC, G, TR>(s, ts, qrow, qvalid, kb, k0, Tk, D, sub);
        chunk_dots<DC, G, TR>(dp, ts, dorow, qvalid, vb, k0, Tk, D, sub);
#pragma unroll
        for (int j = 0; j < TR; ++j) {
          const int kj = k0 + j;
          const bool valid = qvalid && kj < Tk && (!causal || qi >= kj);
          const float p = valid ? expf(s[j] * scale - lse_i) : 0.f;
          s[j] = valid ? p * (dp[j] - delta_i) : 0.f;
        }
        __syncthreads();
        load_tile<DC, TR>(ts, kb, k0, Tk, D, d0);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < TR; ++j) axpy_slice<DG, G>(acc, s[j], ts[j], sub);
      }
      if (qvalid)
        store_row<DG, G>(dq + (bh * Tq + qi) * D + d0, acc, scale, false, sub,
                      D - d0);
    }
  }
}

template <int DC, int G, int TR, typename T>
__global__ void __launch_bounds__(kThreads)
flash_dkv_wide_kernel(const T* __restrict__ q,
                      const T* __restrict__ k,
                      const T* __restrict__ v,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int Tq,
                      int Tk, int D, float scale, int causal,
                      long long n_bh, long long n_blocks) {
  constexpr int DG = DC / G;
  constexpr int BK = kThreads / G;
  __shared__ __align__(16) float ts[TR][DC];
  __shared__ float lses[TR];
  __shared__ float dels[TR];
  const int sub = threadIdx.x % G;
  for (long long b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const long long bh = b % n_bh;
    const int k0 = static_cast<int>(b / n_bh) * BK;
    const int kj = k0 + threadIdx.x / G;
    const bool kvalid = kj < Tk;
    const T* krow = k + (bh * Tk + kj) * D;
    const T* vrow = v + (bh * Tk + kj) * D;
    const T* qb = q + bh * Tq * D;
    const T* db = dout + bh * Tq * D;
    const int q_begin = causal ? min(k0, Tq) : 0;
    for (int d0 = 0; d0 < D; d0 += DC) {
      float dka[DG], dva[DG];
#pragma unroll
      for (int d = 0; d < DG; ++d) dka[d] = dva[d] = 0.f;
      for (int qt = q_begin; qt < Tq; qt += TR) {
        float s[TR], dp[TR];
        __syncthreads();
        if (threadIdx.x < TR) {
          const int row = qt + threadIdx.x;
          lses[threadIdx.x] = row < Tq ? lse[bh * Tq + row] : 0.f;
          dels[threadIdx.x] = row < Tq ? delta[bh * Tq + row] : 0.f;
        }
        chunk_dots<DC, G, TR>(s, ts, krow, kvalid, qb, qt, Tq, D, sub);
        chunk_dots<DC, G, TR>(dp, ts, vrow, kvalid, db, qt, Tq, D, sub);
        float p[TR];
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int qi = qt + i;
          const bool valid = kvalid && qi < Tq && (!causal || qi >= kj);
          p[i] = valid ? expf(s[i] * scale - lses[i]) : 0.f;
          s[i] = valid ? p[i] * (dp[i] - dels[i]) : 0.f;
        }
        __syncthreads();
        load_tile<DC, TR>(ts, db, qt, Tq, D, d0);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < TR; ++i) axpy_slice<DG, G>(dva, p[i], ts[i], sub);
        __syncthreads();
        load_tile<DC, TR>(ts, qb, qt, Tq, D, d0);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < TR; ++i) axpy_slice<DG, G>(dka, s[i], ts[i], sub);
      }
      if (kvalid) {
        store_row<DG, G>(dk + (bh * Tk + kj) * D + d0, dka, scale, false, sub,
                      D - d0);
        store_row<DG, G>(dv + (bh * Tk + kj) * D + d0, dva, 1.f, false, sub,
                      D - d0);
      }
    }
  }
}

// the launch shape of a head dim D: {padded width (the chunk above 256),
// lanes per row G, tile rows, chunks}
struct Shape {
  int dp, g, tr, chunks;
};

Shape shape_of(int D) {
  if (D <= 8) return {8, 1, 32, 1};
  if (D <= 16) return {16, 1, 32, 1};
  if (D <= 32) return {32, 1, 32, 1};
  if (D <= 64) return {64, 2, 32, 1};
  if (D <= 128) return {128, 4, 32, 1};
  if (D <= 192) return {192, 8, 16, 1};
  if (D <= 256) return {256, 8, 16, 1};
  return {kWide, 8, 16, (D + kWide - 1) / kWide};
}

// the padded width DP, lanes per row G and tile rows TR for a head dim D;
// Launch<..., true> is the wide kernels' (D > 256)
template <template <int, int, int, bool> class Launch, typename... Args>
int dispatch(int D, Args... args) {
  if (D <= 8) return Launch<8, 1, 32, false>::run(args...);
  if (D <= 16) return Launch<16, 1, 32, false>::run(args...);
  if (D <= 32) return Launch<32, 1, 32, false>::run(args...);
  if (D <= 64) return Launch<64, 2, 32, false>::run(args...);
  if (D <= 128) return Launch<128, 4, 32, false>::run(args...);
  if (D <= 192) return Launch<192, 8, 16, false>::run(args...);
  if (D <= 256) return Launch<256, 8, 16, false>::run(args...);
  return Launch<kWide, 8, 16, true>::run(args...);
}

// (heads, blocks in all, blocks launched) for T rows of bh heads; block b
// is head b % bh of tile b / bh (the order of a (bh, tiles) grid)
struct Grid {
  long long bh, blocks;
  unsigned launched;
};

Grid grid_of(long long bh, long long t, int rows_per_block) {
  Grid g;
  g.bh = bh;
  g.blocks = (t + rows_per_block - 1) / rows_per_block * bh;
  g.launched = static_cast<unsigned>(g.blocks < kMaxGrid ? g.blocks
                                                         : kMaxGrid);
  return g;
}

template <int DP, int G, int TR, bool WIDE>
struct Fwd {
  template <typename T>
  static int run(const T* q, const T* k, const T* v, T* o,
                 float* lse, int bh, int tq, int tk, int d, float scale,
                 int causal, cudaStream_t st) {
    const Grid g = grid_of(bh, tq, kThreads / G);
    if constexpr (WIDE)
      flash_fwd_wide_kernel<DP, G, TR, T><<<g.launched, kThreads, 0, st>>>(
          q, k, v, o, lse, tq, tk, d, scale, causal, g.bh, g.blocks);
    else
      flash_fwd_kernel<DP, G, TR, T><<<g.launched, kThreads, 0, st>>>(
          q, k, v, o, lse, tq, tk, d, scale, causal, g.bh, g.blocks);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int DP, int G, int TR, bool WIDE>
struct Dq {
  template <typename T>
  static int run(const T* q, const T* k, const T* v,
                 const T* dout, const float* lse, const float* delta,
                 T* dq, int bh, int tq, int tk, int d, float scale,
                 int causal, cudaStream_t st) {
    const Grid g = grid_of(bh, tq, kThreads / G);
    if constexpr (WIDE)
      flash_dq_wide_kernel<DP, G, TR, T><<<g.launched, kThreads, 0, st>>>(
          q, k, v, dout, lse, delta, dq, tq, tk, d, scale, causal, g.bh,
          g.blocks);
    else
      flash_dq_kernel<DP, G, TR, T><<<g.launched, kThreads, 0, st>>>(
          q, k, v, dout, lse, delta, dq, tq, tk, d, scale, causal, g.bh,
          g.blocks);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int DP, int G, int TR, bool WIDE>
struct Dkv {
  template <typename T>
  static int run(const T* q, const T* k, const T* v,
                 const T* dout, const float* lse, const float* delta,
                 T* dk, T* dv, int bh, int tq, int tk, int d,
                 float scale, int causal, cudaStream_t st) {
    const Grid g = grid_of(bh, tk, kThreads / G);
    if constexpr (WIDE)
      flash_dkv_wide_kernel<DP, G, TR, T><<<g.launched, kThreads, 0, st>>>(
          q, k, v, dout, lse, delta, dk, dv, tq, tk, d, scale, causal,
          g.bh, g.blocks);
    else
      flash_dkv_kernel<DP, G, TR, T><<<g.launched, kThreads, 0, st>>>(
          q, k, v, dout, lse, delta, dk, dv, tq, tk, d, scale, causal,
          g.bh, g.blocks);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// out[4] = {padded width (the chunk above 256), lanes per row, tile rows,
// chunks} of head dim d; returns cudaErrorInvalidValue for d < 1.
extern "C" int mxtt_flash_simt_shape(int d, int* out) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = shape_of(d);
  out[0] = s.dp;
  out[1] = s.g;
  out[2] = s.tr;
  out[3] = s.chunks;
  return 0;
}

// q, o: (bh, tq, d); k, v: (bh, tk, d); lse: (bh, tq); contiguous f32.
extern "C" int mxtt_flash_fwd(const float* q, const float* k, const float* v,
                              float* o, float* lse, int bh, int tq, int tk,
                              int d, float scale, int causal, void* stream) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
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
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
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
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || tk <= 0) return 0;
  return dispatch<Dkv>(d, q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d,
                       scale, causal, static_cast<cudaStream_t>(stream));
}

// The bf16 route: the same entries on __nv_bfloat16 q, k, v, dout and
// outputs (o, dq, dk, dv); lse and delta stay f32.
extern "C" int mxtt_flash_fwd_bf16(const __nv_bfloat16* q,
                                   const __nv_bfloat16* k,
                                   const __nv_bfloat16* v, __nv_bfloat16* o,
                                   float* lse, int bh, int tq, int tk, int d,
                                   float scale, int causal, void* stream) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || tq <= 0) return 0;
  return dispatch<Fwd>(d, q, k, v, o, lse, bh, tq, tk, d, scale, causal,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int mxtt_flash_dq_bf16(const __nv_bfloat16* q,
                                  const __nv_bfloat16* k,
                                  const __nv_bfloat16* v,
                                  const __nv_bfloat16* dout, const float* lse,
                                  const float* delta, __nv_bfloat16* dq,
                                  int bh, int tq, int tk, int d, float scale,
                                  int causal, void* stream) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || tq <= 0) return 0;
  return dispatch<Dq>(d, q, k, v, dout, lse, delta, dq, bh, tq, tk, d,
                      scale, causal, static_cast<cudaStream_t>(stream));
}

extern "C" int mxtt_flash_dkv_bf16(const __nv_bfloat16* q,
                                   const __nv_bfloat16* k,
                                   const __nv_bfloat16* v,
                                   const __nv_bfloat16* dout,
                                   const float* lse, const float* delta,
                                   __nv_bfloat16* dk, __nv_bfloat16* dv,
                                   int bh, int tq, int tk, int d, float scale,
                                   int causal, void* stream) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || tk <= 0) return 0;
  return dispatch<Dkv>(d, q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d,
                       scale, causal, static_cast<cudaStream_t>(stream));
}
