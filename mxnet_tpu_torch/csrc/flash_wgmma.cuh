// Pieces shared by the flash kernels on the tensor cores (the split-TF32
// flash_fwd_wgmma.cu and flash_bwd_wgmma.cu, and the bf16
// flash_bf16_wgmma.cu): the 64-byte-swizzled K-major tile layout and its
// wgmma descriptors, mbarrier waits and arrivals that keep a warpgroup's
// control flow uniform, the TF32 hi / lo split of a landed tile (as it lies
// and transposed), the A fragments of a warpgroup's own rows, the tf32
// wgmma by N, the product with a register operand from an accumulator, the
// forward's online softmax of a tile, and the shapes the split-TF32
// kernels take.  ops/build.py passes -I csrc and hashes
// this text into every library's name.
//
// TF32 keeps 10 mantissa bits, so every operand x is split into hi = x with
// its low 13 bits cleared and lo = x - hi with its low 13 bits cleared:
// truncation, so both are exact tf32 values and the tensor cores read
// exactly what was written.  A product is then hi.hi + hi.lo + lo.hi in
// f32 accumulators ("3xTF32").
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr uint32_t kTf32 = 0xFFFFE000u;
constexpr float kNegInf = -1e30f;    // _NEG_INF of the Pallas kernels
constexpr float kHalfNegInf = -5e29f;
constexpr float kLog2e = 1.4426950408889634f;

// byte offset of element (row, k) of a K-major tile of R rows, 64-byte
// swizzle, the K axis in atoms of 16 floats
__device__ __forceinline__ uint32_t sw_off(int row, int k, int R) {
  return (k >> 4) * R * 64 + row * 64 +
         ((((k >> 2) & 3) ^ ((row >> 1) & 3)) << 4) + (k & 3) * 4;
}

// wgmma descriptor of k-step kk (8 floats of K) of such a tile whose
// descriptor is `base` (sw_desc<64> of its address): the address field
// counts 16-byte units, and no offset inside the shared memory window
// carries out of it
__device__ __forceinline__ uint64_t tile_desc(uint64_t base, int R, int kk) {
  return base + (uint32_t)(((kk >> 1) * R * 64 + (kk & 1) * 32) >> 4);
}

// one arrival per warp on an mbarrier, by lane 0, predicated inside the asm
// so the compiler sees no branch around the warpgroup's wgmmas
__device__ __forceinline__ void warp_arrive(uint32_t bar, int lane) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(lane)
      : "memory");
}

// mbarrier wait with the spin inside the asm, so the compiler sees no
// data-dependent branch around the warpgroup's wgmmas
__device__ __forceinline__ void wait_phase(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ uint32_t hi_of(float x) {
  return __float_as_uint(x) & kTf32;
}
__device__ __forceinline__ uint32_t lo_of(float x) {
  return __float_as_uint(x - __uint_as_float(hi_of(x))) & kTf32;
}

__device__ __forceinline__ void split4(float4 x, uint4& hi, uint4& lo) {
  hi = make_uint4(hi_of(x.x), hi_of(x.y), hi_of(x.z), hi_of(x.w));
  lo = make_uint4(lo_of(x.x), lo_of(x.y), lo_of(x.z), lo_of(x.w));
}

// The producer warpgroup's split of a landed tile (BT rows of D floats at
// src; rows at and past `valid` and columns past D read as zero) into hi /
// lo copies, K-major over D (BT rows x DP, at hi / lo).
template <int DP, int BT>
__device__ __forceinline__ void split_rows(const float* src, int valid,
                                           int D, uint8_t* hi, uint8_t* lo,
                                           int tid) {
  constexpr int C = DP / 4;
  for (int it = tid; it < BT * C; it += 128) {
    const int row = it / C, k = (it % C) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < valid && k < D)
      x = *reinterpret_cast<const float4*>(src + row * D + k);
    uint4 h, l;
    split4(x, h, l);
    const uint32_t o = sw_off(row, k, BT);
    *reinterpret_cast<uint4*>(hi + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

// ... and transposed: DP rows (d) x BT positions, K-major over the tile's
// rows, which are permuted within each group of 8 as [0, 2, 4, 6, 1, 3, 5,
// 7] (the order of an A operand taken from an accumulator, see mma_rs):
// positions 4c .. 4c + 3 hold rows 8 (c / 2) + 2 e + c % 2, e = 0..3.
template <int DP, int BT>
__device__ __forceinline__ void split_cols(const float* src, int valid,
                                           int D, uint8_t* hi, uint8_t* lo,
                                           int tid) {
  for (int it = tid; it < DP * (BT / 4); it += 128) {
    const int d = it % DP, c = it / DP;
    const int r0 = 8 * (c >> 1) + (c & 1);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 2 * e;
      v[e] = r < valid && d < D ? src[r * D + d] : 0.f;
    }
    uint4 h, l;
    split4(make_float4(v[0], v[1], v[2], v[3]), h, l);
    const uint32_t o = sw_off(d, 4 * c, DP);
    *reinterpret_cast<uint4*>(hi + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

// wgmma m64nNk8 tf32, A from registers, by N
template <int N> struct Rs;
template <> struct Rs<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
      const uint32_t (&a)[4], uint64_t b, int acc) {
    wgmma_tf32_rs_n16(d, a, b, acc);
  }
};
template <> struct Rs<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
      const uint32_t (&a)[4], uint64_t b, int acc) {
    wgmma_tf32_rs_n32(d, a, b, acc);
  }
};
template <> struct Rs<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
      const uint32_t (&a)[4], uint64_t b, int acc) {
    wgmma_tf32_rs_n64(d, a, b, acc);
  }
};

// A thread's fragments of the warpgroup's 64 own rows of one (., D)
// matrix, k-step by k-step over DP, split: an A operand read once per block
template <int DP> struct Own {
  uint32_t hi[DP / 8][4], lo[DP / 8][4];
};

// rows row0 + r (+ 8) and columns 8 kk + t (+ 4) of the (rows, D) matrix
// src, zeros past either end
template <int DP>
__device__ __forceinline__ void load_own(Own<DP>& o, const float* src,
                                         int row0, int rows, int D, int r,
                                         int t) {
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + r + 8 * (j & 1), col = 8 * kk + t + 4 * (j >> 1);
      const float x = row < rows && col < D ? src[(long long)row * D + col]
                                            : 0.f;
      o.hi[kk][j] = hi_of(x);
      o.lo[kk][j] = lo_of(x);
    }
  }
}

// acc[kk % NA] += X[:, k-step kk] B[k-step kk] over the BT rows of a tile,
// in the first NP passes (hi.hi, hi.lo, lo.hi), pass by pass: X (64 x BT)
// an accumulator of the tile's scores (as p or ds), split into xh / xl; B
// the transposed tile's hi / lo copies (DP x BT, split_cols) at bh / bl.
// The accumulator holds columns (2t, 2t + 1) of each 8-column block where
// the A fragment wants (t, t + 4), so the contraction index runs permuted
// within each group of 8 as [0, 2, 4, 6, 1, 3, 5, 7] (a0..a3 = d0, d2, d1,
// d3), as split_cols writes B.  NA independent accumulators, so
// consecutive wgmmas rarely wait on each other.
template <int NP, int DP, int BT, int NA>
__device__ __forceinline__ void mma_rs(float (&acc)[NA][DP / 2],
                                       const uint32_t (&xh)[BT / 2],
                                       const uint32_t (&xl)[BT / 2],
                                       uint64_t bh, uint64_t bl) {
#pragma unroll
  for (int ps = 0; ps < NP; ++ps) {
#pragma unroll
    for (int kk = 0; kk < BT / 8; ++kk) {
      const uint32_t(&x)[BT / 2] = ps == 2 ? xl : xh;
      const uint32_t a[4] = {x[4 * kk], x[4 * kk + 2], x[4 * kk + 1],
                             x[4 * kk + 3]};
      Rs<DP>::run(acc[kk % NA], a, tile_desc(ps == 1 ? bl : bh, DP, kk), 1);
    }
  }
}

// 2^x by the SFU, flushing to 0 below 2^-126
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one tile of BT keys for the thread's two rows, in
// place (both forward designs, flash_fwd_wgmma.cu and flash_bf16_wgmma.cu): s
// (element e: own row row_lo + r + 8 h, h = (e / 2) % 2, key c0 + 8 nb + 2 t
// + c, nb = e / 4, c = e % 2) becomes p.  m holds the rows' running max (the
// same in the quad of lanes that share r: its 64 keys), l the thread's
// partial running sums over its own keys (summed over the quad at the end),
// corr the factor l and the output accumulators take.  MASK: the diagonal
// or the ragged end crosses the tile.
//
// s = fl(acc * scale), as the reference rounds it; p = 2^(s log2(e) - m_safe
// log2(e)) by one FMA and ex2.approx (relative error ~2^-22).  An argument
// below -126 gives 0, so p = 0 wherever s <= -5e29 (a masked score, or a
// score one float step or more below a running max above -5e29): the
// reference's select holds without one.  The max and the sums run as trees
// of four partials (partial j takes nb = j, j + 4; c = 0, 1 in that order).
template <int BT, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BT / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float scale, int row_lo, int r,
                                             int t, int c0, int Tk,
                                             int causal) {
  float mx[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < 4; ++j) mx[h][j] = kNegInf;
  }
#pragma unroll
  for (int e = 0; e < BT / 2; ++e) {
    const int h = (e >> 1) & 1, j = (e >> 2) & 3;
    float x = __fmul_rn(s[e], scale);
    if (MASK) {
      const int qi = row_lo + r + 8 * h;
      const int kj = c0 + 8 * (e >> 2) + 2 * t + (e & 1);
      if (kj >= Tk || (causal && kj > qi)) x = kNegInf;
    }
    s[e] = x;
    mx[h][j] = fmaxf(mx[h][j], x);
  }
  float ml[2];   // m_safe log2(e)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x = fmaxf(fmaxf(mx[h][0], mx[h][1]), fmaxf(mx[h][2], mx[h][3]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(m[h], x);
    ml[h] = (m_new <= kHalfNegInf ? 0.f : m_new) * kLog2e;
    corr[h] = m[h] <= kHalfNegInf
                  ? 0.f
                  : exp2_approx(fmaf(m[h], kLog2e, -ml[h]));
    m[h] = m_new;
  }
  float sum[2][4] = {};
#pragma unroll
  for (int e = 0; e < BT / 2; ++e) {
    const int h = (e >> 1) & 1, j = (e >> 2) & 3;
    const float p = exp2_approx(fmaf(s[e], kLog2e, -ml[h]));
    s[e] = p;
    sum[h][j] += p;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    l[h] = l[h] * corr[h] +
           ((sum[h][0] + sum[h][1]) + (sum[h][2] + sum[h][3]));
}

// D % 4 == 0 up to 32 (a row is whole 16-byte units for the bulk copies;
// at D = 64 the accumulators and split operands outgrow the registers),
// the streamed operands 16-byte aligned
bool takes(const void* const* ptrs, int n, int d) {
  if (d < 1 || d > 32 || d % 4 != 0) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  return true;
}

}  // namespace
