// Tensor-core building blocks shared by the float32 window-attention kernels
// (window_attention.cu, window_attention_bwd.cu): warp-level mma.sync
// m16n8k8 with TF32 operands and float32 accumulation, run three times per
// product on hi/lo splits of both operands (3xTF32), fragment loads, cp.async
// staging of a window's head group as float32, and the closed forms of a
// window whose keys are all masked. The pieces that do not depend on the
// element type (cp.async, quad reductions, the key bias, warps per block)
// come from tc_tiles.cuh.
//
// 3xTF32. One TF32 operand keeps 10 of float32's 23 mantissa bits, so one
// TF32 product is good to about 2^-11 relative: not float32. Each operand x
// is split as hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), and
// a . b ~ lo_a . hi_b + hi_a . lo_b + hi_a . hi_b, accumulated in float32:
// about 22 bits, at a third of the TF32 rate (494.7 / 3 = 165 TFLOP/s on
// the H100 SXM against 67 on the CUDA cores). lo_a . lo_b (2^-22 relative)
// is dropped. The two small products go first, and consecutive mma go to
// different accumulators where the product has more than one.
//
// Layout in shared memory. A block owns one window and a group of G adjacent
// heads. Each staged tensor is [Tp][rs] float32: Tp = T rounded up to 16,
// head j of the group at columns [j * HD, (j + 1) * HD), rs = G * HD + 4.
// HD is a multiple of 8, so rs = 4 (mod 8): eight rows rs apart start in
// eight distinct 4-bank groups, and rows 2 rs apart in four groups 8 banks
// apart. Rows [T, Tp) are zero. rs * 4 bytes is a multiple of 16, as
// cp.async and ldmatrix need.
//
// Fragments (PTX ISA, mma.m16n8k8 with .tf32): lane = 4 * gid + tig. A 16x8
// (row-major) holds rows gid (a0, a2) and gid + 8 (a1, a3) at columns tig
// (a0, a1) and tig + 4 (a2, a3). B 8x8 (column-major) holds k = tig (b0) and
// k = tig + 4 (b1) at column n = gid. C 16x8 holds rows gid (c0, c1) and
// gid + 8 (c2, c3) at columns 2 tig (c0, c2) and 2 tig + 1 (c1, c3).
//
// Loads. A fragments and the B fragments whose n runs down the staged rows
// (k along them: K for q . k^T) come from ldmatrix.x4 on the 8x8 b16 tiles
// reinterpreted as 8x4 32-bit tiles: lane l receives word (l / 4, l % 4) of
// each tile, which is (gid, tig), the TF32 layout. B fragments whose k runs
// down the rows (V for P . V) are read with 32-bit ld.shared: ldmatrix.trans
// would transpose 16-bit halves.
//
// P stays in registers. A C tile holds key columns 2 tig and 2 tig + 1, the A
// operand of the next product wants k = tig and tig + 4. So the k index is
// permuted within each 8-key step: k = tig is key 2 tig and k = tig + 4 is
// key 2 tig + 1. Then a0..a3 = c0, c2, c1, c3 and the B rows are read with
// the same permutation (b0 from row 2 tig, b1 from row 2 tig + 1). The sum
// over keys does not depend on their order, and no shuffle is needed.
#pragma once

#include <math.h>
#include <stdint.h>

#include "tc_tiles.cuh"

namespace tf32 {

using tc::kLog2e;
using tc::kMaskedLogit2;

// One head's row segment in a block: G heads of HD float32 columns, at most
// 64 bytes (two whole sectors) unless one head is wider (G = 1 at hd = 32).
constexpr int kRowBytes = 64;

// cvt.rna.tf32.f32 of a finite x: round half away from zero to 10 mantissa
// bits, on the bit pattern. Two integer instructions; the PTX instruction
// compiles to seven on sm_90a (a guard for inf and NaN, which the attention's
// finite inputs never take).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 22 bits: hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x -
// hi). lo is left unmasked: the mma reads the 19 high bits of a .tf32
// operand and ignores the rest (ptxas itself relies on it in cvt's code), so
// adding the rounding half is all that rna needs.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// Four 8x4 32-bit tiles read as ldmatrix's 8x8 b16 tiles; lane l gives the
// address of row l % 8 of tile l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  tc::ldsm_x4(r, reinterpret_cast<const tc::bf16*>(p));
}

// d += a . b, one 16x8x8 TF32 product on the tensor cores. Not volatile: it
// touches registers only, so the compiler may interleave independent ones.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragments (hi and lo) of the 16-row strip at row0 of a staged head,
// KS k-steps of 8 columns.
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&hi)[KS][4],
                                       uint32_t (&lo)[KS][4],
                                       const float* base, int rs, int row0,
                                       int lane) {
  const float* p =
      base + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * rs + (lane >> 4) * 4;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t r[4];
    ldsm_x4(r, p + kk * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split(__uint_as_float(r[i]), hi[kk][i], lo[kk][i]);
    }
  }
}

// s = a . b^T against rows row0 .. row0 + 15 of a staged head b (k along
// its columns): two 16x8 C tiles, b's rows row0 .. +7 and row0 + 8 .. +15.
// 3xTF32, or with kOne a single TF32 product hi_a . hi_b.
template <int KS, bool kOne = false>
__device__ __forceinline__ void product_rows(const uint32_t (&ah)[KS][4],
                                             const uint32_t (&al)[KS][4],
                                             const float* b, int rs, int row0,
                                             int lane, float (&s)[2][4]) {
#pragma unroll
  for (int x = 0; x < 2; ++x) s[x][0] = s[x][1] = s[x][2] = s[x][3] = 0.0f;
  const float* p =
      b + (row0 + (lane & 7) + (lane >> 4) * 8) * rs + ((lane >> 3) & 1) * 4;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t h[4], l[4];   // b0, b1 of the first tile, then of the second
    ldsm_x4(h, p + kk * 8);
    if (kOne) {
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = to_tf32(__uint_as_float(h[i]));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) split(__uint_as_float(h[i]), h[i], l[i]);
      mma(s[0], al[kk], h[0], h[1]);
      mma(s[1], al[kk], h[2], h[3]);
      mma(s[0], ah[kk], l[0], l[1]);
      mma(s[1], ah[kk], l[2], l[3]);
    }
    mma(s[0], ah[kk], h[0], h[1]);
    mma(s[1], ah[kk], h[2], h[3]);
  }
}

// The A fragment (hi and lo) of an 8-key step from one C tile, keys
// permuted (k = tig is column 2 tig, k = tig + 4 is column 2 tig + 1).
__device__ __forceinline__ void c_to_a(const float (&c)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// acc[n] += a[n] . b[row0 .. row0 + 7] for N A operands of one 8-key step
// (keys permuted as c_to_a gives them) and the NT 8-column tiles of a
// staged head b whose k runs down its rows, read with the same permutation.
template <int NT, int N>
__device__ __forceinline__ void product_cols(float (&acc)[N][NT][4],
                                             const uint32_t (&ah)[N][4],
                                             const uint32_t (&al)[N][4],
                                             const float* b, int rs, int row0,
                                             int lane) {
  const float* p = b + (row0 + 2 * (lane & 3)) * rs + (lane >> 2);
  uint32_t h0[NT], h1[NT], l0[NT], l1[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    split(p[nt * 8], h0[nt], l0[nt]);
    split(p[rs + nt * 8], h1[nt], l1[nt]);
  }
  // the small products first; consecutive mma on different accumulators
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma(acc[n][nt], al[n], h0[nt], h1[nt]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma(acc[n][nt], ah[n], l0[nt], l1[nt]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma(acc[n][nt], ah[n], h0[nt], h1[nt]);
  }
}

// The row max of a 16-query strip's logits against keys [0, Tp): rows gid
// (m0) and gid + 8 (m1), across the quad; no exponential. The products are
// single TF32 (hi . hi): the max only shifts every exponent of its row by the
// same amount, so the result depends on it only through rounding, and the
// logits within about 2^-10 of it give exponentials near 1, far from
// overflow.
template <int KS>
__device__ __forceinline__ void strip_max(const uint32_t (&qh)[KS][4],
                                          const float* kh, int rs,
                                          const float* bias, int Tp,
                                          float scale_log2, int lane,
                                          float& m0, float& m1) {
  m0 = m1 = -INFINITY;
#pragma unroll 1
  for (int key0 = 0; key0 < Tp; key0 += 16) {
    float s[2][4];
    product_rows<KS, true>(qh, qh, kh, rs, key0, lane, s);
    tc::scale_bias(s, bias, key0, scale_log2, lane);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      m0 = fmaxf(m0, fmaxf(s[x][0], s[x][1]));
      m1 = fmaxf(m1, fmaxf(s[x][2], s[x][3]));
    }
  }
  m0 = tc::quad_max(m0);
  m1 = tc::quad_max(m1);
}

// Copy rows [0, T) of the group's heads from src (the window's first row at
// the group's first column; rows C apart) into dst [Tp][rs], 16 bytes per
// cp.async, neighbouring threads on neighbouring addresses; zero the padding
// rows. The caller waits (cp_async_wait_all, then a barrier).
__device__ __forceinline__ void stage(float* dst, const float* src, int T,
                                      int Tp, int C, int ncols, int rs) {
  const int per_row = ncols / 4;
  for (int i = threadIdx.x; i < Tp * per_row; i += blockDim.x) {
    const int t = i / per_row;
    const int c = (i - t * per_row) * 4;
    float* d = dst + t * rs + c;
    if (t < T) {
      tc::cp_async16(d, src + static_cast<size_t>(t) * C + c);
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// Rows [0, T) of dst (the window's first row at the group's first column;
// rows C apart) all get the mean over rows [0, T) of the staged tensor src:
// the output of a window whose keys are all masked (uniform weights over
// exactly T keys: padding rows are not counted). scratch: blockDim.x floats
// of shared memory that src does not use; blockDim.x >= ncols.
__device__ __forceinline__ void write_mean_rows(float* dst, const float* src,
                                                float* scratch, int T, int C,
                                                int ncols, int rs) {
  const int nparts = blockDim.x / ncols;
  const int col = threadIdx.x % ncols;
  const int part = threadIdx.x / ncols;
  if (part < nparts) {
    float sum = 0.0f;
    for (int t = part; t < T; t += nparts) sum += src[t * rs + col];
    scratch[part * ncols + col] = sum;
  }
  __syncthreads();
  if (threadIdx.x < ncols) {
    float sum = 0.0f;
    for (int p = 0; p < nparts; ++p) sum += scratch[p * ncols + threadIdx.x];
    scratch[threadIdx.x] = sum / static_cast<float>(T);
  }
  __syncthreads();
  const int chunks = ncols / 4;
  for (int i = threadIdx.x; i < T * chunks; i += blockDim.x) {
    const int t = i / chunks;
    const int c = (i - t * chunks) * 4;
    *reinterpret_cast<float4*>(dst + static_cast<size_t>(t) * C + c) =
        *reinterpret_cast<const float4*>(scratch + c);
  }
}

// Rows [0, T) of dst's group columns set to 0.
__device__ __forceinline__ void write_zero_rows(float* dst, int T, int C,
                                                int ncols) {
  const int chunks = ncols / 4;
  for (int i = threadIdx.x; i < T * chunks; i += blockDim.x) {
    const int t = i / chunks;
    const int c = (i - t * chunks) * 4;
    *reinterpret_cast<float4*>(dst + static_cast<size_t>(t) * C + c) =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Store one 16-row strip of a C-fragment result (NT tiles of 8 columns,
// times `mul`) to rows row0 + gid and row0 + gid + 8 of dst (the window's
// first row at the head's first column), skipping rows >= T.
template <int NT>
__device__ __forceinline__ void store_strip(float* dst,
                                            const float (&acc)[NT][4],
                                            float mul0, float mul1, int row0,
                                            int T, int C, int lane) {
  const int r0 = row0 + (lane >> 2);
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (r0 < T) {
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(r0) * C + nt * 8 +
                                 c) =
          make_float2(acc[nt][0] * mul0, acc[nt][1] * mul0);
    }
    if (r0 + 8 < T) {
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(r0 + 8) * C +
                                 nt * 8 + c) =
          make_float2(acc[nt][2] * mul1, acc[nt][3] * mul1);
    }
  }
}

// Heads per block: the largest divisor G of H whose row segment G * HD * 4
// bytes is at most kRowBytes (or G = 1) and whose shared memory,
// smem_bytes(G), fits the SM. 0 if none fits.
template <typename SmemBytes>
inline int choose_group(int H, int HD, SmemBytes smem_bytes) {
  for (int G = H; G >= 1; --G) {
    if (H % G == 0 && (G == 1 || G * HD * 4 <= kRowBytes) &&
        smem_bytes(G) <= tc::kMaxSmem) {
      return G;
    }
  }
  return 0;
}

}  // namespace tf32
