// Tensor-core building blocks shared by the bf16 window-attention kernels
// (window_attention_tc.cu, window_attention_bwd_tc.cu): warp-level
// mma.sync m16n8k16 (bf16 in, float32 accumulate), ldmatrix fragment loads,
// cp.async staging of a window's head group in shared memory, the key mask,
// and the closed-form result of a window whose keys are all masked. The
// float32 kernels' tf32_tiles.cuh uses the pieces that do not depend on the
// element type (cp.async, quad reductions, the key bias, warps per block).
//
// Layout in shared memory. A block owns one window and a group of G adjacent
// heads. Each staged tensor (q, k, v or g) is [Tp][rs] bf16: Tp = T rounded
// up to 16, head j of the group at columns [j * KD, j * KD + HD), KD = max(HD,
// 16) so that one k-step of the mma covers a head, and rs = G * KD + 8. The 8
// extra columns make the row stride an odd multiple of 16 bytes, so the eight
// rows of an ldmatrix 8x8 tile fall in distinct banks. Rows [T, Tp) and, at
// HD = 8, columns [HD, KD) of each head are zero.
//
// Fragments (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 * gid + tig. A 16x16
// (row-major) holds rows gid and gid + 8 at columns 2 tig, 2 tig + 1 (a0, a1)
// and 8 + 2 tig, 9 + 2 tig (a2, a3). B 16x8 (column-major) holds k = 2 tig,
// 2 tig + 1 (b0) and 8 + 2 tig, 9 + 2 tig (b1) at column gid. C 16x8 holds
// rows gid (c0, c1) and gid + 8 (c2, c3) at columns 2 tig, 2 tig + 1. So the
// C fragments of two adjacent 8-column tiles are, packed to bf16, the A
// fragment of a 16-column k-step: that is how P and dS feed the next product
// without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <string.h>

#include "window_rows.cuh"

namespace tc {

using window_rows::kLog2e;
using window_rows::kMaskedLogit2;

typedef __nv_bfloat16 bf16;

// At most 8 warps (256 threads) in a block; see block_warps.
constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = kMaxWarps * 32;
// A block's row segment: G heads of HD bf16 columns, at most 64 bytes (two
// whole sectors; G = 2 at hd = 16). Blocks of 128-byte segments ran slower on
// the H100 in both kernels: fewer blocks fit an SM to overlap copies with
// products.
constexpr int kRowBytes = 64;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four 8x8 bf16 tiles; lane l gives the address of row l % 8 of tile l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The lane's row address for a 16x16 block at (row0, col0) of a staged
// tensor, read as an A fragment (ldsm_x4: a0..a3) or, transposed, as the B
// fragments of two 8-column tiles whose k runs down the rows (ldsm_x4_t:
// b0, b1 of columns col0..+7, then of col0+8..+15).
__device__ __forceinline__ const bf16* a_rows(const bf16* base, int rs,
                                              int row0, int col0, int lane) {
  return base + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * rs + col0 +
         (lane >> 4) * 8;
}

// The lane's row address for the B fragments of two 8-column tiles whose n
// runs down the rows (rows row0..+7, then row0+8..+15) and k along the
// columns col0..+15 (ldsm_x4: b0, b1 of the first tile, then the second).
__device__ __forceinline__ const bf16* b_rows(const bf16* base, int rs,
                                              int row0, int col0, int lane) {
  return base + (row0 + (lane & 7) + (lane >> 4) * 8) * rs + col0 +
         ((lane >> 3) & 1) * 8;
}

// d += a . b, one 16x8x16 product on the tensor cores.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// Two floats as one bf16x2 register, x0 in the low half (the lower column).
__device__ __forceinline__ uint32_t pack(float x0, float x1) {
  return as_u32(__floats2bfloat162_rn(x0, x1));
}

// x = hi + lo to about 16 bits: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = pack(x0 - f.x, x1 - f.y);
}

// The A fragment of a 16-column k-step from the C fragments of its two
// 8-column tiles.
__device__ __forceinline__ void c_to_a(const float (&c0)[4],
                                       const float (&c1)[4],
                                       uint32_t (&a)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

__device__ __forceinline__ void c_to_a_split(const float (&c0)[4],
                                             const float (&c1)[4],
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  split(c0[0], c0[1], hi[0], lo[0]);
  split(c0[2], c0[3], hi[1], lo[1]);
  split(c1[0], c1[1], hi[2], lo[2]);
  split(c1[2], c1[3], hi[3], lo[3]);
}

// s = a . b^T for rows row0 .. row0 + 15 of a staged head b (k along its
// columns): two 16x8 C tiles, rows of a by (row0 .. +7, row0 + 8 .. +15).
template <int KS>
__device__ __forceinline__ void product_rows(const uint32_t (&a)[KS][4],
                                             const bf16* b, int rs, int row0,
                                             int lane, float (&s)[2][4]) {
#pragma unroll
  for (int x = 0; x < 2; ++x) s[x][0] = s[x][1] = s[x][2] = s[x][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t f[4];
    ldsm_x4(f, b_rows(b, rs, row0, kk * 16, lane));
    mma(s[0], a[kk], f[0], f[1]);
    mma(s[1], a[kk], f[2], f[3]);
  }
}

// acc += (a[0] + ... + a[N-1]) . b[row0 .. row0 + 15] for the NT 8-column
// tiles of a staged head b (k down its rows, read through ldmatrix.trans).
// N = 2 takes an operand as a hi+lo pair.
template <int NT, int N>
__device__ __forceinline__ void product_cols(float (&acc)[NT][4],
                                             const uint32_t (&a)[N][4],
                                             const bf16* b, int rs, int row0,
                                             int lane) {
#pragma unroll
  for (int np = 0; np < (NT + 1) / 2; ++np) {
    uint32_t f[4];
    ldsm_x4_t(f, a_rows(b, rs, row0, np * 16, lane));
#pragma unroll
    for (int y = 0; y < 2 && 2 * np + y < NT; ++y) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        mma(acc[2 * np + y], a[n], f[2 * y], f[2 * y + 1]);
      }
    }
  }
}

// The A fragments of a 16x16 block at (row0, col0) of a staged tensor, KS
// k-steps of 16 columns.
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], const bf16* base,
                                       int rs, int row0, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ldsm_x4(a[kk], a_rows(base, rs, row0, kk * 16, lane));
  }
}

// Logits in the log2 domain with the key bias added: s * scale_log2 + bias
// of the column's key (key0 + 8 x + 2 tig, + 1).
__device__ __forceinline__ void scale_bias(float (&s)[2][4], const float* bias,
                                           int key0, float scale_log2,
                                           int lane) {
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const float2 kb = *reinterpret_cast<const float2*>(
        bias + key0 + 8 * x + 2 * (lane & 3));
    s[x][0] = fmaf(s[x][0], scale_log2, kb.x);
    s[x][1] = fmaf(s[x][1], scale_log2, kb.y);
    s[x][2] = fmaf(s[x][2], scale_log2, kb.x);
    s[x][3] = fmaf(s[x][3], scale_log2, kb.y);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The row max of a 16-query strip's logits against keys [0, Tp): rows gid
// (m0) and gid + 8 (m1), exact, across the quad. No exponential.
template <int KS>
__device__ __forceinline__ void strip_max(const uint32_t (&qa)[KS][4],
                                          const bf16* kh, int rs,
                                          const float* bias, int Tp,
                                          float scale_log2, int lane,
                                          float& m0, float& m1) {
  m0 = m1 = -INFINITY;
#pragma unroll 1
  for (int key0 = 0; key0 < Tp; key0 += 16) {
    float s[2][4];
    product_rows<KS>(qa, kh, rs, key0, lane, s);
    scale_bias(s, bias, key0, scale_log2, lane);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      m0 = fmaxf(m0, fmaxf(s[x][0], s[x][1]));
      m1 = fmaxf(m1, fmaxf(s[x][2], s[x][3]));
    }
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
}

// Copy rows [0, T) of the group's heads from src (the window's first row at
// the group's first column; rows C apart) into dst [Tp][rs], 16 bytes per
// cp.async, neighbouring threads on neighbouring addresses; zero the padding.
// The caller waits (cp_async_wait_all, then a barrier).
template <int HD>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int T,
                                      int Tp, int C, int G, int rs) {
  constexpr int KD = HD < 16 ? 16 : HD;
  constexpr int kChunks = KD / 8;
  const int per_row = G * kChunks;
  for (int i = threadIdx.x; i < Tp * per_row; i += blockDim.x) {
    const int t = i / per_row;
    const int r = i - t * per_row;
    const int j = r / kChunks;
    const int c = (r - j * kChunks) * 8;
    bf16* d = dst + t * rs + j * KD + c;
    if (t < T && c < HD) {
      cp_async16(d, src + static_cast<size_t>(t) * C + j * HD + c);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// bias[t] = 0 for a valid key and kMaskedLogit2 for a masked or padding one
// (t >= T), added to the log2-domain logit. Returns, to every thread,
// whether the window has a valid key. Where it has one, a masked or padding
// key weighs exactly 0 (exp2 of about -1.4e9 below the row max), as in the
// `where` form; where it has none the caller writes the closed form instead.
__device__ __forceinline__ bool key_bias(float* bias, const uint8_t* mask,
                                         int T, int Tp) {
  int any = 0;
  for (int t = threadIdx.x; t < Tp; t += blockDim.x) {
    const bool ok = t < T && mask[t] != 0;
    bias[t] = ok ? 0.0f : kMaskedLogit2;
    any |= ok;
  }
  return __syncthreads_or(any) != 0;
}

// Rows [0, T) of dst (the window's first row at the group's first column;
// rows C apart) all get the float32 mean over rows [0, T) of the staged
// tensor src, in bf16: the output of a window whose keys are all masked
// (uniform weights over exactly T keys: padding rows are not counted).
// scratch: blockDim.x floats of shared memory that src does not use.
template <int HD>
__device__ __forceinline__ void write_mean_rows(bf16* dst, const bf16* src,
                                                float* scratch, int T, int C,
                                                int G, int rs) {
  constexpr int KD = HD < 16 ? 16 : HD;
  const int ncols = G * HD;
  const int nparts = blockDim.x / ncols;
  const int col = threadIdx.x % ncols;
  const int part = threadIdx.x / ncols;
  if (part < nparts) {
    const bf16* s = src + (col / HD) * KD + col % HD;
    float sum = 0.0f;
    for (int t = part; t < T; t += nparts) sum += __bfloat162float(s[t * rs]);
    scratch[part * ncols + col] = sum;
  }
  __syncthreads();
  if (threadIdx.x < ncols) {
    float sum = 0.0f;
    for (int p = 0; p < nparts; ++p) sum += scratch[p * ncols + threadIdx.x];
    scratch[threadIdx.x] = sum / static_cast<float>(T);
  }
  __syncthreads();
  const int chunks = ncols / 8;
  for (int i = threadIdx.x; i < T * chunks; i += blockDim.x) {
    const int t = i / chunks;
    const int c = (i - t * chunks) * 8;
    const float* m = scratch + c;
    uint4 raw;
    raw.x = pack(m[0], m[1]);
    raw.y = pack(m[2], m[3]);
    raw.z = pack(m[4], m[5]);
    raw.w = pack(m[6], m[7]);
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(t) * C + c) = raw;
  }
}

// Rows [0, T) of dst's group columns set to 0.
__device__ __forceinline__ void write_zero_rows(bf16* dst, int T, int C,
                                                int ncols) {
  const int chunks = ncols / 8;
  for (int i = threadIdx.x; i < T * chunks; i += blockDim.x) {
    const int t = i / chunks;
    const int c = (i - t * chunks) * 8;
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(t) * C + c) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// Store one 16-row strip of a C-fragment result (NT tiles of 8 columns,
// times `mul`) to rows row0 + gid and row0 + gid + 8 of dst (the window's
// first row at the head's first column), skipping rows >= T.
template <int NT>
__device__ __forceinline__ void store_strip(bf16* dst, const float (&acc)[NT][4],
                                            float mul0, float mul1, int row0,
                                            int T, int C, int lane) {
  const int r0 = row0 + (lane >> 2);
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (r0 < T) {
      *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(r0) * C +
                                   nt * 8 + c) =
          pack(acc[nt][0] * mul0, acc[nt][1] * mul0);
    }
    if (r0 + 8 < T) {
      *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(r0 + 8) * C +
                                   nt * 8 + c) =
          pack(acc[nt][2] * mul1, acc[nt][3] * mul1);
    }
  }
}

// Heads per block: the largest divisor G of H whose row segment G * HD * 2
// bytes is at most kRowBytes and whose shared memory, smem_bytes(G), fits the
// SM. 0 if none fits.
template <typename SmemBytes>
inline int choose_group(int H, int HD, SmemBytes smem_bytes) {
  for (int G = H; G >= 1; --G) {
    if (H % G == 0 && G * HD * 2 <= kRowBytes && smem_bytes(G) <= kMaxSmem) {
      return G;
    }
  }
  return 0;
}

// Warps per block for `items` strips dealt round robin: as few rounds as
// kMaxWarps allow, and no more warps than those rounds need (36 strips: 5
// rounds of 8 warps; 18: 3 rounds of 6).
inline int block_warps(int items) {
  const int rounds = (items + kMaxWarps - 1) / kMaxWarps;
  return (items + rounds - 1) / rounds;
}

}  // namespace tc
