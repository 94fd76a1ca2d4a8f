// Row helpers shared by the window-attention kernels: one head's slice of a
// token row, HD contiguous elements of float32 or bfloat16, moved between
// device or shared memory and a float32 register array in 16-byte pieces.
// Callers guarantee 16-byte alignment (HD is a multiple of 8 and the tensors
// are 16-byte aligned with rows of C = H * HD elements).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace window_rows {

constexpr float kLog2e = 1.4426950408889634f;
// The JAX package's masked logit (-1e9), in the log2 domain the kernels use.
constexpr float kMaskedLogit2 = -1e9f * kLog2e;

template <int HD>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         float (&dst)[HD]) {
#pragma unroll
  for (int i = 0; i < HD; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(src + i);
    dst[i] = x.x;
    dst[i + 1] = x.y;
    dst[i + 2] = x.z;
    dst[i + 3] = x.w;
  }
}

template <int HD>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ src,
                                         float (&dst)[HD]) {
#pragma unroll
  for (int i = 0; i < HD; i += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src + i);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(p[j]);
      dst[i + 2 * j] = f.x;
      dst[i + 2 * j + 1] = f.y;
    }
  }
}

template <int HD>
__device__ __forceinline__ void store_row(float* __restrict__ dst,
                                          const float (&src)[HD]) {
#pragma unroll
  for (int i = 0; i < HD; i += 4) {
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(src[i], src[i + 1], src[i + 2], src[i + 3]);
  }
}

template <int HD>
__device__ __forceinline__ void store_row(__nv_bfloat16* __restrict__ dst,
                                          const float (&src)[HD]) {
#pragma unroll
  for (int i = 0; i < HD; i += 8) {
    uint4 raw;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[j] = __floats2bfloat162_rn(src[i + 2 * j], src[i + 2 * j + 1]);
    }
    *reinterpret_cast<uint4*>(dst + i) = raw;
  }
}

// Dot product of a register row with a row in shared memory, summed in the
// order d = 0 .. HD-1 (both backward passes rely on this to recompute
// bit-identical logits).
template <int HD>
__device__ __forceinline__ float dot_row(const float (&a)[HD],
                                         const float* __restrict__ b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) {
    const float4 x = b4[i];
    s = fmaf(a[4 * i], x.x, s);
    s = fmaf(a[4 * i + 1], x.y, s);
    s = fmaf(a[4 * i + 2], x.z, s);
    s = fmaf(a[4 * i + 3], x.w, s);
  }
  return s;
}

// acc += c * row, for a row in shared memory.
template <int HD>
__device__ __forceinline__ void axpy_row(float c, const float* __restrict__ row,
                                         float (&acc)[HD]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) {
    const float4 x = r4[i];
    acc[4 * i] = fmaf(c, x.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(c, x.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(c, x.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(c, x.w, acc[4 * i + 3]);
  }
}

}  // namespace window_rows
