// Masked multi-head window attention, forward, float32, on the CUDA cores
// of Hopper (sm_90a).
//
// Replaces the TPU kernel objectcentricocccompletion_tpu/ops/pallas_attention.py
// `_attn_kernel`, launched by `pallas_window_attention`, for float32 inputs
// (bfloat16 inputs go to the tensor-core kernel, window_attention_tc.cu). It
// computes, for each window w and head h (hd = C / H):
//
//   out[w, t, h] = softmax_s(where(mask[w, s], q[w, t, h] . k[w, s, h] / sqrt(hd), -1e9)) . v[w, s, h]
//
// in float32, with the denominator clamped at 1e-20. A masked logit is
// *replaced* by -1e9 (never -inf), as the plain reference
// `jnp_window_attention` does, so a window whose keys are all masked (every
// padded window slot) gives the exact mean of its v rows. Full float32
// products: TF32 tensor cores would not hold the float32 tolerance.
//
// What bounds it on the H100. The function reads q, k, v once and writes out
// once: 4 * W * T * C float32 elements, 209.7 MB at the SST small level
// (W = 3200, T = 32, C = 128) and 235.9 MB at the large level (W = 800,
// T = 144): 62.6 and 70.4 us at 3.35 TB/s. Its products are 4 * W * T^2 * C
// operations, 1.68 and 8.49 GFLOP, 25 and 127 us at the 67 TFLOP/s of
// float32 outside the tensor cores. So the small level is bound by memory,
// the large one by operations.
//
// What the design does about that. Each element of q, k and v is read from
// device memory exactly once and the [W, H, T, T] logits never leave the SM:
// one thread block per (window, head) stages that head's K and V slices
// [T, hd] in shared memory (at most 2 * 144 * 16 * 4 B = 18 KB), and one
// thread per query row runs an online softmax (running max, running sum)
// over the T keys in registers. The blocks of one window are neighbours in
// the grid.
#include "window_rows.cuh"

namespace {

using window_rows::kLog2e;
using window_rows::kMaskedLogit2;
using window_rows::axpy_row;
using window_rows::dot_row;
using window_rows::load_row;
using window_rows::store_row;

constexpr int kMaxThreads = 512;

// Grid: one block per (window, head), heads fastest. Block: T threads rounded
// up to a warp; thread t < T owns query row t. Dynamic shared memory:
// K [T, HD], V [T, HD] as float32, then the key mask [T] as float32.
template <int HD>
__global__ void __launch_bounds__(kMaxThreads)
    window_attention_fwd_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const uint8_t* __restrict__ mask,
                                float* __restrict__ out, int T, int C,
                                int H, float qk_scale_log2) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + T * HD;
  float* valid = vs + T * HD;

  const int w = blockIdx.x / H;
  const int h = blockIdx.x - w * H;
  const int t = threadIdx.x;
  const size_t row0 = static_cast<size_t>(w) * T;

  if (t < T) {
    const size_t off = (row0 + t) * C + static_cast<size_t>(h) * HD;
    float row[HD];
    load_row<HD>(k + off, row);
    store_row<HD>(ks + t * HD, row);
    load_row<HD>(v + off, row);
    store_row<HD>(vs + t * HD, row);
    valid[t] = mask[row0 + t] ? 1.0f : 0.0f;
  }
  __syncthreads();
  if (t >= T) return;

  const size_t qoff = (row0 + t) * C + static_cast<size_t>(h) * HD;
  float qr[HD];
  load_row<HD>(q + qoff, qr);
#pragma unroll
  for (int d = 0; d < HD; ++d) qr[d] *= qk_scale_log2;

  // Online softmax in the log2 domain: exp2(x * log2 e) == exp(x). The
  // running max starts at the masked logit, so masked keys weigh exactly 0
  // once a valid key is seen, and 1 each when none is.
  float mx = kMaskedLogit2;
  float denom = 0.0f;
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.0f;

  for (int j = 0; j < T; ++j) {
    float s = dot_row<HD>(qr, ks + j * HD);
    s = valid[j] != 0.0f ? s : kMaskedLogit2;
    if (s > mx) {
      const float c = exp2f(mx - s);
      denom *= c;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= c;
      mx = s;
    }
    const float p = exp2f(s - mx);
    denom += p;
    axpy_row<HD>(p, vs + j * HD, acc);
  }
  denom = fmaxf(denom, 1e-20f);
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = acc[d] / denom;
  store_row<HD>(out + qoff, acc);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, int W, int T, int C, int H,
                   cudaStream_t stream) {
  const int threads = ((T + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(2 * T * HD + T) * sizeof(float);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  window_attention_fwd_kernel<HD>
      <<<W * H, threads, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v),
          static_cast<const uint8_t*>(mask), static_cast<float*>(out), T,
          C, H, scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        const void* mask, void* out, int W, int T, int C,
                        int H, cudaStream_t stream) {
  switch (C / H) {
    case 8:
      return launch<8>(q, k, v, mask, out, W, T, C, H, stream);
    case 16:
      return launch<16>(q, k, v, mask, out, W, T, C, H, stream);
    case 32:
      return launch<32>(q, k, v, mask, out, W, T, C, H, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: [W, T, C] float32, contiguous, 16-byte aligned; mask: [W, T]
// bool (one byte each). C % H == 0,
// C / H in {8, 16, 32}, 1 <= T <= 512, (2 * C / H + 1) * T * 4 <= 48 KiB.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int window_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    void* out, int W, int T, int C, int H,
                                    void* stream) {
  if (W <= 0 || T <= 0 || T > kMaxThreads || H <= 0 || C % H != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_hd(q, k, v, mask, out, W, T, C, H, s));
}
