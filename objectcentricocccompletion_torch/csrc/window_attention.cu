// Masked multi-head window attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel objectcentricocccompletion_tpu/ops/pallas_attention.py
// `_attn_kernel`, launched by `pallas_window_attention`. It computes, for each
// window w and head h (hd = C / H):
//
//   out[w, t, h] = softmax_s(where(mask[w, s], q[w, t, h] . k[w, s, h] / sqrt(hd), -1e9)) . v[w, s, h]
//
// in float32, with the denominator clamped at 1e-20 and the result stored in
// the input dtype. A masked logit is *replaced* by -1e9 (never -inf), as the
// plain reference `jnp_window_attention` does, so a window whose keys are all
// masked (every padded window slot) gives the exact mean of its v rows.
//
// What bounds it on the H100. The function reads q, k, v once and writes out
// once: 4 * W * T * C elements. At the SST production shapes in bf16 that is
// 4 * 3200 * 32 * 128 * 2 B = 104.9 MB at the small level (T = 32) and
// 4 * 800 * 144 * 128 * 2 B = 118.0 MB at the large level (T = 144): 31.3 and
// 35.2 us at 3.35 TB/s. Its products are 4 * W * T^2 * C operations, 1.68 and
// 8.49 GFLOP, 1.7 and 8.6 us at the bf16 tensor-core peak of 989 TFLOP/s. So it
// is bound by memory.
//
// What the design does about that. Each element of q, k and v is read from
// device memory exactly once and the [W, H, T, T] logits never leave the SM:
// one thread block per (window, head) stages that head's K and V slices
// [T, hd] in shared memory as float32 (at most 2 * 144 * 16 * 4 B = 18 KB), and
// one thread per query row runs an online softmax (running max, running sum)
// over the T keys in registers. A head slice of one row is hd * 2 = 32 B in
// bf16, one whole sector, so the per-head blocks waste no memory traffic; the
// blocks of one window are neighbours in the grid. The arithmetic runs on the
// CUDA cores, not the tensor cores: a later version can move the two products
// to wgmma and the loads to TMA.
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
template <typename scalar_t, int HD>
__global__ void __launch_bounds__(kMaxThreads)
    window_attention_fwd_kernel(const scalar_t* __restrict__ q,
                                const scalar_t* __restrict__ k,
                                const scalar_t* __restrict__ v,
                                const uint8_t* __restrict__ mask,
                                scalar_t* __restrict__ out, int T, int C,
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

template <typename scalar_t, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, int W, int T, int C, int H,
                   cudaStream_t stream) {
  const int threads = ((T + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(2 * T * HD + T) * sizeof(float);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  window_attention_fwd_kernel<scalar_t, HD>
      <<<W * H, threads, smem, stream>>>(
          static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
          static_cast<const scalar_t*>(v),
          static_cast<const uint8_t*>(mask), static_cast<scalar_t*>(out), T,
          C, H, scale * kLog2e);
  return cudaGetLastError();
}

template <typename scalar_t>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        const void* mask, void* out, int W, int T, int C,
                        int H, cudaStream_t stream) {
  switch (C / H) {
    case 8:
      return launch<scalar_t, 8>(q, k, v, mask, out, W, T, C, H, stream);
    case 16:
      return launch<scalar_t, 16>(q, k, v, mask, out, W, T, C, H, stream);
    case 32:
      return launch<scalar_t, 32>(q, k, v, mask, out, W, T, C, H, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: [W, T, C] contiguous, 16-byte aligned, float32 (is_bf16 = 0)
// or bfloat16 (is_bf16 = 1); mask: [W, T] bool (one byte each). C % H == 0,
// C / H in {8, 16, 32}, 1 <= T <= 512, (2 * C / H + 1) * T * 4 <= 48 KiB.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int window_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    void* out, int W, int T, int C, int H,
                                    int is_bf16, void* stream) {
  if (W <= 0 || T <= 0 || T > kMaxThreads || H <= 0 || C % H != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_hd<__nv_bfloat16>(q, k, v, mask, out, W, T, C, H, s)
              : dispatch_hd<float>(q, k, v, mask, out, W, T, C, H, s);
  return static_cast<int>(err);
}
