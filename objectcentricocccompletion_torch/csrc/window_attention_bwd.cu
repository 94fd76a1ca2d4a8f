// Masked multi-head window attention, backward, float32, on the CUDA cores
// of Hopper (sm_90a).
//
// Replaces the two TPU backward kernels of benchmarks/repro_attn_bwd.py:
// `_attn_bwd_kernel` (launched by `pallas_window_attention_bwd`) and
// `_attn_bwd_kernel_fullstore` (launched by
// `pallas_window_attention_bwd_fullstore`), for float32 inputs (bfloat16
// inputs go to the tensor-core kernel, window_attention_bwd_tc.cu). Given the
// forward
//
//   out = softmax_s(where(mask[w, s], q . k / sqrt(hd), -1e9)) . v
//
// per window w and head h (hd = C / H), and g = d out, it returns, in
// float32:
//
//   P   = softmax(where(mask, q k^T * scale, -1e9))     (recomputed)
//   dP  = g v^T,  delta_t = sum_s P_ts dP_ts,  dS = P * (dP - delta)
//   dv  = P^T g,  dq = scale * dS k,  dk = scale * dS^T q
//
// with dS set to 0 at masked keys. That is the VJP of the `where` form the
// JAX package's einsum path and its chunked backward differentiate: in a
// window whose keys are all masked, dq = dk = 0 and dv_s = (1/T) sum_t g_t;
// a masked key of a window with valid keys has P = 0 exactly and gets
// nothing. (The repro kernels add a -1e9 bias instead, which in a fully
// masked window lets gradient reach dq and dk; the port does not follow
// them there.) No [W, H, T, T] tensor is read or written: the softmax is
// recomputed from q and k, as the JAX production backward
// (`xla_chunked_window_attention_bwd`) does.
//
// What bounds it on the H100. The function reads q, k, v and g once and
// writes dq, dk and dv once: 7 * W * T * C float32 elements plus the mask,
// 367.1 MB at the SST small level (W = 3200, T = 32, C = 128) and 412.9 MB
// at the large level (W = 800, T = 144): 109.6 and 123.3 us at 3.35 TB/s.
// Its 10 * W * T^2 * C operations (five products of 2 * T^2 * hd per window
// and head) are 4.2 and 21.2 GFLOP, 63 us and 0.317 ms at the 67 TFLOP/s of
// float32 outside the tensor cores. So the small level is bound by bytes and
// the large one by operations.
//
// What the design does about that. Every input element is read from device
// memory once and every output element written once; nothing of size T^2
// leaves the SM, and no atomics are used, so the result is the same from run
// to run. One thread block per (window, head), heads of one window adjacent
// in the grid, stages that head's q, k, v and g slices [T, hd] in shared
// memory as float32. Then two passes:
//
//   1. one thread per query row t: an online pass over the keys gives the
//      row's max, its sum and delta_t (rescaled with the sum as the max
//      moves); a second pass over the keys recomputes P_ts and accumulates
//      dq_t. The row's max, 1 / sum and delta go to shared memory.
//   2. one thread per key row s: recompute P_ts for every query t from those
//      statistics and accumulate dv_s and dk_s.
//
// The logits are recomputed in the same order of operations in both passes,
// so pass 2 sees bit-identical P. The products run in full float32 on the
// CUDA cores: TF32 tensor cores would not hold the float32 tolerance.
#include "window_rows.cuh"

namespace {

using window_rows::kLog2e;
using window_rows::kMaskedLogit2;
using window_rows::axpy_row;
using window_rows::dot_row;
using window_rows::load_row;
using window_rows::store_row;

constexpr int kMaxThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

// Grid: one block per (window, head), heads fastest. Block: T threads rounded
// up to a warp. Dynamic shared memory, float32: q, k, v, g [T, HD] each, then
// per query row the max (log2 domain), 1 / sum and delta, then the key mask,
// [T] each: (4 * HD + 4) * T * 4 bytes.
template <int HD>
__global__ void __launch_bounds__(kMaxThreads)
    window_attention_bwd_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const uint8_t* __restrict__ mask,
                                const float* __restrict__ g,
                                float* __restrict__ dq,
                                float* __restrict__ dk,
                                float* __restrict__ dv, int T, int C,
                                int H, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + T * HD;
  float* vs = ks + T * HD;
  float* gs = vs + T * HD;
  float* row_max = gs + T * HD;
  float* row_inv = row_max + T;
  float* row_delta = row_inv + T;
  float* valid = row_delta + T;

  const int w = blockIdx.x / H;
  const int h = blockIdx.x - w * H;
  const int t = threadIdx.x;
  const size_t row0 = static_cast<size_t>(w) * T;
  const size_t off = (row0 + t) * C + static_cast<size_t>(h) * HD;
  const float scale_log2 = scale * kLog2e;

  if (t < T) {
    float row[HD];
    load_row<HD>(q + off, row);
    store_row<HD>(qs + t * HD, row);
    load_row<HD>(k + off, row);
    store_row<HD>(ks + t * HD, row);
    load_row<HD>(v + off, row);
    store_row<HD>(vs + t * HD, row);
    load_row<HD>(g + off, row);
    store_row<HD>(gs + t * HD, row);
    valid[t] = mask[row0 + t] ? 1.0f : 0.0f;
  }
  __syncthreads();

  // Pass 1: thread t owns query row t.
  if (t < T) {
    float qr[HD], gr[HD], acc[HD];
    load_row<HD>(qs + t * HD, qr);
    load_row<HD>(gs + t * HD, gr);
    // Online softmax in the log2 domain (exp2(x * log2 e) == exp(x)) with
    // sum_s e_s dP_s carried beside the sum. The running max starts at the
    // masked logit, so masked keys weigh exactly 0 once a valid key is seen,
    // and 1 each when none is.
    float mx = kMaskedLogit2;
    float denom = 0.0f;
    float pdp = 0.0f;
    for (int j = 0; j < T; ++j) {
      const float s = valid[j] != 0.0f
                          ? dot_row<HD>(qr, ks + j * HD) * scale_log2
                          : kMaskedLogit2;
      const float dp = dot_row<HD>(gr, vs + j * HD);
      if (s > mx) {
        const float c = exp2f(mx - s);
        denom *= c;
        pdp *= c;
        mx = s;
      }
      const float p = exp2f(s - mx);
      denom += p;
      pdp = fmaf(p, dp, pdp);
    }
    const float inv = 1.0f / fmaxf(denom, 1e-20f);
    const float delta = pdp * inv;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = 0.0f;
    for (int j = 0; j < T; ++j) {
      if (valid[j] == 0.0f) continue;       // dS = 0 at a masked key
      const float s = dot_row<HD>(qr, ks + j * HD) * scale_log2;
      const float p = exp2f(s - mx) * inv;
      const float dp = dot_row<HD>(gr, vs + j * HD);
      axpy_row<HD>(p * (dp - delta), ks + j * HD, acc);
    }
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= scale;
    store_row<HD>(dq + off, acc);
    row_max[t] = mx;
    row_inv[t] = inv;
    row_delta[t] = delta;
  }
  __syncthreads();
  if (t >= T) return;

  // Pass 2: thread t owns key row t.
  float kr[HD], vr[HD], dka[HD], dva[HD];
  load_row<HD>(ks + t * HD, kr);
  load_row<HD>(vs + t * HD, vr);
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    dka[d] = 0.0f;
    dva[d] = 0.0f;
  }
  const bool key_valid = valid[t] != 0.0f;
  for (int i = 0; i < T; ++i) {
    // the same logit as pass 1 computed: q_i . k_t in the order d = 0..HD-1
    // (fmaf(a, b, c) == fmaf(b, a, c)), then the same scale
    const float s = key_valid ? dot_row<HD>(kr, qs + i * HD) * scale_log2
                              : kMaskedLogit2;
    const float p = exp2f(s - row_max[i]) * row_inv[i];
    axpy_row<HD>(p, gs + i * HD, dva);
    if (key_valid) {
      const float dp = dot_row<HD>(vr, gs + i * HD);
      axpy_row<HD>(p * (dp - row_delta[i]), qs + i * HD, dka);
    }
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) dka[d] *= scale;
  store_row<HD>(dk + off, dka);
  store_row<HD>(dv + off, dva);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, const void* g, void* dq, void* dk,
                   void* dv, int W, int T, int C, int H,
                   cudaStream_t stream) {
  const int threads = ((T + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(4 * HD + 4) * T * sizeof(float);
  auto kernel = window_attention_bwd_kernel<HD>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  kernel<<<W * H, threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(g), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), T, C, H, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        const void* mask, const void* g, void* dq, void* dk,
                        void* dv, int W, int T, int C, int H,
                        cudaStream_t stream) {
  switch (C / H) {
    case 8:
      return launch<8>(q, k, v, mask, g, dq, dk, dv, W, T, C, H,
                                 stream);
    case 16:
      return launch<16>(q, k, v, mask, g, dq, dk, dv, W, T, C, H,
                                  stream);
    case 32:
      return launch<32>(q, k, v, mask, g, dq, dk, dv, W, T, C, H,
                                  stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, g, dq, dk, dv: [W, T, C] float32, contiguous, 16-byte aligned;
// mask: [W, T] bool (one byte each). C % H == 0, C / H in {8, 16, 32}, 1 <= T <= 256 (so the shared
// memory, (4 * C / H + 4) * T * 4 bytes, stays within 135 KB). Launches on
// `stream` and returns cudaGetLastError() as an int.
extern "C" int window_attention_bwd(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    const void* g, void* dq, void* dk,
                                    void* dv, int W, int T, int C, int H,
                                    void* stream) {
  if (W <= 0 || T <= 0 || T > kMaxThreads || H <= 0 || C % H != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dispatch_hd(q, k, v, mask, g, dq, dk, dv, W, T, C, H, s));
}
