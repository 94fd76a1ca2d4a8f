// Masked multi-head window attention, forward, bf16, on Hopper's tensor
// cores (sm_90a).
//
// Replaces the TPU kernel objectcentricocccompletion_tpu/ops/pallas_attention.py
// `_attn_kernel` (launched by `pallas_window_attention`) for bfloat16 inputs;
// float32 inputs go to window_attention.cu. Per window w and head h
// (hd = C / H):
//
//   out[w, t, h] = softmax_s(where(mask[w, s], q[w, t, h] . k[w, s, h] / sqrt(hd), -1e9)) . v[w, s, h]
//
// with float32 logits, softmax and accumulation, the probabilities rounded to
// bf16 for the second product, and the result stored in bf16.
//
// What bounds it on the H100. It must read v and write out for every window,
// and q and k only for windows with a valid key (the rest have a closed
// form, the mean of v): at most 4 * W * T * C bf16 elements, 118.0 MB at the
// SST large level (W = 800, T = 144, C = 128), 35.2 us at 3.35 TB/s. Its
// 4 * W * T^2 * C operations (8.5 GFLOP there) take 8.6 us at the bf16 peak
// of 989 TFLOP/s. The exponentials are a floor of their own: one per
// (query, key, head), W * H * T^2 = 132.7 M at the large level, 32 us at 16
// ex2 per clock on each of 132 SMs at 1.98 GHz. So bytes and exponentials
// bound it about equally; the products are far below both.
//
// What the design does about that.
// - Block: one window and a group of G heads whose row segment is at most 64
//   bytes (G = 2 at hd = 16), one warp per 16-query strip up to 8 warps. It
//   reads the window's T mask bytes and starts the cp.async copies of v (16
//   bytes per thread, neighbouring threads on neighbouring addresses, whole
//   row segments). If no key is valid it writes the mean of v over exactly T
//   rows and stops: it reads neither q nor k and computes no exponential.
//   Otherwise it copies q and k the same way. Everything is staged as bf16
//   (tc_tiles.cuh).
// - A warp owns a strip of 16 query rows of one head. q . k^T runs as
//   mma.m16n8k16 from ldmatrix fragments (hd = 8 zero-padded to k = 16;
//   hd = 32 takes two k-steps). Sweep 1 over the keys takes the exact row
//   max, across the quad by shuffles, with no exponential. Sweep 2 computes
//   the logits again (products are cheap here), one exponential per logit,
//   the row sum, and P . V with P packed to bf16 straight from the
//   accumulator registers as the A operand (V through ldmatrix.trans). So no
//   logit is kept across keys, at any T up to 512.
// - Keys past T are padding: zero rows in shared memory whose logit gets the
//   masked bias, so they weigh exactly 0 next to a valid key; fully masked
//   windows never reach the softmax, so padding is never counted as a key.
// - Occupancy at hd = 16, large level: 3 * 144 * 40 * 2 B = 34.6 KB of
//   staged rows plus 0.6 KB of key biases per block of 6 warps (18 strips,
//   3 rounds); 48 registers a thread (`nvcc -Xptxas -v`, printed by
//   chip_smoke.py), so 6 blocks (36 warps) are resident on an SM and the
//   copies of some overlap the products of others. Small level: 7.8 KB and
//   4 warps per block, 10 blocks per SM.
#include "tc_tiles.cuh"

namespace {

using tc::bf16;

template <int HD>
__global__ void __launch_bounds__(tc::kMaxThreads)
    window_attention_tc_fwd_kernel(const bf16* __restrict__ q,
                                   const bf16* __restrict__ k,
                                   const bf16* __restrict__ v,
                                   const uint8_t* __restrict__ mask,
                                   bf16* __restrict__ out, int T, int C,
                                   int G, float scale_log2) {
  constexpr int KD = HD < 16 ? 16 : HD;
  constexpr int KS = KD / 16;         // k-steps of q . k^T
  constexpr int NT = HD / 8;          // 8-column tiles of an output strip
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tp = (T + 15) & ~15;
  const int rs = G * KD + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + Tp * rs;
  bf16* vs = ks + Tp * rs;
  float* bias = reinterpret_cast<float*>(vs + Tp * rs);

  const int groups = C / (G * HD);
  const int w = blockIdx.x / groups;
  const int h0 = (blockIdx.x - w * groups) * G;
  const size_t base = static_cast<size_t>(w) * T * C + h0 * HD;

  tc::stage<HD>(vs, v + base, T, Tp, C, G, rs);
  if (!tc::key_bias(bias, mask + static_cast<size_t>(w) * T, T, Tp)) {
    tc::cp_async_wait_all();
    __syncthreads();
    tc::write_mean_rows<HD>(out + base, vs, reinterpret_cast<float*>(qs), T,
                            C, G, rs);
    return;
  }
  tc::stage<HD>(qs, q + base, T, Tp, C, G, rs);
  tc::stage<HD>(ks, k + base, T, Tp, C, G, rs);
  tc::cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int ns = Tp / 16;
  for (int item = threadIdx.x >> 5; item < G * ns; item += blockDim.x >> 5) {
    const int j = item / ns;
    const int i0 = (item - j * ns) * 16;
    const bf16* kh = ks + j * KD;
    const bf16* vh = vs + j * KD;
    uint32_t qa[KS][4];
    tc::load_a<KS>(qa, qs + j * KD, rs, i0, lane);
    // Sweep 1: the exact row max, no exponential.
    float m0, m1;
    tc::strip_max<KS>(qa, kh, rs, bias, Tp, scale_log2, lane, m0, m1);
    // Sweep 2: the logits again (products only), one exponential each, and
    // P . V with P in bf16 straight from the registers. (Not unrolled: that
    // ran faster on the H100 than unrolled by 3.)
    float l0 = 0.0f, l1 = 0.0f;
    float o[NT][4] = {};
#pragma unroll 1
    for (int key0 = 0; key0 < Tp; key0 += 16) {
      float s[2][4];
      tc::product_rows<KS>(qa, kh, rs, key0, lane, s);
      tc::scale_bias(s, bias, key0, scale_log2, lane);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        s[x][0] = tc::ex2(s[x][0] - m0);
        s[x][1] = tc::ex2(s[x][1] - m0);
        s[x][2] = tc::ex2(s[x][2] - m1);
        s[x][3] = tc::ex2(s[x][3] - m1);
        l0 += s[x][0] + s[x][1];
        l1 += s[x][2] + s[x][3];
      }
      uint32_t pa[1][4];
      tc::c_to_a(s[0], s[1], pa[0]);
      tc::product_cols<NT, 1>(o, pa, vh, rs, key0, lane);
    }
    // the denominator is at least 1 (the row max's own term)
    const float inv0 = 1.0f / tc::quad_sum(l0);
    const float inv1 = 1.0f / tc::quad_sum(l1);
    tc::store_strip<NT>(out + base + j * HD, o, inv0, inv1, i0, T, C, lane);
  }
}

size_t smem_bytes(int T, int G, int HD) {
  const int Tp = (T + 15) & ~15;
  const int KD = HD < 16 ? 16 : HD;
  return static_cast<size_t>(3 * Tp * (G * KD + 8)) * sizeof(bf16) +
         static_cast<size_t>(Tp) * sizeof(float);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, int W, int T, int C, int H,
                   cudaStream_t stream) {
  const int G = tc::choose_group(
      H, HD, [&](int g) { return smem_bytes(T, g, HD); });
  if (G == 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T, G, HD);
  auto kernel = window_attention_tc_fwd_kernel<HD>;
  if (smem > tc::kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const float scale_log2 = tc::kLog2e / sqrtf(static_cast<float>(HD));
  const int threads = 32 * tc::block_warps(G * ((T + 15) / 16));
  kernel<<<W * (H / G), threads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<bf16*>(out), T, C, G, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: [W, T, C] bfloat16, contiguous, 16-byte aligned; mask: [W, T]
// bool (one byte each). C % H == 0, C / H in {8, 16, 32}, 1 <= T <= 512.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int window_attention_tc_fwd(const void* q, const void* k,
                                       const void* v, const void* mask,
                                       void* out, int W, int T, int C, int H,
                                       void* stream) {
  if (W <= 0 || T <= 0 || T > 512 || H <= 0 || C % H != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C / H) {
    case 8:
      err = launch<8>(q, k, v, mask, out, W, T, C, H, s);
      break;
    case 16:
      err = launch<16>(q, k, v, mask, out, W, T, C, H, s);
      break;
    case 32:
      err = launch<32>(q, k, v, mask, out, W, T, C, H, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
