// Masked multi-head window attention, forward, float32, on Hopper's tensor
// cores (sm_90a) in 3xTF32.
//
// Replaces the TPU kernel objectcentricocccompletion_tpu/ops/pallas_attention.py
// `_attn_kernel`, launched by `pallas_window_attention`, for float32 inputs
// (SST's default compute dtype; bfloat16 inputs go to window_attention_tc.cu).
// Per window w and head h (hd = C / H):
//
//   out[w, t, h] = softmax_s(where(mask[w, s], q[w, t, h] . k[w, s, h] / sqrt(hd), -1e9)) . v[w, s, h]
//
// in float32, with the denominator clamped at 1e-20. A masked logit is
// *replaced* by -1e9 (never -inf), as the plain reference
// `jnp_window_attention` does, so a window whose keys are all masked (every
// padded window slot) gives the exact mean of its v rows.
//
// What bounds it on the H100. It must read v and write out for every window,
// and q and k only for windows with a valid key (the rest have a closed
// form, the mean of v): at most 4 * W * T * C float32 elements, 235.9 MB at
// the SST large level (W = 800, T = 144, C = 128), 70.4 us at 3.35 TB/s;
// 209.7 MB (62.6 us) at the small level (W = 3200, T = 32). Its products,
// 4 * W * T^2 * C operations (8.5 GFLOP at the large level), must be
// float32-accurate: one TF32 product keeps about 11 bits, so the least time
// for them is 3xTF32 at 494.7 / 3 = 165 TFLOP/s, 51 us (the CUDA cores' 67
// TFLOP/s would take 127 us). So bytes bound both levels. The exponentials,
// one per (query, key, head), 132.7 M at the large level, take 32 us at 16
// ex2 per clock on each of 132 SMs at 1.98 GHz.
//
// What the design does about that (tf32_tiles.cuh has the fragment layouts
// and the loads: ldmatrix on the reinterpreted 8x4 32-bit tile for q and k,
// 32-bit ld.shared for v).
// - Block: one window and a group of G heads whose row segment is at most 64
//   bytes (G = 1 at hd = 16, 2 at hd = 8), one warp per 16-query strip up to
//   8 warps. It reads the window's T mask bytes and starts the cp.async
//   copies of v (16 bytes per thread, neighbouring threads on neighbouring
//   addresses). If no key is valid it writes the mean of v over exactly T
//   rows and stops: it reads neither q nor k and computes no exponential.
//   Otherwise it copies q and k the same way.
// - A warp owns a strip of 16 query rows of one head and holds its q
//   fragments, split once into TF32 hi and lo, in registers. Sweep 1 over
//   the keys takes the row max of single TF32 products (hi . hi: the max
//   only shifts the exponents) with no exponential. Sweep 2 computes the
//   logits in 3xTF32 (mma.m16n8k8, three products each), one exponential
//   per logit (ex2.approx.ftz), the row sum, and P . V in 3xTF32 with P
//   split straight from the accumulator registers, keys permuted so that
//   the C tile is the A fragment (tf32_tiles.cuh). So no logit is kept
//   across keys, at any T up to 512.
// - Keys past T are padding: zero rows in shared memory whose logit gets the
//   masked bias, so they weigh exactly 0 next to a valid key; fully masked
//   windows never reach the softmax, so padding is never counted as a key.
// - Shared memory at hd = 16, large level: 3 * 144 * 20 * 4 B = 34.6 KB of
//   staged rows and 0.6 KB of key biases per block of 5 warps (9 strips);
//   small level 7.7 KB and 2 warps. Registers and spills: `nvcc -Xptxas -v`,
//   printed by chip_smoke.py.
#include "tf32_tiles.cuh"

namespace {

template <int HD>
__global__ void __launch_bounds__(tc::kMaxThreads)
    window_attention_fwd_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const uint8_t* __restrict__ mask,
                                float* __restrict__ out, int T, int C, int G,
                                float scale_log2) {
  constexpr int KS = HD / 8;          // k-steps of q . k^T
  constexpr int NT = HD / 8;          // 8-column tiles of an output strip
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tp = (T + 15) & ~15;
  const int rs = G * HD + 4;
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + Tp * rs;
  float* vs = ks + Tp * rs;
  float* bias = vs + Tp * rs;

  const int groups = C / (G * HD);
  const int w = blockIdx.x / groups;
  const int h0 = (blockIdx.x - w * groups) * G;
  const size_t base = static_cast<size_t>(w) * T * C + h0 * HD;

  tf32::stage(vs, v + base, T, Tp, C, G * HD, rs);
  if (!tc::key_bias(bias, mask + static_cast<size_t>(w) * T, T, Tp)) {
    tc::cp_async_wait_all();
    __syncthreads();
    tf32::write_mean_rows(out + base, vs, qs, T, C, G * HD, rs);
    return;
  }
  tf32::stage(qs, q + base, T, Tp, C, G * HD, rs);
  tf32::stage(ks, k + base, T, Tp, C, G * HD, rs);
  tc::cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int ns = Tp / 16;
  for (int item = threadIdx.x >> 5; item < G * ns; item += blockDim.x >> 5) {
    const int j = item / ns;
    const int i0 = (item - j * ns) * 16;
    const float* kh = ks + j * HD;
    const float* vh = vs + j * HD;
    uint32_t qh[KS][4], ql[KS][4];
    tf32::load_a<KS>(qh, ql, qs + j * HD, rs, i0, lane);
    // Sweep 1: the row max, no exponential.
    float m0, m1;
    tf32::strip_max<KS>(qh, kh, rs, bias, Tp, scale_log2, lane, m0, m1);
    // Sweep 2: the logits in 3xTF32, one exponential each, and P . V.
    float l0 = 0.0f, l1 = 0.0f;
    float o[2][1][NT][4] = {};   // keys key0 .. +7 and key0 + 8 .. +15
#pragma unroll 1
    for (int key0 = 0; key0 < Tp; key0 += 16) {
      float s[2][4];
      tf32::product_rows<KS>(qh, ql, kh, rs, key0, lane, s);
      tc::scale_bias(s, bias, key0, scale_log2, lane);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        s[x][0] = tc::ex2(s[x][0] - m0);
        s[x][1] = tc::ex2(s[x][1] - m0);
        s[x][2] = tc::ex2(s[x][2] - m1);
        s[x][3] = tc::ex2(s[x][3] - m1);
        l0 += s[x][0] + s[x][1];
        l1 += s[x][2] + s[x][3];
        uint32_t ph[1][4], pl[1][4];
        tf32::c_to_a(s[x], ph[0], pl[0]);
        tf32::product_cols<NT, 1>(o[x], ph, pl, vh, rs, key0 + 8 * x, lane);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) o[0][0][nt][i] += o[1][0][nt][i];
    }
    const float inv0 = 1.0f / fmaxf(tc::quad_sum(l0), 1e-20f);
    const float inv1 = 1.0f / fmaxf(tc::quad_sum(l1), 1e-20f);
    tf32::store_strip<NT>(out + base + j * HD, o[0][0], inv0, inv1, i0, T, C,
                          lane);
  }
}

size_t smem_bytes(int T, int G, int HD) {
  const int Tp = (T + 15) & ~15;
  return static_cast<size_t>(3 * Tp * (G * HD + 4) + Tp) * sizeof(float);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, int W, int T, int C, int H,
                   cudaStream_t stream) {
  const int G = tf32::choose_group(
      H, HD, [&](int g) { return smem_bytes(T, g, HD); });
  if (G == 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T, G, HD);
  auto kernel = window_attention_fwd_kernel<HD>;
  if (smem > tc::kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const float scale_log2 = tc::kLog2e / sqrtf(static_cast<float>(HD));
  const int threads = 32 * tc::block_warps(G * ((T + 15) / 16));
  kernel<<<W * (H / G), threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), T, C, G, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: [W, T, C] float32, contiguous, 16-byte aligned; mask: [W, T]
// bool (one byte each). C % H == 0, C / H in {8, 16, 32}, 1 <= T <= 512 (at
// T = 512 and hd = 32 one head's block takes 218 KB of shared memory).
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int window_attention_fwd(const void* q, const void* k,
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
