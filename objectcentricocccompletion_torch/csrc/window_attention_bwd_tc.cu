// Masked multi-head window attention, backward, bf16, on Hopper's tensor
// cores (sm_90a).
//
// Replaces the two TPU backward kernels of benchmarks/repro_attn_bwd.py,
// `_attn_bwd_kernel` (launched by `pallas_window_attention_bwd`) and
// `_attn_bwd_kernel_fullstore` (launched by
// `pallas_window_attention_bwd_fullstore`), for bfloat16 inputs; float32
// inputs go to window_attention_bwd.cu. Per window w and head h, given
// g = d out, with float32 arithmetic and bf16 results:
//
//   P  = softmax(where(mask, q k^T * scale, -1e9))       (recomputed)
//   dP = g v^T,  delta_t = sum_s P_ts dP_ts,  dS = P * (dP - delta)
//   dv = P^T g,  dq = scale * dS k,  dk = scale * dS^T q
//
// with dS = 0 at masked keys: the VJP of the `where` form, as
// window_attention_bwd.cu computes it. In a window whose keys are all masked,
// dq = dk = 0 and dv_s = (1/T) sum_t g_t, written without reading q, k or v.
// No atomics: every output element is written by one thread, once, so the
// result is the same from run to run. Nothing of size T^2 leaves the SM.
//
// What bounds it on the H100. It must read g and write dq, dk, dv for every
// window, and read q, k, v only for windows with a valid key: at most
// 7 * W * T * C bf16 elements, 206.4 MB at the SST large level (W = 800,
// T = 144, C = 128), 61.6 us at 3.35 TB/s. The five products are
// 10 * W * T^2 * C operations, 21.2 GFLOP there, 21.5 us at 989 TFLOP/s.
// The exponentials: two per (query, key, head) here, 265 M at the large
// level, 64 us at 16 ex2 per clock on each of 132 SMs at 1.98 GHz. The
// kernel runs more products than the five: the hi+lo pairs below double
// three of them, phase B recomputes two and phase A computes dP twice,
// 46.7 GFLOP at the large level (47 us at the peak).
//
// What the design does about that.
// - Block: one window and a group of G heads (G = 2 at hd = 16: 64-byte row
//   segments), one warp per 16-row strip up to 8 warps. It reads the T mask
//   bytes and starts the cp.async copies of g; if no key is valid it writes
//   dv = the mean of g over exactly T rows and dq = dk = 0, and stops.
//   Otherwise it copies q, k and v, all as bf16 (tc_tiles.cuh).
// - Phase A, a warp per 16-query strip of one head: sweep 1 takes the exact
//   row max of S = q k^T (mma.m16n8k16 from ldmatrix fragments, max across
//   the quad by shuffles) with no exponential. Sweep 2 recomputes S, takes
//   e = exp2(S - max) (the one exponential of phase A), dP = g v^T, the row
//   sums l = sum e and sum e dP, and two products that need no delta yet:
//   sum_s e dP k_s and sum_s e k_s (k through ldmatrix.trans). Then
//   delta = sum e dP / l and dq = scale / l (sum e dP k - delta sum e k),
//   which is scale dS k. So no logit is kept across keys: a thread holds
//   about 80 registers at hd = 16, not a 16 x T strip. Each query's
//   max + log2(l) and delta go to shared memory (2 * G * Tp floats).
// - Phase B, after one barrier, a warp per 16-key strip of one head: for
//   every 16-query tile, S^T = k q^T and dP^T = v g^T on the tensor cores,
//   P^T = exp2(S^T - max - log2 l) from the saved statistics (the second and
//   last exponential per pair), dS^T = P^T (dP^T - delta); dv += P^T g and
//   dk += dS^T q with g and q through ldmatrix.trans. Nothing of size T^2 is
//   staged: option (b) of recomputing, two exponentials per pair.
// - Precision: dS, the P that feeds dv, and in phase A e and e dP, go into
//   the mma as bf16 hi+lo pairs (hi = bf16(x), lo = bf16(x - hi)), two
//   products each, so the rounding of these operands (2^-9 relative for one
//   bf16) drops to about 2^-17 and the final bf16 rounding of dq, dk, dv
//   dominates, as in the float32 kernel. dq's difference form loses
//   nothing that shows: tests/test_torch_attention_tiles.py emulates these
//   rounding points against the JAX reference.
// - Ragged T: keys and queries past T are zero rows; their keys get the
//   masked bias (weight exactly 0 next to a valid key), their queries have
//   g = 0 and so dP = delta = dS = 0; their outputs are never stored.
// - Occupancy at hd = 16, large level: 4 * 144 * 40 * 2 B = 46.1 KB of
//   staged rows and 2.9 KB of statistics and key biases, 47.8 KB per block
//   of 6 warps (18 strips, 3 rounds each phase); 80 registers a thread and
//   no spills (`nvcc -Xptxas -v`, printed by chip_smoke.py), so 4 blocks
//   (24 warps) are resident on an SM and one block's copies overlap the
//   others' products. Small level: 10.9 KB and 4 warps per block, 6 blocks
//   per SM. The loops are not unrolled: unrolled by 3 they spilled at
//   hd = 16 and ran no faster on the H100.
#include "tc_tiles.cuh"

namespace {

using tc::bf16;

template <int HD>
__global__ void __launch_bounds__(tc::kMaxThreads)
    window_attention_tc_bwd_kernel(const bf16* __restrict__ q,
                                   const bf16* __restrict__ k,
                                   const bf16* __restrict__ v,
                                   const uint8_t* __restrict__ mask,
                                   const bf16* __restrict__ g,
                                   bf16* __restrict__ dq,
                                   bf16* __restrict__ dk,
                                   bf16* __restrict__ dv, int T, int C,
                                   int G, float scale) {
  constexpr int KD = HD < 16 ? 16 : HD;
  constexpr int KS = KD / 16;         // k-steps of the products over hd
  constexpr int NT = HD / 8;          // 8-column tiles of an output strip
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tp = (T + 15) & ~15;
  const int rs = G * KD + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + Tp * rs;
  bf16* vs = ks + Tp * rs;
  bf16* gs = vs + Tp * rs;
  // per query: m' = row max + log2(row sum), so P = exp2(logit - m'); delta
  float* row_m = reinterpret_cast<float*>(gs + Tp * rs);   // [G][Tp]
  float* row_delta = row_m + G * Tp;                       // [G][Tp]
  float* bias = row_delta + G * Tp;                        // [Tp]

  const int groups = C / (G * HD);
  const int w = blockIdx.x / groups;
  const int h0 = (blockIdx.x - w * groups) * G;
  const size_t base = static_cast<size_t>(w) * T * C + h0 * HD;
  const float scale_log2 = scale * tc::kLog2e;

  tc::stage<HD>(gs, g + base, T, Tp, C, G, rs);
  if (!tc::key_bias(bias, mask + static_cast<size_t>(w) * T, T, Tp)) {
    tc::cp_async_wait_all();
    __syncthreads();
    tc::write_mean_rows<HD>(dv + base, gs, reinterpret_cast<float*>(qs), T,
                            C, G, rs);
    tc::write_zero_rows(dq + base, T, C, G * HD);
    tc::write_zero_rows(dk + base, T, C, G * HD);
    return;
  }
  tc::stage<HD>(qs, q + base, T, Tp, C, G, rs);
  tc::stage<HD>(ks, k + base, T, Tp, C, G, rs);
  tc::stage<HD>(vs, v + base, T, Tp, C, G, rs);
  tc::cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int ns = Tp / 16;
  const int warps = blockDim.x >> 5;

  // Phase A: a warp per (head j, 16-query strip i0).
  for (int item = threadIdx.x >> 5; item < G * ns; item += warps) {
    const int j = item / ns;
    const int i0 = (item - j * ns) * 16;
    const bf16* kh = ks + j * KD;
    const bf16* vh = vs + j * KD;
    uint32_t qa[KS][4], ga[KS][4];
    tc::load_a<KS>(qa, qs + j * KD, rs, i0, lane);
    tc::load_a<KS>(ga, gs + j * KD, rs, i0, lane);
    // Sweep 1: the exact row max, no exponential.
    float m0, m1;
    tc::strip_max<KS>(qa, kh, rs, bias, Tp, scale_log2, lane, m0, m1);
    // Sweep 2: e = exp2(logit - max), one exponential per logit; dP = g v^T.
    // With l = sum e and delta = sum e dP / l, dS = (e / l)(dP - delta) and
    //   dq = scale / l * (sum_s e dP k_s - delta * sum_s e k_s),
    // two products that need no delta yet, so nothing of the strip is kept.
    float l0 = 0.0f, l1 = 0.0f, d0 = 0.0f, d1 = 0.0f;
    float ea[NT][4] = {}, eb[NT][4] = {};   // sum e dP k, sum e k
#pragma unroll 1
    for (int key0 = 0; key0 < Tp; key0 += 16) {
      float e[2][4], x[2][4];
      tc::product_rows<KS>(qa, kh, rs, key0, lane, e);
      tc::scale_bias(e, bias, key0, scale_log2, lane);
      tc::product_rows<KS>(ga, vh, rs, key0, lane, x);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          e[h][c] = tc::ex2(e[h][c] - (c < 2 ? m0 : m1));
          x[h][c] *= e[h][c];
        }
        l0 += e[h][0] + e[h][1];
        l1 += e[h][2] + e[h][3];
        d0 += x[h][0] + x[h][1];
        d1 += x[h][2] + x[h][3];
      }
      uint32_t ep[2][4], xp[2][4];   // hi+lo pairs
      tc::c_to_a_split(e[0], e[1], ep[0], ep[1]);
      tc::c_to_a_split(x[0], x[1], xp[0], xp[1]);
      tc::product_cols<NT, 2>(ea, xp, kh, rs, key0, lane);
      tc::product_cols<NT, 2>(eb, ep, kh, rs, key0, lane);
    }
    // the sums are at least 1 (the row max's own term)
    l0 = tc::quad_sum(l0);
    l1 = tc::quad_sum(l1);
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
    d0 = tc::quad_sum(d0) * inv0;
    d1 = tc::quad_sum(d1) * inv1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      ea[nt][0] -= d0 * eb[nt][0];
      ea[nt][1] -= d0 * eb[nt][1];
      ea[nt][2] -= d1 * eb[nt][2];
      ea[nt][3] -= d1 * eb[nt][3];
    }
    tc::store_strip<NT>(dq + base + j * HD, ea, scale * inv0, scale * inv1,
                        i0, T, C, lane);
    if ((lane & 3) == 0) {
      const int r = j * Tp + i0 + gid;
      row_m[r] = m0 + log2f(l0);
      row_delta[r] = d0;
      row_m[r + 8] = m1 + log2f(l1);
      row_delta[r + 8] = d1;
    }
  }
  __syncthreads();

  // Phase B: a warp per (head j, 16-key strip s0).
  for (int item = threadIdx.x >> 5; item < G * ns; item += warps) {
    const int j = item / ns;
    const int s0 = (item - j * ns) * 16;
    const bf16* qh = qs + j * KD;
    const bf16* gh = gs + j * KD;
    const float* rm = row_m + j * Tp;
    const float* rd = row_delta + j * Tp;
    uint32_t ka[KS][4], va[KS][4];
    tc::load_a<KS>(ka, ks + j * KD, rs, s0, lane);
    tc::load_a<KS>(va, vs + j * KD, rs, s0, lane);
    const float kb0 = bias[s0 + gid], kb1 = bias[s0 + gid + 8];
    float dva[NT][4] = {}, dka[NT][4] = {};
#pragma unroll 1
    for (int q0 = 0; q0 < Tp; q0 += 16) {
      // P^T and dS^T for keys s0 + gid (+ 8), queries q0 + 8 h + 2 tig (+ 1)
      float p[2][4], d[2][4];
      tc::product_rows<KS>(ka, qh, rs, q0, lane, p);
      tc::product_rows<KS>(va, gh, rs, q0, lane, d);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = q0 + 8 * h + 2 * (lane & 3);
        const float2 m = *reinterpret_cast<const float2*>(rm + t);
        const float2 de = *reinterpret_cast<const float2*>(rd + t);
        p[h][0] = tc::ex2(fmaf(p[h][0], scale_log2, kb0) - m.x);
        p[h][1] = tc::ex2(fmaf(p[h][1], scale_log2, kb0) - m.y);
        p[h][2] = tc::ex2(fmaf(p[h][2], scale_log2, kb1) - m.x);
        p[h][3] = tc::ex2(fmaf(p[h][3], scale_log2, kb1) - m.y);
        d[h][0] = p[h][0] * (d[h][0] - de.x);
        d[h][1] = p[h][1] * (d[h][1] - de.y);
        d[h][2] = p[h][2] * (d[h][2] - de.x);
        d[h][3] = p[h][3] * (d[h][3] - de.y);
      }
      uint32_t pp[2][4], dp[2][4];   // hi+lo pairs
      tc::c_to_a_split(p[0], p[1], pp[0], pp[1]);
      tc::c_to_a_split(d[0], d[1], dp[0], dp[1]);
      tc::product_cols<NT, 2>(dva, pp, gh, rs, q0, lane);
      tc::product_cols<NT, 2>(dka, dp, qh, rs, q0, lane);
    }
    tc::store_strip<NT>(dv + base + j * HD, dva, 1.0f, 1.0f, s0, T, C,
                        lane);
    tc::store_strip<NT>(dk + base + j * HD, dka, scale, scale, s0, T, C,
                        lane);
  }
}

size_t smem_bytes(int T, int G, int HD) {
  const int Tp = (T + 15) & ~15;
  const int KD = HD < 16 ? 16 : HD;
  return static_cast<size_t>(4 * Tp * (G * KD + 8)) * sizeof(bf16) +
         static_cast<size_t>((2 * G + 1) * Tp) * sizeof(float);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, const void* g, void* dq, void* dk,
                   void* dv, int W, int T, int C, int H,
                   cudaStream_t stream) {
  const int G = tc::choose_group(
      H, HD, [&](int n) { return smem_bytes(T, n, HD); });
  if (G == 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T, G, HD);
  auto kernel = window_attention_tc_bwd_kernel<HD>;
  if (smem > tc::kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const int threads = 32 * tc::block_warps(G * ((T + 15) / 16));
  kernel<<<W * (H / G), threads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const bf16*>(g), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, C, G, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, g, dq, dk, dv: [W, T, C] bfloat16, contiguous, 16-byte aligned;
// mask: [W, T] bool (one byte each). C % H == 0, C / H in {8, 16, 32},
// 1 <= T <= 256. Launches on `stream` and returns cudaGetLastError() as an
// int.
extern "C" int window_attention_tc_bwd(const void* q, const void* k,
                                       const void* v, const void* mask,
                                       const void* g, void* dq, void* dk,
                                       void* dv, int W, int T, int C, int H,
                                       void* stream) {
  if (W <= 0 || T <= 0 || T > 256 || H <= 0 || C % H != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C / H) {
    case 8:
      err = launch<8>(q, k, v, mask, g, dq, dk, dv, W, T, C, H, s);
      break;
    case 16:
      err = launch<16>(q, k, v, mask, g, dq, dk, dv, W, T, C, H, s);
      break;
    case 32:
      err = launch<32>(q, k, v, mask, g, dq, dk, dv, W, T, C, H, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
