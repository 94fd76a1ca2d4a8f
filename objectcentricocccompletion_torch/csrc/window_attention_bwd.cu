// Masked multi-head window attention, backward, float32, on Hopper's tensor
// cores (sm_90a) in 3xTF32.
//
// Replaces the two TPU backward kernels of benchmarks/repro_attn_bwd.py:
// `_attn_bwd_kernel` (launched by `pallas_window_attention_bwd`) and
// `_attn_bwd_kernel_fullstore` (launched by
// `pallas_window_attention_bwd_fullstore`), for float32 inputs (SST's default
// compute dtype; bfloat16 inputs go to window_attention_bwd_tc.cu). Given the
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
// with dS set to 0 at masked keys and the softmax denominator clamped at
// 1e-20. That is the VJP of the `where` form the JAX package's einsum path
// and its chunked backward differentiate: in a window whose keys are all
// masked, dq = dk = 0 and dv_s = (1/T) sum_t g_t, written without reading q,
// k or v; a masked key of a window with valid keys has P = 0 exactly and
// gets nothing. (The repro kernels add a -1e9 bias instead, which in a fully
// masked window lets gradient reach dq and dk; the port does not follow them
// there.) No [W, H, T, T] tensor is read or written, and no atomics are
// used: every output element is written by one thread, once, so the result
// is the same from run to run.
//
// What bounds it on the H100. It must read g and write dq, dk, dv for every
// window, and read q, k, v only for windows with a valid key: at most
// 7 * W * T * C float32 elements, 412.9 MB at the SST large level (W = 800,
// T = 144, C = 128), 123.3 us at 3.35 TB/s; 367.1 MB (109.6 us) at the
// small level (W = 3200, T = 32). The five products, 10 * W * T^2 * C
// operations (21.2 GFLOP at the large level), must be float32-accurate:
// 3xTF32 at 494.7 / 3 = 165 TFLOP/s takes 129 us (the CUDA cores' 67
// TFLOP/s, 317 us). So bytes and products bound the large level about
// equally, bytes the small one. The kernel runs more products than the five:
// the row max (one TF32 product), S and dP once more in phase B, and dq as
// two products, 25 TF32 products of 2 * T^2 * hd per head where the five in
// 3xTF32 are 15.
//
// What the design does about that (tf32_tiles.cuh has the fragment layouts
// and the loads: ldmatrix on the reinterpreted 8x4 32-bit tile for the
// operands whose k runs along the staged rows, 32-bit ld.shared for those
// whose k runs down them).
// - Block: one window and a group of G heads (G = 1 at hd = 16: 64-byte row
//   segments), one warp per 16-row strip up to 8 warps. It reads the T mask
//   bytes and starts the cp.async copies of g; if no key is valid it writes
//   dv = the mean of g over exactly T rows and dq = dk = 0, and stops.
//   Otherwise it copies q, k and v, all as float32.
// - Phase A, a warp per 16-query strip of one head, q and g held in
//   registers as TF32 hi/lo: sweep 1 takes the row max of S = q k^T from
//   single TF32 products, with no exponential. Sweep 2 computes S and
//   dP = g v^T in 3xTF32, e = exp2(S - max) (the one exponential of phase
//   A), the row sums l = sum e and sum e dP, and two 3xTF32 products that
//   need no delta yet: sum_s e dP k_s and sum_s e k_s, with e and e dP split
//   straight from the accumulators (keys permuted, tf32_tiles.cuh). Then
//   delta = sum e dP / l and dq = scale / l (sum e dP k - delta sum e k),
//   which is scale dS k. So no logit is kept across keys. Each query's
//   max + log2(l) and delta go to shared memory (2 * G * Tp floats).
// - Phase B, after one barrier, a warp per 16-key strip of one head, k and
//   v in registers as hi/lo: for every 16-query tile, S^T = k q^T and
//   dP^T = v g^T in 3xTF32, P^T = exp2(S^T - max - log2 l) from the stored
//   statistics (the second and last exponential per pair; the logits need
//   not equal phase A's bit for bit), dS^T = P^T (dP^T - delta);
//   dv += P^T g and dk += dS^T q in 3xTF32. Nothing of size T^2 is staged.
// - Ragged T: keys and queries past T are zero rows; their keys get the
//   masked bias (weight exactly 0 next to a valid key), their queries have
//   g = 0 and so dP = delta = dS = 0; their outputs are never stored.
// - Shared memory at hd = 16, large level: 4 * 144 * 20 * 4 B = 46.1 KB of
//   staged rows and 1.7 KB of statistics and key biases per block of 5
//   warps (9 strips each phase); small level 10.9 KB and 2 warps. Registers
//   and spills: `nvcc -Xptxas -v`, printed by chip_smoke.py.
#include "tf32_tiles.cuh"

namespace {

template <int HD>
__global__ void __launch_bounds__(tc::kMaxThreads)
    window_attention_bwd_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const uint8_t* __restrict__ mask,
                                const float* __restrict__ g,
                                float* __restrict__ dq,
                                float* __restrict__ dk,
                                float* __restrict__ dv, int T, int C, int G,
                                float scale) {
  constexpr int KS = HD / 8;          // k-steps of the products over hd
  constexpr int NT = HD / 8;          // 8-column tiles of an output strip
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tp = (T + 15) & ~15;
  const int rs = G * HD + 4;
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + Tp * rs;
  float* vs = ks + Tp * rs;
  float* gs = vs + Tp * rs;
  // per query: m' = row max + log2(row sum), so P = exp2(logit - m'); delta
  float* row_m = gs + Tp * rs;                 // [G][Tp]
  float* row_delta = row_m + G * Tp;           // [G][Tp]
  float* bias = row_delta + G * Tp;            // [Tp]

  const int groups = C / (G * HD);
  const int w = blockIdx.x / groups;
  const int h0 = (blockIdx.x - w * groups) * G;
  const size_t base = static_cast<size_t>(w) * T * C + h0 * HD;
  const int ncols = G * HD;
  const float scale_log2 = scale * tc::kLog2e;

  tf32::stage(gs, g + base, T, Tp, C, ncols, rs);
  if (!tc::key_bias(bias, mask + static_cast<size_t>(w) * T, T, Tp)) {
    tc::cp_async_wait_all();
    __syncthreads();
    tf32::write_mean_rows(dv + base, gs, qs, T, C, ncols, rs);
    tf32::write_zero_rows(dq + base, T, C, ncols);
    tf32::write_zero_rows(dk + base, T, C, ncols);
    return;
  }
  tf32::stage(qs, q + base, T, Tp, C, ncols, rs);
  tf32::stage(ks, k + base, T, Tp, C, ncols, rs);
  tf32::stage(vs, v + base, T, Tp, C, ncols, rs);
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
    const float* kh = ks + j * HD;
    const float* vh = vs + j * HD;
    uint32_t qh[KS][4], ql[KS][4], gh[KS][4], gl[KS][4];
    tf32::load_a<KS>(qh, ql, qs + j * HD, rs, i0, lane);
    tf32::load_a<KS>(gh, gl, gs + j * HD, rs, i0, lane);
    // Sweep 1: the row max, no exponential.
    float m0, m1;
    tf32::strip_max<KS>(qh, kh, rs, bias, Tp, scale_log2, lane, m0, m1);
    // Sweep 2: e = exp2(logit - max), one exponential per logit; dP = g v^T.
    // With l = sum e and delta = sum e dP / l, dS = (e / l)(dP - delta) and
    //   dq = scale / l * (sum_s e dP k_s - delta * sum_s e k_s),
    // two products that need no delta yet, so nothing of the strip is kept.
    float l0 = 0.0f, l1 = 0.0f, d0 = 0.0f, d1 = 0.0f;
    float acc[2][NT][4] = {};   // sum e dP k, sum e k
#pragma unroll 1
    for (int key0 = 0; key0 < Tp; key0 += 16) {
      float e[2][4], x[2][4];
      tf32::product_rows<KS>(qh, ql, kh, rs, key0, lane, e);
      tc::scale_bias(e, bias, key0, scale_log2, lane);
      tf32::product_rows<KS>(gh, gl, vh, rs, key0, lane, x);
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
        uint32_t ah[2][4], al[2][4];
        tf32::c_to_a(x[h], ah[0], al[0]);
        tf32::c_to_a(e[h], ah[1], al[1]);
        tf32::product_cols<NT, 2>(acc, ah, al, kh, rs, key0 + 8 * h, lane);
      }
    }
    // the sums are at least about 1 (the row max's own term)
    l0 = fmaxf(tc::quad_sum(l0), 1e-20f);
    l1 = fmaxf(tc::quad_sum(l1), 1e-20f);
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
    d0 = tc::quad_sum(d0) * inv0;
    d1 = tc::quad_sum(d1) * inv1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[0][nt][0] -= d0 * acc[1][nt][0];
      acc[0][nt][1] -= d0 * acc[1][nt][1];
      acc[0][nt][2] -= d1 * acc[1][nt][2];
      acc[0][nt][3] -= d1 * acc[1][nt][3];
    }
    tf32::store_strip<NT>(dq + base + j * HD, acc[0], scale * inv0,
                          scale * inv1, i0, T, C, lane);
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
    const float* qh = qs + j * HD;
    const float* gh = gs + j * HD;
    const float* rm = row_m + j * Tp;
    const float* rd = row_delta + j * Tp;
    uint32_t kah[KS][4], kal[KS][4], vah[KS][4], val[KS][4];
    tf32::load_a<KS>(kah, kal, ks + j * HD, rs, s0, lane);
    tf32::load_a<KS>(vah, val, vs + j * HD, rs, s0, lane);
    const float kb0 = bias[s0 + gid], kb1 = bias[s0 + gid + 8];
    float dva[1][NT][4] = {}, dka[1][NT][4] = {};
#pragma unroll 1
    for (int q0 = 0; q0 < Tp; q0 += 16) {
      // P^T and dS^T for keys s0 + gid (+ 8), queries q0 + 8 h + 2 tig (+ 1)
      float p[2][4], d[2][4];
      tf32::product_rows<KS>(kah, kal, qh, rs, q0, lane, p);
      tf32::product_rows<KS>(vah, val, gh, rs, q0, lane, d);
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
        uint32_t ph[1][4], pl[1][4], dh[1][4], dl[1][4];
        tf32::c_to_a(p[h], ph[0], pl[0]);
        tf32::c_to_a(d[h], dh[0], dl[0]);
        tf32::product_cols<NT, 1>(dva, ph, pl, gh, rs, q0 + 8 * h, lane);
        tf32::product_cols<NT, 1>(dka, dh, dl, qh, rs, q0 + 8 * h, lane);
      }
    }
    tf32::store_strip<NT>(dv + base + j * HD, dva[0], 1.0f, 1.0f, s0, T, C,
                          lane);
    tf32::store_strip<NT>(dk + base + j * HD, dka[0], scale, scale, s0, T, C,
                          lane);
  }
}

size_t smem_bytes(int T, int G, int HD) {
  const int Tp = (T + 15) & ~15;
  return static_cast<size_t>(4 * Tp * (G * HD + 4) + (2 * G + 1) * Tp) *
         sizeof(float);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, const void* g, void* dq, void* dk,
                   void* dv, int W, int T, int C, int H,
                   cudaStream_t stream) {
  const int G = tf32::choose_group(
      H, HD, [&](int n) { return smem_bytes(T, n, HD); });
  if (G == 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T, G, HD);
  auto kernel = window_attention_bwd_kernel<HD>;
  if (smem > tc::kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const int threads = 32 * tc::block_warps(G * ((T + 15) / 16));
  kernel<<<W * (H / G), threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(g), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), T, C, G, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, g, dq, dk, dv: [W, T, C] float32, contiguous, 16-byte aligned;
// mask: [W, T] bool (one byte each). C % H == 0, C / H in {8, 16, 32},
// 1 <= T <= 256 (at T = 256 and hd = 32 one head's block takes 147 KB of
// shared memory). Launches on `stream` and returns cudaGetLastError() as an
// int.
extern "C" int window_attention_bwd(const void* q, const void* k,
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
