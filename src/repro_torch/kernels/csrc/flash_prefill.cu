// Full-sequence GQA flash attention (prefill), float32.
// Replaces the Pallas kernel repro/kernels/flash_prefill.py::flash_prefill
// (`_kernel`).
//
//   q (B, S, H, hd), k/v (B, T, Hkv, hd) -> out (B, S, H, hd)
//   query i sits at position i, key j at j; key j is valid for query i iff
//   j < t_valid, and j <= i when causal, and j > i - window with a window.
//
// One CTA per (query block, KV head, batch row).  A query block is BQ
// positions x the G query heads of the KV head: R = BQ * G score rows that
// share every K/V block the CTA loads.  The CTA walks key blocks of BS = 32
// in order up to the causal diagonal, skipping whole blocks that are dead for
// all its rows (past t_valid, above the diagonal, left of the window), and
// masks the rest element by element.  Online softmax in float32 per row: one
// warp per row for the block's max and sum (fixed shuffle order), the
// accumulator spread over the CTA as (row, dim) pairs.  A dead KV head
// (head_mask[h] == 0) reads nothing and writes zeros.  Output is
// acc / max(l, 1e-30), as in the TPU kernel.  Ragged S and T need no padding.
//
// Bound on an H100: at the serving prefill (S = T = 32, hd = 64) the q/k/v/o
// bytes; the causal score work is ~S/2 FLOP per K/V byte per query head.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128, kWarps = kThreads / 32;
constexpr int BS = 32;                      // keys per block (one per lane)
constexpr int kMaxHd = 128, kMaxR = 64;
constexpr int kMaxPairs = kMaxR * kMaxHd / kThreads;   // 64 per thread

__global__ void __launch_bounds__(kThreads)
prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v,
               const int32_t* __restrict__ head_mask, float* __restrict__ out,
               int S, int T, int H, int Hkv, int hd, int BQ, int causal,
               int window, int t_valid, float scale) {
  extern __shared__ float smem[];
  const int G = H / Hkv, R = BQ * G;
  float* qs = smem;                         // [R][hd]
  float* ks = qs + R * hd;                  // [BS][hd + 1]
  float* vs = ks + BS * (hd + 1);           // [BS][hd]
  float* ps = vs + BS * hd;                 // [R][BS]
  float* m_s = ps + R * BS;                 // [R]
  float* l_s = m_s + R;                     // [R]
  float* alpha_s = l_s + R;                 // [R]

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q_lo = qb * BQ, q_last = min(q_lo + BQ, S) - 1;
  const int npairs = R * hd;
  // row r = (query qi = r / G, head g = r % G): the rows of one query
  // position are contiguous in q and out, so element e of the CTA's tile
  // sits at row_base(qi) + (r % G) * hd + d
  auto offset = [&](int e) -> size_t {
    const int r = e / hd, d = e % hd, qi = r / G;
    return (((size_t)b * S + q_lo + qi) * H + (size_t)h * G + r % G) * hd + d;
  };
  auto row_real = [&](int e) { return q_lo + (e / hd) / G < S; };

  if (head_mask[h] == 0) {
    for (int e = tid; e < npairs; e += kThreads)
      if (row_real(e)) out[offset(e)] = 0.f;
    return;
  }
  const int t_eff = min(t_valid, T);

  for (int e = tid; e < npairs; e += kThreads)
    qs[e] = row_real(e) ? q[offset(e)] : 0.f;
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  float acc[kMaxPairs];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int k_lo = 0; k_lo < t_eff; k_lo += BS) {
    if (causal && k_lo > q_last) break;                       // above diagonal
    if (window > 0 && k_lo + BS - 1 <= q_lo - window) continue;  // left of it
    for (int e = tid; e < BS * hd; e += kThreads) {
      const int j = e / hd, d = e % hd, kpos = k_lo + j;
      if (kpos < t_eff) {
        const size_t idx = (((size_t)b * T + kpos) * Hkv + h) * hd + d;
        ks[j * (hd + 1) + d] = k[idx];
        vs[j * hd + d] = v[idx];
      } else {
        vs[j * hd + d] = 0.f;
      }
    }
    __syncthreads();
    for (int e = tid; e < R * BS; e += kThreads) {
      const int r = e / BS, j = e % BS;
      const int qpos = q_lo + r / G, kpos = k_lo + j;
      const bool valid = qpos < S && kpos < t_eff &&
                         (!causal || kpos <= qpos) &&
                         (window <= 0 || kpos > qpos - window);
      float s = -INFINITY;
      if (valid) {
        const float* qr = qs + r * hd;
        const float* kr = ks + j * (hd + 1);
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      ps[e] = s;
    }
    __syncthreads();
    for (int r = warp; r < R; r += kWarps) {
      const float s = ps[r * BS + lane];
      float mx = s;
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r], m_new = fmaxf(m_old, mx);
      // a row with no valid key yet keeps its (empty) state unchanged
      const bool empty = m_new == -INFINITY;
      const float pr = (empty || s == -INFINITY) ? 0.f : expf(s - m_new);
      float sum = pr;
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[r * BS + lane] = pr;
      __syncwarp();
      if (lane == 0) {
        const float alpha = empty ? 1.f : expf(m_old - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int e = tid + i * kThreads;
      if (e < npairs) {
        const int r = e / hd, d = e % hd;
        const float* pr = ps + r * BS;
        float a = acc[i] * alpha_s[r];
        for (int j = 0; j < BS; ++j) a = fmaf(pr[j], vs[j * hd + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int e = tid + i * kThreads;
    if (e < npairs && row_real(e))
      out[offset(e)] = acc[i] / fmaxf(l_s[e / hd], 1e-30f);
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// causal: 0/1; window <= 0: no window; head_mask: (Hkv,) int32, 0 = dead.
int flash_prefill(const float* q, const float* k, const float* v,
                  const int32_t* head_mask, float* out, int B, int S, int T,
                  int H, int Hkv, int hd, int causal, int window, int t_valid,
                  float scale, void* stream) {
  if (B == 0 || S == 0 || Hkv == 0) return 0;
  if (H % Hkv != 0 || hd > kMaxHd || H / Hkv > kMaxR)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Hkv;
  const int BQ = std::max(1, std::min(16, kMaxR / G));
  const int R = BQ * G;
  const size_t smem = sizeof(float) *
      ((size_t)R * hd + BS * (hd + 1) + BS * hd + R * BS + 3 * R);
  cudaError_t err = cudaFuncSetAttribute(
      prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, Hkv, B);
  prefill_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, head_mask, out, S, T, H, Hkv, hd, BQ, causal, window, t_valid,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
