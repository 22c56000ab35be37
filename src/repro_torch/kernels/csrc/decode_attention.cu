// One-token GQA decode attention against a KV cache, float32.
// Replaces the Pallas kernel repro/kernels/decode_attention.py::
// decode_attention (`_kernel`).
//
//   q (B, H, hd), k/v (B, S, Hkv, hd), pos (B,) -> out (B, H, hd)
//   key kpos is valid for row b iff kpos <= pos[b] (and, with a window,
//   kpos > pos[b] - window); out = softmax(q k^T * scale) v per query head.
//
// One CTA per (batch row, KV head): the G = H / Hkv query heads of the group
// share every K/V row it loads.  The CTA walks the cache in blocks of BS = 32
// keys from the first valid key to min(pos, S - 1), so the stale tail of an
// earlier request beyond pos (the serving engine recycles slots without
// clearing them) is never read; keys outside the valid range inside a live
// block enter with probability 0 and value 0.  Online softmax in float32:
// running max, denominator and accumulator per query head, one warp per head
// for the block's max and sum (fixed shuffle order), the accumulator spread
// over the CTA as (head, dim) pairs.  A dead KV head (head_mask[h] == 0)
// reads no cache and writes zeros, and so does a row with no valid key; the
// output is acc / max(l, 1e-30) as in the TPU kernel.  Ragged S needs no
// padding.
//
// Bound on an H100: bytes.  Each valid K/V element is read once and used for
// 2 G FLOP (G = 3 for smollm-135m), far below the card's ops:byte balance.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128, kWarps = kThreads / 32;
constexpr int BS = 32;                      // keys per block (one per lane)
constexpr int kMaxHd = 128, kMaxG = 8;
constexpr int kMaxPairs = kMaxG * kMaxHd / kThreads;   // 8 per thread

__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int32_t* __restrict__ pos,
              const int32_t* __restrict__ head_mask, float* __restrict__ out,
              int S, int H, int Hkv, int hd, int window, float scale) {
  __shared__ float qs[kMaxG][kMaxHd];
  __shared__ float ks[BS][kMaxHd + 1];
  __shared__ float vs[BS][kMaxHd];
  __shared__ float ps[kMaxG][BS];
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int G = H / Hkv, npairs = G * hd;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t qo = ((size_t)b * H + (size_t)h * G) * hd;

  const int p = pos[b];
  const int hi = min(p, S - 1);
  const int lo = window > 0 ? max(0, p - window + 1) : 0;
  // zeros for a dead head or a row with no valid key (a window past the
  // cache's end); otherwise [lo, hi] is not empty
  if (head_mask[h] == 0 || lo > hi) {
    for (int e = tid; e < npairs; e += kThreads) out[qo + e] = 0.f;
    return;
  }

  for (int e = tid; e < npairs; e += kThreads) qs[e / hd][e % hd] = q[qo + e];
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kMaxPairs];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int blk = lo - lo % BS; blk <= hi; blk += BS) {
    for (int e = tid; e < BS * hd; e += kThreads) {
      const int j = e / hd, d = e % hd, kpos = blk + j;
      if (kpos >= lo && kpos <= hi) {
        const size_t idx = (((size_t)b * S + kpos) * Hkv + h) * hd + d;
        ks[j][d] = k[idx];
        vs[j][d] = v[idx];
      } else {
        vs[j][d] = 0.f;
      }
    }
    __syncthreads();
    for (int e = tid; e < G * BS; e += kThreads) {
      const int g = e / BS, j = e % BS, kpos = blk + j;
      float s = -INFINITY;
      if (kpos >= lo && kpos <= hi) {
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qs[g][d], ks[j][d], dot);
        s = dot * scale;
      }
      ps[g][j] = s;
    }
    __syncthreads();
    // every block in [lo, hi] holds a valid key, so the max is finite
    for (int g = warp; g < G; g += kWarps) {
      const float s = ps[g][lane];
      float mx = s;
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g], m_new = fmaxf(m_old, mx);
      const float pr = s == -INFINITY ? 0.f : expf(s - m_new);
      float sum = pr;
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[g][lane] = pr;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int e = tid + i * kThreads;
      if (e < npairs) {
        const int g = e / hd, d = e % hd;
        float a = acc[i] * alpha_s[g];
        for (int j = 0; j < BS; ++j) a = fmaf(ps[g][j], vs[j][d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int e = tid + i * kThreads;
    if (e < npairs) out[qo + e] = acc[i] / fmaxf(l_s[e / hd], 1e-30f);
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// window <= 0: no window.  head_mask: (Hkv,) int32, 0 = dead head.
int decode_attention(const float* q, const float* k, const float* v,
                     const int32_t* pos, const int32_t* head_mask, float* out,
                     int B, int S, int H, int Hkv, int hd, int window,
                     float scale, void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  if (H % Hkv != 0 || hd > kMaxHd || H / Hkv > kMaxG || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  decode_kernel<<<B * Hkv, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, pos, head_mask, out, S, H, Hkv, hd, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
