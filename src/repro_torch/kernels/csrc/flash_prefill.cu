// Full-sequence GQA flash attention (prefill), float32.
// Replaces the Pallas kernel repro/kernels/flash_prefill.py::flash_prefill
// (`_kernel`).
//
//   q (B, S, H, hd), k/v (B, T, Hkv, hd) -> out (B, S, H, hd)
//   query i sits at position i, key j at j; key j is valid for query i iff
//   j < t_valid, and j <= i when causal, and j > i - window with a window.
//
// Bound on an H100: at the serving wave (B = 32, S = T = 32, G = 3,
// hd = 64) the q/k/v/o bytes, 6.3 MB, 1.9 us at 3.35 TB/s; the causal
// score and value work is a tenth of that at the float32 rate.  So what
// sets the time is latency: how many loads and dependent shared-memory
// reads stand between a CTA's start and its last store.
//
// The design.  A KV head's G query heads share every K/V row, so the rows
// of (query position, query head) are flattened, row r = i * G + g, and
// one CTA takes 32 consecutive rows of one (batch row, KV head): any G
// works and no row slot is wasted (the serving wave launches 3 x 3 x 32 =
// 288 CTAs of 8 warps).  Each warp owns 4 rows outright, so the online
// softmax needs only warp shuffles; the CTA shares a K/V block of 32 keys
// in shared memory, loaded with cp.async together with Q (the first
// block's copies overlap Q's).  For a block:
//   * Q·Kᵀ: lane j scores key j against the warp's 4 rows, float4 reads of
//     K (rows padded by 4 floats: conflict-free) and of Q (broadcast), 16
//     independent fmaf chains a lane (4 rows x 4 float4 components), each
//     summed in one fixed order;
//   * softmax: per row, butterfly max and sum over the 32 lanes (one fixed
//     order), the probabilities into the warp's slice of shared memory;
//   * P·V: each lane owns dims lane + 32u of the 4 rows (4 x DPL
//     accumulators in registers), unrolled over the block's keys, with
//     float4 broadcast reads of P and conflict-free reads of V.
// Key blocks are walked in order from the window's first live block to the
// causal diagonal; masked keys inside a block get probability 0 and value
// 0.  A dead KV head (head_mask[h] == 0) reads nothing and writes zeros; a
// row with no valid key writes zeros (acc / max(l, 1e-30) with acc = 0),
// as the TPU kernel does.  Every order is fixed, so reruns are bitwise
// identical.  Ragged S and T need no padding.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8, kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4, kRows = kWarps * kRowsPerWarp;   // 32
constexpr int BS = 32;                      // keys per block (one per lane)
constexpr int kMaxHd = 128;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const int32_t* head_mask;
  float* out;
  int S, T, H, Hkv, G, hd, hd4, causal, window, t_valid;
  float scale;
  bool vec;   // 16-byte copies: hd % 4 == 0 and q, k, v 16-byte aligned
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Copy `rows` rows of hd floats into shared rows of `stride` (zero-filled
// to hd4); row_src(r) is the row's global start, or nullptr for a row of
// zeros.
template <typename RowSrc>
__device__ __forceinline__ void copy_rows(const Args& a, float* dst,
                                          int stride, int rows,
                                          RowSrc row_src) {
  if (a.vec) {
    const int n4 = a.hd4 / 4;
    for (int e = threadIdx.x; e < rows * n4; e += kThreads) {
      const int r = e / n4, c = (e - r * n4) * 4;
      const float* src = row_src(r);
      cp_async16(dst + r * stride + c, src ? src + c : a.q, src != nullptr);
    }
  } else {
    for (int e = threadIdx.x; e < rows * a.hd4; e += kThreads) {
      const int r = e / a.hd4, c = e - r * a.hd4;
      const float* src = row_src(r);
      const bool ok = src != nullptr && c < a.hd;
      cp_async4(dst + r * stride + c, ok ? src + c : a.q, ok);
    }
  }
}

template <int DPL>   // head dims per lane: ceil(hd / 32)
__global__ void __launch_bounds__(kThreads) prefill_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int KS = a.hd4 + 4;
  float* qs = reinterpret_cast<float*>(smem4);   // [kRows][hd4]
  float* ks = qs + kRows * a.hd4;                // [BS][KS]
  float* vs = ks + BS * KS;                      // [BS][hd4]
  float* ps = vs + BS * a.hd4;                   // [kRows][BS]

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nrows = a.S * a.G, r0 = blockIdx.x * kRows;
  const int q_first = r0 / a.G;
  const int q_last = (min(r0 + kRows, nrows) - 1) / a.G;
  // flattened row r = i * G + g is query head h * G + g at position i
  auto row_off = [&](int r) -> size_t {
    const int i = r / a.G, g = r - i * a.G;
    return (((size_t)b * a.S + i) * a.H + (size_t)h * a.G + g) * a.hd;
  };

  if (a.head_mask[h] == 0) {
    for (int e = tid; e < kRows * a.hd; e += kThreads) {
      const int rr = e / a.hd, d = e - rr * a.hd;
      if (r0 + rr < nrows) a.out[row_off(r0 + rr) + d] = 0.f;
    }
    return;
  }
  const int t_eff = min(a.t_valid, a.T);

  copy_rows(a, qs, a.hd4, kRows, [&](int rr) -> const float* {
    return r0 + rr < nrows ? a.q + row_off(r0 + rr) : nullptr;
  });

  int qpos[kRowsPerWarp];
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp], o[kRowsPerWarp][DPL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + warp * kRowsPerWarp + i;
    qpos[i] = r < nrows ? r / a.G : -1;   // -1: no such row, no valid key
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int u = 0; u < DPL; ++u) o[i][u] = 0.f;
  }

  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q_first - a.window + 1) / BS * BS;
  const int k_end = a.causal ? min(t_eff, q_last + 1) : t_eff;
  const float* qw = qs + warp * kRowsPerWarp * a.hd4;
  float* pw = ps + warp * kRowsPerWarp * BS;

  for (int k_lo = k_begin; k_lo < k_end; k_lo += BS) {
    __syncthreads();   // the previous block's K/V are no longer read
    const size_t kv0 = (((size_t)b * a.T + k_lo) * a.Hkv + h) * a.hd;
    const size_t kv_row = (size_t)a.Hkv * a.hd;
    copy_rows(a, ks, KS, BS, [&](int j) -> const float* {
      return k_lo + j < t_eff ? a.k + kv0 + j * kv_row : nullptr;
    });
    copy_rows(a, vs, a.hd4, BS, [&](int j) -> const float* {
      return k_lo + j < t_eff ? a.v + kv0 + j * kv_row : nullptr;
    });
    cp_async_wait_all();
    __syncthreads();

    // scores of key k_lo + lane against the warp's rows
    const int kpos = k_lo + lane;
    float part[kRowsPerWarp][4];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[i][c] = 0.f;
    const float4* kr = reinterpret_cast<const float4*>(ks + lane * KS);
    for (int d4 = 0; d4 < a.hd4 / 4; ++d4) {
      const float4 kv = kr[d4];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv = reinterpret_cast<const float4*>(qw + i * a.hd4)[d4];
        part[i][0] = fmaf(qv.x, kv.x, part[i][0]);
        part[i][1] = fmaf(qv.y, kv.y, part[i][1]);
        part[i][2] = fmaf(qv.z, kv.z, part[i][2]);
        part[i][3] = fmaf(qv.w, kv.w, part[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const bool valid = qpos[i] >= 0 && kpos < t_eff &&
                         (!a.causal || kpos <= qpos[i]) &&
                         (a.window <= 0 || kpos > qpos[i] - a.window);
      const float s = valid ? ((part[i][0] + part[i][1])
                               + (part[i][2] + part[i][3])) * a.scale
                            : -INFINITY;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      // a row with no valid key yet keeps its (empty) state unchanged
      const bool empty = m_new == -INFINITY;
      const float p = (empty || !valid) ? 0.f : expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = empty ? 1.f : expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
      pw[i * BS + lane] = p;
#pragma unroll
      for (int u = 0; u < DPL; ++u) o[i][u] *= alpha;
    }
    __syncwarp();

    // o += P · V over the block's keys, in key order
    int dcol[DPL];
#pragma unroll
    for (int u = 0; u < DPL; ++u) dcol[u] = min(lane + 32 * u, a.hd4 - 1);
#pragma unroll 2
    for (int j4 = 0; j4 < BS; j4 += 4) {
      float4 pv[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        pv[i] = *reinterpret_cast<const float4*>(pw + i * BS + j4);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DPL];
#pragma unroll
        for (int u = 0; u < DPL; ++u) vv[u] = vs[(j4 + jj) * a.hd4 + dcol[u]];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float pj = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                         : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int u = 0; u < DPL; ++u) o[i][u] = fmaf(pj, vv[u], o[i][u]);
        }
      }
    }
    __syncwarp();   // pw is rewritten by the next block
  }
  cp_async_wait_all();   // Q's copies, when no key block was walked

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (qpos[i] < 0) continue;
    const size_t off = row_off(r0 + warp * kRowsPerWarp + i);
    const float denom = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int u = 0; u < DPL; ++u) {
      const int d = lane + 32 * u;
      if (d < a.hd) a.out[off + d] = o[i][u] / denom;
    }
  }
}

template <int DPL>
int launch_dpl(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kRows * a.hd4
                                       + BS * (a.hd4 + 4) + BS * a.hd4
                                       + kRows * BS);
  // the attribute is set once per kernel, for the largest size yet asked
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        prefill_kernel<DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  const dim3 grid((a.S * a.G + kRows - 1) / kRows, a.Hkv, B);
  prefill_kernel<DPL><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
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
  if (H % Hkv != 0 || hd <= 0 || hd > kMaxHd || B > 65535 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q; a.k = k; a.v = v; a.head_mask = head_mask; a.out = out;
  a.S = S; a.T = T; a.H = H; a.Hkv = Hkv; a.G = H / Hkv; a.hd = hd;
  a.hd4 = (hd + 3) / 4 * 4; a.causal = causal; a.window = window;
  a.t_valid = t_valid; a.scale = scale;
  const auto aligned = [](const float* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  a.vec = (hd & 3) == 0 && aligned(q) && aligned(k) && aligned(v);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((hd + 31) / 32) {
    case 1: return launch_dpl<1>(a, B, st);
    case 2: return launch_dpl<2>(a, B, st);
    case 3: return launch_dpl<3>(a, B, st);
    default: return launch_dpl<4>(a, B, st);
  }
}

}  // extern "C"
