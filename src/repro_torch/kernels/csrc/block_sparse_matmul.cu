// Block-sparse matmul over a tile keep mask, float32 on the CUDA cores.
// Replaces the Pallas kernel repro/kernels/block_sparse_matmul.py::
// block_sparse_matmul: `_kernel` (forward) and `_kernel_t` (transpose_rhs).
//
//   forward     y (M, N) = x (M, K) @ (W ⊙ expand(mask))      W: (K, N)
//   transposed  y (M, K) = x (M, N) @ (W ⊙ expand(mask))^T    same W, mask
//
// mask is (ceil(K/bk), ceil(N/bn)) int32; W element (k, n) counts only where
// mask[k / bk][n / bn] != 0.  The mask tiles (bk, bn) are the pruning grid
// and can be any size (72 x 24, 192 x 72, 72 x 6144 ...): the CTA tile does
// not have to line up with them, so every W element's tile is looked up.
//
// Each CTA owns a BM x BN output tile and walks the contraction in chunks of
// BC in one fixed order.  Before loading a chunk it checks the mask tiles
// under (chunk x its BN columns); if all are dropped it skips the chunk,
// loads included (the TPU kernel still fetched masked tiles).  Each output
// element is one thread's fmaf chain over the contraction in ascending
// order, so a row's result does not depend on M or on the row's position
// (no split-K): the serving engine's slot invariance rests on this.
//
// Bound on an H100: at serving batch (M = 32) the kept weight bytes
// dominate (memory-bound, ~8 FLOP per weight element read); at M = 1024 the
// float32 FMA rate bounds it.  No tensor cores: TF32 would break the 1e-4
// parity with the plain version.  Ragged M, K, N need no padding copies:
// every load is bounds-checked and out-of-range elements enter as zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32, BN = 64, BC = 16;
constexpr int TM = 2, TN = 4;              // per-thread output micro-tile
constexpr int kThreads = (BM / TM) * (BN / TN);   // 256

// Operand B of the product y = x @ B, with B (C, NO):
//   forward     B[c][j] = W[c][j],  tile (c / bk, j / bn)
//   transposed  B[c][j] = W[j][c],  tile (j / bk, c / bn)
template <bool kTrans>
__global__ void __launch_bounds__(kThreads)
bsmm_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const int32_t* __restrict__ mask, float* __restrict__ y,
            int M, int C, int NO, int N, int bk, int bn, int tn) {
  __shared__ __align__(16) float xs[BC][BM + 4];
  __shared__ __align__(16) float bs[BC][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int j_hi = min(j0 + BN, NO) - 1;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += BC) {
    const int c_hi = min(c0 + BC, C) - 1;
    // mask tiles under this chunk and this CTA's columns
    const int r_lo = kTrans ? j0 / bk : c0 / bk;
    const int r_hi = kTrans ? j_hi / bk : c_hi / bk;
    const int q_lo = kTrans ? c0 / bn : j0 / bn;
    const int q_hi = kTrans ? c_hi / bn : j_hi / bn;
    const int nq = q_hi - q_lo + 1, count = (r_hi - r_lo + 1) * nq;
    int live = 0;
    for (int e = tid; e < count && !live; e += kThreads)
      live = mask[(size_t)(r_lo + e / nq) * tn + q_lo + e % nq] != 0;
    if (!__syncthreads_or(live)) continue;   // every tile dropped: no loads

    for (int e = tid; e < BM * BC; e += kThreads) {
      const int i = e / BC, cc = e % BC;
      const int m = m0 + i, c = c0 + cc;
      xs[cc][i] = (m < M && c < C) ? x[(size_t)m * C + c] : 0.f;
    }
    for (int e = tid; e < BC * BN; e += kThreads) {
      // neighbouring threads read neighbouring W addresses in both modes
      const int cc = kTrans ? e % BC : e / BN;
      const int jj = kTrans ? e / BC : e % BN;
      const int c = c0 + cc, j = j0 + jj;
      float val = 0.f;
      if (c < C && j < NO) {
        const int kk = kTrans ? j : c, nn = kTrans ? c : j;
        if (mask[(size_t)(kk / bk) * tn + nn / bn] != 0)
          val = w[(size_t)kk * N + nn];
      }
      bs[cc][jj] = val;
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < BC; ++cc) {
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[cc][tx * TN]);
      const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float a = xs[cc][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = j0 + tx * TN + j;
      if (col < NO) y[(size_t)m * NO + col] = acc[i][j];
    }
  }
}

template <bool kTrans>
int launch(const float* x, const float* w, const int32_t* mask, float* y,
           int M, int K, int N, int bk, int bn, void* stream) {
  const int C = kTrans ? N : K, NO = kTrans ? K : N;
  if (M == 0 || NO == 0) return 0;
  if (bk <= 0 || bn <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tn = (N + bn - 1) / bn;
  dim3 grid((NO + BN - 1) / BN, (M + BM - 1) / BM);
  bsmm_kernel<kTrans><<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, w, mask, y, M, C, NO, N, bk, bn, tn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (M, K), w (K, N), mask (ceil(K/bk), ceil(N/bn)) -> y (M, N); row-major.
int bsmm_forward(const float* x, const float* w, const int32_t* mask,
                 float* y, int M, int K, int N, int bk, int bn,
                 void* stream) {
  return launch<false>(x, w, mask, y, M, K, N, bk, bn, stream);
}

// x (M, N), w (K, N), mask (ceil(K/bk), ceil(N/bn)) -> y (M, K); row-major.
int bsmm_transposed(const float* x, const float* w, const int32_t* mask,
                    float* y, int M, int K, int N, int bk, int bn,
                    void* stream) {
  return launch<true>(x, w, mask, y, M, K, N, bk, bn, stream);
}

}  // extern "C"
