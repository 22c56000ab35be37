// Per-tile squared L2 norms of a float32 weight matrix (the block-pruning
// ranking statistic).  Replaces the Pallas kernel
// repro/kernels/block_norms.py::block_norms.
//
// One CTA per (bk x bn) tile: each thread sums the squares of a strided
// share of the tile's real elements (ragged edge tiles stop at the matrix
// edge, which is what zero padding gives), then a fixed-order tree in
// shared memory reduces the CTA.  No atomics: the result is the same
// every run.  The work is a few hundred KB per call, so launch latency,
// not bytes or arithmetic, bounds it on an H100.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
tile_sqnorms_kernel(const float* __restrict__ w, float* __restrict__ out,
                    int K, int N, int bk, int bn, int tn) {
  const int ti = blockIdx.y, uj = blockIdx.x;
  const int k0 = ti * bk, n0 = uj * bn;
  const int kr = min(bk, K - k0), nr = min(bn, N - n0);
  const int count = kr * nr;
  float acc = 0.f;
  for (int e = threadIdx.x; e < count; e += kThreads) {
    const int r = e / nr, c = e - r * nr;
    const float v = w[(size_t)(k0 + r) * N + n0 + c];
    acc = fmaf(v, v, acc);
  }
  __shared__ float s[kThreads];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) s[threadIdx.x] += s[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[(size_t)ti * tn + uj] = s[0];
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// w: (K, N) row-major float32; out: (ceil(K/bk), ceil(N/bn)) float32.
int tile_sqnorms(const float* w, float* out, int K, int N, int bk, int bn,
                 void* stream) {
  const int tk = (K + bk - 1) / bk, tn = (N + bn - 1) / bn;
  if (tk == 0 || tn == 0) return 0;
  dim3 grid(tn, tk);
  tile_sqnorms_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w, out, K, N, bk, bn, tn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
