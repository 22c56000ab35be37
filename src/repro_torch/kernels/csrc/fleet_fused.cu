// Fused block-pruned client gradients of the layer-structured MLP.
// Replaces the Pallas kernel repro/kernels/fleet_fused.py::fused_grads_pallas
// (body _build_fused_kernel); the semantics are those of fused_grads_xla.
//
// For rows r = (client c, sample) of the flattened (clients x batch) batch:
//   z_l = sum_t keep_l[c, t] * (a_l[:, rows of tile t] @ W_l[tile t]) + b_l
//   a_{l+1} = relu(z_l) for hidden layers; log-softmax cross-entropy last
//   dz_L = (softmax - onehot) / batch                       (unweighted)
//   dA_l = sum_t keep_l[c, t] * dz_l[:, cols of t] @ W_l[t]^T
//   dz_{l-1} = dA_l * (z_{l-1} > 0)
//   dW_l = sum_r wts[c] * keep_l[c, t] * a_l[r]^T dz_l[r]  (per tile t)
//   db_l = sum_r wts[c] * dz_l[r]                           (biases unmasked)
//
// The Pallas kernel carried dW in VMEM across a sequential grid of client
// tiles.  CTAs on Hopper run in parallel with nothing carried between them,
// so the work is split in two kinds of pass:
//   * row-parallel (masked_rows_kernel): forward layers, then the loss and
//     dz (loss_kernel), then the back-propagated dz, each into a per-row
//     workspace of (clients x batch) x width float32;
//   * output-tile-parallel (dw_partial_kernel): each CTA reduces a 64 x 64
//     block of dW (and db) over one fixed segment of rows; a second kernel
//     (reduce_segments_kernel) sums the segments in index order.
// No float atomics anywhere: every sum has a fixed order, so a run repeats
// bit for bit.
//
// Bound on an H100 at the 784-60-20-10 model, 10,000 clients x batch 8:
// about 15.7 GFLOP of float32 FMA work against 0.28 GB of traffic, i.e.
// compute-bound on the CUDA cores (tensor cores would need TF32 and lose
// the f32 parity).  This first design stages 64-row x 32-deep operand
// chunks in shared memory and gives each thread a 4 x 4 register tile;
// wgmma, TMA and whole-tile skipping are left for later work.  A pruned
// tile contributes zero because its keep multiplies the tile's partial
// product (dW passes skip it per row).  Rows past the end are bounds-
// checked, so a client count that is not a multiple of any tile needs no
// padding, and the class dimension is never padded (the Pallas kernel's
// -1e30 padded-class columns do not exist here).
//
// Requirements checked by the Python wrapper: float32 operands, the pruning
// block divides 32 and is a multiple of 4.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int RB = 64;         // rows per CTA (row-parallel pass)
constexpr int OB = 64;         // output columns per CTA
constexpr int KC = 32;         // contraction depth staged per step
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int RC = 32;         // rows staged per step (dW pass)

// out[r, o] = epilogue(sum_t keep(c(r), t, o) * sum_{i in t} in[r, i] w(i, o))
// TRANS = false (forward):  w(i, o) = W[i, o], W (Din, Dout),
//                           keep (C, Tin, Tout), epilogue + bias, relu.
// TRANS = true  (backward): w(i, o) = W[o, i], W (Dout, Din),
//                           keep (C, Tout, Tin), epilogue * (gate > 0).
template <bool TRANS>
__global__ void __launch_bounds__(kThreads)
masked_rows_kernel(const float* __restrict__ in, const float* __restrict__ w,
                   const float* __restrict__ keep,
                   const float* __restrict__ bias,
                   const float* __restrict__ gate, float* __restrict__ out,
                   int R, int Din, int Dout, int batch, int block, int relu) {
  __shared__ float s_in[KC][RB + 4];
  __shared__ float s_w[KC][OB + 4];
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int r0 = blockIdx.x * RB, o0 = blockIdx.y * OB;
  const int tin = (Din + block - 1) / block;
  const int tout = (Dout + block - 1) / block;
  const size_t keep_stride = (size_t)tin * tout;
  const int oc = o0 + tc * TN;   // first output column of this thread
  const int ot = oc / block;     // its pruning tile (block % TN == 0)

  int crow[TM];
  for (int a = 0; a < TM; ++a) {
    const int r = r0 + tr * TM + a;
    crow[a] = r < R ? r / batch : -1;
  }
  float acc[TM][TN];
  for (int a = 0; a < TM; ++a)
    for (int b = 0; b < TN; ++b) acc[a][b] = 0.f;

  for (int i0 = 0; i0 < Din; i0 += KC) {
    for (int e = tid; e < RB * KC; e += kThreads) {
      const int rr = e / KC, ii = e - rr * KC;
      const int r = r0 + rr, i = i0 + ii;
      s_in[ii][rr] = (r < R && i < Din) ? in[(size_t)r * Din + i] : 0.f;
    }
    for (int e = tid; e < KC * OB; e += kThreads) {
      int ii, oo;
      if (TRANS) { oo = e / KC; ii = e - oo * KC; }
      else       { ii = e / OB; oo = e - ii * OB; }
      const int i = i0 + ii, o = o0 + oo;
      float v = 0.f;
      if (i < Din && o < Dout)
        v = TRANS ? w[(size_t)o * Din + i] : w[(size_t)i * Dout + o];
      s_w[ii][oo] = v;
    }
    __syncthreads();
    for (int t0 = 0; t0 < KC && i0 + t0 < Din; t0 += block) {
      const int it = (i0 + t0) / block;
      float part[TM][TN];
      for (int a = 0; a < TM; ++a)
        for (int b = 0; b < TN; ++b) part[a][b] = 0.f;
      for (int ii = t0; ii < t0 + block; ++ii) {
        float av[TM], wv[TN];
        for (int a = 0; a < TM; ++a) av[a] = s_in[ii][tr * TM + a];
        for (int b = 0; b < TN; ++b) wv[b] = s_w[ii][tc * TN + b];
        for (int a = 0; a < TM; ++a)
          for (int b = 0; b < TN; ++b) part[a][b] = fmaf(av[a], wv[b], part[a][b]);
      }
      if (ot < tout) {
        for (int a = 0; a < TM; ++a) {
          if (crow[a] < 0) continue;
          const size_t kidx = (size_t)crow[a] * keep_stride +
              (TRANS ? (size_t)ot * tin + it : (size_t)it * tout + ot);
          const float kv = keep[kidx];
          for (int b = 0; b < TN; ++b) acc[a][b] = fmaf(kv, part[a][b], acc[a][b]);
        }
      }
    }
    __syncthreads();
  }

  for (int a = 0; a < TM; ++a) {
    const int r = r0 + tr * TM + a;
    if (r >= R) continue;
    for (int b = 0; b < TN; ++b) {
      const int o = oc + b;
      if (o >= Dout) continue;
      float v = acc[a][b];
      if (TRANS) {
        v = gate[(size_t)r * Dout + o] > 0.f ? v : 0.f;
      } else {
        v += bias[o];
        if (relu) v = v > 0.f ? v : 0.f;
      }
      out[(size_t)r * Dout + o] = v;
    }
  }
}

// One thread per client: log-softmax cross-entropy over its batch rows,
// dz = (softmax - onehot) / batch, and the client's mean loss.
__global__ void loss_kernel(const float* __restrict__ logits,
                            const int64_t* __restrict__ y,
                            float* __restrict__ dz, float* __restrict__ losses,
                            int C, int batch, int NC) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float nll_sum = 0.f;
  for (int s = 0; s < batch; ++s) {
    const size_t r = (size_t)c * batch + s;
    const float* z = logits + r * NC;
    float mx = -INFINITY;
    for (int j = 0; j < NC; ++j) mx = fmaxf(mx, z[j]);
    float se = 0.f;
    for (int j = 0; j < NC; ++j) se += expf(z[j] - mx);
    const float lse = logf(se);
    const int64_t label = y[r];
    for (int j = 0; j < NC; ++j) {
      const float p = expf((z[j] - mx) - lse);
      dz[r * NC + j] = (p - (j == label ? 1.f : 0.f)) / batch;
    }
    nll_sum += (label >= 0 && label < NC) ? -((z[label] - mx) - lse) : NAN;
  }
  losses[c] = nll_sum / batch;
}

// partial[s, k, n] = sum over rows r of segment s of
//                    a[r, k] * (dz[r, n] * wts[c(r)]) * keep(c(r), k, n)
// partial[s, K, n] = sum over the same rows of dz[r, n] * wts[c(r)]  (db)
__global__ void __launch_bounds__(kThreads)
dw_partial_kernel(const float* __restrict__ a, const float* __restrict__ dz,
                  const float* __restrict__ wts,
                  const float* __restrict__ keep, float* __restrict__ partial,
                  int R, int K, int N, int batch, int block, int seg_rows) {
  __shared__ float s_a[RC][OB + 4];
  __shared__ float s_d[RC][OB + 4];
  __shared__ int s_c[RC];
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int k0 = blockIdx.x * OB, n0 = blockIdx.y * OB, seg = blockIdx.z;
  const int rs = seg * seg_rows;
  const int re = min(R, rs + seg_rows);
  const int tk = (K + block - 1) / block, tn = (N + block - 1) / block;
  const int kc = k0 + tr * TM, nc = n0 + tc * TN;
  const bool live = kc < K && nc < N;
  const size_t kofs = (size_t)(kc / block) * tn + nc / block;
  const bool bias_row = blockIdx.x == 0 && tr == 0;

  float acc[TM][TN];
  float bacc[TN];
  for (int b = 0; b < TN; ++b) {
    bacc[b] = 0.f;
    for (int i = 0; i < TM; ++i) acc[i][b] = 0.f;
  }

  for (int rb = rs; rb < re; rb += RC) {
    for (int e = tid; e < RC * OB; e += kThreads) {
      const int rr = e / OB, cc = e - rr * OB;
      const int r = rb + rr;
      const int k = k0 + cc, n = n0 + cc;
      s_a[rr][cc] = (r < re && k < K) ? a[(size_t)r * K + k] : 0.f;
      s_d[rr][cc] = (r < re && n < N) ? dz[(size_t)r * N + n] * wts[r / batch] : 0.f;
    }
    if (tid < RC) s_c[tid] = rb + tid < re ? (rb + tid) / batch : 0;
    __syncthreads();
    const int nrow = min(RC, re - rb);
    for (int rr = 0; rr < nrow; ++rr) {
      float dv[TN];
      for (int b = 0; b < TN; ++b) dv[b] = s_d[rr][tc * TN + b];
      if (bias_row)
        for (int b = 0; b < TN; ++b) bacc[b] += dv[b];
      if (!live) continue;
      const float kv = keep[(size_t)s_c[rr] * tk * tn + kofs];
      if (kv == 0.f) continue;  // pruned tile for this client
      float av[TM];
      for (int i = 0; i < TM; ++i) av[i] = s_a[rr][tr * TM + i];
      for (int b = 0; b < TN; ++b) dv[b] *= kv;
      for (int i = 0; i < TM; ++i)
        for (int b = 0; b < TN; ++b) acc[i][b] = fmaf(av[i], dv[b], acc[i][b]);
    }
    __syncthreads();
  }

  float* P = partial + (size_t)seg * (K + 1) * N;
  if (live) {
    for (int i = 0; i < TM; ++i)
      for (int b = 0; b < TN; ++b) {
        const int k = kc + i, n = nc + b;
        if (k < K && n < N) P[(size_t)k * N + n] = acc[i][b];
      }
  }
  if (bias_row) {
    for (int b = 0; b < TN; ++b) {
      const int n = nc + b;
      if (n < N) P[(size_t)K * N + n] = bacc[b];
    }
  }
}

// out[j] = sum_{s < S} partial[s, j], in index order.
__global__ void reduce_segments_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int S,
                                       int64_t M) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= M) return;
  float s = 0.f;
  for (int i = 0; i < S; ++i) s += partial[(size_t)i * M + j];
  out[j] = s;
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Forward (trans = 0): in (R, Din), W (Din, Dout), keep (C, Tin, Tout),
//   bias (Dout,), out = relu?(masked product + bias).
// Backward (trans = 1): in = dz (R, Din), W (Dout, Din), keep (C, Tout, Tin),
//   gate (R, Dout), out = masked product * (gate > 0).
int ff_masked_rows(const float* in, const float* w, const float* keep,
                   const float* bias, const float* gate, float* out, int R,
                   int Din, int Dout, int batch, int block, int relu,
                   int trans, void* stream) {
  if (R == 0 || Dout == 0) return 0;
  dim3 grid((R + RB - 1) / RB, (Dout + OB - 1) / OB);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trans)
    masked_rows_kernel<true><<<grid, kThreads, 0, s>>>(
        in, w, keep, bias, gate, out, R, Din, Dout, batch, block, relu);
  else
    masked_rows_kernel<false><<<grid, kThreads, 0, s>>>(
        in, w, keep, bias, gate, out, R, Din, Dout, batch, block, relu);
  return launch_status();
}

int ff_loss(const float* logits, const int64_t* y, float* dz, float* losses,
            int C, int batch, int NC, void* stream) {
  if (C == 0) return 0;
  loss_kernel<<<(C + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, y, dz, losses, C, batch, NC);
  return launch_status();
}

// partial: (nseg, K + 1, N) float32; row K of each segment holds db.
int ff_dw_partial(const float* a, const float* dz, const float* wts,
                  const float* keep, float* partial, int R, int K, int N,
                  int batch, int block, int seg_rows, int nseg, void* stream) {
  if (nseg == 0) return 0;
  dim3 grid((K + OB - 1) / OB, (N + OB - 1) / OB, nseg);
  dw_partial_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, dz, wts, keep, partial, R, K, N, batch, block, seg_rows);
  return launch_status();
}

int ff_reduce(const float* partial, float* out, int S, int64_t M,
              void* stream) {
  if (M == 0) return 0;
  const int64_t blocks = (M + 255) / 256;
  reduce_segments_kernel<<<(unsigned)blocks, 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      partial, out, S, M);
  return launch_status();
}

}  // extern "C"
