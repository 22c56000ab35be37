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
//   * row-parallel: forward layers, then the loss and dz (loss_kernel),
//     then the back-propagated dz, each into a per-row workspace of
//     (clients x batch) x width float32;
//   * output-tile-parallel: each CTA reduces a block of dW (and db) over
//     one fixed segment of rows; reduce_segments_kernel sums the segments
//     in index order.
// No float atomics anywhere: every sum has a fixed order, so a run repeats
// bit for bit.  No TF32: every product is a float32 fmaf on the CUDA cores
// (TF32 breaks the 1e-4 parity with the plain version).
//
// Bound on an H100 at the 784-60-20-10 model, 10,000 clients x batch 8:
// ~15.7 GFLOP of dense float32 FMA work, 94% of it in the input layer
// (784 -> 60), against ~0.65 GB that this two-pass design moves (x is read
// by the forward and again by dW): compute-bound on the CUDA cores.  The
// input layer's two passes are therefore built for FMA throughput, each
// templated on the pruning block so that tile loops unroll and keep
// indices are shifts, each CTA of 256 threads, two CTAs an SM:
//   * wide_rows_kernel (forward): a CTA takes 128 rows x 64 columns, a
//     thread an 8-row x 4-column register tile.  x (row-major, each 8-row
//     group offset by 4 floats so that a warp's two groups lie on different
//     banks) and the matching 32 x 64 slice of W are staged by 16-byte
//     cp.async copies into a ring of up to kStages stages, with the keeps
//     of the stage's clients; a 4-deep step reads 8 float4 of x and 4 of W
//     for 128 FMAs.  Each keep tile's partial product is folded as acc =
//     fmaf(kv, part, acc), kv from shared memory.
//   * wide_dw_kernel (dW): a CTA takes a 128 (k) x 64 (n) block of dW over
//     one row segment, a thread an 8 (k) x 4 (n) tile; rows of a and dz are
//     staged row-major by cp.async, 32 rows a stage, with the stage's
//     client weights and keeps.  A thread forms its scale wts[c] * keep[c,
//     kt, nt] once per client and folds it into its 4 dz values; a row costs
//     2 LDS.128 of a and 1 of dz for 32 FMAs, with no global load, no
//     division and no branch on the keep in the row loop.
// On an H100 (700 W) at the slice both run at ~40% of the float32 FMA peak
// (PERF.md); an 8 x 8 dW tile, 3 CTAs an SM and other ring depths were no
// faster.
// Rows whose width or base is not a multiple of 16 bytes take 4-byte
// cp.async copies instead (the scalar path).  The narrow layers (60 -> 20
// -> 10, ~6% of the MACs) and the back-propagated dz keep the first
// design: masked_rows_kernel and dw_partial_kernel, 64 x 64 tiles staged
// synchronously, a 4 x 4 register tile, keeps read per row.  A pruned tile
// contributes zero because its keep multiplies the tile's partial product.
// Rows past the end are bounds-checked, so a client count that is not a
// multiple of any tile needs no padding, and the class dimension is never
// padded (the Pallas kernel's -1e30 padded-class columns do not exist here).
//
// Requirements checked by the Python wrapper: float32 operands, the pruning
// block divides 32 and is a multiple of 4.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads a CTA in every tiled pass
constexpr int RB = 64;         // rows per CTA (row-parallel pass)
constexpr int OB = 64;         // output columns per CTA
constexpr int KC = 32;         // contraction depth staged per step
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int RC = 32;         // rows staged per step (dW pass)

// the input layer's passes (wide_rows_kernel, wide_dw_kernel)
constexpr int kStages = 3;     // deepest cp.async ring (at least 2)
constexpr int kRowsCTAs = 2;   // CTAs an SM the forward is built for
constexpr int kDwCTAs = 2;     // CTAs an SM the dW pass is built for
constexpr int WR = 128;        // forward: rows per CTA, 8 a thread
constexpr int WK = 32;         // forward: contraction depth a stage
constexpr int WO = 64;         // output columns per CTA, 4 a thread
constexpr int DK = 128;        // dW: rows of dW per CTA, 8 a thread
constexpr int DR = 32;         // dW: batch rows a stage
constexpr int XS = WK + 4;     // padded row strides in shared memory, in
constexpr int OS = WO + 4;     // floats (multiples of 4 keep float4
constexpr int AS = DK + 4;     // alignment); each 8-row group of x is
constexpr int XG = 8 * XS + 4; // XG floats on, so the two groups a warp
                               // reads lie on different banks
constexpr int kMaxSmem = 227 * 1024;  // a CTA's shared memory at most
constexpr int kSmSmem = 228 * 1024;   // an SM's, 1 KB of it reserved a CTA
static_assert(WK % 32 == 0 && DK % 32 == 0 && WO % 32 == 0,
              "every pruning block (4..32) must divide the staged tiles");
static_assert(WR == 16 * 8 && WO == 16 * 4 && DK == 16 * 8,
              "16 x 16 threads, 8 x 4 outputs each");
static_assert(kStages >= 2 && kStages <= 4, "cp_async_wait_ring's range");

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Wait until the oldest stage of a ring of nst has landed: every iteration
// commits one group (empty past the end), so nst - 2 may stay in flight.
__device__ __forceinline__ void cp_async_wait_ring(int nst) {
  if (nst >= 4) cp_async_wait<2>();
  else if (nst == 3) cp_async_wait<1>();
  else cp_async_wait<0>();
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Most clients that `rows` consecutive batch rows can touch.
__host__ __device__ inline int span_clients(int rows, int batch) {
  const int n = (rows - 1) / batch + 2;
  return n < rows ? n : rows;
}

// Floats of one ring stage of each input-layer kernel.
__host__ __device__ inline int rows_stage_floats(int batch, int block) {
  return (WR / 8) * XG + WK * OS +
         round4(span_clients(WR, batch) * (WK / block) * (WO / block));
}

__host__ __device__ inline int dw_stage_floats(int batch, int block) {
  const int ncl = span_clients(DR, batch);
  return DR * AS + DR * OS + round4(ncl * (DK / block) * (WO / block)) +
         round4(ncl);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

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

// The input layer's forward: out[r, o] = relu?(bias[o] + sum_t keep(c(r),
// t, o) * sum_{i in t} x[r, i] W[i, o]); W (Din, Dout), keep (C, Tin, Tout).
// vec: Din and Dout multiples of 4 and x, W 16-byte aligned (16-byte
// copies); otherwise 4-byte copies.  nst: the ring's depth.
template <int BLOCK>
__global__ void __launch_bounds__(kThreads, kRowsCTAs)
wide_rows_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ keep,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int R, int Din, int Dout, int batch, int relu, int vec,
                 int nst) {
  constexpr int KT = WK / BLOCK, OT = WO / BLOCK;  // keep tiles a stage
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int r0 = blockIdx.x * WR, o0 = blockIdx.y * WO;
  const int tin = (Din + BLOCK - 1) / BLOCK;
  const int tout = (Dout + BLOCK - 1) / BLOCK;
  const int nkv = span_clients(WR, batch) * KT * OT;
  const int stage = rows_stage_floats(batch, BLOCK);
  const int c_lo = r0 / batch;
  const int c_hi = (min(R, r0 + WR) - 1) / batch;

  // offset of each of the thread's rows' keep (tile 0 of the stage, the
  // thread's column tile) within a stage's keeps
  int kofs[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int r = min(r0 + tr * 8 + a, R - 1);
    kofs[a] = (r / batch - c_lo) * KT * OT + (tc * 4) / BLOCK;
  }

  auto load = [&](int kb, int slot) {
    float* sx = smem + slot * stage;
    float* sw = sx + (WR / 8) * XG;
    float* skv = sw + WK * OS;
    const int i0 = kb * WK;
    if (vec) {
      for (int e = tid; e < WR * (WK / 4); e += kThreads) {
        const int rr = e / (WK / 4), q = 4 * (e % (WK / 4));
        const int r = r0 + rr, i = i0 + q;
        const bool ok = r < R && i < Din;
        cp_async16(sx + (rr / 8) * XG + (rr % 8) * XS + q,
                   ok ? x + (size_t)r * Din + i : x, ok);
      }
      for (int e = tid; e < WK * (WO / 4); e += kThreads) {
        const int ii = e / (WO / 4), q = 4 * (e % (WO / 4));
        const int i = i0 + ii, o = o0 + q;
        const bool ok = i < Din && o < Dout;
        cp_async16(sw + ii * OS + q, ok ? w + (size_t)i * Dout + o : w, ok);
      }
    } else {
      for (int e = tid; e < WR * WK; e += kThreads) {
        const int rr = e / WK, q = e % WK;
        const int r = r0 + rr, i = i0 + q;
        const bool ok = r < R && i < Din;
        cp_async4(sx + (rr / 8) * XG + (rr % 8) * XS + q,
                  ok ? x + (size_t)r * Din + i : x, ok);
      }
      for (int e = tid; e < WK * WO; e += kThreads) {
        const int ii = e / WO, q = e % WO;
        const int i = i0 + ii, o = o0 + q;
        const bool ok = i < Din && o < Dout;
        cp_async4(sw + ii * OS + q, ok ? w + (size_t)i * Dout + o : w, ok);
      }
    }
    for (int e = tid; e < nkv; e += kThreads) {
      const int cl = e / (KT * OT), kt = (e / OT) % KT, ot = e % OT;
      const int c = c_lo + cl, it = i0 / BLOCK + kt, oo = o0 / BLOCK + ot;
      const bool ok = c <= c_hi && it < tin && oo < tout;
      cp_async4(skv + e, ok ? keep + ((size_t)c * tin + it) * tout + oo : keep,
                ok);
    }
  };

  float acc[8][4], part[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = part[a][b] = 0.f;

  const int nk = (Din + WK - 1) / WK;
  for (int s = 0; s < nst - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kb = 0; kb < nk; ++kb) {
    cp_async_wait_ring(nst);
    __syncthreads();  // stage kb landed for all; stage kb - 1 is free
    if (kb + nst - 1 < nk) load(kb + nst - 1, (kb + nst - 1) % nst);
    cp_async_commit();
    const float* sx = smem + (kb % nst) * stage + tr * XG;
    const float* sw = smem + (kb % nst) * stage + (WR / 8) * XG + tc * 4;
    const float* skv = sw - tc * 4 + WK * OS;
    // live keep tiles of the stage
    const int tiles = min(KT, (Din - kb * WK + BLOCK - 1) / BLOCK);
#pragma unroll 1
    for (int t = 0; t < tiles; ++t) {
#pragma unroll
      for (int k = t * BLOCK; k < (t + 1) * BLOCK; k += 4) {
        const float4 w0 = ld4(sw + (k + 0) * OS), w1 = ld4(sw + (k + 1) * OS);
        const float4 w2 = ld4(sw + (k + 2) * OS), w3 = ld4(sw + (k + 3) * OS);
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const float4 xv = ld4(sx + a * XS + k);
          part[a][0] = fmaf(xv.x, w0.x, part[a][0]);
          part[a][1] = fmaf(xv.x, w0.y, part[a][1]);
          part[a][2] = fmaf(xv.x, w0.z, part[a][2]);
          part[a][3] = fmaf(xv.x, w0.w, part[a][3]);
          part[a][0] = fmaf(xv.y, w1.x, part[a][0]);
          part[a][1] = fmaf(xv.y, w1.y, part[a][1]);
          part[a][2] = fmaf(xv.y, w1.z, part[a][2]);
          part[a][3] = fmaf(xv.y, w1.w, part[a][3]);
          part[a][0] = fmaf(xv.z, w2.x, part[a][0]);
          part[a][1] = fmaf(xv.z, w2.y, part[a][1]);
          part[a][2] = fmaf(xv.z, w2.z, part[a][2]);
          part[a][3] = fmaf(xv.z, w2.w, part[a][3]);
          part[a][0] = fmaf(xv.w, w3.x, part[a][0]);
          part[a][1] = fmaf(xv.w, w3.y, part[a][1]);
          part[a][2] = fmaf(xv.w, w3.z, part[a][2]);
          part[a][3] = fmaf(xv.w, w3.w, part[a][3]);
        }
      }
      // the tile's end: fold its partial product with the keep
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const float kv = skv[kofs[a] + t * OT];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc[a][b] = fmaf(kv, part[a][b], acc[a][b]);
          part[a][b] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int r = r0 + tr * 8 + a;
    if (r >= R) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int o = o0 + tc * 4 + b;
      if (o >= Dout) continue;
      float v = acc[a][b] + bias[o];
      if (relu) v = v > 0.f ? v : 0.f;
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

// The input layer's dW, one row segment per blockIdx.z:
// partial[s, k, n] = sum over rows r of segment s of
//                    a[r, k] * dz[r, n] * (wts[c(r)] * keep(c(r), k, n))
// partial[s, K, n] = sum over the same rows of dz[r, n] * wts[c(r)]  (db)
// At BLOCK 4 a thread's 8 k rows span two keep tiles, with a scale each.
// vec and nst as for wide_rows_kernel.
template <int BLOCK>
__global__ void __launch_bounds__(kThreads, kDwCTAs)
wide_dw_kernel(const float* __restrict__ a, const float* __restrict__ dz,
               const float* __restrict__ wts, const float* __restrict__ keep,
               float* __restrict__ partial, int R, int K, int N, int batch,
               int seg_rows, int vec, int nst) {
  constexpr int KT = DK / BLOCK, OT = WO / BLOCK;  // keep tiles a CTA
  constexpr bool SPLIT = BLOCK == 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int tk = tid / 16, tn = tid % 16;
  const int k0 = blockIdx.x * DK, n0 = blockIdx.y * WO, seg = blockIdx.z;
  const int rs = seg * seg_rows;
  const int re = min(R, rs + seg_rows);
  const int tkn = (K + BLOCK - 1) / BLOCK, tnn = (N + BLOCK - 1) / BLOCK;
  const int ncl = span_clients(DR, batch);
  const int stage = dw_stage_floats(batch, BLOCK);
  const int c_end = (re - 1) / batch;
  // the thread's keep tiles within a client's staged keeps
  const int kp0 = ((tk * 8) / BLOCK) * OT + (tn * 4) / BLOCK;
  const int kp1 = ((tk * 8 + 4) / BLOCK) * OT + (tn * 4) / BLOCK;
  const bool bias_thread = blockIdx.x == 0 && tk == 0;

  auto load = [&](int j, int slot) {
    float* sa = smem + slot * stage;
    float* sd = sa + DR * AS;
    float* skp = sd + DR * OS;
    float* swt = skp + round4(ncl * KT * OT);
    const int rb = rs + j * DR;
    const int c_lo = rb / batch;
    if (vec) {
      for (int e = tid; e < DR * (DK / 4); e += kThreads) {
        const int rr = e / (DK / 4), q = 4 * (e % (DK / 4));
        const int r = rb + rr, k = k0 + q;
        const bool ok = r < re && k < K;
        cp_async16(sa + rr * AS + q, ok ? a + (size_t)r * K + k : a, ok);
      }
      for (int e = tid; e < DR * (WO / 4); e += kThreads) {
        const int rr = e / (WO / 4), q = 4 * (e % (WO / 4));
        const int r = rb + rr, n = n0 + q;
        const bool ok = r < re && n < N;
        cp_async16(sd + rr * OS + q, ok ? dz + (size_t)r * N + n : dz, ok);
      }
    } else {
      for (int e = tid; e < DR * DK; e += kThreads) {
        const int rr = e / DK, q = e % DK;
        const int r = rb + rr, k = k0 + q;
        const bool ok = r < re && k < K;
        cp_async4(sa + rr * AS + q, ok ? a + (size_t)r * K + k : a, ok);
      }
      for (int e = tid; e < DR * WO; e += kThreads) {
        const int rr = e / WO, q = e % WO;
        const int r = rb + rr, n = n0 + q;
        const bool ok = r < re && n < N;
        cp_async4(sd + rr * OS + q, ok ? dz + (size_t)r * N + n : dz, ok);
      }
    }
    for (int e = tid; e < ncl * KT * OT; e += kThreads) {
      const int cl = e / (KT * OT), kt = (e / OT) % KT, nt = e % OT;
      const int c = c_lo + cl, it = k0 / BLOCK + kt, jt = n0 / BLOCK + nt;
      const bool ok = c <= c_end && it < tkn && jt < tnn;
      cp_async4(skp + e, ok ? keep + ((size_t)c * tkn + it) * tnn + jt : keep,
                ok);
    }
    for (int e = tid; e < ncl; e += kThreads) {
      const bool ok = c_lo + e <= c_end;
      cp_async4(swt + e, ok ? wts + c_lo + e : wts, ok);
    }
  };

  float acc[8][4];
  float bacc[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    bacc[b] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][b] = 0.f;
  }

  const int nchunk = (re - rs + DR - 1) / DR;
  for (int s = 0; s < nst - 1; ++s) {
    if (s < nchunk) load(s, s);
    cp_async_commit();
  }
  for (int j = 0; j < nchunk; ++j) {
    cp_async_wait_ring(nst);
    __syncthreads();  // chunk j landed for all; chunk j - 1 is free
    if (j + nst - 1 < nchunk) load(j + nst - 1, (j + nst - 1) % nst);
    cp_async_commit();
    const float* sa = smem + (j % nst) * stage + tk * 8;
    const float* sd = smem + (j % nst) * stage + DR * AS + tn * 4;
    const float* skp = sd - tn * 4 + DR * OS;
    const float* swt = skp + round4(ncl * KT * OT);
    const int rb = rs + j * DR;
    const int nrow = min(DR, re - rb);
    // the client of row rb, its rows left from rb, its weight and scales
    int cl = 0, left = batch - rb % batch;
    float wc = swt[0];
    float sc0 = wc * skp[kp0];
    float sc1 = SPLIT ? wc * skp[kp1] : sc0;
    for (int rr = 0; rr < nrow; ++rr) {
      if (left == 0) {  // next client (the same for every thread)
        ++cl;
        left = batch;
        wc = swt[cl];
        sc0 = wc * skp[cl * KT * OT + kp0];
        if (SPLIT) sc1 = wc * skp[cl * KT * OT + kp1];
      }
      --left;
      const float4 dc = ld4(sd + rr * OS);
      const float4 ac0 = ld4(sa + rr * AS), ac1 = ld4(sa + rr * AS + 4);
      const float d0[4] = {dc.x * sc0, dc.y * sc0, dc.z * sc0, dc.w * sc0};
      float d1[4] = {d0[0], d0[1], d0[2], d0[3]};
      if (SPLIT) {
        d1[0] = dc.x * sc1; d1[1] = dc.y * sc1;
        d1[2] = dc.z * sc1; d1[3] = dc.w * sc1;
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        acc[0][b] = fmaf(ac0.x, d0[b], acc[0][b]);
        acc[1][b] = fmaf(ac0.y, d0[b], acc[1][b]);
        acc[2][b] = fmaf(ac0.z, d0[b], acc[2][b]);
        acc[3][b] = fmaf(ac0.w, d0[b], acc[3][b]);
        acc[4][b] = fmaf(ac1.x, d1[b], acc[4][b]);
        acc[5][b] = fmaf(ac1.y, d1[b], acc[5][b]);
        acc[6][b] = fmaf(ac1.z, d1[b], acc[6][b]);
        acc[7][b] = fmaf(ac1.w, d1[b], acc[7][b]);
      }
      if (bias_thread) {
        bacc[0] = fmaf(dc.x, wc, bacc[0]);
        bacc[1] = fmaf(dc.y, wc, bacc[1]);
        bacc[2] = fmaf(dc.z, wc, bacc[2]);
        bacc[3] = fmaf(dc.w, wc, bacc[3]);
      }
    }
  }
  cp_async_wait<0>();

  float* P = partial + (size_t)seg * (K + 1) * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + tk * 8 + i;
    if (k >= K) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int n = n0 + tn * 4 + b;
      if (n < N) P[(size_t)k * N + n] = acc[i][b];
    }
  }
  if (bias_thread) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int n = n0 + tn * 4 + b;
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

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The deepest ring (at most kStages, at least 2) at which `ctas` CTAs fit
// an SM's shared memory (one CTA, where even 2 stages do not).
inline int ring_depth(size_t stage_bytes, int ctas) {
  int n = kStages;
  while (n > 2 && (n * stage_bytes > (size_t)kMaxSmem ||
                   ctas * (n * stage_bytes + 1024) > (size_t)kSmSmem))
    --n;
  return n;
}

// Allow `bytes` of dynamic shared memory for `fn` (once per larger size),
// with the SM's unified L1 / shared memory split set to shared at the first
// call, so that the CTAs a kernel is built for fit.
template <typename F>
inline cudaError_t allow_smem(F fn, size_t bytes, size_t* allowed) {
  if (*allowed == 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    *allowed = 48 * 1024;
  }
  if (bytes <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

template <int BLOCK>
int launch_wide_rows(const float* x, const float* w, const float* keep,
                     const float* bias, float* out, int R, int Din, int Dout,
                     int batch, int relu, cudaStream_t stream) {
  const size_t stage = sizeof(float) * rows_stage_floats(batch, BLOCK);
  const int nst = ring_depth(stage, kRowsCTAs);
  static size_t allowed = 0;
  const cudaError_t err =
      allow_smem(wide_rows_kernel<BLOCK>, nst * stage, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = Din % 4 == 0 && Dout % 4 == 0 && aligned16(x) &&
                  aligned16(w);
  const dim3 grid((R + WR - 1) / WR, (Dout + WO - 1) / WO);
  wide_rows_kernel<BLOCK><<<grid, kThreads, nst * stage, stream>>>(
      x, w, keep, bias, out, R, Din, Dout, batch, relu, vec, nst);
  return launch_status();
}

template <int BLOCK>
int launch_wide_dw(const float* a, const float* dz, const float* wts,
                   const float* keep, float* partial, int R, int K, int N,
                   int batch, int seg_rows, int nseg, cudaStream_t stream) {
  const size_t stage = sizeof(float) * dw_stage_floats(batch, BLOCK);
  const int nst = ring_depth(stage, kDwCTAs);
  static size_t allowed = 0;
  const cudaError_t err =
      allow_smem(wide_dw_kernel<BLOCK>, nst * stage, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = K % 4 == 0 && N % 4 == 0 && aligned16(a) && aligned16(dz);
  const dim3 grid((K + DK - 1) / DK, (N + WO - 1) / WO, nseg);
  wide_dw_kernel<BLOCK><<<grid, kThreads, nst * stage, stream>>>(
      a, dz, wts, keep, partial, R, K, N, batch, seg_rows, vec, nst);
  return launch_status();
}

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

// The input layer's forward: x (R, Din), W (Din, Dout), keep (C, Tin, Tout),
// bias (Dout,), out = relu?(masked product + bias); block in (4, 8, 16, 32).
int ff_wide_rows(const float* x, const float* w, const float* keep,
                 const float* bias, float* out, int R, int Din, int Dout,
                 int batch, int block, int relu, void* stream) {
  if (R == 0 || Dout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 4: return launch_wide_rows<4>(x, w, keep, bias, out, R, Din, Dout,
                                       batch, relu, s);
    case 8: return launch_wide_rows<8>(x, w, keep, bias, out, R, Din, Dout,
                                       batch, relu, s);
    case 16: return launch_wide_rows<16>(x, w, keep, bias, out, R, Din, Dout,
                                         batch, relu, s);
    case 32: return launch_wide_rows<32>(x, w, keep, bias, out, R, Din, Dout,
                                         batch, relu, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The input layer's dW partials: a (R, K), dz (R, N), keep (C, Tk, Tn);
// partial (nseg, K + 1, N) float32, row K of each segment holding db.
int ff_wide_dw(const float* a, const float* dz, const float* wts,
               const float* keep, float* partial, int R, int K, int N,
               int batch, int block, int seg_rows, int nseg, void* stream) {
  if (nseg == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 4: return launch_wide_dw<4>(a, dz, wts, keep, partial, R, K, N,
                                     batch, seg_rows, nseg, s);
    case 8: return launch_wide_dw<8>(a, dz, wts, keep, partial, R, K, N,
                                     batch, seg_rows, nseg, s);
    case 16: return launch_wide_dw<16>(a, dz, wts, keep, partial, R, K, N,
                                       batch, seg_rows, nseg, s);
    case 32: return launch_wide_dw<32>(a, dz, wts, keep, partial, R, K, N,
                                       batch, seg_rows, nseg, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
