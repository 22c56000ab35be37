// The sLSTM's full-sequence scan (xLSTM's scalar memory with head-wise
// recurrence and exponential gating), forward and backward, float32.
// Replaces no Pallas kernel: the reference runs the cell as a
// jax.lax.scan (src/repro/models/recurrent.py:243, the cell at :213),
// which XLA compiles into one loop; stepped from PyTorch the same cell is
// ~30 launches a position.  Here one launch runs each direction.
//
// Per (batch row b, head h), gates g in (z, i, f, o), from (c, n, m, h0):
//   pre_g,t = x_g,t + h_{t-1} R_g            (R_g hd x hd: R[h][g][k][v])
//   z = tanh(pre_z)   o = sigmoid(pre_o)   lf = log sigmoid(pre_f)
//   m_t = max(lf + m_{t-1}, pre_i)   fe = exp(lf + m_{t-1} - m_t)
//   ie = exp(pre_i - m_t)   c_t = fe c_{t-1} + ie z
//   n_t = max(fe n_{t-1} + ie, 1e-6)   h_t = o c_t / n_t
// all elementwise in the head's hd dims except the four products with R.
//
// What bounds it.  The recurrence is nonlinear, so the positions are a
// chain of four hd x hd matrix-vector products: 8 hd^2 flops a step, and
// the four matrices (576 KB a head at hd = 192, float32) do not fit one
// SM's shared memory, so each step reads them from L2.  This first design
// is the simple one: one CTA per (b, h), a thread per (gate, column) of
// the products (4 hd threads, hd <= 256) reading its column of R with the
// other threads of its warp (128-byte rows), h_{t-1} in shared memory, and
// a thread per dim for the cell; two barriers a step.  Its time is the L2
// reads of R, S times.  (A cluster of CTAs that split R and exchange h
// through distributed shared memory is the faster design.)
//
// Backward (reverse in time).  A thread per dim carries dc, dn, dm and the
// recurrent dh; from the forward's saved pre-activations, c, n and m it
// forms the gradient of each pre-activation (clamp_min's gradient passes
// where fe n + ie >= 1e-6, torch.maximum splits it equally at a tie, as
// autograd of the stepped cell does), writes it (it is dx), and the
// products with R^T (passed transposed, so the reads are rows again) give
// dh_{t-1}.  dR = sum over rows and positions of h_{t-1}^T dpre is a plain
// matrix product, left to the caller.  Every sum runs in a fixed order, so
// reruns are bitwise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxHd = 256;           // 4 hd threads a CTA

struct Args {
  const float *x, *R, *c0, *n0, *m0, *h0;
  float *h, *c_all, *n_all, *m_all, *pre;
  const float *dh, *RT;
  float *dx, *dc0, *dn0, *dm0, *dh0;
  int B, S, H, hd;
};

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// sum_k vec[k] * M[k * hd] over k < hd: column `M` of a row-major hd x hd
// matrix against a vector in shared memory.  The column's loads go out
// kBatch at a time before their products (the L2's latency, not its
// bandwidth, would set the time with a few loads in flight); four chains,
// k mod 4, added in a fixed order.
constexpr int kBatch = 16;

__device__ __forceinline__ float column_dot(const float* __restrict__ M,
                                            const float* vec, int hd) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  int k = 0;
  for (; k + kBatch <= hd; k += kBatch) {
    float r[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) r[j] = M[static_cast<size_t>(k + j) * hd];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) s[j & 3] = fmaf(vec[k + j], r[j], s[j & 3]);
  }
  for (; k < hd; ++k)
    s[k & 3] = fmaf(vec[k], M[static_cast<size_t>(k) * hd], s[k & 3]);
  return (s[0] + s[1]) + (s[2] + s[3]);
}

__global__ void __launch_bounds__(4 * kMaxHd) slstm_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  const int hd = a.hd, tid = threadIdx.x;
  float* hs = smem;              // h_{t-1}, hd
  float* pre_s = smem + hd;      // this step's pre-activations, 4 hd
  const int bh = blockIdx.x, b = bh / a.H, hh = bh % a.H;
  const bool mat = tid < 4 * hd, cell = tid < hd;
  const int g = tid / hd, col = tid - g * hd;
  const float* Rcol = a.R + (static_cast<size_t>(hh) * 4 + (mat ? g : 0))
                                * hd * hd + col;
  const size_t st = static_cast<size_t>(bh) * hd + tid;   // state index
  float c = 0.f, n = 0.f, m = 0.f;
  if (cell) {
    c = a.c0[st];
    n = a.n0[st];
    m = a.m0[st];
    hs[tid] = a.h0[st];
  }
  const size_t xrow = static_cast<size_t>(a.H) * 4 * hd;   // a position
  const float* x = a.x + (static_cast<size_t>(b) * a.S * a.H + hh) * 4 * hd;
  float xn = mat ? x[tid] : 0.f;
  __syncthreads();
  for (int t = 0; t < a.S; ++t) {
    const float xv = xn;
    if (mat && t + 1 < a.S) xn = x[(t + 1) * xrow + tid];
    if (mat) {
      const float p = xv + column_dot(Rcol, hs, hd);
      pre_s[tid] = p;
      a.pre[t * xrow + (static_cast<size_t>(b) * a.S * a.H + hh) * 4 * hd
            + tid] = p;
    }
    __syncthreads();
    if (cell) {
      const float zp = pre_s[tid], ip = pre_s[hd + tid];
      const float fp = pre_s[2 * hd + tid], op = pre_s[3 * hd + tid];
      const float z = tanhf(zp), o = sigmoid(op);
      const float aa = log_sigmoid(fp) + m;
      const float mn = fmaxf(aa, ip);
      const float fe = expf(aa - mn), ie = expf(ip - mn);
      c = fe * c + ie * z;
      n = fmaxf(fe * n + ie, 1e-6f);
      m = mn;
      const float hv = o * c / n;
      hs[tid] = hv;
      const size_t o_ = ((static_cast<size_t>(b) * a.S + t) * a.H + hh) * hd
                        + tid;
      a.h[o_] = hv;
      a.c_all[o_] = c;
      a.n_all[o_] = n;
      a.m_all[o_] = m;
    }
    __syncthreads();
  }
}

// One position's saved values for the thread of dim `tid`.
struct CellIn {
  float zp, ip, fp, op, c, n, m, cp, np, mp, dy;
};

__device__ __forceinline__ void cell_load(CellIn& in, const Args& a, int b,
                                          int hh, int t, int tid) {
  const int hd = a.hd;
  const size_t o_ = ((static_cast<size_t>(b) * a.S + t) * a.H + hh) * hd
                    + tid;
  const size_t p_ = ((static_cast<size_t>(b) * a.S + t) * a.H + hh) * 4 * hd
                    + tid;
  in.zp = a.pre[p_];
  in.ip = a.pre[p_ + hd];
  in.fp = a.pre[p_ + 2 * hd];
  in.op = a.pre[p_ + 3 * hd];
  in.c = a.c_all[o_];
  in.n = a.n_all[o_];
  in.m = a.m_all[o_];
  in.dy = a.dh[o_];
  if (t > 0) {
    const size_t q_ = o_ - static_cast<size_t>(a.H) * hd;
    in.cp = a.c_all[q_];
    in.np = a.n_all[q_];
    in.mp = a.m_all[q_];
  } else {
    const size_t st = (static_cast<size_t>(b) * a.H + hh) * hd + tid;
    in.cp = a.c0[st];
    in.np = a.n0[st];
    in.mp = a.m0[st];
  }
}

__global__ void __launch_bounds__(4 * kMaxHd) slstm_bwd_kernel(Args a) {
  extern __shared__ float smem[];
  const int hd = a.hd, tid = threadIdx.x;
  float* dpre_s = smem;          // this step's dpre, 4 hd
  float* part_s = smem + 4 * hd; // the products with R^T by gate, 4 hd
  const int bh = blockIdx.x, b = bh / a.H, hh = bh % a.H;
  const bool mat = tid < 4 * hd, cell = tid < hd;
  const int g = tid / hd, col = tid - g * hd;
  const float* RTcol = a.RT + (static_cast<size_t>(hh) * 4 + (mat ? g : 0))
                                  * hd * hd + col;
  float dc = 0.f, dn = 0.f, dm = 0.f, dhr = 0.f;
  CellIn nxt{};
  if (cell) cell_load(nxt, a, b, hh, a.S - 1, tid);
  for (int t = a.S - 1; t >= 0; --t) {
    if (cell) {
      const CellIn in = nxt;
      if (t > 0) cell_load(nxt, a, b, hh, t - 1, tid);
      const float z = tanhf(in.zp), o = sigmoid(in.op);
      const float aa = log_sigmoid(in.fp) + in.mp;
      const float fe = expf(aa - in.m), ie = expf(in.ip - in.m);
      const float nraw = fe * in.np + ie;
      const float dh = in.dy + dhr;
      dc += dh * o / in.n;
      const float dov = dh * in.c / in.n;
      const float dnt = dn - dh * o * in.c / (in.n * in.n);
      const float dnr = nraw >= 1e-6f ? dnt : 0.f;
      const float e1 = (dc * in.cp + dnr * in.np) * fe;     // fe dL/dfe
      const float e2 = (dc * z + dnr) * ie;                 // ie dL/die
      const float dz = dc * ie;
      const float dmt = dm - e1 - e2;
      float da = e1, di = e2;
      if (aa > in.ip) {
        da += dmt;
      } else if (aa < in.ip) {
        di += dmt;
      } else {
        da += 0.5f * dmt;
        di += 0.5f * dmt;
      }
      const float dp[4] = {dz * (1.f - z * z), di,
                           da / (1.f + expf(in.fp)), dov * o * (1.f - o)};
      const size_t p_ = ((static_cast<size_t>(b) * a.S + t) * a.H + hh) * 4
                        * hd + tid;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dpre_s[q * hd + tid] = dp[q];
        a.dx[p_ + q * hd] = dp[q];
      }
      dm = da;
      dc *= fe;
      dn = dnr * fe;
    }
    __syncthreads();
    if (mat) part_s[tid] = column_dot(RTcol, dpre_s + g * hd, hd);
    __syncthreads();
    if (cell)
      dhr = (part_s[tid] + part_s[hd + tid]) +
            (part_s[2 * hd + tid] + part_s[3 * hd + tid]);
  }
  if (cell) {
    const size_t st = static_cast<size_t>(bh) * hd + tid;
    a.dc0[st] = dc;
    a.dn0[st] = dn;
    a.dm0[st] = dm;
    a.dh0[st] = dhr;
  }
}

int threads_for(int hd) { return (4 * hd + 31) / 32 * 32; }

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int slstm_scan_max_head_dim() { return kMaxHd; }

// x, pre (B, S, H, 4, hd); R (H, 4, hd, hd); c0, n0, m0, h0 (B, H, hd);
// h, c_all, n_all, m_all (B, S, H, hd).  All float32, contiguous.
int slstm_scan_fwd(const float* x, const float* R, const float* c0,
                   const float* n0, const float* m0, const float* h0,
                   float* h, float* c_all, float* n_all, float* m_all,
                   float* pre, int B, int S, int H, int hd, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd > kMaxHd)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = x; a.R = R; a.c0 = c0; a.n0 = n0; a.m0 = m0; a.h0 = h0;
  a.h = h; a.c_all = c_all; a.n_all = n_all; a.m_all = m_all; a.pre = pre;
  a.B = B; a.S = S; a.H = H; a.hd = hd;
  slstm_fwd_kernel<<<B * H, threads_for(hd), 5 * hd * sizeof(float),
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dh (B, S, H, hd); RT (H, 4, hd, hd), RT[h][g][v][k] = R[h][g][k][v]; the
// forward's states and outputs; writes dx (B, S, H, 4, hd) and dc0, dn0,
// dm0, dh0 (B, H, hd).
int slstm_scan_bwd(const float* dh, const float* RT, const float* c0,
                   const float* n0, const float* m0, const float* c_all,
                   const float* n_all, const float* m_all, const float* pre,
                   float* dx, float* dc0, float* dn0, float* dm0, float* dh0,
                   int B, int S, int H, int hd, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd > kMaxHd)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.dh = dh; a.RT = RT; a.c0 = c0; a.n0 = n0; a.m0 = m0;
  a.c_all = const_cast<float*>(c_all);
  a.n_all = const_cast<float*>(n_all);
  a.m_all = const_cast<float*>(m_all);
  a.pre = const_cast<float*>(pre);
  a.dx = dx; a.dc0 = dc0; a.dn0 = dn0; a.dm0 = dm0; a.dh0 = dh0;
  a.B = B; a.S = S; a.H = H; a.hd = hd;
  slstm_bwd_kernel<<<B * H, threads_for(hd), 8 * hd * sizeof(float),
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
