// The mLSTM's full-sequence scan (xLSTM's matrix memory with exponential
// gating and a stabiliser), forward and backward, float32.  Replaces no
// Pallas kernel: the reference runs the cell as a jax.lax.scan
// (src/repro/models/recurrent.py:162, the cell at :143), which XLA
// compiles into one loop; stepped from PyTorch the same cell is ~25
// launches a position.  Here one launch runs the forward over every
// position and two launches the backward.
//
// Per (batch row b, head h), with s = hd^-1/2, from (C, n, m) = (C0, n0, m0):
//   lf_t = log sigmoid(f_t)     a_t = lf_t + m_{t-1}      m_t = max(a_t, i_t)
//   fe_t = exp(a_t - m_t)       ie_t = exp(i_t - m_t)
//   C_t = fe_t C_{t-1} + ie_t v_t (s k_t)^T    n_t = fe_t n_{t-1} + ie_t s k_t
//   d_t = n_t . q_t    den_t = max(|d_t|, 1)    h_t = C_t q_t / den_t
// C is hd x hd (rows index v, columns index k): 576 KB a (b, h) at
// xlstm-125m's hd = 384.
//
// What bounds it.  The work is ~5 hd^2 flops a position and (b, h) each way
// (the update and the product with q), 0.74 MFLOP at hd = 384: 11 us of
// the float32 peak for a (16, 4096) block, but the positions are a chain,
// so what sets the time is each step's latency times S.  The design keeps
// C out of memory: every row of C evolves on its own once the scalars are
// known, so a warp owns 4 rows (or, in two of the backward passes, 4
// columns) in registers, 12 elements a lane, and recomputes the scalar
// recurrence, n and d itself: no barrier, no shared memory, no atomics.  A
// step's inputs are loaded one step ahead.  Every sum runs in a fixed
// order, so reruns are bitwise.
//
// Backward.  With dnum_t = dh_t / den_t, dd_t = -(dh_t . h_t) / den_t *
// sign(d_t) where |d_t| >= 1 (clamp_min's gradient passes at the tie,
// abs's sign(0) is 0), and the reverse states
//   G_t = dnum_t q_t^T + fe_{t+1} G_{t+1}      N_t = dd_t q_t + fe_{t+1} N_{t+1}
// the gradients are
//   dq_t = C_t^T dnum_t + dd_t n_t        (forward in time: C_t's columns)
//   dv_t = ie_t G_t s k_t                  (reverse: G_t's rows)
//   dk_t = s ie_t (G_t^T v_t + N_t)        (reverse: G_t's columns)
// each a pass in which a warp owns 4 vectors of one matrix: the three
// passes are one launch (blockIdx.z), none needs another's output, and
// none sums across warps.  The gates need W_t = fe_t <G_t, C_{t-1}>, which
// would need C_{t-1} in the reverse pass.  Expanding G_t and C_t = fe_t
// C_{t-1} + ie_t v_t s k_t^T gives
//   W_t = (dh_t . h_t - v_t . dv_t) + W_{t+1},   W_S = 0,
// a sum of terms much larger than W, whose float32 rounding adds up
// (~1e-5 a step at hd = 384).  So W is anchored exactly every kChunk
// steps: the forward saves C at each chunk's start (C0, C_31, C_63, ...),
// and the dv pass forms each warp's part of <G_t0, C_{t0-1}> there (per
// warp, summed by the gate pass in a fixed order).  Between two anchors
// the gate pass (a warp per (b, h), reverse) runs the sum above and
// spreads the chunk's gap to the anchor linearly over it.  It also runs
// N_t, and then
//   fe_t dL/dfe_t = W_t + fe_t N_t . n_{t-1}    ie_t dL/die_t = k_t . dk_t
// and the stabiliser's chain back through m (torch.maximum splits the
// gradient equally at a tie), as autograd of the stepped cell does.
// The forward saves n_t, m_t and d_t for every position and C at every
// chunk's start.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kVec = 4;               // rows (or columns) of a matrix a warp
constexpr int kMaxE = 12;             // elements a lane: hd <= 384
constexpr int kGateWarps = 4;         // (b, h) a CTA of the gate pass
constexpr int kChunk = 32;            // steps between saved C (a lane each)
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  // forward inputs (B, S, H, hd) / (B, S, H); states (B, H, hd, hd) etc.
  const float *q, *k, *v, *ip, *fp, *C0, *n0, *m0;
  // forward outputs / backward inputs
  float *h, *n_all, *m_all, *d_all;
  float* snap;      // (B, H, nc, hd, hd): C_{c kChunk - 1}, slot 0 C0
  // backward
  const float* dh;
  float *dq, *dk, *dv, *di, *df, *dC0, *dn0, *dm0;
  float* part;      // (B * H, nc, ceil(hd / kVec)): the anchors' parts
  int B, S, H, hd, nc;
  float scale;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// log sigmoid(x) = -softplus(-x), softplus(y) = max(y, 0) + log1p(e^-|y|)
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// (b, t, h)'s offset in a (B, S, H) array; times hd for (B, S, H, hd)
__device__ __forceinline__ size_t pos(const Args& a, int b, int t, int hh) {
  return (static_cast<size_t>(b) * a.S + t) * a.H + hh;
}

// The scalars of position t: fe, ie from the saved stabilisers, and den,
// the sign factor of dd.
struct Gate {
  float fe, ie, den, sg, aa, ip, fp;
};

__device__ __forceinline__ Gate gate_at(const Args& a, size_t p, float m_prev) {
  Gate g;
  g.ip = a.ip[p];
  g.fp = a.fp[p];
  const float m = a.m_all[p];
  g.aa = log_sigmoid(g.fp) + m_prev;
  g.fe = expf(g.aa - m);
  g.ie = expf(g.ip - m);
  const float d = a.d_all[p];
  g.den = fmaxf(fabsf(d), 1.f);
  g.sg = fabsf(d) >= 1.f ? (d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f)) : 0.f;
  return g;
}

// Lane elements: x[e * 32 + lane] for e < E, 0 past hd.
template <int E>
__device__ __forceinline__ void load_lane(float (&dst)[E], const float* src,
                                          int lane, int hd) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = e * 32 + lane;
    dst[e] = j < hd ? src[j] : 0.f;
  }
}

// A warp's vectors: x[a0 + i] for i < kVec, 0 past hd (every lane the same).
__device__ __forceinline__ void load_vec(float (&dst)[kVec], const float* src,
                                         int a0, int hd) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) dst[i] = a0 + i < hd ? src[a0 + i] : 0.f;
}

// Lane i < kVec writes val[i] to dst[a0 + i].
__device__ __forceinline__ void store_vec(float* dst, const float (&val)[kVec],
                                          int a0, int hd, int lane) {
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    if (lane == i && a0 + i < hd) dst[a0 + i] = val[i];
}

// A warp's rows a0 + i of a row-major hd x hd matrix, from registers.
template <int E>
__device__ __forceinline__ void store_rows(float* dst,
                                           const float (&rows)[kVec][E],
                                           int a0, int hd, int lane) {
#pragma unroll
  for (int i = 0; i < kVec; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = e * 32 + lane;
      if (a0 + i < hd && j < hd)
        dst[static_cast<size_t>(a0 + i) * hd + j] = rows[i][e];
    }
}

// ---------------------------------------------------------------------------
// Forward: a warp owns rows a0 .. a0 + 3 of C; grid (hd / 32, B * H)
// ---------------------------------------------------------------------------

template <int E>
struct FwdIn {
  float q[E], k[E], v[kVec], ip, fp;
};

template <int E>
__device__ __forceinline__ void fwd_load(FwdIn<E>& in, const Args& a, int b,
                                         int t, int hh, int a0, int lane) {
  const size_t p = pos(a, b, t, hh), base = p * a.hd;
  load_lane<E>(in.q, a.q + base, lane, a.hd);
  load_lane<E>(in.k, a.k + base, lane, a.hd);
  load_vec(in.v, a.v + base, a0, a.hd);
  in.ip = a.ip[p];
  in.fp = a.fp[p];
}

template <int E>
__global__ void __launch_bounds__(kThreads) mlstm_fwd_kernel(Args a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y, b = bh / a.H, hh = bh % a.H, hd = a.hd;
  const int a0 = (blockIdx.x * kWarps + warp) * kVec;
  if (a0 >= hd) return;
  const bool writer = blockIdx.x == 0 && warp == 0;   // n, m, d for all
  float C[kVec][E], n[E];
  const float* C0 = a.C0 + static_cast<size_t>(bh) * hd * hd;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (a0 + i < hd) {
      load_lane<E>(C[i], C0 + static_cast<size_t>(a0 + i) * hd, lane, hd);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) C[i][e] = 0.f;
    }
  }
  load_lane<E>(n, a.n0 + static_cast<size_t>(bh) * hd, lane, hd);
  float m = a.m0[bh];
  float* snap = a.snap + static_cast<size_t>(bh) * a.nc * hd * hd;
  store_rows<E>(snap, C, a0, hd, lane);
  FwdIn<E> nxt;
  fwd_load<E>(nxt, a, b, 0, hh, a0, lane);
  for (int t = 0; t < a.S; ++t) {
    const FwdIn<E> in = nxt;
    if (t + 1 < a.S) fwd_load<E>(nxt, a, b, t + 1, hh, a0, lane);
    const float aa = log_sigmoid(in.fp) + m;
    const float mn = fmaxf(aa, in.ip);
    const float fe = expf(aa - mn), ie = expf(in.ip - mn);
    m = mn;
    float ks[E], dpart = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      ks[e] = in.k[e] * a.scale;
      n[e] = fe * n[e] + ie * ks[e];
      dpart += n[e] * in.q[e];
    }
    const float d = warp_sum(dpart);
    const float den = fmaxf(fabsf(d), 1.f);
    float num[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float iv = ie * in.v[i];
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        C[i][e] = fe * C[i][e] + iv * ks[e];
        s += C[i][e] * in.q[e];
      }
      num[i] = s;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) num[i] = warp_sum(num[i]) / den;
    if ((t + 1) % kChunk == 0 && t + 1 < a.S)
      store_rows<E>(snap + static_cast<size_t>((t + 1) / kChunk) * hd * hd,
                    C, a0, hd, lane);
    const size_t p = pos(a, b, t, hh), base = p * hd;
    store_vec(a.h + base, num, a0, hd, lane);
    if (writer) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (e * 32 + lane < hd) a.n_all[base + e * 32 + lane] = n[e];
      if (lane == 0) {
        a.m_all[p] = m;
        a.d_all[p] = d;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, the matrix passes: blockIdx.z 0 dq (C_t's columns, forward in
// time), 1 dv (G_t's rows, reverse), 2 dk (G_t's columns, reverse).  A warp
// owns vectors a0 .. a0 + 3 (rows or columns); a lane holds the other
// index's elements e * 32 + lane.
// ---------------------------------------------------------------------------

template <int E>
struct BwdIn {
  float x[E], y[E], w[E];     // lane vectors (which ones: the role's)
  float s0[kVec], s1[kVec];   // the warp's vector entries
  float m_prev;
  Gate g;
};

// dq: lane vectors v, dh, h (rows r); warp entries k, n (columns)
// dv: lane vectors q, k (columns j); warp entries dh (rows)
// dk: lane vectors v, dh, h (rows r); warp entries q (columns)
template <int ROLE, int E>
__device__ __forceinline__ void bwd_load(BwdIn<E>& in, const Args& a, int b,
                                         int t, int hh, int a0, int lane) {
  const size_t p = pos(a, b, t, hh), base = p * a.hd;
  const int bh = b * a.H + hh;
  in.m_prev = t > 0 ? a.m_all[pos(a, b, t - 1, hh)] : a.m0[bh];
  in.g = gate_at(a, p, in.m_prev);
  if (ROLE == 1) {
    load_lane<E>(in.x, a.q + base, lane, a.hd);
    load_lane<E>(in.y, a.k + base, lane, a.hd);
    load_vec(in.s0, a.dh + base, a0, a.hd);
  } else {
    load_lane<E>(in.x, a.v + base, lane, a.hd);
    load_lane<E>(in.y, a.dh + base, lane, a.hd);
    load_lane<E>(in.w, a.h + base, lane, a.hd);
    if (ROLE == 0) {
      load_vec(in.s0, a.k + base, a0, a.hd);
      load_vec(in.s1, a.n_all + base, a0, a.hd);
    } else {
      load_vec(in.s0, a.q + base, a0, a.hd);
    }
  }
}

template <int ROLE, int E>
__device__ void bwd_pass(const Args& a, int b, int hh, int a0, int lane) {
  const int hd = a.hd, S = a.S, bh = b * a.H + hh;
  float M[kVec][E], N[kVec];
  if (ROLE == 0) {   // C0's columns a0 + i: M[i][e] = C0[r_e, a0 + i]
    const float* C0 = a.C0 + static_cast<size_t>(bh) * hd * hd;
#pragma unroll
    for (int i = 0; i < kVec; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int r = e * 32 + lane;
        M[i][e] = (r < hd && a0 + i < hd)
                      ? C0[static_cast<size_t>(r) * hd + a0 + i] : 0.f;
      }
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      N[i] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) M[i][e] = 0.f;
    }
  }
  float fnext = 0.f;          // fe_{t+1} (reverse passes)
  const int t0 = ROLE == 0 ? 0 : S - 1, dt = ROLE == 0 ? 1 : -1;
  BwdIn<E> nxt;
  bwd_load<ROLE, E>(nxt, a, b, t0, hh, a0, lane);
  for (int step = 0; step < S; ++step) {
    const int t = t0 + dt * step;
    const BwdIn<E> in = nxt;
    if (step + 1 < S) bwd_load<ROLE, E>(nxt, a, b, t + dt, hh, a0, lane);
    const Gate& g = in.g;
    const size_t base = pos(a, b, t, hh) * hd;
    float out[kVec];
    if (ROLE == 1) {
      // G rows: G[i][e] = fe_{t+1} G + dnum[a0+i] q[e]; dv = ie G s k
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float dn = in.s0[i] / g.den;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          M[i][e] = fnext * M[i][e] + dn * in.x[e];
          s += M[i][e] * (in.y[e] * a.scale);
        }
        out[i] = s;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) out[i] = g.ie * warp_sum(out[i]);
      store_vec(a.dv + base, out, a0, hd, lane);
      if (t % kChunk == 0) {
        // this warp's part of <G_t, C_{t-1}>, C_{t-1} the saved snapshot
        const int c = t / kChunk;
        const float* snap = a.snap + (static_cast<size_t>(bh) * a.nc + c)
                                         * hd * hd;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int j = e * 32 + lane;
            if (a0 + i < hd && j < hd)
              part += M[i][e] * snap[static_cast<size_t>(a0 + i) * hd + j];
          }
        part = warp_sum(part);
        const int nw = (hd + kVec - 1) / kVec;
        if (lane == 0)
          a.part[(static_cast<size_t>(bh) * a.nc + c) * nw + a0 / kVec] = part;
      }
    } else {
      float dnum[E], part = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dnum[e] = in.y[e] / g.den;
        part += in.y[e] * in.w[e];
      }
      const float dd = -warp_sum(part) / g.den * g.sg;
      if (ROLE == 0) {
        // C columns: M[i][e] = fe M + ie s k[a0+i] v[e]; dq = M^T dnum + dd n
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float ik = g.ie * (in.s0[i] * a.scale);
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            M[i][e] = g.fe * M[i][e] + ik * in.x[e];
            s += M[i][e] * dnum[e];
          }
          out[i] = s;
        }
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          out[i] = warp_sum(out[i]) + dd * in.s1[i];
        store_vec(a.dq + base, out, a0, hd, lane);
      } else {
        // G columns: M[i][e] = fe_{t+1} M + q[a0+i] dnum[e];
        // dk = s ie (M^T v + N)
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          N[i] = fnext * N[i] + dd * in.s0[i];
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            M[i][e] = fnext * M[i][e] + in.s0[i] * dnum[e];
            s += M[i][e] * in.x[e];
          }
          out[i] = s;
        }
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          out[i] = a.scale * (g.ie * (warp_sum(out[i]) + N[i]));
        store_vec(a.dk + base, out, a0, hd, lane);
      }
    }
    fnext = g.fe;
  }
  // after t = 0, fnext = fe_0: the initial states' gradients
  if (ROLE == 1) {
    float* dC0 = a.dC0 + static_cast<size_t>(bh) * hd * hd;
#pragma unroll
    for (int i = 0; i < kVec; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = e * 32 + lane;
        if (a0 + i < hd && j < hd)
          dC0[static_cast<size_t>(a0 + i) * hd + j] = fnext * M[i][e];
      }
  } else if (ROLE == 2) {
    float dn0[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) dn0[i] = fnext * N[i];
    store_vec(a.dn0 + static_cast<size_t>(bh) * hd, dn0, a0, hd, lane);
  }
}

template <int E>
__global__ void __launch_bounds__(kThreads) mlstm_bwd_mat_kernel(Args a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y, b = bh / a.H, hh = bh % a.H;
  const int a0 = (blockIdx.x * kWarps + warp) * kVec;
  if (a0 >= a.hd) return;
  if (blockIdx.z == 0) bwd_pass<0, E>(a, b, hh, a0, lane);
  else if (blockIdx.z == 1) bwd_pass<1, E>(a, b, hh, a0, lane);
  else bwd_pass<2, E>(a, b, hh, a0, lane);
}

// ---------------------------------------------------------------------------
// Backward, the gates: a warp per (b, h), reverse in time, a chunk of
// kChunk steps at a time: first the chunk's dot products (lane t - t0
// keeps step t's), then its steps in reverse
// ---------------------------------------------------------------------------

template <int E>
struct DotIn {
  float dh[E], h[E], v[E], dv[E], k[E], dk[E];
};

template <int E>
__device__ __forceinline__ void dot_load(DotIn<E>& in, const Args& a, int b,
                                         int t, int hh, int lane) {
  const size_t base = pos(a, b, t, hh) * a.hd;
  load_lane<E>(in.dh, a.dh + base, lane, a.hd);
  load_lane<E>(in.h, a.h + base, lane, a.hd);
  load_lane<E>(in.v, a.v + base, lane, a.hd);
  load_lane<E>(in.dv, a.dv + base, lane, a.hd);
  load_lane<E>(in.k, a.k + base, lane, a.hd);
  load_lane<E>(in.dk, a.dk + base, lane, a.hd);
}

template <int E>
struct StepIn {
  float q[E], np[E];
  Gate g;
};

template <int E>
__device__ __forceinline__ void step_load(StepIn<E>& in, const Args& a, int b,
                                          int t, int hh, int lane) {
  const int bh = b * a.H + hh;
  const size_t p = pos(a, b, t, hh);
  const float m_prev = t > 0 ? a.m_all[pos(a, b, t - 1, hh)] : a.m0[bh];
  in.g = gate_at(a, p, m_prev);
  load_lane<E>(in.q, a.q + p * a.hd, lane, a.hd);
  load_lane<E>(in.np, t > 0 ? a.n_all + pos(a, b, t - 1, hh) * a.hd
                            : a.n0 + static_cast<size_t>(bh) * a.hd,
               lane, a.hd);
}

__device__ __forceinline__ double warp_sum_d(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int E>
__global__ void __launch_bounds__(32 * kGateWarps) mlstm_bwd_gate_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x * kGateWarps + (threadIdx.x >> 5);
  if (bh >= a.B * a.H) return;
  const int b = bh / a.H, hh = bh % a.H;
  const int nw = (a.hd + kVec - 1) / kVec;
  float N[E];
#pragma unroll
  for (int e = 0; e < E; ++e) N[e] = 0.f;
  float fnext = 0.f, gm = 0.f;
  double w_end = 0.0;            // W at the chunk's end (W_S = 0)
  for (int c = a.nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk, t1 = min(t0 + kChunk, a.S);
    // the chunk's dot products, step t's kept by lane t - t0
    float my_dhh = 0.f, my_vdv = 0.f, my_kdk = 0.f;
    double xsum = 0.0;
    DotIn<E> dn;
    dot_load<E>(dn, a, b, t0, hh, lane);
    for (int t = t0; t < t1; ++t) {
      const DotIn<E> in = dn;
      if (t + 1 < t1) dot_load<E>(dn, a, b, t + 1, hh, lane);
      float dhh = 0.f, vdv = 0.f, kdk = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dhh += in.dh[e] * in.h[e];
        vdv += in.v[e] * in.dv[e];
        kdk += in.k[e] * in.dk[e];
      }
      dhh = warp_sum(dhh);
      vdv = warp_sum(vdv);
      kdk = warp_sum(kdk);
      if (lane == t - t0) {
        my_dhh = dhh;
        my_vdv = vdv;
        my_kdk = kdk;
      }
      xsum += static_cast<double>(dhh) - static_cast<double>(vdv);
    }
    // the anchor: W_t0 = fe_t0 <G_t0, C_{t0-1}>, the dv pass's parts
    double part = 0.0;
    for (int w = lane; w < nw; w += 32)
      part += a.part[(static_cast<size_t>(bh) * a.nc + c) * nw + w];
    part = warp_sum_d(part);
    StepIn<E> sn;
    step_load<E>(sn, a, b, t0, hh, lane);
    const double w_start = static_cast<double>(sn.g.fe) * part;
    // the running sum's gap to the anchor, spread over the chunk
    const double gap = w_start - (w_end + xsum);
    double W = w_end;
    step_load<E>(sn, a, b, t1 - 1, hh, lane);
    for (int t = t1 - 1; t >= t0; --t) {
      const StepIn<E> in = sn;
      if (t > t0) step_load<E>(sn, a, b, t - 1, hh, lane);
      const Gate& g = in.g;
      const float dhh = __shfl_sync(kFull, my_dhh, t - t0);
      const float vdv = __shfl_sync(kFull, my_vdv, t - t0);
      const float kdk = __shfl_sync(kFull, my_kdk, t - t0);
      const float dd = -dhh / g.den * g.sg;
      float nn = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        N[e] = fnext * N[e] + dd * in.q[e];
        nn += N[e] * in.np[e];
      }
      nn = warp_sum(nn);
      W += static_cast<double>(dhh) - static_cast<double>(vdv);
      const double Wt = W + gap * (t1 - t) / (t1 - t0);
      const float e1 = static_cast<float>(Wt) + g.fe * nn;  // fe dL/dfe
      const float e2 = kdk;                                  // ie dL/die
      const float dm = gm - e1 - e2;
      float da = e1, di = e2;
      if (g.aa > g.ip) {
        da += dm;
      } else if (g.aa < g.ip) {
        di += dm;
      } else {
        da += 0.5f * dm;
        di += 0.5f * dm;
      }
      if (lane == 0) {
        const size_t p = pos(a, b, t, hh);
        a.di[p] = di;
        a.df[p] = da / (1.f + expf(g.fp));     // d log sigmoid = sigmoid(-f)
      }
      gm = da;
      fnext = g.fe;
    }
    w_end = w_start;
  }
  if (lane == 0) a.dm0[bh] = gm;
}

#define MLSTM_E_CASES(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12)

int launch_fwd(const Args& a, cudaStream_t st) {
  const int E = (a.hd + 31) / 32;
  dim3 grid((a.hd + kWarps * kVec - 1) / (kWarps * kVec), a.B * a.H);
  switch (E) {
#define CASE(e) \
  case e: mlstm_fwd_kernel<e><<<grid, kThreads, 0, st>>>(a); break;
    MLSTM_E_CASES(CASE)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd(const Args& a, cudaStream_t st) {
  const int E = (a.hd + 31) / 32;
  dim3 grid((a.hd + kWarps * kVec - 1) / (kWarps * kVec), a.B * a.H, 3);
  const int gates = (a.B * a.H + kGateWarps - 1) / kGateWarps;
  switch (E) {
#define CASE(e)                                                          \
  case e:                                                                \
    mlstm_bwd_mat_kernel<e><<<grid, kThreads, 0, st>>>(a);               \
    mlstm_bwd_gate_kernel<e><<<gates, 32 * kGateWarps, 0, st>>>(a);      \
    break;
    MLSTM_E_CASES(CASE)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int mlstm_scan_max_head_dim() { return 32 * kMaxE; }

int mlstm_scan_chunk() { return kChunk; }

// q, k, v, h, n_all (B, S, H, hd); ip, fp, m_all, d_all (B, S, H); C0
// (B, H, hd, hd); n0 (B, H, hd); m0 (B, H); snap (B, H, nc, hd, hd), nc =
// ceil(S / kChunk).  All float32, contiguous.
int mlstm_scan_fwd(const float* q, const float* k, const float* v,
                   const float* ip, const float* fp, const float* C0,
                   const float* n0, const float* m0, float* h, float* n_all,
                   float* m_all, float* d_all, float* snap, int B, int S,
                   int H, int hd, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd > 32 * kMaxE ||
      B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q; a.k = k; a.v = v; a.ip = ip; a.fp = fp;
  a.C0 = C0; a.n0 = n0; a.m0 = m0;
  a.h = h; a.n_all = n_all; a.m_all = m_all; a.d_all = d_all; a.snap = snap;
  a.B = B; a.S = S; a.H = H; a.hd = hd; a.scale = scale;
  a.nc = (S + kChunk - 1) / kChunk;
  return launch_fwd(a, static_cast<cudaStream_t>(stream));
}

// The forward's inputs and outputs, dh (B, S, H, hd); writes dq, dk, dv
// (B, S, H, hd), di, df (B, S, H), dC0, dn0, dm0, and uses part (B * H *
// nc * ceil(hd / 4) floats) as scratch.  Two launches.
int mlstm_scan_bwd(const float* dh, const float* q, const float* k,
                   const float* v, const float* ip, const float* fp,
                   const float* C0, const float* n0, const float* m0,
                   const float* h, const float* n_all, const float* m_all,
                   const float* d_all, const float* snap, float* dq,
                   float* dk, float* dv, float* di, float* df, float* dC0,
                   float* dn0, float* dm0, float* part, int B, int S, int H,
                   int hd, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd > 32 * kMaxE ||
      B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q; a.k = k; a.v = v; a.ip = ip; a.fp = fp;
  a.C0 = C0; a.n0 = n0; a.m0 = m0;
  a.h = const_cast<float*>(h);
  a.n_all = const_cast<float*>(n_all);
  a.m_all = const_cast<float*>(m_all);
  a.d_all = const_cast<float*>(d_all);
  a.snap = const_cast<float*>(snap);
  a.dh = dh;
  a.dq = dq; a.dk = dk; a.dv = dv; a.di = di; a.df = df;
  a.dC0 = dC0; a.dn0 = dn0; a.dm0 = dm0; a.part = part;
  a.B = B; a.S = S; a.H = H; a.hd = hd; a.scale = scale;
  a.nc = (S + kChunk - 1) / kChunk;
  return launch_bwd(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
