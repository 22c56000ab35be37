// The mLSTM's full-sequence scan (xLSTM's matrix memory with exponential
// gating and a stabiliser), forward and backward, float32.  Replaces no
// Pallas kernel: the reference runs the cell as a jax.lax.scan
// (src/repro/models/recurrent.py:162, the cell at :143), which XLA
// compiles into one loop; stepped from PyTorch the same cell is ~25
// launches a position.  Here one launch runs the forward over every
// position and three launches the backward.
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
// so what sets the forward's time is each step's latency times S.  The
// forward keeps C out of memory: every row of C evolves on its own once
// the scalars are known, so a warp owns 4 rows in registers, 12 elements a
// lane, and recomputes the scalar recurrence, n and d itself: no barrier,
// no shared memory, no atomics.  A step's inputs are loaded one step
// ahead.  It saves n_t, m_t and d_t for every position and C at every
// chunk's start (snap: C0, C_31, C_63, ...).
//
// Backward, chunkwise over those kChunk = 32-step chunks.  With dnum_t =
// dh_t / den_t, dd_t = -(dnum_t . h_t) sign(d_t) where |d_t| >= 1
// (clamp_min's gradient passes at the tie, abs's sign(0) is 0), the decays
//   D(u, s) = fe_{s+1} ... fe_u = exp(LF_u - LF_s + m_s - m_u),  s <= u,
// from the saved m (LF the chunk's running sum of log sigmoid(f), in
// double), and for chunk [t0, t1) zeta_t = D(t, t0 - 1), rho_t = D(t1 -
// 1, t), E = D(t1 - 1, t0 - 1), C_t = zeta_t Csnap + sum_{s <= t} D(t, s)
// ie_s v_s (s k_s)^T, and the reverse states at the chunk's end G' =
// dL/dC_{t1-1}, N' = dL/dn_{t1-1}:
//   G_t = rho_t G' + sum_{u >= t} D(u, t) dnum_u q_u^T
//   N_t = rho_t N' + sum_{u >= t} D(u, t) dd_u q_u
// the gradients are, with P[u][s] = dnum_u . v_s, Qk[u][s] = q_u . s k_s:
//   dq_t = zeta_t Csnap^T dnum_t + sum_{s <= t} D(t, s) ie_s P[t][s] s k_s
//          + dd_t n_t
//   dv_t = ie_t rho_t G' s k_t + sum_{u >= t} ie_t D(u, t) Qk[u][t] dnum_u
//   dk_t = s ie_t rho_t (G'^T v_t + N')
//          + sum_{u >= t} s ie_t D(u, t) (P[u][t] + dd_u) q_u
// and the carries G'' = E G' + sum_u zeta_u dnum_u q_u^T, N'' = E N' +
// sum_u zeta_u dd_u q_u pass to the chunk before (after chunk 0 they are
// dC0 and dn0).  The gates need W_t = fe_t <G_t, C_{t-1}>; expanding both
// factors over the chunk gives it exactly, with no running identity:
//   W_t = E <G', Csnap> + sum_{s < t} rho_s ie_s v_s^T G' s k_s
//         + sum_{u >= t} zeta_u dnum_u^T Csnap q_u
//         + sum_{u >= t > s} D(u, s) ie_s P[u][s] Qk[u][s]
// and then fe_t dL/dfe_t = W_t + fe_t N_t . n_{t-1}, ie_t dL/die_t = k_t .
// dk_t and the stabiliser's chain back through m (torch.maximum splits
// the gradient equally at a tie), as autograd of the stepped cell does.
//
// Three launches.  The chunk kernel (a CTA per (chunk, b, h), a thread per
// column, the chunk's rows and its 32 x 32 products in shared memory) does
// everything that needs no carry, fully parallel: dq whole (its snapshot
// product streams C_snap once), the intra-chunk parts of dv and dk
// (written, then added to), W's last two terms, N's part of N_t . n_{t-1}.
// The carry kernel walks the chunks in reverse with G' on chip: a CTA per
// (b, h, tile of 96 rows, role), a warp owning 8 rows of G' (role 0) or of
// G'^T (role 1) in registers, 12 elements a lane; a chunk step is two 32 x
// 96 x hd products (the boundary terms, the carry) against the chunk's
// rows, which cp.async brings into shared memory while the step before
// computes, so the serial chain is S / 32 steps, not S.  Its sums over
// rows outside the tile (v . G' s k, k . dk, N' . n, <G', Csnap>) are
// written as per-tile parts; the gate kernel (a warp per (b, h), reverse)
// adds them in a fixed order and runs the scalar chain.  What bounds it
// now: the carry's float32 FMAs from registers (128 CTAs of 12 warps at
// (4, 4096), one a multiprocessor) over its 128 chunk steps, and the chunk
// kernel's snapshot product, 1.2 GB of C_snap at (4, 4096) against 2048
// CTAs' FMAs.  No atomics, every sum in a fixed order, so reruns are
// bitwise.

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
// Backward, chunkwise.  Three launches:
//   1. mlstm_bwd_chunk_kernel, a CTA per (chunk, b, h), a thread per column:
//      the chunk's scalars, dq whole, the intra-chunk parts of dv, dk, N,
//      and W's chunk-local terms;
//   2. mlstm_bwd_carry_kernel, a CTA per (row tile, b, h, role), reverse over
//      the chunks with its rows of G (role 0) or of G^T (role 1) in
//      registers: dv's (role 0) or dk's (role 1) boundary terms, the
//      per-position dot products and the anchors as per-tile parts, dC0
//      and dn0;
//   3. mlstm_bwd_gate_kernel, a warp per (b, h), reverse over the chunks:
//      the parts summed in a fixed order, W, and the chain through m.
// ---------------------------------------------------------------------------

constexpr int kCarryWarps = 12;                 // a carry CTA
constexpr int kRows = 8;                        // rows of G a warp
constexpr int kTile = kCarryWarps * kRows;      // rows of G a carry CTA
constexpr int kRedWarps = 12;                   // at most (hd <= 384)
constexpr int kTileLd = kTile + 8;   // a tile array's rows 8 banks apart

// Scratch (floats): per position (b, h, t) at bh S + t; per chunk at
// bh nc + c; the carry's parts at (bh S + t) nt + tile and (bh nc + c) nt
// + tile, nt = ceil(hd / kTile).
struct Scratch {
  // per position: ie rho, rho, zeta / den, zeta dd, W's chunk-local terms,
  // N_intra . n_{t-1}; per chunk: E; the carry's per-tile parts
  float *ierho, *rho, *fz, *zdd, *w34, *nu_in, *E;
  float *alpha, *kappa, *nu_b, *gamma;
  int nt;
  __host__ __device__ Scratch(float* base, int B, int S, int H, int hd,
                              int nc) {
    const size_t ps = static_cast<size_t>(B) * H * S;
    const size_t pc = static_cast<size_t>(B) * H * nc;
    nt = (hd + kTile - 1) / kTile;
    ierho = base; rho = ierho + ps; fz = rho + ps; zdd = fz + ps;
    w34 = zdd + ps; nu_in = w34 + ps; E = nu_in + ps;
    alpha = E + pc; kappa = alpha + ps * nt; nu_b = kappa + ps * nt;
    gamma = nu_b + ps * nt;
  }
  static size_t floats(int B, int S, int H, int hd, int nc) {
    const size_t ps = static_cast<size_t>(B) * H * S;
    const size_t pc = static_cast<size_t>(B) * H * nc;
    const size_t nt = (hd + kTile - 1) / kTile;
    return 6 * ps + pc + 3 * ps * nt + pc * nt;
  }
};

// 4 bytes global -> shared, asynchronously; zero-filled where !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 16 bytes global -> shared, asynchronously; zero-filled where !valid
// (both addresses 16-byte aligned)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// every group but the newest done
__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One step of transpose_sum: lanes that differ in bit OFF exchange halves.
template <int OFF>
__device__ __forceinline__ void transpose_step(float (&v)[32], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? v[i] : v[i + OFF];
    const float keep = upper ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, OFF);
  }
}

// 32 sums across the warp at once: on return lane l holds the warp's sum
// of v[l] (a fixed tree of 31 shuffles).
__device__ __forceinline__ float transpose_sum(float (&v)[32], int lane) {
  transpose_step<16>(v, lane);
  transpose_step<8>(v, lane);
  transpose_step<4>(v, lane);
  transpose_step<2>(v, lane);
  transpose_step<1>(v, lane);
  return v[0];
}

// The chunk kernel's shared memory in floats: the chunk's rows of dnum, q,
// s k and v (L rows of ld floats, zero past hd and past the sequence), the
// 32 x 32 matrices (rows of kLq, read as float4) and the per-position
// scalars.
constexpr int kLq = kChunk + 4;
struct ChunkSmem {
  int ld, dn, q, k, v, D, P, Qk, Bv, Bk, Nc, sc, red, floats;
  __host__ __device__ ChunkSmem(int E) {
    constexpr int LL = kChunk * kLq;
    ld = 32 * E + 4;     // rows 4 banks apart: float4 reads of 8 rows at once
    sc = 0;                                   // scalars first: 16 rows of L
    red = sc + 16 * kChunk;                   // kRedWarps rows of L, twice
    dn = red + 2 * kRedWarps * kChunk;
    q = dn + kChunk * ld; k = q + kChunk * ld; v = k + kChunk * ld;
    D = v + kChunk * ld; P = D + LL; Qk = P + LL; Bv = Qk + LL;
    Bk = Bv + LL; Nc = Bk + LL;
    floats = Nc + LL;
  }
};

// scalar rows of the chunk kernel (each kChunk floats): LF takes two rows
// (double)
enum { kLF = 0, kM = 2, kIe = 3, kDen = 4, kSg = 5, kDd = 6, kZeta = 7,
       kRho = 8, kBeta = 9, kW4 = 10, kMisc = 11 };

template <int E>
__global__ void __launch_bounds__(32 * E) mlstm_bwd_chunk_kernel(Args a,
                                                                 Scratch sc) {
  constexpr int L = kChunk;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const ChunkSmem Z(E);
  const int ld = Z.ld, hd = a.hd, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, nthr = 32 * E;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / a.H, hh = bh % a.H;
  const int t0 = c * L, n = min(L, a.S - t0);
  double* sLF = reinterpret_cast<double*>(sm + Z.sc + kLF * L);
  float* sM = sm + Z.sc + kM * L;
  float* sIe = sm + Z.sc + kIe * L;
  float* sDen = sm + Z.sc + kDen * L;
  float* sSg = sm + Z.sc + kSg * L;
  float* sDd = sm + Z.sc + kDd * L;
  float* sZeta = sm + Z.sc + kZeta * L;
  float* sRho = sm + Z.sc + kRho * L;
  float* sBeta = sm + Z.sc + kBeta * L;
  float* sW4 = sm + Z.sc + kW4 * L;
  float* sMisc = sm + Z.sc + kMisc * L;      // [0]: m_{t0 - 1}
  float* red = sm + Z.red;
  float* red2 = red + kRedWarps * L;
  float *DN = sm + Z.dn, *Q = sm + Z.q, *K = sm + Z.k, *V = sm + Z.v;
  float *D = sm + Z.D, *P = sm + Z.P, *Qk = sm + Z.Qk;
  float *Bv = sm + Z.Bv, *Bk = sm + Z.Bk, *Nc = sm + Z.Nc;

  const int j = tid;
  const bool col = j < hd;
  // 1. the chunk's scalars: lane t of warp 0 for position t0 + t
  if (warp == 0) {
    float lf = 0.f, mt = 0.f, ie = 0.f, den = 1.f, sg = 0.f, mp = 0.f;
    if (lane < n) {
      const size_t p = pos(a, b, t0 + lane, hh);
      mt = a.m_all[p];
      mp = t0 + lane > 0 ? a.m_all[pos(a, b, t0 + lane - 1, hh)] : a.m0[bh];
      lf = log_sigmoid(a.fp[p]);
      ie = expf(a.ip[p] - mt);
      const float d = a.d_all[p];
      den = fmaxf(fabsf(d), 1.f);
      sg = fabsf(d) >= 1.f ? (d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f)) : 0.f;
    }
    double LF = lf;                    // inclusive running sum, fixed tree
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(kFull, LF, o);
      if (lane >= o) LF += y;
    }
    sLF[lane] = LF;
    sM[lane] = mt;
    sIe[lane] = ie;
    sDen[lane] = den;
    sSg[lane] = sg;
    const float m_start = __shfl_sync(kFull, mp, 0);
    if (lane == 0) sMisc[0] = m_start;
  }
  __syncthreads();
  // 2. the rows, a thread a column: dnum = dh / den, q, s k, v (zero past
  // the chunk and hd; the ld - 32 E columns past the threads are padding),
  // kB rows' loads issued before their stores
  constexpr int kB = 8;
  for (int t0b = 0; t0b < L; t0b += kB) {
    float r[kB][4];
#pragma unroll
    for (int tb = 0; tb < kB; ++tb) {
      const int t = t0b + tb;
      const bool ok = t < n && col;
      const size_t base = ok ? pos(a, b, t0 + t, hh) * hd + j : 0;
      r[tb][0] = ok ? a.dh[base] : 0.f;
      r[tb][1] = ok ? a.q[base] : 0.f;
      r[tb][2] = ok ? a.k[base] : 0.f;
      r[tb][3] = ok ? a.v[base] : 0.f;
    }
#pragma unroll
    for (int tb = 0; tb < kB; ++tb) {
      const int t = t0b + tb;
      DN[t * ld + j] = r[tb][0] / sDen[t];
      Q[t * ld + j] = r[tb][1];
      K[t * ld + j] = r[tb][2] * a.scale;
      V[t * ld + j] = r[tb][3];
    }
  }
  for (int i = tid; i < L * (ld - nthr); i += nthr) {
    const int t = i / (ld - nthr), x = nthr + i % (ld - nthr);
    DN[t * ld + x] = 0.f; Q[t * ld + x] = 0.f; K[t * ld + x] = 0.f;
    V[t * ld + x] = 0.f;
  }
  // D(u, s) = exp(LF_u - LF_s + m_s - m_u), s <= u; zeta_t = D(t, t0 - 1),
  // rho_t = D(t0 + n - 1, t)
  for (int i = tid; i < L * L; i += nthr) {
    const int u = i / L, s = i - u * L;
    D[u * kLq + s] = (s <= u && u < n)
               ? expf(static_cast<float>(sLF[u] - sLF[s] + sM[s] - sM[u]))
               : 0.f;
  }
  if (tid < L) {
    const int t = tid;
    // the exponents in double: LF and m may be large and nearly cancel
    sZeta[t] = t < n ? expf(static_cast<float>(
                           sLF[t] + sMisc[0] - static_cast<double>(sM[t])))
                     : 0.f;
    sRho[t] = t < n ? expf(static_cast<float>(sLF[n - 1] - sLF[t] + sM[t]
                                              - static_cast<double>(sM[n - 1])))
                    : 0.f;
  }
  __syncthreads();
  // dd_t = -(dnum_t . h_t) sign(d_t) where |d_t| >= 1: a warp a row
  for (int t = warp; t < L; t += E) {
    float s = 0.f;
    if (t < n) {
      const float* hrow = a.h + pos(a, b, t0 + t, hh) * hd;
      for (int x = lane; x < hd; x += 32) s += DN[t * ld + x] * hrow[x];
    }
    s = warp_sum(s);
    if (lane == 0) sDd[t] = -s * sSg[t];
  }
  // P[u][s] = dnum_u . v_s and Qk[u][s] = q_u . s k_s for s <= u, 2 x 2
  // blocks, float4 along the columns
  for (int i = tid; i < 2 * (L / 2) * (L / 2); i += nthr) {
    const int which = i / ((L / 2) * (L / 2)), r = i % ((L / 2) * (L / 2));
    const int u0 = (r / (L / 2)) * 2, s0 = (r % (L / 2)) * 2;
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    if (s0 <= u0 + 1) {
      const float* A = which ? Q : DN;
      const float* Bm = which ? K : V;
      for (int x = 0; x < hd; x += 4) {
        float4 av[2], bv[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          av[q] = *reinterpret_cast<const float4*>(A + (u0 + q) * ld + x);
          bv[q] = *reinterpret_cast<const float4*>(Bm + (s0 + q) * ld + x);
        }
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            acc[p][q] = fmaf(av[p].x, bv[q].x, acc[p][q]);
            acc[p][q] = fmaf(av[p].y, bv[q].y, acc[p][q]);
            acc[p][q] = fmaf(av[p].z, bv[q].z, acc[p][q]);
            acc[p][q] = fmaf(av[p].w, bv[q].w, acc[p][q]);
          }
      }
    }
    float* out = which ? Qk : P;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < 2; ++q) out[(u0 + p) * kLq + s0 + q] = acc[p][q];
  }
  __syncthreads();
  // the coefficients, row u the summation index, column t the output:
  //   Bv[u][t] = ie_t D(u, t) (q_u . s k_t)             dv's
  //   Bk[u][t] = s ie_t D(u, t) (dnum_u . v_t + dd_u)   dk's
  //   Nc[u][t] = D(u, t) dd_u                           N's
  // (zero for t > u)
  for (int i = tid; i < L * L; i += nthr) {
    const int u = i / L, t = i - u * L, at = u * kLq + t;
    const float dut = D[at];
    Bv[at] = sIe[t] * dut * Qk[at];
    Bk[at] = a.scale * sIe[t] * dut * (P[at] + sDd[u]);
    Nc[at] = dut * sDd[u];
  }
  // W's fourth term, sum over u >= t > s of D(u, s) ie_s P[u][s] Qk[u][s]:
  // warp 0, a row u at a time, its running sum over s < t at lane t
  if (warp == 0) {
    float w = 0.f;
    for (int u = n - 1; u >= 1; --u) {
      const int at = u * kLq + lane;
      const float mv = lane < u ? D[at] * sIe[lane] * P[at] * Qk[at] : 0.f;
      float incl = mv;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane <= u) w += incl - mv;
    }
    sW4[lane] = w;
  }
  __syncthreads();
  // dq's coefficient, row s, column t: Aq[s][t] = D(t, s) ie_s P[t][s]
  // (zero for t < s), into Qk's place
  float* Aq = Qk;
  for (int i = tid; i < L * L; i += nthr) {
    const int s = i / L, t = i - s * L;
    Aq[s * kLq + t] = D[t * kLq + s] * sIe[s] * P[t * kLq + s];
  }
  __syncthreads();
  // 3. a thread per column j: dq, and beta_t = q_t . (C_snap^T dnum_t).
  // The snapshot streams through kU rows at a time, the next rows' loads
  // in flight while the current ones are used.
  float acc[L], nv[L];
#pragma unroll
  for (int t = 0; t < L; ++t) acc[t] = 0.f;
  {
    const float* snap = a.snap + (static_cast<size_t>(bh) * a.nc + c) * hd * hd;
    constexpr int kU = 8;
    float sv[kU], nx[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      nx[u] = (col && u < hd) ? snap[static_cast<size_t>(u) * hd + j] : 0.f;
    for (int i0 = 0; i0 < hd; i0 += kU) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        sv[u] = nx[u];
        const int i = i0 + kU + u;
        nx[u] = (col && i < hd) ? snap[static_cast<size_t>(i) * hd + j] : 0.f;
      }
#pragma unroll
      for (int h4 = 0; h4 < kU; h4 += 4) {
        if (i0 + h4 >= hd) break;
#pragma unroll
        for (int t = 0; t < L; ++t) {
          const float4 dn =
              *reinterpret_cast<const float4*>(DN + t * ld + i0 + h4);
          acc[t] = fmaf(dn.x, sv[h4], acc[t]);
          acc[t] = fmaf(dn.y, sv[h4 + 1], acc[t]);
          acc[t] = fmaf(dn.z, sv[h4 + 2], acc[t]);
          acc[t] = fmaf(dn.w, sv[h4 + 3], acc[t]);
        }
      }
    }
  }
  // beta's parts, then acc becomes dq but its dd n term: zeta_t (C_snap^T
  // dnum_t)_j + sum_s Aq[s][t] s k_s[j], s outer
#pragma unroll
  for (int t = 0; t < L; ++t) nv[t] = acc[t] * Q[t * ld + j];
  red[warp * L + lane] = transpose_sum(nv, lane);
#pragma unroll
  for (int t = 0; t < L; ++t) acc[t] *= sZeta[t];
  for (int s = 0; s < n; ++s) {
    const float kj = K[s * ld + j];
    const float4* row = reinterpret_cast<const float4*>(Aq + s * kLq);
#pragma unroll
    for (int q = 0; q < L / 4; ++q) {
      const float4 c4 = row[q];
      acc[4 * q] = fmaf(c4.x, kj, acc[4 * q]);
      acc[4 * q + 1] = fmaf(c4.y, kj, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(c4.z, kj, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(c4.w, kj, acc[4 * q + 3]);
    }
  }
  // this column's n_t, all loaded before any store (nv[t] = n_{t0+t}[j])
#pragma unroll
  for (int t = 0; t < L; ++t)
    nv[t] = (col && t < n) ? a.n_all[pos(a, b, t0 + t, hh) * hd + j] : 0.f;
  const float n_first = col ? (t0 > 0 ? a.n_all[pos(a, b, t0 - 1, hh) * hd + j]
                                      : a.n0[static_cast<size_t>(bh) * hd + j])
                            : 0.f;
#pragma unroll
  for (int t = 0; t < L; ++t)
    if (col && t < n)
      a.dq[pos(a, b, t0 + t, hh) * hd + j] = acc[t] + sDd[t] * nv[t];
  // 4. the intra-chunk parts of dv and dk (a thread per column, u outer),
  // then N_intra_t . n_{t-1}
  {
    float dk[L];
#pragma unroll
    for (int t = 0; t < L; ++t) acc[t] = dk[t] = 0.f;
    for (int u = 0; u < n; ++u) {
      const float dnj = DN[u * ld + j], qj = Q[u * ld + j];
      const float4* bv = reinterpret_cast<const float4*>(Bv + u * kLq);
      const float4* bk = reinterpret_cast<const float4*>(Bk + u * kLq);
#pragma unroll
      for (int q = 0; q < L / 4; ++q) {
        const float4 v4 = bv[q], k4 = bk[q];
        acc[4 * q] = fmaf(v4.x, dnj, acc[4 * q]);
        acc[4 * q + 1] = fmaf(v4.y, dnj, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v4.z, dnj, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v4.w, dnj, acc[4 * q + 3]);
        dk[4 * q] = fmaf(k4.x, qj, dk[4 * q]);
        dk[4 * q + 1] = fmaf(k4.y, qj, dk[4 * q + 1]);
        dk[4 * q + 2] = fmaf(k4.z, qj, dk[4 * q + 2]);
        dk[4 * q + 3] = fmaf(k4.w, qj, dk[4 * q + 3]);
      }
    }
#pragma unroll
    for (int t = 0; t < L; ++t)
      if (col && t < n) {
        const size_t base = pos(a, b, t0 + t, hh) * hd + j;
        a.dv[base] = acc[t];
        a.dk[base] = dk[t];
      }
#pragma unroll
    for (int t = 0; t < L; ++t) dk[t] = 0.f;
    for (int u = 0; u < n; ++u) {
      const float qj = Q[u * ld + j];
      const float4* nc = reinterpret_cast<const float4*>(Nc + u * kLq);
#pragma unroll
      for (int q = 0; q < L / 4; ++q) {
        const float4 c4 = nc[q];
        dk[4 * q] = fmaf(c4.x, qj, dk[4 * q]);
        dk[4 * q + 1] = fmaf(c4.y, qj, dk[4 * q + 1]);
        dk[4 * q + 2] = fmaf(c4.z, qj, dk[4 * q + 2]);
        dk[4 * q + 3] = fmaf(c4.w, qj, dk[4 * q + 3]);
      }
    }
#pragma unroll
    for (int t = 0; t < L; ++t)
      acc[t] = dk[t] * (t == 0 ? n_first : nv[t - 1]);
    red2[warp * L + lane] = transpose_sum(acc, lane);
  }
  __syncthreads();
  // 5. the per-position scalars: beta, W's chunk-local terms
  //   w34_t = sum_{u >= t} zeta_u beta_u + sum_{u >= t > s} Aq[u][s] Qk[u][s]
  if (tid < L) {
    float beta = 0.f, nu = 0.f;
    for (int w = 0; w < E; ++w) {
      beta += red[w * L + tid];
      nu += red2[w * L + tid];
    }
    sBeta[tid] = sZeta[tid] * beta;
    red2[tid] = nu;
  }
  __syncthreads();
  if (tid < n) {
    const int t = tid;
    float suf = 0.f;
    for (int u = n - 1; u >= t; --u) suf += sBeta[u];
    const size_t p = static_cast<size_t>(bh) * a.S + t0 + t;
    sc.ierho[p] = sIe[t] * sRho[t];
    sc.rho[p] = sRho[t];
    sc.fz[p] = sZeta[t] / sDen[t];
    sc.zdd[p] = sZeta[t] * sDd[t];
    sc.w34[p] = suf + sW4[t];
    sc.nu_in[p] = red2[t];
    if (t == n - 1) sc.E[static_cast<size_t>(bh) * a.nc + c] = sZeta[t];
  }
}

// The carry kernel's shared memory in floats: the chunk's rows X and Z (L
// rows of ld = 32 E), the tile's Y and three more tile arrays (L rows of
// kTile), three per-position scalars and the warps' parts.
struct CarrySmem {
  int ld, X, Zr, Y, A1, A2, A3, sc, red, floats;
  __host__ __device__ CarrySmem(int E) {
    ld = 32 * E;
    X = 0; Zr = X + kChunk * ld; Y = Zr + kChunk * ld;
    A1 = Y + kChunk * kTileLd; A2 = A1 + kChunk * kTileLd;
    A3 = A2 + kChunk * kTileLd; sc = A3 + kChunk * kTileLd;
    red = sc + 4 * kChunk;
    floats = red + 2 * kCarryWarps * kChunk + kCarryWarps;
  }
};

// role 0: rows i of G = dL/dC at the chunk's end; out[t][i] = (G s k_t)_i;
//   dv_t += ie_t rho_t out; alpha_t's part v_t . out; gamma's part
//   <G, C_snap>; G <- E G + sum_u dnum_u (zeta_u q_u)^T.
// role 1: rows j of G^T; out[t][j] = (G^T v_t)_j; dk_t += s ie_t rho_t
//   (out + N); kappa_t's part k_t . dk_t and nu_t's part N . n_{t-1};
//   G^T <- E G^T + sum_u (zeta_u q_u) dnum_u^T, N <- E N + sum_u zeta_u dd_u
//   q_u.
// The chunk's rows are raw copies (cp.async), the scalars folded in at
// use: X = k (role 0) or v, A1 = dv or dk (the chunk kernel's parts), A2 =
// v or k, A3 = n_{t-1} (role 1), Z = q or dh, Y = dh or q (the tile's
// rows, times zeta_u / den_u).  X and the A arrays of the chunk before
// load while this chunk's carry runs, Z and Y while the next products do.
template <int E>
__global__ void __launch_bounds__(32 * kCarryWarps, 1)
    mlstm_bwd_carry_kernel(Args a, Scratch sc) {
  constexpr int L = kChunk;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const CarrySmem Z(E);
  const int ld = Z.ld, hd = a.hd, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, nthr = 32 * kCarryWarps;
  const int tile = blockIdx.x, bh = blockIdx.y, role = blockIdx.z;
  const int b = bh / a.H, hh = bh % a.H, nt = sc.nt;
  const int rb = tile * kTile, r0 = rb + warp * kRows;
  float *X = sm + Z.X, *Zs = sm + Z.Zr, *Y = sm + Z.Y;
  float *A1 = sm + Z.A1, *A2 = sm + Z.A2, *A3 = sm + Z.A3;
  float *sIR = sm + Z.sc, *sFz = sIR + L, *sZdd = sFz + L;
  float *red = sm + Z.red, *red2 = red + kCarryWarps * L;
  float* redg = red2 + kCarryWarps * L;
  const size_t bhS = static_cast<size_t>(bh) * a.S;
  const float* snap0 = a.snap + static_cast<size_t>(bh) * a.nc * hd * hd;

  // the async copies of chunk c's rows (none for c < 0: an empty group),
  // 16 bytes a copy where rows are 16-byte aligned (hd a multiple of 4)
  const bool vec = hd % 4 == 0;
  auto copy_rows = [&](float* dst, int dst_ld, const float* src, int t0,
                       int n, int x0, int cols) {
    // rows t < L of dst[t * dst_ld + x], x < cols, from src's position
    // t0 + t, column x0 + x (zero past n and hd)
    if (vec) {
      const int q = cols / 4;
      for (int i = tid; i < L * q; i += nthr) {
        const int t = i / q, x = 4 * (i - t * q);
        const bool ok = t < n && x0 + x < hd;
        cp_async16(dst + t * dst_ld + x,
                   ok ? src + pos(a, b, t0 + t, hh) * hd + x0 + x : src, ok);
      }
    } else {
      for (int i = tid; i < L * cols; i += nthr) {
        const int t = i / cols, x = i - t * cols;
        const bool ok = t < n && x0 + x < hd;
        cp_async4(dst + t * dst_ld + x,
                  ok ? src + pos(a, b, t0 + t, hh) * hd + x0 + x : src, ok);
      }
    }
  };
  auto stage_xa = [&](int c) {
    if (c < 0) return;
    const int t0 = c * L, n = min(L, a.S - t0);
    copy_rows(X, ld, role == 0 ? a.k : a.v, t0, n, 0, ld);
    copy_rows(A1, kTileLd, role == 0 ? a.dv : a.dk, t0, n, rb, kTile);
    copy_rows(A2, kTileLd, role == 0 ? a.v : a.k, t0, n, rb, kTile);
    if (role == 1) {
      // n_{t-1}: position t0 + t - 1's row, n0 before the sequence
      if (t0 > 0) {
        copy_rows(A3, kTileLd, a.n_all, t0 - 1, n, rb, kTile);
      } else {
        for (int i = tid; i < L * kTile; i += nthr) {
          const int t = i / kTile, r = i - t * kTile, row = rb + r;
          const bool ok = t < n && row < hd;
          const float* np = !ok ? a.n0
                          : t > 0 ? a.n_all + pos(a, b, t - 1, hh) * hd + row
                                  : a.n0 + static_cast<size_t>(bh) * hd + row;
          cp_async4(A3 + t * kTileLd + r, np, ok);
        }
      }
    }
    if (tid < L) cp_async4(sIR + tid, sc.ierho + bhS + t0 + tid, tid < n);
  };
  auto stage_zy = [&](int c) {
    if (c < 0) return;
    const int t0 = c * L, n = min(L, a.S - t0);
    copy_rows(Zs, ld, role == 0 ? a.q : a.dh, t0, n, 0, ld);
    copy_rows(Y, kTileLd, role == 0 ? a.dh : a.q, t0, n, rb, kTile);
    if (tid < L) {
      cp_async4(sFz + tid, sc.fz + bhS + t0 + tid, tid < n);
      cp_async4(sZdd + tid, sc.zdd + bhS + t0 + tid, tid < n);
    }
  };

  float T[kRows][E], Nn[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    Nn[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) T[r][e] = 0.f;
  }
  stage_xa(a.nc - 1);
  cp_async_commit();
  stage_zy(a.nc - 1);
  cp_async_commit();
  for (int c = a.nc - 1; c >= 0; --c) {
    const int t0 = c * L, n = min(L, a.S - t0);
    const float Ec = sc.E[static_cast<size_t>(bh) * a.nc + c];
    if (role == 0 && c > 0) {
      // the next step's snapshot rows into L2 (they are one range)
      const char* next = reinterpret_cast<const char*>(
          snap0 + (static_cast<size_t>(c - 1) * hd + rb) * hd);
      const int rows = max(0, min(kTile, hd - rb));
      const size_t bytes = static_cast<size_t>(rows) * hd * sizeof(float);
      for (size_t off = static_cast<size_t>(tid) * 128; off < bytes;
           off += static_cast<size_t>(nthr) * 128)
        asm volatile("prefetch.global.L2 [%0];" :: "l"(next + off));
    }
    cp_async_wait_but_one();      // X and the A arrays of chunk c
    __syncthreads();
    // gamma's part: <G, C_snap> over this warp's rows (G is zero at the
    // end), two rows' loads in flight at a time
    if (role == 0) {
      float g = 0.f;
      if (c < a.nc - 1) {
        const float* snap = snap0 + static_cast<size_t>(c) * hd * hd;
#pragma unroll
        for (int r = 0; r < kRows; r += 2) {
          float sv[2][E];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const int x = e * 32 + lane, row = r0 + r + rr;
              sv[rr][e] = row < hd && x < hd
                              ? snap[static_cast<size_t>(row) * hd + x] : 0.f;
            }
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
#pragma unroll
            for (int e = 0; e < E; ++e) g = fmaf(T[r + rr][e], sv[rr][e], g);
        }
      }
      g = warp_sum(g);
      if (lane == 0) redg[warp] = g;
    }
    // out[t][r] for 4 positions at a time, then the boundary terms
    const int my_r = lane & 7, row = r0 + my_r;
    float n_mine = 0.f;                         // N of this lane's row
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (my_r == r) n_mine = Nn[r];
#pragma unroll 1
    for (int grp = 0; grp < L / 4; ++grp) {
      float v[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = 0.f;
#pragma unroll
      for (int tl = 0; tl < 4; ++tl) {
        const float* xr = X + (grp * 4 + tl) * ld;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xv = xr[e * 32 + lane];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            v[tl * kRows + r] = fmaf(xv, T[r][e], v[tl * kRows + r]);
        }
      }
      const float out = transpose_sum(v, lane);
      const int t = grp * 4 + (lane >> 3);
      const int ti = t * kTileLd + warp * kRows + my_r;
      const bool ok = t < n && row < hd;
      float p1 = 0.f, p2 = 0.f;
      if (role == 0) {
        const float gk = a.scale * out;           // (G s k_t)_i
        const float dv = A1[ti] + sIR[t] * gk;
        if (ok) a.dv[pos(a, b, t0 + t, hh) * hd + row] = dv;
        p1 = A2[ti] * gk;
      } else {
        const float dk = A1[ti] + a.scale * sIR[t] * (out + n_mine);
        if (ok) a.dk[pos(a, b, t0 + t, hh) * hd + row] = dk;
        p1 = A2[ti] * dk;
        p2 = n_mine * A3[ti];
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        p1 += __shfl_xor_sync(kFull, p1, o);
        p2 += __shfl_xor_sync(kFull, p2, o);
      }
      if (my_r == 0) {
        red[warp * L + t] = p1;
        red2[warp * L + t] = p2;
      }
    }
    __syncthreads();              // X and the A arrays are free
    stage_xa(c - 1);
    cp_async_commit();
    cp_async_wait_but_one();      // Z and Y of chunk c
    __syncthreads();
    // the carry: G (or G^T) <- E G + Y^T Z, N <- E N + sum_u Y[u] dd_u
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      Nn[r] *= Ec;
#pragma unroll
      for (int e = 0; e < E; ++e) T[r][e] *= Ec;
    }
#pragma unroll 1
    for (int u = 0; u < n; ++u) {
      float z[E];
#pragma unroll
      for (int e = 0; e < E; ++e) z[e] = Zs[u * ld + e * 32 + lane];
      const float4 y0 = *reinterpret_cast<const float4*>(
          Y + u * kTileLd + warp * kRows);
      const float4 y1 = *reinterpret_cast<const float4*>(
          Y + u * kTileLd + warp * kRows + 4);
      const float yr[kRows] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
      const float fz = sFz[u], zdd = sZdd[u];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        Nn[r] = fmaf(yr[r], zdd, Nn[r]);
        const float y = yr[r] * fz;
#pragma unroll
        for (int e = 0; e < E; ++e) T[r][e] = fmaf(y, z[e], T[r][e]);
      }
    }
    __syncthreads();              // Z and Y are free, the parts written
    stage_zy(c - 1);
    cp_async_commit();
    // the tile's parts of the per-position sums (warps in order)
    if (tid < n) {
      float p1 = 0.f, p2 = 0.f;
      for (int w = 0; w < kCarryWarps; ++w) {
        p1 += red[w * L + tid];
        p2 += red2[w * L + tid];
      }
      const size_t at = (bhS + t0 + tid) * nt + tile;
      if (role == 0) {
        sc.alpha[at] = p1;
      } else {
        sc.kappa[at] = p1;
        sc.nu_b[at] = p2;
      }
    }
    if (role == 0 && tid == 0) {
      float g = 0.f;
      for (int w = 0; w < kCarryWarps; ++w) g += redg[w];
      sc.gamma[(static_cast<size_t>(bh) * a.nc + c) * nt + tile] = g;
    }
  }
  // after the first chunk: G = dL/dC0, N = dL/dn0
  if (role == 0) {
    float* dC0 = a.dC0 + static_cast<size_t>(bh) * hd * hd;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int x = e * 32 + lane;
        if (r0 + r < hd && x < hd)
          dC0[static_cast<size_t>(r0 + r) * hd + x] = T[r][e];
      }
  } else if (lane < kRows && r0 + lane < hd) {
    float nv = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (lane == r) nv = Nn[r];
    a.dn0[static_cast<size_t>(bh) * hd + r0 + lane] = nv;
  }
}

// The gates: a warp per (b, h), reverse over the chunks, lane t for
// position t0 + t.  W_t = E gamma + sum_{s<t} rho_s ie_s alpha_s + w34_t,
// fe dL/dfe = W_t + fe_t (rho_t nu_b_t + nu_in_t), ie dL/die = kappa_t =
// k_t . dk_t, then the chain back through m (torch.maximum splits at a
// tie), serial over the chunk's positions.
__global__ void __launch_bounds__(32 * kGateWarps) mlstm_bwd_gate_kernel(
    Args a, Scratch sc) {
  constexpr int L = kChunk;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x * kGateWarps + (threadIdx.x >> 5);
  if (bh >= a.B * a.H) return;
  const int b = bh / a.H, hh = bh % a.H, nt = sc.nt;
  const size_t bhS = static_cast<size_t>(bh) * a.S;
  float gm = 0.f;
  for (int c = a.nc - 1; c >= 0; --c) {
    const int t0 = c * L, n = min(L, a.S - t0), t = t0 + lane;
    const size_t pc = (static_cast<size_t>(bh) * a.nc + c);
    float gam = 0.f;
    for (int i = 0; i < nt; ++i) gam += sc.gamma[pc * nt + i];
    float e1 = 0.f, e2 = 0.f, aa = 0.f, ip = 0.f, fp = 0.f, pre = 0.f;
    if (lane < n) {
      const size_t p = bhS + t;
      float alpha = 0.f, kappa = 0.f, nub = 0.f;
      for (int i = 0; i < nt; ++i) {
        alpha += sc.alpha[p * nt + i];
        kappa += sc.kappa[p * nt + i];
        nub += sc.nu_b[p * nt + i];
      }
      const size_t q = pos(a, b, t, hh);
      const float m_prev = t > 0 ? a.m_all[pos(a, b, t - 1, hh)] : a.m0[bh];
      fp = a.fp[q];
      ip = a.ip[q];
      aa = log_sigmoid(fp) + m_prev;
      const float fe = expf(aa - a.m_all[q]);
      const float rho = sc.rho[p];
      pre = sc.ierho[p] * alpha;
      e1 = sc.w34[p] + fe * (rho * nub + sc.nu_in[p]);
      e2 = kappa;
    }
    // exclusive running sum of rho ie alpha over the chunk (fixed tree)
    float incl = pre;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    e1 += sc.E[pc] * gam + (incl - pre);
    float g_in = 0.f;
    for (int s = n - 1; s >= 0; --s) {
      const float se1 = __shfl_sync(kFull, e1, s);
      const float se2 = __shfl_sync(kFull, e2, s);
      const float saa = __shfl_sync(kFull, aa, s);
      const float sip = __shfl_sync(kFull, ip, s);
      if (lane == s) g_in = gm;
      const float dm = gm - se1 - se2;
      gm = saa > sip ? se1 + dm : (saa < sip ? se1 : se1 + 0.5f * dm);
    }
    if (lane < n) {
      const float dm = g_in - e1 - e2;
      float da = e1, di = e2;
      if (aa > ip) {
        da += dm;
      } else if (aa < ip) {
        di += dm;
      } else {
        da += 0.5f * dm;
        di += 0.5f * dm;
      }
      const size_t q = pos(a, b, t, hh);
      a.di[q] = di;
      a.df[q] = da / (1.f + expf(fp));     // d log sigmoid = sigmoid(-f)
    }
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

// The backward's launches timed apart (a measurement: off unless asked
// for): events before the first launch and after each.
cudaEvent_t g_bwd_events[4];
bool g_bwd_timed = false;

void mark(int i, cudaStream_t st) {
  if (g_bwd_timed) cudaEventRecord(g_bwd_events[i], st);
}

template <int E>
int launch_bwd_e(const Args& a, Scratch sc, cudaStream_t st) {
  const size_t chunk = sizeof(float) * ChunkSmem(E).floats;
  const size_t carry = sizeof(float) * CarrySmem(E).floats;
  cudaError_t e = cudaFuncSetAttribute(
      mlstm_bwd_chunk_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(chunk));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(mlstm_bwd_carry_kernel<E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(carry));
  if (e != cudaSuccess) return static_cast<int>(e);
  mark(0, st);
  mlstm_bwd_chunk_kernel<E><<<dim3(a.nc, a.B * a.H), 32 * E, chunk, st>>>(
      a, sc);
  mark(1, st);
  mlstm_bwd_carry_kernel<E><<<dim3(sc.nt, a.B * a.H, 2), 32 * kCarryWarps,
                              carry, st>>>(a, sc);
  mark(2, st);
  const int gates = (a.B * a.H + kGateWarps - 1) / kGateWarps;
  mlstm_bwd_gate_kernel<<<gates, 32 * kGateWarps, 0, st>>>(a, sc);
  mark(3, st);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd(const Args& a, float* scratch, cudaStream_t st) {
  const Scratch sc(scratch, a.B, a.S, a.H, a.hd, a.nc);
  switch ((a.hd + 31) / 32) {
#define CASE(e) \
  case e: return launch_bwd_e<e>(a, sc, st);
    MLSTM_E_CASES(CASE)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

// on != 0: the backward records an event before its first launch and
// after each (mlstm_scan_bwd_launch_ms reads them); 0: it records none.
int mlstm_scan_bwd_time_launches(int on) {
  static bool made = false;
  if (on && !made) {
    for (cudaEvent_t& e : g_bwd_events) {
      const cudaError_t err = cudaEventCreate(&e);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    made = true;
  }
  g_bwd_timed = on != 0;
  return 0;
}

// The last timed backward's launches in ms: the chunk, carry and gate
// kernels (waits for the last event).
int mlstm_scan_bwd_launch_ms(float* ms) {
  cudaError_t err = cudaEventSynchronize(g_bwd_events[3]);
  for (int i = 0; i < 3 && err == cudaSuccess; ++i)
    err = cudaEventElapsedTime(ms + i, g_bwd_events[i], g_bwd_events[i + 1]);
  return static_cast<int>(err);
}

// Scratch floats of the backward at these sizes.
long long mlstm_scan_bwd_scratch(int B, int S, int H, int hd) {
  return static_cast<long long>(
      Scratch::floats(B, S, H, hd, (S + kChunk - 1) / kChunk));
}

// The forward's inputs and outputs, dh (B, S, H, hd); writes dq, dk, dv
// (B, S, H, hd), di, df (B, S, H), dC0, dn0, dm0, and uses scratch
// (mlstm_scan_bwd_scratch floats).  Three launches.
int mlstm_scan_bwd(const float* dh, const float* q, const float* k,
                   const float* v, const float* ip, const float* fp,
                   const float* C0, const float* n0, const float* m0,
                   const float* h, const float* n_all, const float* m_all,
                   const float* d_all, const float* snap, float* dq,
                   float* dk, float* dv, float* di, float* df, float* dC0,
                   float* dn0, float* dm0, float* scratch, int B, int S,
                   int H, int hd, float scale, void* stream) {
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
  a.dC0 = dC0; a.dn0 = dn0; a.dm0 = dm0;
  a.B = B; a.S = S; a.H = H; a.hd = hd; a.scale = scale;
  a.nc = (S + kChunk - 1) / kChunk;
  return launch_bwd(a, scratch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
