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
// SM's shared memory; read from L2 at every step they would set the time
// at one SM's L2 port.
//
// Forward: a thread-block cluster of kCluster = 8 CTAs per (b, h).  CTA r
// owns the dims [r chunk, (r + 1) chunk), chunk = ceil(hd / kCluster) (the
// last CTAs fewer, or none, where kCluster does not divide hd), for all
// four gates: its 4 hd chunk entries of R (72 KB at hd = 192) go into its
// shared memory once a launch, and the first kRegK = 64 of each warp's k
// range into its lanes' registers, so no R is read from L2 inside the step
// loop.  Each CTA keeps the whole h_{t-1} in shared memory, twice (even and
// odd steps).  A step: 4 kSplit warps form the products of its columns
// with h_{t-1} (warp (g, s) over the s-th part of k, a lane a column,
// h_{t-1} as float4 broadcasts; where the parts split evenly, as at hd =
// 192, without a branch, every block's loads issued before its products);
// one CTA barrier; a thread per owned dim adds the parts in a fixed order,
// runs the cell, and sends its h_t to every CTA of the cluster with
// st.async, each CTA's mbarrier counting the bytes of h it expects a
// step.  So a step waits only for its own inputs: no cluster barrier and
// no fence on the outputs' global stores.  With h double-buffered, a peer
// writes buffer (t + 1) & 1 only after it has this CTA's h_t, sent after
// this CTA's last read of that buffer.  Two CTAs share a multiprocessor
// (128 registers a thread; 30 clusters fit an H100 at hd = 192).  What
// bounds it now (scripts/slstm_phases.py): each step's latency, ~1,170
// cycles of products (shared-memory reads of R and h and their latency)
// and ~830 of cell, sends and stores.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxHd = 256;           // the backward's 4 hd threads a CTA

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
// matrix against a vector in shared memory (the backward's products with
// R^T, read from L2).  The column's loads go out kBatch at a time before
// their products (the L2's latency, not its bandwidth, would set the time
// with a few loads in flight); four chains, k mod 4, added in a fixed order.
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

// The forward's cluster: kCluster CTAs a (b, h) (8, the portable maximum),
// each of 4 kSplit warps (a gate and a part of k each).  A lane keeps the
// first kRegK entries of its column's part of R in registers, the rest is
// read from shared memory each step (kRegK a multiple of 16).
constexpr int kCluster = 8;
constexpr int kSplit = 2;
constexpr int kRegK = 64;
constexpr int kFwdThreads = 4 * kSplit * 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `addr` (this CTA's shared memory) as CTA `rank` of the cluster sees it
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// one arrival that also expects `bytes` more of this phase's transactions
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// the wait acquires at cluster scope: the peers' st.async complete_tx
// releases at cluster scope
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// value into a peer's shared memory `dst`, counted on the peer's mbarrier
// `bar` (shared::cluster addresses)
__device__ __forceinline__ void st_async(uint32_t dst, float value,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" :: "r"(dst), "f"(value), "r"(bar) : "memory");
}

// The forward's shared memory: two mbarriers (16 bytes), then in floats
// R's columns (4 hd chunk), h twice (2 hpad, hpad = hd rounded up to 4),
// the products' parts (kSplit 4 chunk).
struct FwdSmem {
  int chunk, hpad, r_off, h_off, part_off, floats;
  __host__ __device__ explicit FwdSmem(int hd) {
    chunk = (hd + kCluster - 1) / kCluster;
    hpad = (hd + 3) & ~3;
    r_off = 4;                                // after the mbarriers
    h_off = r_off + 4 * hd * chunk;
    h_off = (h_off + 3) & ~3;                 // float4 reads of h
    part_off = h_off + 2 * hpad;
    floats = part_off + kSplit * 4 * chunk;
  }
};

__global__ void __launch_bounds__(kFwdThreads, 2) slstm_fwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int hd = a.hd, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const FwdSmem L(hd);
  const int chunk = L.chunk, hpad = L.hpad;
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / kCluster, b = bh / a.H, hh = bh % a.H;
  const int v0 = rank * chunk, nd = max(0, min(chunk, hd - v0));
  const uint32_t bar0 = smem_addr(smem);    // buffer i's mbarrier at + 8 i
  float* Rs = smem + L.r_off;      // Rs[(g hd + k) chunk + j] = R[h][g][k][v0 + j]
  float* hbuf = smem + L.h_off;    // h_{t-1} at (t & 1) hpad
  float* part = smem + L.part_off; // part[(s 4 + g) chunk + j]
  const float* Rh = a.R + static_cast<size_t>(hh) * 4 * hd * hd;
  for (int i = tid; i < 4 * hd * chunk; i += kFwdThreads) {
    const int j = i % chunk, gk = i / chunk;
    Rs[i] = j < nd ? Rh[static_cast<size_t>(gk) * hd + v0 + j] : 0.f;
  }
  const float* h0 = a.h0 + static_cast<size_t>(bh) * hd;
  for (int k = tid; k < 2 * hpad; k += kFwdThreads)
    hbuf[k] = k < hd ? h0[k] : 0.f;
  if (tid == 0) {
    // buffer i receives hd floats a phase, from the whole cluster
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    mbar_expect(bar0, 4 * hd);
    mbar_expect(bar0 + 8, 4 * hd);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the thread of owned dim `tid`: its state and its x one step ahead
  const bool cell = tid < nd;
  const int v = v0 + tid;
  float c = 0.f, n = 0.f, m = 0.f;
  float xn[4] = {0.f, 0.f, 0.f, 0.f};
  const size_t xrow = static_cast<size_t>(a.H) * 4 * hd;   // a position
  const size_t xb = (static_cast<size_t>(b) * a.S * a.H + hh) * 4 * hd + v;
  if (cell) {
    const size_t st = static_cast<size_t>(bh) * hd + v;
    c = a.c0[st];
    n = a.n0[st];
    m = a.m0[st];
#pragma unroll
    for (int q = 0; q < 4; ++q) xn[q] = a.x[xb + q * hd];
  }
  // warp (g, s): gate g over k in [kb, ke); kb a multiple of 4; the lane
  // of column j = lane (< nd) holds R[kb + i][j], i < kRegK, in registers
  // (zero past ke)
  const int g = warp & 3, s = warp >> 2;
  const int kpart = (((hd + kSplit - 1) / kSplit) + 3) & ~3;
  const int kb = min(hd, s * kpart), ke = min(hd, kb + kpart);
  const int kr = min(ke, kb + kRegK);        // [kr, ke) from shared memory
  // every warp's k-part fills its registers and leaves whole blocks of 16
  // to shared memory, and a lane has one column (hd = 192: 64 + 2 x 16)
  const bool fast = kpart >= kRegK && (kpart - kRegK) % 16 == 0 &&
                    hd % kpart == 0 && hd / kpart == kSplit && chunk <= 32;
  cluster.sync();                  // every CTA's buffers and mbarriers ready
  float rr[kRegK];
  {
    const float* Rg = Rs + static_cast<size_t>(g) * hd * chunk + lane;
#pragma unroll
    for (int i = 0; i < kRegK; ++i)
      rr[i] = (lane < nd && kb + i < ke) ? Rg[(kb + i) * chunk] : 0.f;
  }
  for (int t = 0; t < a.S; ++t) {
    const float* hcur = hbuf + (t & 1) * hpad;
    if (t > 0) {
      // h_{t-1} has come from every CTA: the ((t - 1) / 2)-th phase of
      // buffer t & 1.  Re-armed for its next phase, whose values the
      // peers send only after this CTA's h_t, so never before this wait.
      const uint32_t bar = bar0 + 8 * (t & 1);
      mbar_wait(bar, ((t - 1) >> 1) & 1);
      if (tid == 0) mbar_expect(bar, 4 * hd);
    }
    if (fast && lane < nd) {
      // the whole k-part without a branch: registers, then shared memory
      // in blocks of 16, each block's loads issued before its products
      const float* Rg = Rs + static_cast<size_t>(g) * hd * chunk + lane;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kRegK; i += 16) {
        float4 hv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          hv[q] = *reinterpret_cast<const float4*>(hcur + kb + i + 4 * q);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[0] = fmaf(hv[q].x, rr[i + 4 * q], acc[0]);
          acc[1] = fmaf(hv[q].y, rr[i + 4 * q + 1], acc[1]);
          acc[2] = fmaf(hv[q].z, rr[i + 4 * q + 2], acc[2]);
          acc[3] = fmaf(hv[q].w, rr[i + 4 * q + 3], acc[3]);
        }
      }
#pragma unroll 1
      for (int k = kr; k < ke; k += 16) {
        float4 hv[4];
        float rv[16];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          hv[q] = *reinterpret_cast<const float4*>(hcur + k + 4 * q);
#pragma unroll
        for (int q = 0; q < 16; ++q) rv[q] = Rg[(k + q) * chunk];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[0] = fmaf(hv[q].x, rv[4 * q], acc[0]);
          acc[1] = fmaf(hv[q].y, rv[4 * q + 1], acc[1]);
          acc[2] = fmaf(hv[q].z, rv[4 * q + 2], acc[2]);
          acc[3] = fmaf(hv[q].w, rv[4 * q + 3], acc[3]);
        }
      }
      part[(s * 4 + g) * chunk + lane] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    for (int j = lane; !fast && j < nd; j += 32) {
      const float* Rg = Rs + static_cast<size_t>(g) * hd * chunk + j;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      int k = kb;
      if (j == lane) {             // the first kRegK from registers
#pragma unroll
        for (int i = 0; i < kRegK; i += 4) {
          if (kb + i >= kr) break;
          const float4 hv = *reinterpret_cast<const float4*>(hcur + kb + i);
          acc[0] = fmaf(hv.x, rr[i], acc[0]);
          acc[1] = fmaf(hv.y, rr[i + 1], acc[1]);
          acc[2] = fmaf(hv.z, rr[i + 2], acc[2]);
          acc[3] = fmaf(hv.w, rr[i + 3], acc[3]);
        }
        k = kr;
      }
#pragma unroll 4
      for (; k + 4 <= ke; k += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(hcur + k);
        acc[0] = fmaf(hv.x, Rg[(k + 0) * chunk], acc[0]);
        acc[1] = fmaf(hv.y, Rg[(k + 1) * chunk], acc[1]);
        acc[2] = fmaf(hv.z, Rg[(k + 2) * chunk], acc[2]);
        acc[3] = fmaf(hv.w, Rg[(k + 3) * chunk], acc[3]);
      }
      for (; k < ke; ++k) acc[0] = fmaf(hcur[k], Rg[k * chunk], acc[0]);
      part[(s * 4 + g) * chunk + j] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    __syncthreads();
    if (cell) {
      float p[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float sum = part[q * chunk + tid];
#pragma unroll
        for (int r = 1; r < kSplit; ++r) sum += part[(r * 4 + q) * chunk + tid];
        p[q] = xn[q] + sum;
      }
      const size_t pb = xb + t * xrow;
      if (t + 1 < a.S) {
#pragma unroll
        for (int q = 0; q < 4; ++q) xn[q] = a.x[pb + xrow + q * hd];
      }
      const float z = tanhf(p[0]), o = sigmoid(p[3]);
      const float aa = log_sigmoid(p[2]) + m;
      const float mn = fmaxf(aa, p[1]);
      const float fe = expf(aa - mn), ie = expf(p[1] - mn);
      c = fe * c + ie * z;
      n = fmaxf(fe * n + ie, 1e-6f);
      m = mn;
      const float hv = o * c / n;
      if (t + 1 < a.S) {
        const uint32_t dst = smem_addr(hbuf + ((t + 1) & 1) * hpad + v);
        const uint32_t bar = bar0 + 8 * ((t + 1) & 1);
#pragma unroll
        for (int r = 0; r < kCluster; ++r)
          st_async(peer_addr(dst, r), hv, peer_addr(bar, r));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) a.pre[pb + q * hd] = p[q];
      const size_t o_ = ((static_cast<size_t>(b) * a.S + t) * a.H + hh) * hd
                        + v;
      a.h[o_] = hv;
      a.c_all[o_] = c;
      a.n_all[o_] = n;
      a.m_all[o_] = m;
    }
  }
  cluster.sync();                  // no CTA leaves while a peer may write
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

// The forward's cluster launch over `clusters` (b, h): the dynamic
// shared-memory limit raised above 48 KB, the cluster's shape an attribute.
int fwd_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1],
               int clusters, int hd, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(FwdSmem(hd).floats) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      slstm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  cfg.gridDim = dim3(clusters * kCluster);
  cfg.blockDim = dim3(kFwdThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return 0;
}

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
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  const int err = fwd_config(cfg, attr, B * H, hd,
                             static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, slstm_fwd_kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The forward's launch shape at head dim hd: CTAs a cluster, shared
// memory a CTA (bytes), and how many clusters the card holds at once
// (cudaOccupancyMaxActiveClusters); returns a CUDA error code.
int slstm_scan_fwd_cluster(int hd, int* cluster, int* smem_bytes,
                           int* max_clusters) {
  if (hd <= 0 || hd > kMaxHd) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  const int err = fwd_config(cfg, attr, 1, hd, nullptr);
  if (err != 0) return err;
  *cluster = kCluster;
  *smem_bytes = static_cast<int>(cfg.dynamicSmemBytes);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      max_clusters, slstm_fwd_kernel, &cfg));
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
