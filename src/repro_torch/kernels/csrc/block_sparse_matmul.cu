// Block-sparse matmul over a tile keep mask, float32 on the CUDA cores.
// Replaces the Pallas kernel repro/kernels/block_sparse_matmul.py::
// block_sparse_matmul: `_kernel` (forward) and `_kernel_t` (transpose_rhs).
//
//   forward     y (M, N) = x (M, K) @ (W ⊙ expand(mask))      W: (K, N)
//   transposed  y (M, K) = x (M, N) @ (W ⊙ expand(mask))^T    same W, mask
//
// mask is (ceil(K/bk), ceil(N/bn)) int32; W element (k, n) counts only where
// mask[k / bk][n / bn] != 0.  The mask tiles can be any size (72 x 24,
// 192 x 72, 72 x 6144 ...) and need not line up with the CTA's tiles.
//
// Bounds on an H100 (smollm-135m's products, rho = 0.5): at decode batch
// (M = 32) the kept weight bytes (a step's 211 products read ~269 MB,
// 0.09 ms at 3.35 TB/s), but for all but the unembedding latency sets the
// time: a 576 x 192 product is 0.2 MB, far under a microsecond of
// bandwidth, and costs a chain of dependent steps (launch, keep flags,
// loads, compute, fold).  At the prefill wave (M = 1024) the float32 FMA
// rate: the wave's kept products are ~137 GFLOP, 2 ms at 67 TFLOP/s.  No
// tensor cores: TF32 would break the 1e-4 parity with the plain version.
//
// The design.
//  * Segments.  The contraction (length C: K forward, N transposed) is cut
//    into segments that never cross a mask-tile row: tile row t (bc = bk
//    forward, bn transposed) splits into nsub pieces of seg_len.  The
//    wrapper derives nsub and seg_len from C and bc alone, never from M
//    (about 8 segments a contraction, none longer than 96).
//  * One order.  Inside a segment each output element is one fmaf chain in
//    ascending contraction order from 0 (p_s); the result is
//    ((0 + p_0) + p_1) + ... over the segments whose mask tile keeps the
//    element's column, in ascending order.  A dropped segment adds nothing
//    (or, in the split regime, adds -0.0f, which leaves every float as it
//    is).  Both regimes below run this same sequence of float operations,
//    so a row's result is bitwise the same for every M and every launch
//    plan: the serving engine's slot invariance rests on this.
//  * Walk regime: a CTA owns a BM x 64 output tile (256 threads, TM x 4
//    outputs each; BM = 32 up to M = 32, else 64) and walks the live
//    segments in order, a chunk of up to 96 contraction columns (whole
//    segments of one tile row) a stage, double-buffered with cp.async: the
//    next live chunk's x and W tiles, and the keep flags of the one after
//    it, load while the current one computes.
//  * Split regime, where the walk would put fewer than two CTAs on an SM
//    (at decode every product but the unembedding; at the prefill wave
//    wq, wk, wv, wo and w_out): each output tile gets a thread block
//    cluster of 8 or 16 CTAs, CTA r taking segments r, r + cs, ...  The
//    tile's outputs are dealt out in runs, one run a CTA; each CTA stores
//    each p_s straight into the owner's shared memory (distributed shared
//    memory), and after a cluster barrier every CTA folds its run in
//    segment order from local memory.  No workspace, no atomics.  A CTA
//    may touch a peer's shared memory only once every CTA of the cluster
//    runs, so each CTA also arrives on the cluster barrier as it starts
//    and waits on that phase just before its first remote store: the wait
//    overlaps the first segment's flags, loads and compute.  smollm-135m
//    at M = 32 launches wq / wo 9 x 8 = 72 CTAs, wk / wv 3 x 8 = 24,
//    w_in / w_gate 24 x 8 = 192, w_out 9 x 16 = 144; the unembedding
//    walks with 768 (one CTA a 64-column strip would give 9, 3, 24, 9 and
//    768).  scripts/bsmm_trace.py times the split's phases.
//  * The mask, out of the inner loop.  Each thread works out its columns'
//    tile indices once.  A CTA reads a segment's keep flags once (threads
//    < span, into shared memory) and ORs them in the same barrier: a
//    segment dropped for all its columns costs that read and no loads.
//    Inside a live segment, W loads are unconditional 16-byte cp.async
//    (neighbouring threads, neighbouring addresses); the flags select in
//    registers when the segment is folded.
//  * The transposed mode shares the loop: W is read with 4-byte copies
//    along the contraction and lands transposed in shared memory.
// Ragged M, K, N need no padding: copies past an edge zero-fill.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;            // output columns a CTA owns (a strip)
constexpr int NCG = BN / 4;       // column groups of 4; the rest of the
                                  // threads are row groups of TM rows
constexpr int kThreads = 256;
constexpr int kStage = 96;        // contraction columns a stage holds
constexpr int kCluster = 16;      // split regime: most CTAs a cluster
constexpr int kMaxSlots = 4;      // split regime: most segments a CTA takes

struct Args {
  const float* x;
  const float* w;
  const int32_t* mask;
  float* y;
  int M, C, NO, N, tn;  // C contraction, NO output columns, tn mask cols
  int bc, bo;           // mask tile size along the contraction / output
  int nsub, seg_len, nseg;
  int cluster;          // split regime: CTAs a cluster, 0 for the walk
  bool vec_w;           // W rows 16-byte aligned: N % 4 == 0, aligned base
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the cluster barrier in two halves: every thread of every CTA arrives,
// and a wait returns once all of them have arrived
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// [lo, hi) of segment s (empty past the end of a short last tile row)
__device__ __forceinline__ void seg_bounds(const Args& a, int s, int& lo,
                                           int& hi) {
  const int t = s / a.nsub, sub = s - t * a.nsub;
  lo = t * a.bc + sub * a.seg_len;
  hi = min(lo + a.seg_len, min((t + 1) * a.bc, a.C));
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// A stage holds up to this many segments of one tile row, each at a
// multiple of round4(seg_len), in at most kStage contraction columns.
__host__ __device__ constexpr int seg_per_chunk(int seg_len) {
  return kStage / round4(seg_len) > 0 ? kStage / round4(seg_len) : 1;
}

template <int TM>
__host__ __device__ constexpr int rows_of() { return kThreads / NCG * TM; }

// x and W stages (two for the walk, one for the split; W rows padded by 4
// floats) and the keep flags
template <int TM, bool kSplit>
__host__ __device__ constexpr size_t smem_bytes(int seg_len) {
  return sizeof(float) * (kSplit ? 1 : 2) * (rows_of<TM>() + BN + 4)
             * (seg_per_chunk(seg_len) * round4(seg_len))
         + sizeof(int) * 2 * BN;
}

template <bool kTrans, int TM, bool kSplit>
__global__ void __launch_bounds__(kThreads) bsmm_kernel(Args a) {
  if (kSplit) cluster_arrive_relaxed();   // this CTA runs (see the split)
  constexpr int BM = rows_of<TM>(), BS = BN + 4, NST = kSplit ? 1 : 2;
  extern __shared__ float4 smem4[];
  const int L4 = round4(a.seg_len), spc = seg_per_chunk(a.seg_len);
  const int CW = spc * L4;                      // stage width
  float* xs = reinterpret_cast<float*>(smem4);   // [NST][BM][CW]
  float* bs = xs + NST * BM * CW;                 // [NST][CW][BS]
  int* kf = reinterpret_cast<int*>(bs + NST * CW * BS);   // [2][BN]
  const int tid = threadIdx.x, tx = tid % NCG, ty = tid / NCG;
  const int lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int clo = j0 / a.bo;
  const int span = (min(j0 + BN, a.NO) - 1) / a.bo - clo + 1;
  const bool vec_out = (a.NO & 3) == 0;
  int cidx[4];   // this thread's columns' mask tiles, relative to clo
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
    cidx[jj] = min(j0 + tx * 4 + jj, a.NO - 1) / a.bo - clo;

  // this thread's keep flag for tile row t (threads >= span: 0); a plain
  // load that the caller may consume later
  auto flag_of = [&](int t) -> int {
    if (tid >= span) return 0;
    const int ct = clo + tid;
    return (kTrans ? a.mask[(size_t)ct * a.tn + t]
                   : a.mask[(size_t)t * a.tn + ct]) != 0;
  };
  // publish flags f into kf[st]; returns (to every thread) whether any
  // column tile of the strip is kept.  One barrier.
  auto publish = [&](int f, int st) -> bool {
    if (tid < span) kf[st * BN + tid] = f;
    return __syncthreads_or(f) != 0;
  };
  // issue the copies of contraction [lo, lo + len) into stage st at stage
  // column off (no wait)
  auto load = [&](int lo, int len, int st, int off) {
    float* xd = xs + st * BM * CW + off;
    float* bd = bs + (st * CW + off) * BS;
    for (int i = warp; i < BM; i += kThreads / 32) {
      const int m = m0 + i;
      const bool row = m < a.M;
      const float* src = a.x + (size_t)(row ? m : 0) * a.C + lo;
      for (int cc = lane; cc < len; cc += 32)
        cp_async4(xd + i * CW + cc, row ? src + cc : a.x, row);
    }
    if (kTrans) {
      // B[c][j] = W[j][c]: 4-byte copies along c, landing transposed
      for (int jj = warp; jj < BN; jj += kThreads / 32) {
        const int j = j0 + jj;
        const bool ok = j < a.NO;
        const float* src = a.w + (size_t)(ok ? j : 0) * a.N + lo;
        for (int cc = lane; cc < len; cc += 32)
          cp_async4(bd + cc * BS + jj, ok ? src + cc : a.w, ok);
      }
    } else if (a.vec_w) {
      for (int e = tid; e < len * NCG; e += kThreads) {
        const int cc = e / NCG, q = (e % NCG) * 4, j = j0 + q;
        const bool ok = j < a.NO;
        cp_async16(bd + cc * BS + q,
                   ok ? a.w + (size_t)(lo + cc) * a.N + j : a.w, ok);
      }
    } else {
      for (int e = tid; e < len * BN; e += kThreads) {
        const int cc = e / BN, jj = e % BN, j = j0 + jj;
        const bool ok = j < a.NO;
        cp_async4(bd + cc * BS + jj,
                  ok ? a.w + (size_t)(lo + cc) * a.N + j : a.w, ok);
      }
    }
  };
  // p for this thread's TM x 4 outputs over stage st's columns
  // [off, off + len): one fmaf chain each, ascending contraction order
  auto compute = [&](int st, int off, int len, float (&p)[TM][4]) {
    const float* xd = xs + st * BM * CW + ty * TM * CW + off;
    const float* bd = bs + (st * CW + off) * BS + tx * 4;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) p[i][jj] = 0.f;
    int cc = 0;
    for (; cc + 4 <= len; cc += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(xd + i * CW + cc);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 b4 = *reinterpret_cast<const float4*>(bd + (cc + u) * BS);
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float xa = u == 0 ? av[i].x : u == 1 ? av[i].y
                         : u == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) p[i][jj] = fmaf(xa, b[jj], p[i][jj]);
        }
      }
    }
    for (; cc < len; ++cc) {
      const float4 b4 = *reinterpret_cast<const float4*>(bd + cc * BS);
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float xa = xd[i * CW + cc];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) p[i][jj] = fmaf(xa, b[jj], p[i][jj]);
      }
    }
  };

  float p[TM][4];
  if (!kSplit) {
    // the walk, a chunk (up to spc segments of one tile row) a stage
    const int cpr = (a.nsub + spc - 1) / spc;           // chunks a row
    const int nchunk = (a.C + a.bc - 1) / a.bc * cpr;
    // the non-empty segments [s0, s1) of chunk ch
    auto chunk_segs = [&](int ch, int& s0, int& s1) {
      const int t = ch / cpr, u0 = (ch - t * cpr) * spc;
      s0 = t * a.nsub + u0;
      s1 = t * a.nsub + min(u0 + spc, a.nsub);
      for (int s = s0; s < s1; ++s) {
        int lo, hi;
        seg_bounds(a, s, lo, hi);
        if (lo >= hi) {
          s1 = s;
          break;
        }
      }
    };
    auto load_chunk = [&](int ch, int st) {
      int s0, s1;
      chunk_segs(ch, s0, s1);
      for (int s = s0; s < s1; ++s) {
        int lo, hi;
        seg_bounds(a, s, lo, hi);
        load(lo, hi - lo, st, (s - s0) * L4);
      }
    };
    // the first live chunk from ch on, its flags in kf[st], or nchunk; f
    // is this thread's flag for ch, already read.  Empty chunks only end
    // the last tile row, so the walk ends at the first one.
    auto next_live = [&](int ch, int f, int st) -> int {
      for (; ch < nchunk; ++ch) {
        int s0, s1;
        chunk_segs(ch, s0, s1);
        if (s0 == s1) break;
        if (publish(f, st)) return ch;
        if (ch + 1 < nchunk) f = flag_of((ch + 1) / cpr);
      }
      return nchunk;
    };
    float total[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) total[i][jj] = 0.f;
    int st = 0;
    int ch = next_live(0, nchunk > 0 ? flag_of(0) : 0, 0);
    if (ch < nchunk) load_chunk(ch, 0);
    cp_async_commit();
    // the flag of the chunk after the next is read a chunk ahead, so its
    // latency hides behind a chunk's compute; only a dead chunk costs a
    // read on the spot
    int f = ch + 1 < nchunk ? flag_of((ch + 1) / cpr) : 0;
    while (ch < nchunk) {
      const int ch_next = next_live(ch + 1, f, st ^ 1);
      if (ch_next < nchunk) load_chunk(ch_next, st ^ 1);
      cp_async_commit();
      f = ch_next + 1 < nchunk ? flag_of((ch_next + 1) / cpr) : 0;
      cp_async_wait<1>();
      __syncthreads();
      int s0, s1;
      chunk_segs(ch, s0, s1);
      for (int s = s0; s < s1; ++s) {
        int lo, hi;
        seg_bounds(a, s, lo, hi);
        compute(st, (s - s0) * L4, hi - lo, p);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const bool keep = kf[st * BN + cidx[jj]] != 0;
#pragma unroll
          for (int i = 0; i < TM; ++i)
            if (keep) total[i][jj] = total[i][jj] + p[i][jj];
        }
      }
      __syncthreads();   // stage st is refilled by the next iteration
      ch = ch_next;
      st ^= 1;
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i, j = j0 + tx * 4;
      if (m >= a.M || j >= a.NO) continue;
      float* row = a.y + (size_t)m * a.NO + j;
      if (vec_out) {
        *reinterpret_cast<float4*>(row) =
            make_float4(total[i][0], total[i][1], total[i][2], total[i][3]);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (j + jj < a.NO) row[jj] = total[i][jj];
      }
    }
    return;
  }

  // split regime: the CTAs of a cluster (rank r of cs, along z) share a
  // BM x BN output tile and take its segments r, r + cs, ...  The tile's
  // outputs, as items of 4 columns, are dealt out in runs of `per`, one
  // run a CTA; each CTA
  // stores each of its p_s straight into the shared memory of the items'
  // owner (a dropped column as -0.0f: x + (-0) == x for every x, so the
  // fold need not know which were dropped), and after one cluster barrier
  // every CTA folds its own items in segment order from local memory.  The
  // first remote store waits for the arrival at the kernel's start: by
  // then every CTA of the cluster runs.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = gridDim.z, r = blockIdx.z;
  const int items = min(BM, a.M - m0) * NCG, per = (items + cs - 1) / cs;
  float4* recv = reinterpret_cast<float4*>(kf + 2 * BN);   // [nseg][per]
  bool started = false;   // the whole cluster is known to run
  for (int s = r; s < a.nseg; s += cs) {
    int lo, hi;
    seg_bounds(a, s, lo, hi);
    const bool live = lo < hi && publish(flag_of(s / a.nsub), 0);
    if (live) {
      load(lo, hi - lo, 0, 0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      compute(0, 0, hi - lo, p);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const bool keep = live && kf[cidx[jj]] != 0;
#pragma unroll
      for (int i = 0; i < TM; ++i)
        if (!keep) p[i][jj] = -0.f;
    }
    if (!started) {
      cluster_wait();
      started = true;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = ty * TM + i;
      if (m0 + m >= a.M) continue;
      const int it = m * NCG + tx, owner = it / per;
      cluster.map_shared_rank(recv, owner)[s * per + it - owner * per] =
          make_float4(p[i][0], p[i][1], p[i][2], p[i][3]);
    }
    __syncthreads();   // stage 0 and kf serve the next segment
  }
  if (!started) cluster_wait();   // the barrier's phases stay paired
  cluster.sync();
  for (int l = tid; l < per && r * per + l < items; l += kThreads) {
    const int it = r * per + l, m = m0 + it / NCG, j = j0 + (it % NCG) * 4;
    float4 tot = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < a.nseg; ++s) {
      const float4 v = recv[s * per + l];
      tot.x = tot.x + v.x;
      tot.y = tot.y + v.y;
      tot.z = tot.z + v.z;
      tot.w = tot.w + v.w;
    }
    float* row = a.y + (size_t)m * a.NO + j;
    if (vec_out && j < a.NO) {
      *reinterpret_cast<float4*>(row) = tot;
    } else {
      const float e[4] = {tot.x, tot.y, tot.z, tot.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (j + jj < a.NO) row[jj] = e[jj];
    }
  }
}

template <bool kTrans, int TM, bool kSplit>
int launch_one(const Args& a, cudaStream_t st) {
  auto* kernel = bsmm_kernel<kTrans, TM, kSplit>;
  constexpr int BM = rows_of<TM>();
  // split: the fold's receive buffer, nseg x per items of 16 bytes, where
  // nseg <= cs * kMaxSlots and per = ceil(BM * NCG / cs)
  constexpr size_t kRecvMost = 16 * (size_t)kMaxSlots * (BM * NCG + kCluster);
  static_assert(kRecvMost + smem_bytes<TM, true>(kStage) <= 227 * 1024,
                "split regime exceeds shared memory");
  const int strips = (a.NO + BN - 1) / BN;
  static bool attr_set = false;   // once per kernel: the largest size
  if (!attr_set) {
    const size_t most = smem_bytes<TM, kSplit>(kStage)
                        + (kSplit ? kRecvMost : 0);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(most));
    if (err == cudaSuccess && kSplit)   // clusters of up to 16 CTAs
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  if (!kSplit) {
    kernel<<<dim3(strips, (a.M + BM - 1) / BM), kThreads,
             smem_bytes<TM, kSplit>(a.seg_len), st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int cs = a.cluster;
  const int per = (min(BM, a.M) * NCG + cs - 1) / cs;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(strips, (a.M + BM - 1) / BM, cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<TM, kSplit>(a.seg_len)
                         + 16 * (size_t)a.nseg * per;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cs;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTrans>
int launch(const float* x, const float* w, const int32_t* mask, float* y,
           int M, int K, int N, int bk, int bn, int nsub, int seg_len,
           int split, void* stream) {
  Args a;
  a.x = x; a.w = w; a.mask = mask; a.y = y;
  a.M = M; a.C = kTrans ? N : K; a.NO = kTrans ? K : N; a.N = N;
  a.bc = kTrans ? bn : bk; a.bo = kTrans ? bk : bn;
  if (M == 0 || a.NO == 0) return 0;
  if (bk <= 0 || bn <= 0 || nsub <= 0 || seg_len <= 0 ||
      seg_len > kStage)
    return static_cast<int>(cudaErrorInvalidValue);
  a.tn = (N + bn - 1) / bn;
  a.nsub = nsub; a.seg_len = seg_len;
  a.vec_w = (N & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  a.nseg = (a.C + a.bc - 1) / a.bc * nsub;
  a.cluster = split;
  if (split < 0 || split > kCluster ||
      (split && (split > a.nseg || a.nseg > split * kMaxSlots)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= rows_of<2>())
    return split ? launch_one<kTrans, 2, true>(a, st)
                 : launch_one<kTrans, 2, false>(a, st);
  return split ? launch_one<kTrans, 4, true>(a, st)
               : launch_one<kTrans, 4, false>(a, st);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (M, K), w (K, N), mask (ceil(K/bk), ceil(N/bn)) -> y (M, N); row-major.
// nsub / seg_len: the segments of each mask-tile row; split: 0 the walk,
// else the split regime's cluster size (up to 16, at least nseg / 4) —
// see the note above.
int bsmm_forward(const float* x, const float* w, const int32_t* mask,
                 float* y, int M, int K, int N, int bk, int bn, int nsub,
                 int seg_len, int split, void* stream) {
  return launch<false>(x, w, mask, y, M, K, N, bk, bn, nsub, seg_len,
                       split, stream);
}

// x (M, N), w (K, N), mask (ceil(K/bk), ceil(N/bn)) -> y (M, K); row-major;
// the segments cut N along bn.
int bsmm_transposed(const float* x, const float* w, const int32_t* mask,
                    float* y, int M, int K, int N, int bk, int bn, int nsub,
                    int seg_len, int split, void* stream) {
  return launch<true>(x, w, mask, y, M, K, N, bk, bn, nsub, seg_len,
                      split, stream);
}

}  // extern "C"
