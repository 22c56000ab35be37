// One-token GQA decode attention against a KV cache, float32.
// Replaces the Pallas kernel repro/kernels/decode_attention.py::
// decode_attention (`_kernel`).
//
//   q (B, H, hd), k/v (B, S, Hkv, hd), pos (B,) -> out (B, H, hd)
//   key kpos is valid for row b iff lo <= kpos <= hi, with
//   hi = min(pos[b], S - 1) and lo = max(0, pos[b] - window + 1) (0 without
//   a window); out = softmax(q k^T * scale) v per query head, divided by
//   max(l, 1e-30).  A dead KV head (head_mask[h] <= 0) or a row with no
//   valid key reads no cache and writes zeros.  Ragged S needs no padding.
//
// Bound on an H100: bytes.  Each valid K/V element is read once and used for
// 2 G FLOP (G = H / Hkv = 3 for smollm-135m), far below the card's ops:byte
// balance, so the design is about keeping enough loads in flight on every
// SM and nothing serial between them.
//
// Split-KV with a fixed summation order ("flash decoding").  The cache is
// cut into chunks of kChunk = 16 keys at absolute positions: chunk j holds
// keys [16 j, 16 j + 16) intersected with [lo, hi].  A (row, KV head) gets
// a cluster of NC CTAs along grid y, NC = min(8, ceil(S / kSpan)), a
// function of S alone; each CTA has kWarps = 4 warps, so the row has
// U = 4 NC workers, and worker u = 4 c + w (CTA c, warp w) takes the
// chunks j = u (mod U) in ascending order, keeping its own online softmax
// state (m, l, acc) per query head.  A CTA folds its 4 workers' partials
// in order w = 0..3, and CTA 0 folds the cluster's CTAs in order
// c = 0..NC-1 through distributed shared memory; a fold takes the largest
// m first, then sums l e^(m_j - m) and acc e^(m_j - m) in order.  Every
// step of that order is set by key positions, S, hd and compile-time
// constants, so a row's bits do not depend on B, the slot count or the
// number of SMs: the serving engine's 32-slot, 8-slot and one-request runs
// give the same tokens.  No atomics, no workspace.
//
// Inside a chunk everything is warp-local (no __syncthreads in the chunk
// loop).  Each warp double-buffers its chunks' K and V rows in shared
// memory with cp.async: 16-byte copies when hd % 4 == 0 and the cache is
// 16-byte aligned, 4-byte copies otherwise (the scalar path); keys outside
// [lo, hi] are zero-filled and read nothing.  Two lanes score a key, one
// the even and one the odd 16-byte items of its K row, in four independent
// chains a query head (K rows padded to an odd number of 16-byte units: no
// bank conflicts), and add their halves by one shuffle; the chunk's max
// and sum are shuffles over 16 lanes, all query heads interleaved.  For
// P.V the lanes split into rp = 32 / hd4 groups of hd4 = ceil(hd / 4)
// lanes, a lane holding 4 dims of every query head, group r taking keys
// r, r + rp, ... (two a step); the groups are summed in order once the
// worker's chunks are done.  Two stages a warp: at smollm-135m's shape a
// CTA takes ~76 KB, so three CTAs (12 warps) share an SM; the most any
// shape takes (G = 8, hd = 128, NC = 8) is ~187 KB.  q is copied before pos is
// read, so its round trip overlaps that of pos.
//
// The cluster barrier: every CTA arrives as it starts and waits before its
// first store into CTA 0's shared memory, so no CTA touches a peer that has
// not started; one cluster.sync() then publishes the stores.  With NC = 1
// the kernel is launched without a cluster.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kChunk = 16;          // keys a chunk: two lanes a key
constexpr int kSpan = 1024;         // cache positions a CTA of a cluster
constexpr int kMaxCluster = 8;
constexpr int kMaxHd = 128, kMaxG = 8;
constexpr size_t kSmemMax = 227 * 1024;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const int32_t* pos;
  const float* head_mask;   // (Hkv,); nullptr: every head live
  float* out;
  int S, H, Hkv, hd, window;
  float scale;
  int hd4;      // ceil(hd / 4)
  int rs;       // floats from one K row to the next in shared memory
  bool vec;     // 16-byte copies: hd % 4 == 0 and k, v 16-byte aligned
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

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// (M, L, A) of n partial records rec, rec + stride, ... (m, l, acc[hd]),
// folded in record order: M the largest m, then L and A summed in order,
// each term scaled by e^(m - M); an empty record (m = -inf, l = acc = 0)
// adds zeros
__device__ __forceinline__ void fold(const float* rec, int n, int stride,
                                     int d, float& M, float& L, float& A) {
  M = -INFINITY;
  for (int r = 0; r < n; ++r) M = fmaxf(M, rec[r * stride]);
  L = 0.f;
  A = 0.f;
  if (M == -INFINITY) return;
  for (int r = 0; r < n; ++r) {
    const float* x = rec + r * stride;
    const float sc = expf(x[0] - M);
    L = fmaf(x[1], sc, L);
    A = fmaf(x[2 + d], sc, A);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}

// one stage of a warp: kChunk K rows of rs floats, then kChunk V rows of qw
__host__ __device__ constexpr size_t stage_floats(int qw, int rs) {
  return (size_t)kChunk * (rs + qw);
}

// shared memory, in floats: q (G x qw), each warp's two stages, the warps'
// partials (kWarps x G records of hd + 2: m, l, acc) and, in a cluster,
// CTA 0's receive buffer (NC x G records)
constexpr size_t smem_floats(int G, int hd, int qw, int rs, int nc) {
  return (size_t)G * qw + (size_t)kWarps * 2 * stage_floats(qw, rs)
         + (size_t)(kWarps + (nc > 1 ? nc : 0)) * G * (hd + 2);
}
static_assert(4 * smem_floats(kMaxG, kMaxHd, kMaxHd, kMaxHd + 4, kMaxCluster)
                  <= kSmemMax,
              "the largest shape exceeds shared memory");

template <int G>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int nc = gridDim.y, c = blockIdx.y;
  const int b = blockIdx.x / a.Hkv, h = blockIdx.x - b * a.Hkv;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int hd = a.hd, hd4 = a.hd4, qw = 4 * hd4, rs = a.rs, R = hd + 2;
  const size_t qo = ((size_t)b * a.H + (size_t)h * G) * hd;
  const size_t sf = stage_floats(qw, rs);
  float* qs = smem;
  float* ring = qs + G * qw;
  float* wp = ring + (size_t)kWarps * 2 * sf;
  float* recv = wp + kWarps * G * R;
  float* mine = ring + (size_t)w * 2 * sf;   // stage s at mine + s sf

  // q's copies go out before pos is read (they need no position), and land
  // with the first chunk's
#pragma unroll
  for (int g = 0; g < G; ++g)
    for (int d = tid; d < qw; d += kThreads) {
      if (d < hd)
        cp_async4(qs + g * qw + d, a.q + qo + (size_t)g * hd + d, true);
      else
        qs[g * qw + d] = 0.f;
    }

  const int p = a.pos[b];
  const int hi = min(p, a.S - 1);
  const int lo = a.window > 0 ? max(0, p - a.window + 1) : 0;
  // the condition is the same for every CTA of the cluster, so the whole
  // cluster returns and no barrier is left pending
  if ((a.head_mask != nullptr && !(a.head_mask[h] > 0.f)) || lo > hi) {
    cp_async_wait<0>();
    if (c == 0)
      for (int e = tid; e < G * hd; e += kThreads) a.out[qo + e] = 0.f;
    return;
  }
  if (nc > 1) cluster_arrive_relaxed();   // this CTA runs

  // K columns [hd, qw) meet q's zero padding; copies never write them
  if (lane < kChunk)
    for (int s = 0; s < 2; ++s)
      for (int d = hd; d < qw; ++d) mine[s * sf + lane * rs + d] = 0.f;

  // copies and P.V: lane dl of group grp (rp groups of hd4 lanes) takes
  // rows grp, grp + rp, ... of a chunk and dims [4 dl, 4 dl + 4)
  const int rp = 32 / hd4, grp = lane / hd4, dl = lane - grp * hd4;
  const size_t kst = (size_t)a.Hkv * hd;   // floats from key to key
  const size_t ro = ((size_t)b * a.S * a.Hkv + h) * hd;
  const float* kb = a.k + ro;
  const float* vb = a.v + ro;

  auto issue = [&](int j, int s) {
    float* kd = mine + s * sf;
    float* vd = kd + kChunk * rs;
    const int base = j * kChunk;
    if (a.vec) {
      if (grp < rp)
        for (int r = grp; r < kChunk; r += rp) {
          const int kp = base + r;
          const bool ok = kp >= lo && kp <= hi;
          const size_t off = (ok ? (size_t)kp * kst : 0) + 4 * dl;
          cp_async16(kd + r * rs + 4 * dl, kb + off, ok);
          cp_async16(vd + r * qw + 4 * dl, vb + off, ok);
        }
    } else {
      for (int r = 0; r < kChunk; ++r) {
        const int kp = base + r;
        const bool ok = kp >= lo && kp <= hi;
        const size_t off = ok ? (size_t)kp * kst : 0;
        for (int d = lane; d < hd; d += 32) {
          cp_async4(kd + r * rs + d, kb + off + d, ok);
          cp_async4(vd + r * qw + d, vb + off + d, ok);
        }
      }
    }
  };

  float m[G], l[G], acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  }

  const int U = nc * kWarps, u = c * kWarps + w;
  const int jlo = lo / kChunk, jhi = hi / kChunk;
  const int j0 = jlo + (u - jlo % U + U) % U;   // first j >= jlo, j = u mod U
  if (j0 <= jhi) issue(j0, 0);
  cp_async_commit();   // q and the first chunk
  if (j0 + U <= jhi) issue(j0 + U, 1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();   // q from every thread: the one CTA barrier before the
                     // fold
  // scores: lanes key and key + 16 take key 16 j + key, the even and the
  // odd 16-byte items of its K row
  const int key = lane & (kChunk - 1), half = lane / kChunk;
  int s = 0;
  for (int j = j0; j <= jhi; j += U) {
    if (j != j0) {
      cp_async_wait<1>();   // all but the next chunk's copies
      __syncwarp();
    }
    const float* kd = mine + s * sf;
    const float* vd = kd + kChunk * rs;

    float cc[4][G];
#pragma unroll
    for (int g = 0; g < G; ++g) cc[0][g] = cc[1][g] = cc[2][g] = cc[3][g] = 0.f;
    const float* kr = kd + key * rs;
    int i = half;
    for (; i + 6 < hd4; i += 8) {
      const float4 k0 = ld4(kr + 4 * i), k1 = ld4(kr + 4 * i + 8);
      const float4 k2 = ld4(kr + 4 * i + 16), k3 = ld4(kr + 4 * i + 24);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* qg = qs + g * qw + 4 * i;
        cc[0][g] = dot4(ld4(qg), k0, cc[0][g]);
        cc[1][g] = dot4(ld4(qg + 8), k1, cc[1][g]);
        cc[2][g] = dot4(ld4(qg + 16), k2, cc[2][g]);
        cc[3][g] = dot4(ld4(qg + 24), k3, cc[3][g]);
      }
    }
    for (; i < hd4; i += 2) {
      const float4 k0 = ld4(kr + 4 * i);
#pragma unroll
      for (int g = 0; g < G; ++g)
        cc[0][g] = dot4(ld4(qs + g * qw + 4 * i), k0, cc[0][g]);
    }

    // online softmax, warp-local; the chunk holds a valid key, so the new
    // max is finite (on the worker's first chunk alpha = e^-inf = 0)
    const int kp = j * kChunk + key;
    const bool ok = kp >= lo && kp <= hi;
    float sg[G], mx[G], pr[G], alpha[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float t = (cc[0][g] + cc[1][g]) + (cc[2][g] + cc[3][g]);
      t += __shfl_xor_sync(0xffffffffu, t, kChunk);   // the other half
      sg[g] = ok ? t * a.scale : -INFINITY;
      mx[g] = sg[g];
    }
#pragma unroll
    for (int o = kChunk / 2; o > 0; o >>= 1)
#pragma unroll
      for (int g = 0; g < G; ++g)
        mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mn = fmaxf(m[g], mx[g]);
      pr[g] = ok ? expf(sg[g] - mn) : 0.f;
      alpha[g] = expf(m[g] - mn);
      m[g] = mn;
      mx[g] = pr[g];   // now the sum
    }
#pragma unroll
    for (int o = kChunk / 2; o > 0; o >>= 1)
#pragma unroll
      for (int g = 0; g < G; ++g)
        mx[g] += __shfl_xor_sync(0xffffffffu, mx[g], o);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      l[g] = l[g] * alpha[g] + mx[g];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= alpha[g];
    }

    // P.V: group grp takes keys grp, grp + rp, ..., two a step; each key's
    // probability comes from its lane by shuffle (0 past the chunk)
    for (int t = grp; t < kChunk + grp; t += 2 * rp) {
      const int k0 = t, k1 = t + rp;
      const float4 v0 = ld4(vd + min(k0, kChunk - 1) * qw + 4 * dl);
      const float4 v1 = ld4(vd + min(k1, kChunk - 1) * qw + 4 * dl);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float p0 = __shfl_sync(0xffffffffu, pr[g], k0 & (kChunk - 1));
        float p1 = __shfl_sync(0xffffffffu, pr[g], k1 & (kChunk - 1));
        if (k0 >= kChunk) p0 = 0.f;
        if (k1 >= kChunk) p1 = 0.f;
        acc[g][0] = fmaf(p1, v1.x, fmaf(p0, v0.x, acc[g][0]));
        acc[g][1] = fmaf(p1, v1.y, fmaf(p0, v0.y, acc[g][1]));
        acc[g][2] = fmaf(p1, v1.z, fmaf(p0, v0.z, acc[g][2]));
        acc[g][3] = fmaf(p1, v1.w, fmaf(p0, v0.w, acc[g][3]));
      }
    }
    __syncwarp();   // the stage is read before the next copy into it
    if (j + 2 * U <= jhi) issue(j + 2 * U, s);
    cp_async_commit();
    s ^= 1;
  }
  cp_async_wait<0>();

  // the worker's partial: the P.V groups summed in order into group 0
  float tot[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tot[g][e] = __shfl_sync(0xffffffffu, acc[g][e], dl);
  for (int r = 1; r < rp; ++r)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tot[g][e] += __shfl_sync(0xffffffffu, acc[g][e], r * hd4 + dl);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* rec = wp + (w * G + g) * R;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (lane < hd4 && 4 * dl + e < hd) rec[2 + 4 * dl + e] = tot[g][e];
    if (lane == 0) {
      rec[0] = m[g];
      rec[1] = l[g];
    }
  }
  __syncthreads();

  // the CTA's partial: its workers folded in order; without a cluster it is
  // the answer
  float* dst = recv;
  if (nc > 1) {
    cluster_wait();   // every CTA of the cluster runs
    dst = cg::this_cluster().map_shared_rank(recv, 0);
  }
  for (int e = tid; e < G * hd; e += kThreads) {
    const int g = e / hd, d = e - g * hd;
    float M, L, A;
    fold(wp + g * R, kWarps, G * R, d, M, L, A);
    if (nc == 1) {
      a.out[qo + e] = A / fmaxf(L, 1e-30f);
    } else {
      float* rec = dst + (c * G + g) * R;
      rec[2 + d] = A;
      if (d == 0) {
        rec[0] = M;
        rec[1] = L;
      }
    }
  }
  if (nc == 1) return;
  cg::this_cluster().sync();
  if (c != 0) return;
  for (int e = tid; e < G * hd; e += kThreads) {
    const int g = e / hd, d = e - g * hd;
    float M, L, A;
    fold(recv + g * R, nc, G * R, d, M, L, A);
    a.out[qo + e] = A / fmaxf(L, 1e-30f);
  }
}

// CTAs a (row, KV head) for a cache of S positions: the cluster size
int cluster_size(int S) {
  return min(kMaxCluster, (S + kSpan - 1) / kSpan);
}

template <int G>
int launch(const Args& a, int B, int nc, size_t bytes, cudaStream_t st) {
  auto* kernel = decode_kernel<G>;
  static bool attr_set = false;   // once per kernel: the most any call uses
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemMax));
    if (err == cudaSuccess)   // no use for L1: the copies bypass it
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  if (nc == 1) {
    kernel<<<B * a.Hkv, kThreads, bytes, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.Hkv, nc);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = nc;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// window <= 0: no window.  head_mask: (Hkv,) float32, <= 0 a dead head;
// nullptr: every head live.
int decode_attention(const float* q, const float* k, const float* v,
                     const int32_t* pos, const float* head_mask, float* out,
                     int B, int S, int H, int Hkv, int hd, int window,
                     float scale, void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  if (H % Hkv != 0 || hd <= 0 || hd > kMaxHd || H / Hkv > kMaxG || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Hkv, nc = cluster_size(S);
  Args a;
  a.q = q; a.k = k; a.v = v; a.pos = pos; a.head_mask = head_mask;
  a.out = out;
  a.S = S; a.H = H; a.Hkv = Hkv; a.hd = hd; a.window = window;
  a.scale = scale;
  a.hd4 = (hd + 3) / 4;
  a.rs = 4 * ((a.hd4 + 1) | 1);   // an odd number of 16-byte units
  a.vec = hd % 4 == 0 && (reinterpret_cast<uintptr_t>(k) & 15) == 0
          && (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  const size_t bytes = 4 * smem_floats(G, hd, 4 * a.hd4, a.rs, nc);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1: return launch<1>(a, B, nc, bytes, st);
    case 2: return launch<2>(a, B, nc, bytes, st);
    case 3: return launch<3>(a, B, nc, bytes, st);
    case 4: return launch<4>(a, B, nc, bytes, st);
    case 5: return launch<5>(a, B, nc, bytes, st);
    case 6: return launch<6>(a, B, nc, bytes, st);
    case 7: return launch<7>(a, B, nc, bytes, st);
    default: return launch<8>(a, B, nc, bytes, st);
  }
}

}  // extern "C"
