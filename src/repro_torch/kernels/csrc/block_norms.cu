// Per-tile squared L2 norms of every prunable leaf of one ranking, in one
// launch: the block-pruning ranking statistic.  Replaces the Pallas kernel
// src/repro/kernels/block_norms.py:24 (block_norms: one grid step a tile,
// the tile cast to float32 and its squares summed out of VMEM).
//
// What bounds it on an H100, and what the design does about each:
//  * The fleet's ranking (784 x 60, 60 x 20 and 20 x 10 at block 8: 814
//    tiles of at most 64 floats, 194 KB) is bound by launching: its bytes
//    take 0.06 us at 3.35 TB/s, a launch microseconds.  So every leaf of a
//    ranking goes into one launch (a table of leaf descriptors passed by
//    value in the kernel's parameters, up to kMaxLeaves a launch), and a
//    tile is one warp's work, 8 warps a CTA and no barrier: the ranking is
//    one wave of ~100 CTAs in which each warp makes one trip to memory.
//  * A transformer's ranking (smollm-135m: 134.5 M bfloat16 weights in
//    ~13,600 tiles of up to 6144 x 72) is bound by bytes.  The kernel reads
//    the leaves in their own type (float32 or bfloat16, widened in
//    registers: no float32 copy), 16 bytes a load where the row stride and
//    the tile's first column allow it, kUnroll loads in flight a lane, and
//    cuts each tile into row segments of at most 16,384 elements (their
//    count fixed by the tile's shape alone, block_norms.segments), a warp a
//    segment, so ~15,300 warps of at most 32 KB each stream the leaves over
//    all 132 SMs whatever the tiles' sizes.
//
// Bits.  A slot is the 16 / sizeof(element) columns of a tile row that one
// 16-byte load brings.  Lane l sums the slots l, l + 32, ... of its segment
// into four fmaf chains; the chains, then the warp's lanes (shuffle down),
// are added in a fixed order.  The scalar path (rows that are not 16-byte
// aligned) loads the same slots element by element and reads columns past
// the tile's edge as +0, so it gives the vector path's bits.  A tile of
// several segments: each warp writes its segment's sum to a workspace and
// takes an integer ticket; the warp that takes the tile's last ticket folds
// the segment sums in ascending order and resets the ticket for the next
// launch on the stream.  No float atomics.  A leaf's norms depend on its
// own shape, type, values and blocks only: not on the other leaves of the
// launch, on where in memory the leaf lies, or on the run.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;                  // warps a CTA, a work item each
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;                 // 16-byte slots a lane has in flight
constexpr int kMaxLeaves = 48;             // leaves a launch
constexpr int kDescFields = 15;            // int64 fields of a host descriptor
constexpr unsigned kFull = 0xffffffffu;

struct Leaf {
  const void* ptr;        // slice 0's first element
  long long lead_stride;  // elements from one slice to the next
  float* out;             // the leaf's norms, lead x tk x tn
  long long tile0;        // the leaf's first tile in the group (tickets)
  int first_item;         // the leaf's first work item in the launch
  int K, N, lead, bk, bn, tk, tn;
  int nseg, seg_rows;     // row segments a tile, rows a segment
  int bf16;               // element type: 0 float32, 1 bfloat16
  int vec;                // every slot may be one 16-byte load
};

struct Table {
  int count;              // leaves
  int items;              // work items, one warp each
  Leaf leaf[kMaxLeaves];
};

static_assert(sizeof(Table) + 2 * sizeof(void*) <= 4096,
              "the leaf table must fit the portable 4 KB of parameters");

// One slot as raw bits (float32s or bfloat16 pairs, little-endian);
// columns at or past `left` read as +0.
template <bool kBf16>
__device__ __forceinline__ uint4 load_slot(const char* p, int left,
                                           bool vec) {
  if (vec) return __ldcs(reinterpret_cast<const uint4*>(p));
  unsigned w[4] = {0u, 0u, 0u, 0u};
  if (kBf16) {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < left)
        w[k >> 1] |= static_cast<unsigned>(__ldcs(q + k)) << (16 * (k & 1));
  } else {
    const unsigned* q = reinterpret_cast<const unsigned*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < left) w[k] = __ldcs(q + k);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// acc[j] += the squares of the slot's 32-bit word j (one float32, or two
// bfloat16s low half first), widened to float32 exactly.
template <bool kBf16>
__device__ __forceinline__ void add_squares(uint4 s, float (&acc)[4]) {
  const unsigned w[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (kBf16) {
      const float lo = __uint_as_float(w[j] << 16);
      const float hi = __uint_as_float(w[j] & 0xffff0000u);
      acc[j] = fmaf(lo, lo, acc[j]);
      acc[j] = fmaf(hi, hi, acc[j]);
    } else {
      const float x = __uint_as_float(w[j]);
      acc[j] = fmaf(x, x, acc[j]);
    }
  }
}

// Sum of squares of `rows` x `cols` elements from `base` (rows
// `row_bytes` apart); the whole warp calls it, lane 0 holds the result.
template <bool kBf16>
__device__ float segment_sum(const char* base, long long row_bytes, int rows,
                             int cols, bool vec, int lane) {
  constexpr int kV = kBf16 ? 8 : 4;         // columns a slot
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int cv = (cols + kV - 1) / kV;      // slots a row
  const int total = rows * cv;
  // lane's slot (r, c), stepped by 32 slots without a division
  int r = lane / cv, c = lane - r * cv;
  const int dr = 32 / cv, dc = 32 - dr * cv;
  for (int i = lane; i < total; i += 32 * kUnroll) {
    uint4 s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] = i + 32 * u < total
          ? load_slot<kBf16>(base + r * row_bytes + c * 16, cols - c * kV,
                             vec)
          : make_uint4(0u, 0u, 0u, 0u);
      c += dc;
      r += dr;
      if (c >= cv) {
        c -= cv;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add_squares<kBf16>(s[u], acc);
  }
  float v = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// Work item = (leaf, slice, tile, row segment), in that order, tiles
// row-major within a slice; one warp an item.
__global__ void __launch_bounds__(kThreads)
tile_norms_kernel(const __grid_constant__ Table t,
                  float* __restrict__ partial, int* __restrict__ tickets) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= t.items) return;
  int li = 0;  // first_item rises with the leaf: count the leaves passed
  for (int i = 1; i < t.count; ++i) li += item >= t.leaf[i].first_item;
  const Leaf& L = t.leaf[li];
  int local = item - L.first_item, slice = 0, seg = 0;
  if (L.lead > 1) {
    const int per_slice = L.tk * L.tn * L.nseg;
    slice = local / per_slice;
    local -= slice * per_slice;
  }
  if (L.nseg > 1) {
    seg = local % L.nseg;
    local /= L.nseg;
  }
  const int tile = local;
  const int ti = tile / L.tn, tj = tile - ti * L.tn;
  const int r0 = seg * L.seg_rows;          // first row within the tile
  const int k0 = ti * L.bk + r0;
  const int rows = max(0, min(min(L.seg_rows, L.bk - r0), L.K - k0));
  const int n0 = tj * L.bn;
  const int cols = min(L.bn, L.N - n0);
  const int elem = L.bf16 ? 2 : 4;
  const char* base = static_cast<const char*>(L.ptr)
      + (slice * L.lead_stride + static_cast<long long>(k0) * L.N + n0)
        * elem;
  const long long row_bytes = static_cast<long long>(L.N) * elem;
  const float v = L.bf16
      ? segment_sum<true>(base, row_bytes, rows, cols, L.vec, lane)
      : segment_sum<false>(base, row_bytes, rows, cols, L.vec, lane);
  const long long at = static_cast<long long>(slice) * L.tk * L.tn + tile;
  if (L.nseg == 1) {
    if (lane == 0) L.out[at] = v;
    return;
  }
  int* ticket = tickets + L.tile0 + at;
  int last = 0;
  if (lane == 0) {
    partial[item] = v;
    __threadfence();
    last = atomicAdd(ticket, 1) == L.nseg - 1;
  }
  if (!__shfl_sync(kFull, last, 0)) return;
  __threadfence();
  const int first = item - seg;
  float sum = 0.f;
  for (int q0 = 0; q0 < L.nseg; q0 += 32) {
    const float p = q0 + lane < L.nseg ? __ldcg(partial + first + q0 + lane)
                                       : 0.f;
    const int m = min(32, L.nseg - q0);
    for (int q = 0; q < m; ++q) sum += __shfl_sync(kFull, p, q);
  }
  if (lane == 0) {
    L.out[at] = sum;
    *ticket = 0;
  }
}

// The launch floor's yardstick: a launch that does nothing.
__global__ void empty_kernel() {}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int tile_norms_max_leaves() { return kMaxLeaves; }

// desc: `count` leaves of kDescFields int64 each: ptr, lead_stride, out
// (the leaf's float32 norms), tile0, K, N, lead, bk, bn, tk, tn, nseg,
// seg_rows, bf16, vec.  partial: a float a work item; tickets: an int a
// tile of the group, zero; both used only where some leaf has nseg > 1
// (else they may be null).
int tile_norms_launch(const long long* desc, int count, float* partial,
                      int* tickets, void* stream) {
  if (count <= 0 || count > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  Table t{};
  t.count = count;
  long long items = 0;
  for (int i = 0; i < count; ++i) {
    const long long* d = desc + static_cast<long long>(i) * kDescFields;
    Leaf& L = t.leaf[i];
    L.ptr = reinterpret_cast<const void*>(d[0]);
    L.lead_stride = d[1];
    L.out = reinterpret_cast<float*>(d[2]);
    L.tile0 = d[3];
    L.K = static_cast<int>(d[4]);
    L.N = static_cast<int>(d[5]);
    L.lead = static_cast<int>(d[6]);
    L.bk = static_cast<int>(d[7]);
    L.bn = static_cast<int>(d[8]);
    L.tk = static_cast<int>(d[9]);
    L.tn = static_cast<int>(d[10]);
    L.nseg = static_cast<int>(d[11]);
    L.seg_rows = static_cast<int>(d[12]);
    L.bf16 = static_cast<int>(d[13]);
    L.vec = static_cast<int>(d[14]);
    L.first_item = static_cast<int>(items);
    items += static_cast<long long>(L.lead) * L.tk * L.tn * L.nseg;
    if (items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  t.items = static_cast<int>(items);
  if (items == 0) return 0;
  const int grid = static_cast<int>((items + kWarps - 1) / kWarps);
  tile_norms_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, partial, tickets);
  return static_cast<int>(cudaGetLastError());
}

int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
