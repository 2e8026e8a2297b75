// Exact 3-nearest-neighbour search for Hopper (sm_90a): for every point,
// its three nearest other points, ordered by (squared distance, index), and
// the mean of their squared distances.
//
// It replaces `knn3` of sparse_view_3dgs_pack_tpu/ops/knn.py:106, which is
// XLA (a windowed Morton scan, approximate), not a Pallas kernel. The plain
// PyTorch version is `knn3_torch` in ops/knn.py; `morton_codes_torch` and
// `tree_boxes_torch` there are the plain versions of the codes and boxes.
//
// The search. The points are sorted along a 63-bit Morton curve (kernel
// `codes_kernel`, then torch.sort) and cut into leaves of kLeaf = 32
// consecutive sorted points and parents of kFan = 32 leaves, each with its
// bounding box and the least original index of its members (kernel
// `search_kernel`, phase 1). One warp takes one leaf as its 32 queries
// (phase 2):
//   - the first bound of each lane is its best three among the other 31
//     points of its own leaf, read once from shared memory;
//   - the warp tests 32 parent boxes at once, one per lane, against the box
//     of its active queries and the largest bound of its lanes; where more
//     than kSerial pass, each lane tests its box against every active
//     query's own distance and bound, so that a warp whose queries are
//     spread (a jump of the curve, a stray among them) does not walk the
//     boxes only its loose test lets through; it descends, nearest box
//     first, into the parents some lane needs, and tests their 32 leaves
//     the same way;
//   - a leaf that some lane needs is loaded once, coalesced, into the
//     warp's shared memory and scanned by the lanes that need it;
//   - a lane that has needed more than `budget` leaves (a stray point)
//     leaves the warp: it is appended to a list with its bound, the warp's
//     box shrinks to the lanes left, and phase 3 gives each listed query
//     one block, whose threads split the leaves, keep a best three each
//     and merge them.
// (d², index) is a total order, so a best three does not depend on how the
// points were split or in which order they were offered: the result is the
// brute force's, bit for bit.
//
// Exactness. A leaf or parent is skipped only when its box distance (to the
// query, or to the box of the warp's queries) is beyond the bound, or equal
// to it with a least index beyond the bound's index; the box distance is a
// lower bound of every member's squared distance as computed in float32:
// per axis, fl(lo - q) <= fl(p - q) for lo <= p, fl(lo - hi') <= fl(lo - q)
// for q <= hi' (rounding is monotone), and squares and sums keep the order
// (tests/test_torch_knn_boxes.py holds the boxes to it). This file is
// compiled with --fmad=false (ops/_build.py): dx*dx + dy*dy + dz*dz and
// the mean round step by step in the plain version's order, so the two
// agree bit for bit.
//
// Outliers. FSGS looks for Gaussians far from the rest (more than 5 scene
// extents), and they stretch the bounding box. The codes have 21 bits per
// axis (63 in all), so a dense cloud 10^4 times smaller than the box still
// spreads over ~200 cells per axis; a uniform grid over the box would
// collapse it into a few cells.
//
// What bounds it on an H100: the data it must move is 28 bytes a point
// (12 in, 16 out), ~8 MB at 300k points, 2.5 us at 3.35 TB/s; the work is
// the distance evaluations of the scanned leaves, which depend on the data
// (~30 leaves a warp on the clouds of PERF.md), and at 30k points and
// below the latency of each warp's chain of leaves: there are fewer warps
// than the card holds. A call is `codes_kernel`, torch.sort and
// `search_kernel`; the two kernels are cooperative launches whose phases
// meet at grid-wide barriers (the bounding box before the codes; the
// boxes, the search and the listed queries), so that no phase waits on
// the host and no scratch needs clearing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLeaf = 32;   // sorted points per leaf (LEAF in ops/knn.py)
constexpr int kFan = 32;    // leaves per parent (FAN in ops/knn.py)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGrid = 4096;   // blocks of codes_kernel (partial sums)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSerial = 4;   // candidate boxes the warp takes one by one
// work counts per query warp (box tests, boxes that passed its test,
// leaves scanned, distance evaluations, lanes listed, cycles / 1024) and
// per listed query (leaf tests, distance evaluations, cycles / 1024)
constexpr int kWarpCounts = 6, kListCounts = 3;
constexpr float kCells = 2097151.0f;  // 2^21 - 1

int launch_error() { return static_cast<int>(cudaGetLastError()); }

// a launch's own error, else the last one
int launched(cudaError_t err) {
  return err != cudaSuccess ? static_cast<int>(err) : launch_error();
}

// an error for a card query that failed without one of its own
int setup_error() {
  const int err = launch_error();
  return err != 0 ? err : static_cast<int>(cudaErrorInvalidConfiguration);
}

// scratch layout (bytes, each part 16-aligned): codes (n int64), sorted
// (n float4: x, y, z, original index as bits), leaves (2 float4 a leaf:
// lo with the least index as bits, hi with the count as bits), parents
// (likewise), counters (next leaf, listed queries, 2 spare), the list (n
// int4: sorted position, bound d² as bits, bound index), partial bounding
// boxes (kMaxGrid x 6 floats)
struct Layout {
  size_t codes, sorted, leaves, parents, counters, list, partial, total;
  int n_leaves, n_parents;
  explicit Layout(int n) {
    n_leaves = (n + kLeaf - 1) / kLeaf;
    n_parents = (n_leaves + kFan - 1) / kFan;
    size_t at = 0;
    auto take = [&](size_t bytes) {
      const size_t here = at;
      at += (bytes + 15) / 16 * 16;
      return here;
    };
    codes = take(sizeof(int64_t) * n);
    sorted = take(sizeof(float4) * n);
    leaves = take(2 * sizeof(float4) * n_leaves);
    parents = take(2 * sizeof(float4) * n_parents);
    counters = take(4 * sizeof(int));
    list = take(sizeof(int4) * n);
    partial = take(6 * sizeof(float) * kMaxGrid);
    total = at;
  }
};

__device__ __forceinline__ uint64_t spread21(uint32_t v) {
  uint64_t x = v & 0x1fffffu;
  x = (x | x << 32) & 0x1f00000000ffffULL;
  x = (x | x << 16) & 0x1f0000ff0000ffULL;
  x = (x | x << 8) & 0x100f00f00f00f00fULL;
  x = (x | x << 4) & 0x10c30c30c30c30c3ULL;
  x = (x | x << 2) & 0x1249249249249249ULL;
  return x;
}

__device__ __forceinline__ uint32_t cell(float v, float lo, float hi) {
  const float ext = hi - lo;
  const float q = ext > 0.0f ? (v - lo) / ext * kCells : 0.0f;
  return static_cast<uint32_t>(fminf(fmaxf(q, 0.0f), kCells));
}

// min and max over the block of (lo[3], hi[3]); the result in every thread
__device__ void block_minmax(float lo[3], float hi[3]) {
  __shared__ float red[kWarps][6];
  for (int off = 16; off > 0; off >>= 1)
    for (int d = 0; d < 3; ++d) {
      lo[d] = fminf(lo[d], __shfl_xor_sync(kFull, lo[d], off));
      hi[d] = fmaxf(hi[d], __shfl_xor_sync(kFull, hi[d], off));
    }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0)
    for (int d = 0; d < 3; ++d) {
      red[warp][d] = lo[d];
      red[warp][3 + d] = hi[d];
    }
  __syncthreads();
  for (int w = 0; w < kWarps; ++w)
    for (int d = 0; d < 3; ++d) {
      lo[d] = fminf(lo[d], red[w][d]);
      hi[d] = fmaxf(hi[d], red[w][3 + d]);
    }
  __syncthreads();
}

// Phase 1, each block's bounding box of its points; phase 2, every block
// folds all of them and writes the 63-bit Morton code of its points.
__global__ void __launch_bounds__(kThreads)
codes_kernel(const float* __restrict__ pts, float* partial, int64_t* codes,
             int n) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * kThreads;
  float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
    for (int d = 0; d < 3; ++d) {
      lo[d] = fminf(lo[d], pts[3 * i + d]);
      hi[d] = fmaxf(hi[d], pts[3 * i + d]);
    }
  block_minmax(lo, hi);
  if (threadIdx.x == 0)
    for (int d = 0; d < 3; ++d) {
      partial[6 * blockIdx.x + d] = lo[d];
      partial[6 * blockIdx.x + 3 + d] = hi[d];
    }
  grid.sync();
  for (int d = 0; d < 3; ++d) {
    lo[d] = FLT_MAX;
    hi[d] = -FLT_MAX;
  }
  for (int b = threadIdx.x; b < gridDim.x; b += kThreads)
    for (int d = 0; d < 3; ++d) {
      lo[d] = fminf(lo[d], partial[6 * b + d]);
      hi[d] = fmaxf(hi[d], partial[6 * b + 3 + d]);
    }
  block_minmax(lo, hi);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    uint64_t code = 0;
    for (int d = 0; d < 3; ++d)
      code |= spread21(cell(pts[3 * i + d], lo[d], hi[d])) << d;
    codes[i] = static_cast<int64_t>(code);
  }
}

// a point that no query takes: d² = inf, index INT_MAX
__device__ __forceinline__ float4 far_point() {
  return make_float4(INFINITY, INFINITY, INFINITY, __int_as_float(INT_MAX));
}

__device__ __forceinline__ float sqdist(float4 q, float4 p) {
  const float dx = q.x - p.x, dy = q.y - p.y, dz = q.z - p.z;
  return dx * dx + dy * dy + dz * dz;
}

// distance of the box [qlo, qhi] to the box [lo, hi] (a point: qlo = qhi),
// at most sqdist(q, p) for any q in the first and p in the second
__device__ __forceinline__ float gap2(float4 qlo, float4 qhi, float4 lo,
                                      float4 hi) {
  const float dx = fmaxf(fmaxf(lo.x - qhi.x, qlo.x - hi.x), 0.0f);
  const float dy = fmaxf(fmaxf(lo.y - qhi.y, qlo.y - hi.y), 0.0f);
  const float dz = fmaxf(fmaxf(lo.z - qhi.z, qlo.z - hi.z), 0.0f);
  return dx * dx + dy * dy + dz * dz;
}

struct Best {
  float d[3] = {INFINITY, INFINITY, INFINITY};
  int i[3] = {INT_MAX, INT_MAX, INT_MAX};
};

__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// keep the three smallest (d, i), ordered; a point is offered once
__device__ __forceinline__ void offer(Best& b, float d, int i) {
  if (!before(d, i, b.d[2], b.i[2])) return;
  if (!before(d, i, b.d[1], b.i[1])) {
    b.d[2] = d;
    b.i[2] = i;
    return;
  }
  b.d[2] = b.d[1];
  b.i[2] = b.i[1];
  if (before(d, i, b.d[0], b.i[0])) {
    b.d[1] = b.d[0];
    b.i[1] = b.i[0];
    b.d[0] = d;
    b.i[0] = i;
  } else {
    b.d[1] = d;
    b.i[1] = i;
  }
}

// the best three of the whole warp, in every lane (the lanes' points
// distinct: a butterfly merges disjoint sets)
__device__ __forceinline__ void warp_merge(Best& b) {
  for (int off = 16; off > 0; off >>= 1) {
    float d[3];
    int i[3];
    for (int j = 0; j < 3; ++j) {
      d[j] = __shfl_xor_sync(kFull, b.d[j], off);
      i[j] = __shfl_xor_sync(kFull, b.i[j], off);
    }
    for (int j = 0; j < 3; ++j) offer(b, d[j], i[j]);
  }
}

__device__ __forceinline__ void write_result(const Best& b, int self,
                                             float* mean_d2, int* idx) {
  mean_d2[self] = (b.d[0] + b.d[1] + b.d[2]) / 3.0f;
  for (int j = 0; j < 3; ++j) idx[3 * self + j] = b.i[j];
}

struct Args {
  const float* pts;
  const int64_t* order;   // the stable sort of the codes
  float4* sorted;
  float4* leaves;
  float4* parents;
  int* counters;
  int4* list;   // the listed queries
  float* mean_d2;
  int* idx;
  int* stats;   // null, or kWarpCounts per query warp, kListCounts per
                // listed query
  int n, n_leaves, n_parents, budget;
};

// Phase 1: one block per parent; its warps gather the parent's leaves in
// sorted order and write each leaf's box, the block the parent's.
__device__ __forceinline__ void build(const Args& a) {
  __shared__ float red[kWarps][6];
  __shared__ unsigned red_min[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = blockIdx.x; p < a.n_parents; p += gridDim.x) {
    float plo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float phi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    unsigned pmin = INT_MAX;
    for (int leaf = p * kFan + warp; leaf < min((p + 1) * kFan, a.n_leaves);
         leaf += kWarps) {
      const int s = leaf * kLeaf + lane;
      float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
      float hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      unsigned mi = INT_MAX;
      if (s < a.n) {
        const int o = static_cast<int>(a.order[s]);
        const float x = a.pts[3 * o], y = a.pts[3 * o + 1],
                    z = a.pts[3 * o + 2];
        a.sorted[s] = make_float4(x, y, z, __int_as_float(o));
        lo[0] = hi[0] = x;
        lo[1] = hi[1] = y;
        lo[2] = hi[2] = z;
        mi = static_cast<unsigned>(o);
      }
      for (int off = 16; off > 0; off >>= 1)
        for (int d = 0; d < 3; ++d) {
          lo[d] = fminf(lo[d], __shfl_xor_sync(kFull, lo[d], off));
          hi[d] = fmaxf(hi[d], __shfl_xor_sync(kFull, hi[d], off));
        }
      mi = __reduce_min_sync(kFull, mi);
      if (lane == 0) {
        const int count = min(kLeaf, a.n - leaf * kLeaf);
        a.leaves[2 * leaf] = make_float4(lo[0], lo[1], lo[2],
                                         __int_as_float(static_cast<int>(mi)));
        a.leaves[2 * leaf + 1] = make_float4(hi[0], hi[1], hi[2],
                                             __int_as_float(count));
      }
      for (int d = 0; d < 3; ++d) {
        plo[d] = fminf(plo[d], lo[d]);
        phi[d] = fmaxf(phi[d], hi[d]);
      }
      pmin = min(pmin, mi);
    }
    if (lane == 0) {
      for (int d = 0; d < 3; ++d) {
        red[warp][d] = plo[d];
        red[warp][3 + d] = phi[d];
      }
      red_min[warp] = pmin;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) {
        for (int d = 0; d < 3; ++d) {
          plo[d] = fminf(plo[d], red[w][d]);
          phi[d] = fmaxf(phi[d], red[w][3 + d]);
        }
        pmin = min(pmin, red_min[w]);
      }
      a.parents[2 * p] = make_float4(plo[0], plo[1], plo[2],
                                     __int_as_float(static_cast<int>(pmin)));
      a.parents[2 * p + 1] = make_float4(phi[0], phi[1], phi[2], 0.0f);
    }
    __syncthreads();
  }
}

// The warp's state while it searches for its leaf's 32 queries.
struct Warp {
  float4 q;             // the lane's query
  float4 blo, bhi;      // the box of the active lanes' queries
  int s;                // the lane's sorted position
  Best best;
  bool active;          // a live query still searched by the warp
  int scanned;          // leaves this lane needed
  float bmax;           // the largest bound d² of the active lanes
  unsigned imax;        // the largest bound index of the active lanes
  bool any;             // an active lane is left
  int epoch;            // listings so far (the box shrinks at each)
  int tests, cands, leaves, evals, listed;   // work counts of the warp

  __device__ __forceinline__ void bounds() {
    bmax = __uint_as_float(__reduce_max_sync(
        kFull, active ? __float_as_uint(best.d[2]) : 0u));
    imax = __reduce_max_sync(kFull,
                             active ? static_cast<unsigned>(best.i[2]) : 0u);
    any = __any_sync(kFull, active);
  }
  // may some active lane need a box at distance g from the lanes' box, with
  // least index mi
  __device__ __forceinline__ bool may_need(float g, unsigned mi) const {
    return g < bmax || (g == bmax && mi < imax);
  }
  // lanes with `me` set go to phase 3 with the bound found so far; the box
  // and the bounds shrink to the lanes left
  __device__ __forceinline__ void list(const Args& a, bool me) {
    if (!__any_sync(kFull, me)) return;
    if (me) {
      const int at = atomicAdd(&a.counters[1], 1);
      a.list[at] = make_int4(s, __float_as_int(best.d[2]), best.i[2], 0);
      active = false;
    }
    listed += __popc(__ballot_sync(kFull, me));
    float v[6] = {FLT_MAX, FLT_MAX, FLT_MAX, FLT_MAX, FLT_MAX, FLT_MAX};
    if (active) {
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = -q.x;
      v[4] = -q.y;
      v[5] = -q.z;
    }
    for (int off = 16; off > 0; off >>= 1)
      for (int d = 0; d < 6; ++d)
        v[d] = fminf(v[d], __shfl_xor_sync(kFull, v[d], off));
    blo = make_float4(v[0], v[1], v[2], 0.0f);
    bhi = make_float4(-v[3], -v[4], -v[5], 0.0f);
    bounds();
    ++epoch;
  }
};

__device__ __forceinline__ float4 shfl4(float4 v, int lane) {
  return make_float4(__shfl_sync(kFull, v.x, lane),
                     __shfl_sync(kFull, v.y, lane),
                     __shfl_sync(kFull, v.z, lane),
                     __shfl_sync(kFull, v.w, lane));
}

// Of the lanes' candidate boxes [lo, hi] (least index in lo.w), those that
// some active lane needs by its own distance and bound. The warp's test
// against the lanes' box is loose when its queries are spread (a jump of
// the curve, strays among them): past kSerial candidates, each lane tests
// its box against every active query at once, rather than the warp taking
// the candidates one by one.
__device__ __forceinline__ bool needed(const Warp& w, bool cand, float4 lo,
                                       float4 hi) {
  if (__popc(__ballot_sync(kFull, cand)) <= kSerial) return cand;
  unsigned act = __ballot_sync(kFull, w.active);
  bool hit = false;
  while (act != 0) {
    const int i = __ffs(act) - 1;
    act &= act - 1;
    const float4 qi = shfl4(w.q, i);
    const float bd = __shfl_sync(kFull, w.best.d[2], i);
    const int bi = __shfl_sync(kFull, w.best.i[2], i);
    hit |= before(gap2(qi, qi, lo, hi), __float_as_int(lo.w), bd, bi);
  }
  return cand && hit;
}

// the lane among the candidates whose box is nearest (lowest lane on ties)
__device__ __forceinline__ int nearest(bool cand, float g) {
  const unsigned key = cand ? __float_as_uint(g) : 0xffffffffu;
  const unsigned m = __reduce_min_sync(kFull, key);
  return __ffs(__ballot_sync(kFull, cand && key == m)) - 1;
}

// distance of box `b` of `boxes` to the warp's box
__device__ __forceinline__ float box_gap(const Warp& w, const float4* boxes,
                                         int b) {
  return gap2(w.blo, w.bhi, boxes[2 * b], boxes[2 * b + 1]);
}

// Scan the parent's leaves that some lane needs, nearest first.
__device__ __forceinline__ void descend(const Args& a, Warp& w, int parent,
                                        int own, float4* stage) {
  const int lane = threadIdx.x % 32;
  const int leaf = parent * kFan + lane;
  const bool valid = leaf < a.n_leaves && leaf != own;
  float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;
  if (valid) {
    lo = a.leaves[2 * leaf];
    hi = a.leaves[2 * leaf + 1];
  }
  float g = gap2(w.blo, w.bhi, lo, hi);
  const unsigned mi = static_cast<unsigned>(__float_as_int(lo.w));
  int epoch = w.epoch;
  w.tests += __popc(__ballot_sync(kFull, valid));
  bool done = !needed(w, valid && w.may_need(g, mi), lo, hi);
  for (;;) {
    if (epoch != w.epoch) {
      g = gap2(w.blo, w.bhi, lo, hi);
      epoch = w.epoch;
    }
    const bool cand = !done && w.may_need(g, mi);
    if (!__ballot_sync(kFull, cand)) return;
    const int k = nearest(cand, g);
    if (lane == k) done = true;
    ++w.cands;
    const float4 klo = shfl4(lo, k), khi = shfl4(hi, k);
    // the leaf's points are loaded before the lanes decide whether they
    // need it, so that the load overlaps the test; a leaf of fewer points
    // is padded with points at infinity, which no lane takes, so that the
    // scan has a fixed trip count
    const int count = __float_as_int(khi.w);
    const float4 pt = lane < count
                          ? a.sorted[(parent * kFan + k) * kLeaf + lane]
                          : far_point();
    const bool need = w.active && before(gap2(w.q, w.q, klo, khi),
                                         __float_as_int(klo.w), w.best.d[2],
                                         w.best.i[2]);
    if (!__any_sync(kFull, need)) continue;
    stage[lane] = pt;
    __syncwarp();
    if (need) {
#pragma unroll 8
      for (int j = 0; j < kLeaf; ++j) {
        const float4 p = stage[j];
        const float d = sqdist(w.q, p);
        // most points are beyond the third best: a branch, not a chain of
        // selects through `best`
        if (__builtin_expect(d <= w.best.d[2], 0))
          offer(w.best, d, __float_as_int(p.w));
      }
    }
    __syncwarp();
    w.leaves += 1;
    w.evals += count * __popc(__ballot_sync(kFull, need));
    w.scanned += need;
    // a lane that needs too many leaves goes to phase 3
    w.list(a, w.active && w.scanned > a.budget);
    w.bounds();
    if (!w.any) return;
  }
}

// Phase 2 for one leaf of queries: the own leaf, then every parent the warp
// may need, chunk by chunk of 32 from the own parent's chunk on.
__device__ __forceinline__ void search_leaf(const Args& a, int own,
                                            float4* stage, int* counts) {
  const long long t0 = clock64();
  const int lane = threadIdx.x % 32;
  Warp w;
  w.s = own * kLeaf + lane;
  const bool live = w.s < a.n;
  w.q = live ? a.sorted[w.s] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  stage[lane] = w.q;
  __syncwarp();
  const int count = min(kLeaf, a.n - own * kLeaf);
  if (live)
    for (int j = 0; j < count; ++j) {
      const float4 p = stage[j];
      const float d = sqdist(w.q, p);
      if (j != lane) offer(w.best, d, __float_as_int(p.w));
    }
  __syncwarp();
  w.blo = a.leaves[2 * own];
  w.bhi = a.leaves[2 * own + 1];
  w.active = live;
  w.scanned = 0;
  w.epoch = 0;
  w.tests = 0;
  w.cands = 0;
  w.leaves = 1;
  w.evals = count * (count - 1);
  w.listed = 0;
  w.bounds();
  const int n_chunks = (a.n_parents + 31) / 32;
  const int c0 = own / kFan / 32;
  for (int t = 0; t < n_chunks && w.any; ++t) {
    const int c = c0 + t < n_chunks ? c0 + t : c0 + t - n_chunks;
    const int p = c * 32 + lane;
    const bool valid = p < a.n_parents;
    float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;
    if (valid) {
      lo = a.parents[2 * p];
      hi = a.parents[2 * p + 1];
    }
    float g = gap2(w.blo, w.bhi, lo, hi);
    const unsigned mi = static_cast<unsigned>(__float_as_int(lo.w));
    int epoch = w.epoch;
    w.tests += __popc(__ballot_sync(kFull, valid));
    bool done = !needed(w, valid && w.may_need(g, mi), lo, hi);
    for (;;) {
      if (epoch != w.epoch) {
        if (valid && !done) g = box_gap(w, a.parents, p);
        epoch = w.epoch;
      }
      const bool cand = !done && w.may_need(g, mi);
      if (!__ballot_sync(kFull, cand)) break;
      const int k = nearest(cand, g);
      if (lane == k) done = true;
      ++w.cands;
      descend(a, w, c * 32 + k, own, stage);
      if (!w.any) break;
    }
  }
  if (w.active) write_result(w.best, __float_as_int(w.q.w), a.mean_d2, a.idx);
  if (counts != nullptr && lane == 0) {
    counts[0] = w.tests;
    counts[1] = w.cands;
    counts[2] = w.leaves;
    counts[3] = w.evals;
    counts[4] = w.listed;
    counts[5] = static_cast<int>((clock64() - t0) >> 10);
  }
}

// Phase 3 for one listed query: the block's threads take the leaves in
// turn, test each against their own bound (at most the listed one) and
// scan those they may need; the best threes merge across the block.
__device__ __forceinline__ void search_listed(const Args& a, int4 item,
                                              int* counts) {
  __shared__ float red_d[kWarps][3];
  __shared__ int red_i[kWarps][3];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float4 q = a.sorted[item.x];
  const int self = __float_as_int(q.w);
  const float bd = __int_as_float(item.y);
  const int bi = item.z;
  const long long t0 = clock64();
  Best best;
  int tests = 0, evals = 0;
  for (int leaf = threadIdx.x; leaf < a.n_leaves; leaf += kThreads) {
    const float4 lo = a.leaves[2 * leaf], hi = a.leaves[2 * leaf + 1];
    const float g = gap2(q, q, lo, hi);
    const int mi = __float_as_int(lo.w);
    ++tests;
    // skip only a leaf all of whose points come after the listed bound or
    // after the thread's own third best
    if (before(bd, bi, g, mi) || before(best.d[2], best.i[2], g, mi))
      continue;
    const int count = __float_as_int(hi.w);
    for (int j = 0; j < count; ++j) {
      const float4 p = a.sorted[leaf * kLeaf + j];
      const int pi = __float_as_int(p.w);
      if (pi != self) offer(best, sqdist(q, p), pi);
    }
    evals += count;
  }
  warp_merge(best);
  if (lane == 0)
    for (int j = 0; j < 3; ++j) {
      red_d[warp][j] = best.d[j];
      red_i[warp][j] = best.i[j];
    }
  __syncthreads();
  if (warp == 0) {
    Best all;
    if (lane < kWarps)
      for (int j = 0; j < 3; ++j) {
        all.d[j] = red_d[lane][j];
        all.i[j] = red_i[lane][j];
      }
    warp_merge(all);
    if (lane == 0) write_result(all, self, a.mean_d2, a.idx);
  }
  if (counts != nullptr) {
    atomicAdd(&counts[0], tests);
    atomicAdd(&counts[1], evals);
    if (threadIdx.x == 0)
      counts[2] = static_cast<int>((clock64() - t0) >> 10);
  }
  __syncthreads();
}

// Phase 1 builds the sorted points and the boxes; phase 2 hands out leaves
// of queries to warps; phase 3 gives each listed query a block.
__global__ void __launch_bounds__(kThreads)
search_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float4 stage[kWarps][kLeaf];
  build(a);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.counters[0] = 0;
    a.counters[1] = 0;
  }
  grid.sync();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (;;) {
    int own = 0;
    if (lane == 0) own = atomicAdd(&a.counters[0], 1);
    own = __shfl_sync(kFull, own, 0);
    if (own >= a.n_leaves) break;
    search_leaf(a, own, stage[warp],
                a.stats == nullptr ? nullptr : a.stats + kWarpCounts * own);
  }
  grid.sync();
  const int n_listed = *static_cast<volatile int*>(&a.counters[1]);
  for (int h = blockIdx.x; h < n_listed; h += gridDim.x)
    search_listed(a, a.list[h],
                  a.stats == nullptr
                      ? nullptr
                      : a.stats + kWarpCounts * a.n_leaves + kListCounts * h);
}

// blocks of `kernel` that fit on the card at once (a cooperative launch's
// most) and the card's SM count, per device; 0 if a query failed
struct Fit {
  int most, sms;
};
Fit fit(const void* kernel, int which) {
  static Fit cache[2][16] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16)
    return {0, 0};
  Fit& f = cache[which][dev];
  if (f.most == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return {0, 0};
    f = {per_sm * sms, sms};
  }
  return f;
}

}  // namespace

// The scratch of a call on n points: out[0..6] the byte offsets of the
// codes, sorted points, leaves, parents, counters, list and partial boxes,
// out[7] the bytes in all.
extern "C" void knn3_layout(int n, size_t* out) {
  const Layout lay(n);
  const size_t at[8] = {lay.codes,    lay.sorted, lay.leaves,  lay.parents,
                        lay.counters, lay.list,   lay.partial, lay.total};
  for (int j = 0; j < 8; ++j) out[j] = at[j];
}

// pts (n, 3) f32 -> the int64 Morton codes at the start of `scratch`.
extern "C" int knn3_codes(const void* pts, void* scratch, int n,
                          void* stream) {
  if (n <= 3) return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay(n);
  char* base = static_cast<char*>(scratch);
  const Fit f = fit(reinterpret_cast<const void*>(codes_kernel), 0);
  if (f.most <= 0) return setup_error();
  const int grid = max(1, min(min(f.most, kMaxGrid),
                              (n + kThreads - 1) / kThreads));
  const float* p = static_cast<const float*>(pts);
  float* partial = reinterpret_cast<float*>(base + lay.partial);
  int64_t* codes = reinterpret_cast<int64_t*>(base + lay.codes);
  void* args[] = {&p, &partial, &codes, &n};
  return launched(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(codes_kernel), grid, kThreads, args, 0,
      static_cast<cudaStream_t>(stream)));
}

// pts (n, 3) f32, order (n,) int64 (the stable sort of the codes), the
// scratch of knn3_codes; out mean_d2 (n,) f32, idx (n, 3) i32; a query
// whose search needs more than `budget` leaves is finished by a block of
// its own; stats: null, or (6 * ceil(n / 32) + 3 * n) zeroed i32 for the
// work counts. n must exceed 3.
extern "C" int knn3_search(const void* pts, const void* order, void* scratch,
                           void* mean_d2, void* idx, int n, int budget,
                           void* stats, void* stream) {
  if (n <= 3) return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay(n);
  char* base = static_cast<char*>(scratch);
  Args a;
  a.pts = static_cast<const float*>(pts);
  a.order = static_cast<const int64_t*>(order);
  a.sorted = reinterpret_cast<float4*>(base + lay.sorted);
  a.leaves = reinterpret_cast<float4*>(base + lay.leaves);
  a.parents = reinterpret_cast<float4*>(base + lay.parents);
  a.counters = reinterpret_cast<int*>(base + lay.counters);
  a.list = reinterpret_cast<int4*>(base + lay.list);
  a.mean_d2 = static_cast<float*>(mean_d2);
  a.idx = static_cast<int*>(idx);
  a.stats = static_cast<int*>(stats);
  a.n = n;
  a.n_leaves = lay.n_leaves;
  a.n_parents = lay.n_parents;
  a.budget = budget;
  const Fit f = fit(reinterpret_cast<const void*>(search_kernel), 1);
  if (f.most <= 0) return setup_error();
  // enough warps for every leaf, and at least a block per SM for phase 3
  const int grid = min(f.most,
                       max(f.sms, (lay.n_leaves + kWarps - 1) / kWarps));
  void* args[] = {&a};
  return launched(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(search_kernel), grid, kThreads, args, 0,
      static_cast<cudaStream_t>(stream)));
}
