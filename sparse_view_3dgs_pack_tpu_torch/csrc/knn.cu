// Exact 3-nearest-neighbour search for Hopper (sm_90a): for every point,
// its three nearest other points, ordered by (squared distance, index), and
// the mean of their squared distances.
//
// It replaces `knn3` of sparse_view_3dgs_pack_tpu/ops/knn.py:106, which is
// XLA (a windowed Morton scan, approximate), not a Pallas kernel; the
// algorithm is the reference's simple-knn (and the JAX package's native
// `knn3_exact`): sort the points along a Morton curve, cut the sorted order
// into boxes of kBox consecutive points with their bounding boxes, take a
// first bound from each point's neighbours in sorted order, then scan only
// the boxes whose distance to the point is within the current third-best.
// The plain PyTorch version is `knn3_torch` in ops/knn.py.
//
// Exactness. The result is the brute force's, whatever the Morton order
// looks like: the order only decides how many boxes are scanned. A box is
// skipped when its distance exceeds the bound, and the box distance is a
// lower bound of every member's squared distance as computed in float32:
// per axis, fl(q - hi) <= fl(q - p) for p <= hi (rounding is monotone),
// and squares and sums keep the order. A point at exactly the bound is
// scanned, so ties go to the lower index as in the plain version. This file
// is compiled with --fmad=false (ops/_build.py): dx*dx + dy*dy + dz*dz and
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
// the distance evaluations of the scanned boxes, which depend on the data.
// A warp's 32 consecutive sorted queries scan a box together when any of
// them needs it, so every lane reads the same point at the same time (one
// broadcast load) and the loop has no divergent trip count.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBox = 256;        // sorted points per box (BOX in ops/knn.py)
constexpr int kSeed = 3;         // sorted neighbours each side for the bound
constexpr int kSearchThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kCells = 2097151.0f;  // 2^21 - 1

int launch_error() { return static_cast<int>(cudaGetLastError()); }

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

// 63-bit Morton code of each point over the cloud's bounding box
// bbox = (lo x, y, z, hi x, y, z).
__global__ void morton_kernel(const float* __restrict__ pts,
                              const float* __restrict__ bbox,
                              int64_t* __restrict__ codes, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint64_t code = 0;
  for (int d = 0; d < 3; ++d)
    code |= spread21(cell(pts[3 * i + d], bbox[d], bbox[3 + d])) << d;
  codes[i] = static_cast<int64_t>(code);
}

// One block per box: gathers its points in sorted order into
// sorted[s] = (x, y, z, original index as bits) and writes the box's
// bounds boxes[2b] = lo, boxes[2b + 1] = hi.
__global__ void __launch_bounds__(kBox)
box_kernel(const float* __restrict__ pts, const int* __restrict__ order,
           float4* __restrict__ sorted, float4* __restrict__ boxes, int n) {
  const int s = blockIdx.x * kBox + threadIdx.x;
  float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  if (s < n) {
    const int o = order[s];
    const float p[3] = {pts[3 * o], pts[3 * o + 1], pts[3 * o + 2]};
    sorted[s] = make_float4(p[0], p[1], p[2], __int_as_float(o));
    for (int d = 0; d < 3; ++d) lo[d] = hi[d] = p[d];
  }
  for (int off = 16; off > 0; off >>= 1)
    for (int d = 0; d < 3; ++d) {
      lo[d] = fminf(lo[d], __shfl_xor_sync(kFull, lo[d], off));
      hi[d] = fmaxf(hi[d], __shfl_xor_sync(kFull, hi[d], off));
    }
  __shared__ float red[kBox / 32][6];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0)
    for (int d = 0; d < 3; ++d) {
      red[warp][d] = lo[d];
      red[warp][3 + d] = hi[d];
    }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kBox / 32; ++w)
      for (int d = 0; d < 3; ++d) {
        lo[d] = fminf(lo[d], red[w][d]);
        hi[d] = fmaxf(hi[d], red[w][3 + d]);
      }
    boxes[2 * blockIdx.x] = make_float4(lo[0], lo[1], lo[2], 0.0f);
    boxes[2 * blockIdx.x + 1] = make_float4(hi[0], hi[1], hi[2], 0.0f);
  }
}

__device__ __forceinline__ float sqdist(float4 q, float4 p) {
  const float dx = q.x - p.x, dy = q.y - p.y, dz = q.z - p.z;
  return dx * dx + dy * dy + dz * dz;
}

// distance of q to the box [lo, hi], at most sqdist(q, p) for p inside
__device__ __forceinline__ float box_dist(float4 q, float4 lo, float4 hi) {
  const float dx = fmaxf(fmaxf(lo.x - q.x, q.x - hi.x), 0.0f);
  const float dy = fmaxf(fmaxf(lo.y - q.y, q.y - hi.y), 0.0f);
  const float dz = fmaxf(fmaxf(lo.z - q.z, q.z - hi.z), 0.0f);
  return dx * dx + dy * dy + dz * dz;
}

struct Best {
  float d[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
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

// One thread per sorted position. Lanes past n take the last point and
// write nothing, so that every lane of a warp votes on every box.
__global__ void __launch_bounds__(kSearchThreads)
search_kernel(const float4* __restrict__ sorted,
              const float4* __restrict__ boxes, float* __restrict__ mean_d2,
              int* __restrict__ idx, int n, int n_boxes) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = s < n;
  const float4 q = sorted[live ? s : n - 1];
  const int self = __float_as_int(q.w);

  // the first bound: the third-nearest of the sorted neighbours
  Best seed;
  for (int o = -kSeed; o <= kSeed; ++o) {
    const int t = s + o;
    if (o == 0 || t < 0 || t >= n) continue;
    const float4 p = sorted[t];
    offer(seed, sqdist(q, p), __float_as_int(p.w));
  }
  const float bound = seed.d[2];

  // every box within the bound, the warp's own first; a box of kBox
  // points holds whole warps, so a warp's lanes share b0
  Best best;
  const int b0 = s / kBox;
  for (int t = 0; t < n_boxes; ++t) {
    int b = b0 + t;
    if (b >= n_boxes) b -= n_boxes;
    const bool need =
        live && box_dist(q, boxes[2 * b], boxes[2 * b + 1]) <=
                    fminf(bound, best.d[2]);
    if (!__any_sync(kFull, need)) continue;
    const int end = min(b * kBox + kBox, n);
    for (int j = b * kBox; j < end; ++j) {
      const float4 p = sorted[j];
      const int pi = __float_as_int(p.w);
      if (pi != self) offer(best, sqdist(q, p), pi);
    }
  }
  if (!live) return;
  mean_d2[self] = (best.d[0] + best.d[1] + best.d[2]) / 3.0f;
  for (int j = 0; j < 3; ++j) idx[3 * self + j] = best.i[j];
}

}  // namespace

extern "C" int knn_morton(const void* pts, const void* bbox, void* codes,
                          int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  morton_kernel<<<(n + 255) / 256, 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(bbox),
      static_cast<int64_t*>(codes), n);
  return launch_error();
}

// pts (n, 3) f32, order (n,) i32 (the stable sort of the Morton codes);
// scratch sorted (n, 4) f32 and boxes (ceil(n / kBox), 2, 4) f32; out
// mean_d2 (n,) f32, idx (n, 3) i32. n must exceed 3.
extern "C" int knn3_search(const void* pts, const void* order, void* sorted,
                           void* boxes, void* mean_d2, void* idx, int n,
                           void* stream) {
  if (n <= 3) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_boxes = (n + kBox - 1) / kBox;
  box_kernel<<<n_boxes, kBox, 0, st>>>(
      static_cast<const float*>(pts), static_cast<const int*>(order),
      static_cast<float4*>(sorted), static_cast<float4*>(boxes), n);
  const int err = launch_error();
  if (err != 0) return err;
  search_kernel<<<(n + kSearchThreads - 1) / kSearchThreads, kSearchThreads,
                  0, st>>>(static_cast<const float4*>(sorted),
                           static_cast<const float4*>(boxes),
                           static_cast<float*>(mean_d2),
                           static_cast<int*>(idx), n, n_boxes);
  return launch_error();
}
