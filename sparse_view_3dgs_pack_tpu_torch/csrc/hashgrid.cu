// The multiresolution hash-grid encode for Hopper (sm_90a), forward and
// backward: N points → the trilinear interpolation of the 8 cell corners'
// features at each of L levels, (N, L·F) level by level; and from the
// gradient of those features back to the table and to the points.
//
// Replaces no TPU kernel: the JAX package computes the encode in XLA
// (sparse_view_3dgs_pack_tpu/ops/hashgrid.py), and the port copied that as
// plain PyTorch, `hashgrid_encode_torch` in ops/hashgrid.py: some 22
// launches a corner, and autograd's sort-based `index_put_(accumulate)` a
// corner for the table's gradient. The design is the reference's
// (DNGaussian/gridencoder/src/gridencoder.cu): one kernel each way, the
// table's gradient summed by atomicAdd.
//
// What bounds it on an H100: the corner reads, then the table gradient's
// atomics. Per point and level the forward reads 8 corners of F floats
// (8·F·4 B, random rows of a 2^19-row slice) and writes F floats: at the
// published 16 × 2, 300k points read 307 MB of corners against ~0.3 G f32
// operations, 0.1 ms at 3.35 TB/s if every corner came from device memory.
// The table is 67 MB, so the least device-memory traffic reads it once:
// with the points in and the features out 109 MB, 0.033 ms.
// The backward adds one F-float atomic per corner (38.4M at 300k) into the
// (L, T, F) gradient, and, where the points' gradient is asked for, the
// corners' features again.
//
// What the design does about it:
//  * One thread per (point, level), the level in blockIdx.y. Blocks are
//    issued level by level, so the blocks in flight read one or two levels'
//    4 MB slices of the 64 MB table: the dense coarse levels stay in L1/L2,
//    the hashed ones mostly in the 50 MB L2.
//  * A corner is one vector load (float2 at F = 2, float4s from F = 4) and,
//    in the backward, one native vector atomic (sm_90's float2 / float4
//    atomicAdd, issued as a reduction with no return value).
//  * The per-level constants (resolution, dense stride, dense flag, row
//    offset) go by value in the kernel's arguments: nothing is copied to
//    the card and nothing waits.
//  * Nothing is saved between the two kernels but the inputs: the backward
//    recomputes each (point, level)'s corners and weights.
//  * The points' gradient (N, 3) is summed over levels by float atomics, 3
//    a (point, level), into a zeroed tensor: one launch, 1/8 of the table's
//    atomics, and no (L, N, 3) scratch (58 MB at 300k) or second pass to
//    sum it in order. The 16 terms then add in an order that changes from
//    run to run, as the table's do.
//  * Rounding: compiled with --fmad=false (ops/_build.py), each expression
//    in the plain version's order, the scalars the plain version's on the
//    card: (x + bound) times the float32 reciprocal of 2·bound (PyTorch's
//    CUDA division by a Python number), the weight (wx·wy)·wz, the corners
//    summed in the order (cx, cy, cz) = 000, 001, …, 111. So the forward
//    is the plain version's bit for bit. The hash is taken in uint32: the
//    plain version's int64 products have the same low bits.
//  * One instantiation per level_dim (1, 2, 4, 8), and for the backward
//    with and without the points' gradient.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;
constexpr unsigned kPrime1 = 2654435761u, kPrime2 = 805459861u;

struct Level {
  float res_f;        // the resolution as the plain version's float32
  int res;
  unsigned stride;    // res + 1: the dense grid's row length
  int dense;          // (res + 1)^3 fits the table: indexed densely
  long long offset;   // the level's first row in the flattened table
};

struct Grid {
  Level level[kMaxLevels];
  int num_levels;
  unsigned mask;      // table rows a level - 1
  float bound;
  float inv_2bound;   // float32(1 / float32(2·bound))
};

// The cell of one point at one level: its lower corner, the fractions,
// and where the clamp to [0, 1] passes a gradient (0 ≤ u ≤ 1, inclusive).
struct Cell {
  unsigned p0[3];
  float frac[3];
  bool pass[3];
};

__device__ __forceinline__ Cell locate(const float* __restrict__ x,
                                       const Level& lv, const Grid& g) {
  Cell c;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float v = (__ldg(x + d) + g.bound) * g.inv_2bound;
    const float u = isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
    const float pos = u * lv.res_f;
    int p = static_cast<int>(floorf(pos));
    p = min(max(p, 0), lv.res - 1);
    c.p0[d] = static_cast<unsigned>(p);
    c.frac[d] = pos - static_cast<float>(p);   // reaches 1 on the upper face
    c.pass[d] = v >= 0.0f && v <= 1.0f;
  }
  return c;
}

__device__ __forceinline__ unsigned corner_row(const Cell& c, int cx, int cy,
                                               int cz, const Level& lv,
                                               unsigned mask) {
  const unsigned ix = c.p0[0] + cx, iy = c.p0[1] + cy, iz = c.p0[2] + cz;
  if (lv.dense) return (ix * lv.stride + iy) * lv.stride + iz;
  return (ix ^ (iy * kPrime1) ^ (iz * kPrime2)) & mask;
}

// the corner's weight factor along one axis: 1 - frac below, frac above
__device__ __forceinline__ float side(float frac, int upper) {
  return upper ? frac : 1.0f - frac;
}

template <int F>
__device__ __forceinline__ void load_row(const float* p, float (&v)[F]) {
  if constexpr (F == 1) {
    v[0] = __ldg(p);
  } else if constexpr (F == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x;
    v[1] = a.y;
  } else {
#pragma unroll
    for (int k = 0; k < F; k += 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p + k));
      v[k] = a.x;
      v[k + 1] = a.y;
      v[k + 2] = a.z;
      v[k + 3] = a.w;
    }
  }
}

template <int F>
__device__ __forceinline__ void store_row(float* p, const float (&v)[F]) {
  if constexpr (F == 1) {
    *p = v[0];
  } else if constexpr (F == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < F; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  }
}

template <int F>
__device__ __forceinline__ void atomic_add_row(float* p, const float (&v)[F]) {
  if constexpr (F == 1) {
    atomicAdd(p, v[0]);
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int k = 0; k < F; k += 4)
      atomicAdd(reinterpret_cast<float4*>(p + k),
                make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]));
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads)
    hashgrid_fwd_kernel(const float* __restrict__ table,
                        const float* __restrict__ x, float* __restrict__ out,
                        int n, const Grid g) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int l = blockIdx.y;
  const Level& lv = g.level[l];
  const Cell c = locate(x + 3 * static_cast<size_t>(i), lv, g);
  const float* rows = table + lv.offset * F;
  float acc[F];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int cx = k >> 2, cy = (k >> 1) & 1, cz = k & 1;
    const float w = (side(c.frac[0], cx) * side(c.frac[1], cy))
                    * side(c.frac[2], cz);
    float t[F];
    load_row<F>(rows + static_cast<size_t>(corner_row(c, cx, cy, cz, lv,
                                                      g.mask)) * F, t);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = k == 0 ? w * t[f] : acc[f] + w * t[f];
  }
  store_row<F>(out + static_cast<size_t>(i) * g.num_levels * F + l * F, acc);
}

template <int F, bool kGradX>
__global__ void __launch_bounds__(kThreads)
    hashgrid_bwd_kernel(const float* __restrict__ table,
                        const float* __restrict__ x,
                        const float* __restrict__ grad_out,
                        float* __restrict__ grad_table,
                        float* __restrict__ grad_x, int n, const Grid g) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int l = blockIdx.y;
  const Level& lv = g.level[l];
  const Cell c = locate(x + 3 * static_cast<size_t>(i), lv, g);
  float go[F];
  load_row<F>(grad_out + static_cast<size_t>(i) * g.num_levels * F + l * F,
              go);
  const size_t first = static_cast<size_t>(lv.offset) * F;
  float dfrac[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int cx = k >> 2, cy = (k >> 1) & 1, cz = k & 1;
    const float wx = side(c.frac[0], cx), wy = side(c.frac[1], cy),
                wz = side(c.frac[2], cz);
    const float w = (wx * wy) * wz;
    const size_t row =
        first + static_cast<size_t>(corner_row(c, cx, cy, cz, lv, g.mask)) * F;
    float gt[F];
#pragma unroll
    for (int f = 0; f < F; ++f) gt[f] = w * go[f];
    atomic_add_row<F>(grad_table + row, gt);
    if constexpr (kGradX) {
      float t[F];
      load_row<F>(table + row, t);
      float dw = 0.0f;   // d loss / d w of this corner
#pragma unroll
      for (int f = 0; f < F; ++f) dw += go[f] * t[f];
      dfrac[0] += (cx ? dw : -dw) * (wy * wz);
      dfrac[1] += (cy ? dw : -dw) * (wx * wz);
      dfrac[2] += (cz ? dw : -dw) * (wx * wy);
    }
  }
  if constexpr (kGradX) {
    // d frac / d x = res / (2·bound) where the clamp passes it
    const float scale = lv.res_f * g.inv_2bound;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      if (c.pass[d])
        atomicAdd(grad_x + 3 * static_cast<size_t>(i) + d, dfrac[d] * scale);
  }
}

bool make_grid(int num_levels, int log2_size, const int* res,
               const int* dense, float bound, float inv_2bound, Grid* g) {
  if (num_levels < 1 || num_levels > kMaxLevels || log2_size < 1
      || log2_size > 30)
    return false;
  *g = Grid{};
  for (int l = 0; l < num_levels; ++l) {
    if (res[l] < 1) return false;
    g->level[l] = Level{static_cast<float>(res[l]), res[l],
                        static_cast<unsigned>(res[l] + 1), dense[l],
                        static_cast<long long>(l) << log2_size};
  }
  g->num_levels = num_levels;
  g->mask = (1u << log2_size) - 1u;
  g->bound = bound;
  g->inv_2bound = inv_2bound;
  return true;
}

template <int F>
int launch_fwd(const float* table, const float* x, float* out, int n,
               const Grid& g, cudaStream_t s) {
  const dim3 grid((n + kThreads - 1) / kThreads, g.num_levels);
  hashgrid_fwd_kernel<F><<<grid, kThreads, 0, s>>>(table, x, out, n, g);
  return static_cast<int>(cudaGetLastError());
}

template <int F>
int launch_bwd(const float* table, const float* x, const float* grad_out,
               float* grad_table, float* grad_x, int n, const Grid& g,
               cudaStream_t s) {
  const dim3 grid((n + kThreads - 1) / kThreads, g.num_levels);
  if (grad_x != nullptr)
    hashgrid_bwd_kernel<F, true><<<grid, kThreads, 0, s>>>(
        table, x, grad_out, grad_table, grad_x, n, g);
  else
    hashgrid_bwd_kernel<F, false><<<grid, kThreads, 0, s>>>(
        table, x, grad_out, grad_table, nullptr, n, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (n, L·F) ← the encode of x (n, 3) in the table (L, 2^log2_size, F).
// `res`, `dense`: each level's resolution and whether it is indexed
// densely, host arrays of `num_levels`.
extern "C" int hashgrid_fwd(const void* table, const void* x, void* out,
                            int n, int num_levels, int level_dim,
                            int log2_size, const int* res, const int* dense,
                            float bound, float inv_2bound, void* stream) {
  Grid g;
  if (n < 0 || !make_grid(num_levels, log2_size, res, dense, bound,
                          inv_2bound, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const auto t = static_cast<const float*>(table);
  const auto p = static_cast<const float*>(x);
  const auto o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (level_dim) {
    case 1: return launch_fwd<1>(t, p, o, n, g, s);
    case 2: return launch_fwd<2>(t, p, o, n, g, s);
    case 4: return launch_fwd<4>(t, p, o, n, g, s);
    case 8: return launch_fwd<8>(t, p, o, n, g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// grad_table (L, 2^log2_size, F) ← the table's gradient from grad_out
// (n, L·F); grad_x (n, 3), where not null, ← the points'. Both are zeroed
// here first, on the stream.
extern "C" int hashgrid_bwd(const void* table, const void* x,
                            const void* grad_out, void* grad_table,
                            void* grad_x, int n, int num_levels,
                            int level_dim, int log2_size, const int* res,
                            const int* dense, float bound, float inv_2bound,
                            void* stream) {
  Grid g;
  if (n < 0 || !make_grid(num_levels, log2_size, res, dense, bound,
                          inv_2bound, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t table_bytes =
      (static_cast<size_t>(num_levels) << log2_size) * level_dim * sizeof(float);
  cudaError_t err = cudaMemsetAsync(grad_table, 0, table_bytes, s);
  if (err == cudaSuccess && grad_x != nullptr)
    err = cudaMemsetAsync(grad_x, 0, static_cast<size_t>(n) * 3 * sizeof(float),
                          s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const auto t = static_cast<const float*>(table);
  const auto p = static_cast<const float*>(x);
  const auto go = static_cast<const float*>(grad_out);
  const auto gt = static_cast<float*>(grad_table);
  const auto gx = static_cast<float*>(grad_x);
  switch (level_dim) {
    case 1: return launch_bwd<1>(t, p, go, gt, gx, n, g, s);
    case 2: return launch_bwd<2>(t, p, go, gt, gx, n, g, s);
    case 4: return launch_bwd<4>(t, p, go, gt, gx, n, g, s);
    case 8: return launch_bwd<8>(t, p, go, gt, gx, n, g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
