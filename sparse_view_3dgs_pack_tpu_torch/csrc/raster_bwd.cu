// Backward tile rasterizer for Hopper (sm_90a): replays each tile's
// depth-sorted (tile, Gaussian) pairs back to front and writes every pair's
// gradient into the pair's own slot; a second kernel reduces the pair slots
// of each Gaussian in a fixed order. No atomics anywhere, so two runs on the
// same inputs give the same bits.
//
// Replaces the TPU kernel `rasterize_backward_pallas` -> `_bwd_kernel`
// (sparse_view_3dgs_pack_tpu/ops/pallas/raster_bwd.py:83-427) and the
// `jax.ops.segment_sum` of its custom VJP (ops/pallas/raster_vjp.py:117-132).
// The plain PyTorch versions are `rasterize_backward_torch` and
// `pairs_to_gaussians_torch` in ops/raster.py.
//
// What it computes, per pixel with cotangent g = d(color, invdepth, depth),
// g_alpha, saved log T_final and n_contrib, for each contributing pair j
// (index < n_contrib, not skipped: power > 0 or alpha < 1/255 skip):
//   T_j      = exp(log T_final - sum_{i >= j} log1p(-alpha_i))
//   suffix_j = sum_{i > j} alpha_i T_i <g, payload_i>
//   dL/dalpha_j = T_j <g, payload_j>
//               - (suffix_j + T_final (<g, bg> - g_alpha)) / max(1 - alpha_j, 1e-6)
// then through alpha = min(0.99, op exp(power)) (zero gradient through the
// clamp) to [mx, my, a, b, c, opacity], and d payload_j = alpha_j T_j g.
//
// What bounds it on an H100: per pixel and pair the replay costs two expf
// and one log1pf plus ~40 FMA, and each pair's C + 8 gradients are summed
// over the tile's pixels: five warp shuffles per value wherever a warp has a
// contributing pixel. The shuffles and the SFU, not device memory, bound it
// (a pair's Gaussian is read once per tile, its gradient row written once).
//
// What the design does about it: one block per tile, one thread per pixel.
// The block stages kBatch pairs at a time into shared memory (loaded by
// sorted id straight from the per-Gaussian arrays) and walks them back to
// front; each thread keeps its cotangent, log T_final, n_contrib, the
// running log-transmittance sum and the running suffix in registers, and
// recomputes T_j in the log domain (never dividing by 1 - alpha again and
// again). A pair's gradients are reduced over each warp with an xor
// butterfly (skipped when no lane of the warp contributes), the per-warp
// partials go to shared memory, and after the batch the block sums them in
// warp order and writes the pair rows with coalesced stores. The block only
// walks up to the largest n_contrib of its pixels. The TPU structure (chunk
// -major 128-lane layout, DMA units, the head read-modify-write, pixel
// -monomial matmuls, split_dot) is not carried over, and neither is the
// slot mask of the padded pair buffer: pairs are sized exactly.
//
// The per-Gaussian reduction: pair slots stably sorted by Gaussian id
// (`order`, with `offsets` the start of each Gaussian's run) are summed by
// one thread per (Gaussian, value) in slot order.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr int kMaxTilePixels = 512;
constexpr int kMaxWarps = kMaxTilePixels / 32;
constexpr int kBatch = 32;  // pairs staged in shared memory at a time
constexpr unsigned kFullMask = 0xffffffffu;

template <int C>
__global__ void __launch_bounds__(kMaxTilePixels)
raster_bwd_kernel(const float* __restrict__ means2d,    // (P, 2)
                  const float* __restrict__ conics,     // (P, 3)
                  const float* __restrict__ opacities,  // (P,)
                  const float* __restrict__ colors,     // (P, C)
                  const float* __restrict__ depths,     // (P,)
                  const int* __restrict__ ids,          // (n_pairs,)
                  const int* __restrict__ starts,       // (num_tiles,)
                  const int* __restrict__ counts,       // (num_tiles,)
                  const float* __restrict__ bg,         // (C,)
                  const float* __restrict__ log_t_final,  // (H, W)
                  const int* __restrict__ n_contrib,    // (H, W)
                  const float* __restrict__ g_color,    // (H, W, C)
                  const float* __restrict__ g_invdepth, // (H, W)
                  const float* __restrict__ g_depth,    // (H, W)
                  const float* __restrict__ g_alpha,    // (H, W)
                  float* __restrict__ out_pairs,        // (n_pairs, C + 8)
                  int width, int height, int tile_x, int tile_y,
                  int grid_x) {
  constexpr int NP = C + 2;   // payload: colours, inverse depth, depth
  constexpr int K = 6 + NP;   // pair row: mx, my, a, b, c, opacity, payload
  __shared__ float s_mx[kBatch], s_my[kBatch], s_a[kBatch], s_b[kBatch],
      s_c[kBatch], s_op[kBatch];
  __shared__ float s_pay[NP * kBatch];
  __shared__ float s_part[kMaxWarps * kBatch * K];  // per-warp partial sums
  __shared__ int s_warp_max[kMaxWarps];

  const int n = blockDim.x;
  const int n_warps = n / 32;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int px = (t % grid_x) * tile_x + tid % tile_x;
  const int py = (t / grid_x) * tile_y + tid / tile_x;
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int start = starts[t];
  const int count = counts[t];

  float g[NP];
  float log_tf = 0.0f;
  float g_a = 0.0f;
  int nc = 0;
#pragma unroll
  for (int ch = 0; ch < NP; ++ch) g[ch] = 0.0f;
  if (inside) {
    const int pix = py * width + px;
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      g[ch] = g_color[static_cast<size_t>(pix) * C + ch];
    g[C] = g_invdepth[pix];
    g[C + 1] = g_depth[pix];
    g_a = g_alpha[pix];
    log_tf = log_t_final[pix];
    nc = n_contrib[pix];
  }
  float g_bg = 0.0f;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) g_bg += g[ch] * bg[ch];
  const float back = expf(log_tf) * (g_bg - g_a);  // T_final (<g,bg> - g_a)

  // the tile replays pairs [0, min(count, max n_contrib)) only
  int m = nc;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(kFullMask, m, off));
  if (lane == 0) s_warp_max[warp] = m;
  __syncthreads();
  int end = 0;
  for (int w = 0; w < n_warps; ++w) end = max(end, s_warp_max[w]);
  end = min(end, count);

  float acc_log = 0.0f;  // sum of log1p(-alpha) over contributing pairs >= j
  float suffix = 0.0f;   // sum of alpha T <g, payload> over pairs > j

  for (int hi = end; hi > 0; hi -= kBatch) {
    const int lo = max(hi - kBatch, 0);
    const int nb = hi - lo;
    // the previous batch's shared data (pairs and partials) is consumed
    __syncthreads();
    if (tid < nb) {
      const int gid = ids[start + lo + tid];
      s_mx[tid] = means2d[2 * gid];
      s_my[tid] = means2d[2 * gid + 1];
      s_a[tid] = conics[3 * gid];
      s_b[tid] = conics[3 * gid + 1];
      s_c[tid] = conics[3 * gid + 2];
      s_op[tid] = opacities[gid];
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        s_pay[ch * kBatch + tid] = colors[static_cast<size_t>(gid) * C + ch];
      const float d = depths[gid];
      const float sd = fabsf(d) <= FLT_MAX ? d : 1.0f;  // NaN/inf -> 1
      s_pay[C * kBatch + tid] = 1.0f / sd;
      s_pay[(C + 1) * kBatch + tid] = sd;
    }
    __syncthreads();
    for (int jj = nb - 1; jj >= 0; --jj) {
      float v[K];
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = 0.0f;
      bool contrib = false;
      if (lo + jj < nc) {
        // the forward kernel's exact expression, so the skips replay
        const float dx = fx - s_mx[jj];
        const float dy = fy - s_my[jj];
        const float a = s_a[jj], b = s_b[jj], c = s_c[jj];
        const float power = -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
        const float G = expf(fminf(power, 0.0f));
        const float alpha_raw = s_op[jj] * G;
        const float alpha = fminf(kAlphaMax, alpha_raw);
        if (!(power > 0.0f || alpha < kAlphaEps)) {
          contrib = true;
          acc_log += log1pf(-alpha);
          const float T = expf(log_tf - acc_log);
          const float w = alpha * T;
          float gc = 0.0f;
#pragma unroll
          for (int ch = 0; ch < NP; ++ch) gc += g[ch] * s_pay[ch * kBatch + jj];
          const float dalpha =
              T * gc - (suffix + back) / fmaxf(1.0f - alpha, 1e-6f);
          suffix += w * gc;
#pragma unroll
          for (int ch = 0; ch < NP; ++ch) v[6 + ch] = w * g[ch];
          if (alpha_raw <= kAlphaMax) {  // zero gradient through the clamp
            const float q = dalpha * alpha;  // dL/dpower
            v[0] = q * (a * dx + b * dy);
            v[1] = q * (c * dy + b * dx);
            v[2] = -0.5f * q * dx * dx;
            v[3] = -q * dx * dy;
            v[4] = -0.5f * q * dy * dy;
            v[5] = dalpha * G;
          }
        }
      }
      if (__any_sync(kFullMask, contrib)) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v[k] += __shfl_xor_sync(kFullMask, v[k], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) s_part[(warp * kBatch + jj) * K + k] = v[k];
      }
    }
    __syncthreads();
    // sum the warps' partials in warp order; rows of the batch are adjacent
    for (int e = tid; e < nb * K; e += n) {
      const int jj = e / K;
      const int k = e - jj * K;
      float s = 0.0f;
      for (int w = 0; w < n_warps; ++w) s += s_part[(w * kBatch + jj) * K + k];
      out_pairs[static_cast<size_t>(start + lo) * K + e] = s;
    }
  }
}

__global__ void segment_sum_kernel(const float* __restrict__ pair_grads,
                                   const int* __restrict__ order,
                                   const int* __restrict__ offsets,
                                   int num_gaussians, int k,
                                   float* __restrict__ out) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(num_gaussians) * k) return;
  const int gid = static_cast<int>(idx / k);
  const int col = static_cast<int>(idx - static_cast<long long>(gid) * k);
  float s = 0.0f;
  for (int i = offsets[gid]; i < offsets[gid + 1]; ++i)
    s += pair_grads[static_cast<size_t>(order[i]) * k + col];
  out[idx] = s;
}

template <int C>
void launch(int num_tiles, int n, cudaStream_t stream, const float* means2d,
            const float* conics, const float* opacities, const float* colors,
            const float* depths, const int* ids, const int* starts,
            const int* counts, const float* bg, const float* log_t_final,
            const int* n_contrib, const float* g_color,
            const float* g_invdepth, const float* g_depth,
            const float* g_alpha, float* out_pairs, int width, int height,
            int tile_x, int tile_y, int grid_x) {
  raster_bwd_kernel<C><<<num_tiles, n, 0, stream>>>(
      means2d, conics, opacities, colors, depths, ids, starts, counts, bg,
      log_t_final, n_contrib, g_color, g_invdepth, g_depth, g_alpha,
      out_pairs, width, height, tile_x, tile_y, grid_x);
}

}  // namespace

// Plain C entry points, bound with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for arguments it does
// not take). `out_pairs` must be zeroed by the caller: pairs no pixel
// replays (past every pixel's n_contrib) are not written.
extern "C" int raster_bwd(const void* means2d, const void* conics,
                          const void* opacities, const void* colors,
                          const void* depths, const void* ids,
                          const void* starts, const void* counts,
                          const void* bg, const void* log_t_final,
                          const void* n_contrib, const void* g_color,
                          const void* g_invdepth, const void* g_depth,
                          const void* g_alpha, void* out_pairs,
                          int num_tiles, int channels, int width, int height,
                          int tile_x, int tile_y, int grid_x, void* stream) {
  const int n = tile_x * tile_y;
  if (n <= 0 || n > kMaxTilePixels || n % 32 || num_tiles < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RASTER_BWD_CASE(CH)                                                  \
  case CH:                                                                   \
    launch<CH>(num_tiles, n, s, static_cast<const float*>(means2d),          \
               static_cast<const float*>(conics),                            \
               static_cast<const float*>(opacities),                         \
               static_cast<const float*>(colors),                            \
               static_cast<const float*>(depths),                            \
               static_cast<const int*>(ids), static_cast<const int*>(starts), \
               static_cast<const int*>(counts),                              \
               static_cast<const float*>(bg),                                \
               static_cast<const float*>(log_t_final),                       \
               static_cast<const int*>(n_contrib),                           \
               static_cast<const float*>(g_color),                           \
               static_cast<const float*>(g_invdepth),                        \
               static_cast<const float*>(g_depth),                           \
               static_cast<const float*>(g_alpha),                           \
               static_cast<float*>(out_pairs), width, height, tile_x, tile_y, \
               grid_x);                                                      \
    break;
  switch (channels) {
    RASTER_BWD_CASE(1)
    RASTER_BWD_CASE(2)
    RASTER_BWD_CASE(3)
    RASTER_BWD_CASE(4)
    RASTER_BWD_CASE(5)
    RASTER_BWD_CASE(6)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RASTER_BWD_CASE
  return static_cast<int>(cudaGetLastError());
}

extern "C" int segment_sum(const void* pair_grads, const void* order,
                           const void* offsets, int num_gaussians, int k,
                           void* out, void* stream) {
  if (num_gaussians < 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(num_gaussians) * k;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  segment_sum_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pair_grads), static_cast<const int*>(order),
      static_cast<const int*>(offsets), num_gaussians, k,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
