// Forward tile rasterizer for Hopper (sm_90a): front-to-back alpha blending
// of each tile's depth-sorted (tile, Gaussian) pair range.
//
// Replaces the TPU kernel `rasterize_forward_pallas` -> `_fwd_kernel`
// (sparse_view_3dgs_pack_tpu/ops/pallas/raster.py:151-432) in both of its
// instantiations: inference (32x16 tiles, used by the render path) and
// training (16x16, which also records the per-pixel n_contrib and log
// T_final that the backward, csrc/raster_bwd.cu, replays). The plain PyTorch
// version of the same function is `rasterize_forward_torch` in ops/raster.py.
//
// What bounds it on an H100: per pixel and per pair it does one
// shared-memory read of the pair's Gaussian (broadcast to the whole warp),
// the quadratic form, one expf and one log1pf. With ~0.7 M pairs at 1080p
// and 512 pixels per 32x16 tile that is a few 1e8 transcendental pairs per
// frame: compute bound on the SFU and FMA pipes, not on device memory (each
// pair's Gaussian is read from memory once per tile).
//
// What the design does about it: one block per tile and one thread per
// pixel; the block stages blockDim pairs at a time into shared memory, each
// thread loading one pair's Gaussian by its sorted id straight from the
// per-Gaussian arrays (no separate gather pass), then every thread blends
// the batch sequentially for its pixel with a sticky stop; the block leaves
// the pair loop as soon as every pixel is done (__syncthreads_count). The
// TPU structure (DMA units, prefetch slots, chunk-major layout, the
// triangular-matmul cumsum) is not carried over.
//
// Semantics held to the JAX dense oracle (ops/rasterize_ref.py):
//   * pixel (x, y) sits at integer coordinates, not +0.5;
//   * power = -0.5 (a dx^2 + c dy^2) - b dx dy,
//     alpha = min(0.99, op exp(min(power, 0))), skipped when power > 0 or
//     alpha < 1/255;
//   * log-transmittance s += log1p(-alpha); the pair whose s crosses
//     ln(1e-4) does not contribute and nothing after it does (sticky);
//   * payload = [colors, 1/safe_depth, safe_depth], safe_depth = depth if
//     finite else 1; the background enters the C colour channels only, as
//     T_final * bg; alpha = 1 - exp(log_T);
//   * n_contrib counts every pair before the stop, skipped pairs included
//     (what the JAX backward replays; not CUDA's last_contributor);
//   * log T_final is written as the log-domain sum itself: 1 - alpha cannot
//     give it back to f32 accuracy where T is near the 1e-4 stop;
//   * pixels past the image edge are not written.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kLogTEps = -9.210340371976182f;  // logf(1e-4)
constexpr int kMaxTilePixels = 512;

template <int C, bool kNContrib>
__global__ void __launch_bounds__(kMaxTilePixels)
raster_fwd_kernel(const float* __restrict__ means2d,    // (P, 2)
                  const float* __restrict__ conics,     // (P, 3)
                  const float* __restrict__ opacities,  // (P,)
                  const float* __restrict__ colors,     // (P, C)
                  const float* __restrict__ depths,     // (P,)
                  const int* __restrict__ ids,          // (n_pairs,)
                  const int* __restrict__ starts,       // (num_tiles,)
                  const int* __restrict__ counts,       // (num_tiles,)
                  const float* __restrict__ bg,         // (C,)
                  float* __restrict__ out_color,        // (H, W, C)
                  float* __restrict__ out_invdepth,     // (H, W)
                  float* __restrict__ out_depth,        // (H, W)
                  float* __restrict__ out_alpha,        // (H, W)
                  int* __restrict__ out_n_contrib,      // (H, W) if kNContrib
                  float* __restrict__ out_log_t,        // (H, W) if kNContrib
                  int width, int height, int tile_x, int tile_y,
                  int grid_x) {
  constexpr int NP = C + 2;  // payload: colours, inverse depth, depth
  extern __shared__ float smem[];
  const int n = blockDim.x;
  float* s_mx = smem;
  float* s_my = s_mx + n;
  float* s_a = s_my + n;
  float* s_b = s_a + n;
  float* s_c = s_b + n;
  float* s_op = s_c + n;
  float* s_pay = s_op + n;  // s_pay[k * n + j]: payload channel k of pair j

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int px = (t % grid_x) * tile_x + tid % tile_x;
  const int py = (t / grid_x) * tile_y + tid / tile_x;
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);

  const int start = starts[t];
  const int count = counts[t];

  float acc[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) acc[k] = 0.0f;
  float log_t = 0.0f;
  int n_contrib = 0;
  bool done = !inside;

  for (int base = 0; base < count; base += n) {
    // Also the barrier that keeps this batch's loads from overwriting the
    // previous batch while a thread still blends it.
    if (__syncthreads_count(done) == n) break;
    const int k = base + tid;
    if (k < count) {
      const int g = ids[start + k];
      s_mx[tid] = means2d[2 * g];
      s_my[tid] = means2d[2 * g + 1];
      s_a[tid] = conics[3 * g];
      s_b[tid] = conics[3 * g + 1];
      s_c[tid] = conics[3 * g + 2];
      s_op[tid] = opacities[g];
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        s_pay[ch * n + tid] = colors[static_cast<size_t>(g) * C + ch];
      const float d = depths[g];
      const float sd = fabsf(d) <= FLT_MAX ? d : 1.0f;  // NaN/inf -> 1
      s_pay[C * n + tid] = 1.0f / sd;
      s_pay[(C + 1) * n + tid] = sd;
    }
    __syncthreads();
    if (!done) {
      const int m = min(n, count - base);
      for (int j = 0; j < m; ++j) {
        const float dx = fx - s_mx[j];
        const float dy = fy - s_my[j];
        const float power =
            -0.5f * (s_a[j] * dx * dx + s_c[j] * dy * dy) - s_b[j] * dx * dy;
        const float alpha =
            fminf(kAlphaMax, s_op[j] * expf(fminf(power, 0.0f)));
        if (power > 0.0f || alpha < kAlphaEps) {
          if (kNContrib) ++n_contrib;
          continue;
        }
        const float s_incl = log_t + log1pf(-alpha);
        if (s_incl < kLogTEps) {
          done = true;
          break;
        }
        const float w = alpha * expf(log_t);
#pragma unroll
        for (int ch = 0; ch < NP; ++ch) acc[ch] += w * s_pay[ch * n + j];
        log_t = s_incl;
        if (kNContrib) ++n_contrib;
      }
    }
  }

  if (!inside) return;
  const int pix = py * width + px;
  const float T = expf(log_t);
#pragma unroll
  for (int ch = 0; ch < C; ++ch)
    out_color[static_cast<size_t>(pix) * C + ch] = acc[ch] + T * bg[ch];
  out_invdepth[pix] = acc[C];
  out_depth[pix] = acc[C + 1];
  out_alpha[pix] = 1.0f - T;
  if (kNContrib) {
    out_n_contrib[pix] = n_contrib;
    out_log_t[pix] = log_t;
  }
}

template <int C, bool kNContrib>
void launch(int num_tiles, int n, size_t smem, cudaStream_t stream,
            const float* means2d, const float* conics, const float* opacities,
            const float* colors, const float* depths, const int* ids,
            const int* starts, const int* counts, const float* bg,
            float* out_color, float* out_invdepth, float* out_depth,
            float* out_alpha, int* out_n_contrib, float* out_log_t, int width,
            int height, int tile_x, int tile_y, int grid_x) {
  raster_fwd_kernel<C, kNContrib><<<num_tiles, n, smem, stream>>>(
      means2d, conics, opacities, colors, depths, ids, starts, counts, bg,
      out_color, out_invdepth, out_depth, out_alpha, out_n_contrib,
      out_log_t, width, height, tile_x, tile_y, grid_x);
}

template <bool kNContrib>
bool dispatch_channels(int channels, int num_tiles, int n, size_t smem,
                       cudaStream_t stream, const float* means2d,
                       const float* conics, const float* opacities,
                       const float* colors, const float* depths,
                       const int* ids, const int* starts, const int* counts,
                       const float* bg, float* out_color, float* out_invdepth,
                       float* out_depth, float* out_alpha, int* out_n_contrib,
                       float* out_log_t, int width, int height, int tile_x,
                       int tile_y, int grid_x) {
#define RASTER_FWD_CASE(CH)                                                  \
  case CH:                                                                   \
    launch<CH, kNContrib>(num_tiles, n, smem, stream, means2d, conics,       \
                          opacities, colors, depths, ids, starts, counts, bg, \
                          out_color, out_invdepth, out_depth, out_alpha,     \
                          out_n_contrib, out_log_t, width, height, tile_x,   \
                          tile_y, grid_x);                                   \
    return true;
  switch (channels) {
    RASTER_FWD_CASE(1)
    RASTER_FWD_CASE(2)
    RASTER_FWD_CASE(3)
    RASTER_FWD_CASE(4)
    RASTER_FWD_CASE(5)
    RASTER_FWD_CASE(6)
    default:
      return false;
  }
#undef RASTER_FWD_CASE
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments it does not take).
extern "C" int raster_fwd(const void* means2d, const void* conics,
                          const void* opacities, const void* colors,
                          const void* depths, const void* ids,
                          const void* starts, const void* counts,
                          const void* bg, void* out_color, void* out_invdepth,
                          void* out_depth, void* out_alpha,
                          void* out_n_contrib, void* out_log_t,
                          int num_tiles, int channels,
                          int width, int height, int tile_x, int tile_y,
                          int grid_x, int compute_n_contrib, void* stream) {
  const int n = tile_x * tile_y;
  if (n <= 0 || n > kMaxTilePixels || num_tiles < 0 ||
      (compute_n_contrib && (out_n_contrib == nullptr ||
                             out_log_t == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(n) * (6 + channels + 2) *
                      sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok =
      compute_n_contrib
          ? dispatch_channels<true>(
                channels, num_tiles, n, smem, s,
                static_cast<const float*>(means2d),
                static_cast<const float*>(conics),
                static_cast<const float*>(opacities),
                static_cast<const float*>(colors),
                static_cast<const float*>(depths),
                static_cast<const int*>(ids), static_cast<const int*>(starts),
                static_cast<const int*>(counts), static_cast<const float*>(bg),
                static_cast<float*>(out_color),
                static_cast<float*>(out_invdepth),
                static_cast<float*>(out_depth), static_cast<float*>(out_alpha),
                static_cast<int*>(out_n_contrib),
                static_cast<float*>(out_log_t), width, height, tile_x, tile_y,
                grid_x)
          : dispatch_channels<false>(
                channels, num_tiles, n, smem, s,
                static_cast<const float*>(means2d),
                static_cast<const float*>(conics),
                static_cast<const float*>(opacities),
                static_cast<const float*>(colors),
                static_cast<const float*>(depths),
                static_cast<const int*>(ids), static_cast<const int*>(starts),
                static_cast<const int*>(counts), static_cast<const float*>(bg),
                static_cast<float*>(out_color),
                static_cast<float*>(out_invdepth),
                static_cast<float*>(out_depth), static_cast<float*>(out_alpha),
                nullptr, nullptr, width, height, tile_x, tile_y, grid_x);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
