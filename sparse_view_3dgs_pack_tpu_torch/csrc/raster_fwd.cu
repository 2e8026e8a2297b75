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
// What bounds it on an H100: instruction issue, not device memory (each
// pair's Gaussian is read from memory once per warp of a tile). Per
// (warp, pair) walked, each thread evaluates the quadratic form and one expf
// for each of its pixels, and for each pixel that blends also a log1pf and
// the payload's multiply-adds; most evaluations before the stops are skips
// (power > 0 or alpha < 1/255: 59% at 800p training, 81% at 1080p
// inference, PERF.md), and a warp pays for a pair wherever one of its lanes
// still blends.
//
// What the design does about it (each step measured, PERF.md):
//  * Layout: one block per tile, each thread covering kPix pixels of a
//    column: 2 in the training instantiation (a warp: 16 x 4 pixels of a
//    16 x 16 tile, the backward's layout), 4 in the inference one (32 x 4 of
//    a 32 x 16 tile), so that a shared-memory broadcast and a loop step
//    serve several pixels.
//  * Per-warp cull: a warp walks only the pairs whose cull box
//    (raster_common.cuh, never smaller than the alpha >= 1/255 region)
//    touches its pixel rectangle, in order, by a ballot over each batch, and
//    leaves the tile once all its pixels have stopped. A culled pair is a
//    skip for every lane of the warp, so the outputs do not change.
//  * Staging: each warp stages its own batches of 32 pairs, lane l pair
//    32 b + l: its fields are copied by `cp.async` straight into the pair's
//    64-byte record (geometry mx my a b | c op, payload colours, depth) in
//    the warp's two-slot ring, batch b + 1 in flight while batch b blends,
//    sorted ids read one batch further ahead. The lane that copied a pair
//    packs it once its own copies have landed (1/depth and the safe depth
//    in place of the depth) and tests its cull box, so a __syncwarp orders
//    everything: no block barrier, and no warp waits for another.
//  * n_contrib is the index of the pair that stops the pixel, or the tile's
//    count if none does: every pair before the stop, whatever the cull
//    dropped, with no per-pair count.
//  * Transmittance: the weights take T as a running product of (1 - alpha)
//    (one multiply for an expf); the stop test, log T_final and T_final
//    stay on the log-domain sum, on which the plain version, the JAX
//    oracle and the backward are defined.
// The TPU structure (DMA units, prefetch slots, chunk-major layout, the
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

#include "raster_common.cuh"

namespace {

using raster::cp_async4;
using raster::cp_async_commit;
using raster::cp_async_wait;

constexpr int kMaxTilePixels = 512;
constexpr int kStages = 2;      // batch b blends while b + 1 lands
constexpr int kRec = 16;        // record: mx my a b | c op - - | payload
constexpr unsigned kFullMask = 0xffffffffu;

// Pixels per thread, consecutive rows of a column (`fwd_pixels` in
// ops/raster.py).
__host__ __device__ constexpr int pixels_per_thread(bool n_contrib) {
  return n_contrib ? 2 : 4;
}

// The widest block of an instantiation: a 512-pixel tile.
__host__ __device__ constexpr int max_threads(bool n_contrib) {
  return kMaxTilePixels / pixels_per_thread(n_contrib);
}

// Bytes of shared memory for a block of `threads`: each warp's ring.
constexpr size_t ring_bytes(int threads) {
  return static_cast<size_t>(threads / 32) * kStages * 32 * kRec *
         sizeof(float);
}

template <int C, bool kNContrib>
__global__ void __launch_bounds__(max_threads(kNContrib))
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
  constexpr int kPix = pixels_per_thread(kNContrib);
  static_assert(NP <= kRec - 8, "payload does not fit the packed record");
  // each warp's ring of packed pair records, ring_bytes(blockDim.x)
  extern __shared__ float4 s_rec[];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ox = (t % grid_x) * tile_x;
  const int oy = (t / grid_x) * tile_y;
  // this thread's pixels: column tid % tile_x, rows kPix (tid / tile_x) + i
  const int px = ox + tid % tile_x;
  const float fx = static_cast<float>(px);
  const int start = starts[t];
  const int count = counts[t];

  float fy[kPix], acc[kPix][NP], log_t[kPix], T[kPix];
  int stop[kPix];     // n_contrib: the stopping pair's index, else count
  bool done[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int py = oy + kPix * (tid / tile_x) + i;
    fy[i] = static_cast<float>(py);
    done[i] = !(px < width && py < height);
#pragma unroll
    for (int ch = 0; ch < NP; ++ch) acc[i][ch] = 0.0f;
    log_t[i] = 0.0f;
    T[i] = 1.0f;
    stop[i] = count;
  }
  auto all_done = [&]() {
    bool d = true;
#pragma unroll
    for (int i = 0; i < kPix; ++i) d = d && done[i];
    return d;
  };
  // this warp's pixel rectangle and its ring of two 32-pair batches; lane l
  // stages, packs and culls pair 32 b + l of batch b
  const float4 rect = raster::warp_rect(warp, tile_x, kPix, ox, oy);
  float4(*ring)[32][kRec / 4] = reinterpret_cast<float4(*)[32][kRec / 4]>(
      s_rec + warp * kStages * 32 * (kRec / 4));
  const int n_batches = (count + 31) / 32;
  auto mine = [&](int b) { return b < n_batches && 32 * b + lane < count; };
  auto sorted_id = [&](int b) {
    return mine(b) ? ids[start + 32 * b + lane] : 0;
  };
  auto stage = [&](int b, int gid) {
    if (mine(b)) {
      float* dst = reinterpret_cast<float*>(ring[b % kStages][lane]);
      const size_t q = static_cast<size_t>(gid);
      cp_async4(dst + 0, means2d + 2 * q);
      cp_async4(dst + 1, means2d + 2 * q + 1);
      cp_async4(dst + 2, conics + 3 * q);
      cp_async4(dst + 3, conics + 3 * q + 1);
      cp_async4(dst + 4, conics + 3 * q + 2);
      cp_async4(dst + 5, opacities + q);
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        cp_async4(dst + 8 + ch, colors + q * C + ch);
      cp_async4(dst + 8 + C, depths + q);
    }
    cp_async_commit();
  };
  // this lane's pair of batch b once its copies have landed: packed in
  // place; whether its cull box touches the warp's rectangle
  auto pack = [&](int b) {
    if (!mine(b)) return false;
    float4* r = ring[b % kStages][lane];
    float* f = reinterpret_cast<float*>(r);
    const float d = f[8 + C];
    const float sd = fabsf(d) <= FLT_MAX ? d : 1.0f;  // NaN/inf -> 1
    f[8 + C] = 1.0f / sd;
    f[9 + C] = sd;
    const float4 g0 = r[0];
    return !raster::rect_outside(
        raster::cull_box(g0.x, g0.y, g0.z, g0.w, f[4], f[5]), rect);
  };

  if (!__all_sync(kFullMask, all_done())) {
    stage(0, sorted_id(0));
    int next_gid = sorted_id(1);
    bool warp_done = false;
    for (int b = 0; b < n_batches && !warp_done; ++b) {
      cp_async_wait<0>();  // batch b landed (this lane's copies)
      const bool seen = pack(b);
      __syncwarp();        // batch b's records to the warp; b - 1's slot free
      stage(b + 1, next_gid);
      next_gid = sorted_id(b + 2);
      const int lo = 32 * b;
      float4(*recs)[kRec / 4] = ring[b % kStages];
      unsigned bits = __ballot_sync(kFullMask, seen);
      while (bits) {
        const int j = __ffs(bits) - 1;
        bits &= bits - 1;
        const float4 g0 = recs[j][0];
        const float4 g1 = recs[j][1];
        raster::Eval e[kPix];
        bool live[kPix];
        bool any = false;
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          e[i] = raster::eval_pair(fx, fy[i], g0.x, g0.y, g0.z, g0.w, g1.x,
                                   g1.y);
          live[i] = !done[i] && !e[i].skip;
          any = any || live[i];
        }
        if (any) {
          const float4 p0 = recs[j][2];
          const float4 p1 = recs[j][3];
          const float pay[8] = {p0.x, p0.y, p0.z, p0.w,
                                p1.x, p1.y, p1.z, p1.w};
#pragma unroll
          for (int i = 0; i < kPix; ++i) {
            if (!live[i]) continue;
            const float alpha = e[i].alpha;
            const float s_incl = log_t[i] + log1pf(-alpha);
            if (s_incl < raster::kLogTEps) {
              done[i] = true;
              stop[i] = lo + j;
              continue;
            }
            const float w = alpha * T[i];
#pragma unroll
            for (int ch = 0; ch < NP; ++ch) acc[i][ch] += w * pay[ch];
            T[i] *= 1.0f - alpha;
            log_t[i] = s_incl;
          }
        }
        if (__all_sync(kFullMask, all_done())) {
          warp_done = true;
          break;
        }
      }
    }
    cp_async_wait<0>();  // no copy outlives the warp
  }

#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int py = oy + kPix * (tid / tile_x) + i;
    if (px >= width || py >= height) continue;
    const int pix = py * width + px;
    const float T_final = expf(log_t[i]);
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      out_color[static_cast<size_t>(pix) * C + ch] =
          acc[i][ch] + T_final * bg[ch];
    out_invdepth[pix] = acc[i][C];
    out_depth[pix] = acc[i][C + 1];
    out_alpha[pix] = 1.0f - T_final;
    if (kNContrib) {
      out_n_contrib[pix] = stop[i];
      out_log_t[pix] = log_t[i];
    }
  }
}

// One tile per block, n / kPix threads (training: 128 for a 16 x 16 tile,
// 256 for a 32 x 16 one; inference: at most 128).
template <int C, bool kNContrib>
int launch(int num_tiles, int threads, cudaStream_t stream,
           const float* means2d, const float* conics, const float* opacities,
           const float* colors, const float* depths, const int* ids,
           const int* starts, const int* counts, const float* bg,
           float* out_color, float* out_invdepth, float* out_depth,
           float* out_alpha, int* out_n_contrib, float* out_log_t, int width,
           int height, int tile_x, int tile_y, int grid_x) {
  raster_fwd_kernel<C, kNContrib>
      <<<num_tiles, threads, ring_bytes(threads), stream>>>(
          means2d, conics, opacities, colors, depths, ids, starts, counts,
          bg, out_color, out_invdepth, out_depth, out_alpha, out_n_contrib,
          out_log_t, width, height, tile_x, tile_y, grid_x);
  return static_cast<int>(cudaGetLastError());
}

template <int C, typename... Args>
int launch_c(bool n_contrib, Args... args) {
  return n_contrib ? launch<C, true>(args...) : launch<C, false>(args...);
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments it does not take:
// tiles of at most 512 pixels, rows a multiple of the instantiation's
// pixels per thread, whole warps).
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
  const int pix = pixels_per_thread(compute_n_contrib != 0);
  const int threads = n / pix;
  if (n <= 0 || n > kMaxTilePixels || tile_y % pix || threads % 32 ||
      num_tiles < 0 ||
      (compute_n_contrib && (out_n_contrib == nullptr ||
                             out_log_t == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto i = [](const void* q) { return static_cast<const int*>(q); };
  const auto o = [](void* q) { return static_cast<float*>(q); };
#define RASTER_FWD_CASE(CH)                                                   \
  case CH:                                                                    \
    return launch_c<CH>(compute_n_contrib != 0, num_tiles, threads,           \
                        static_cast<cudaStream_t>(stream), f(means2d),        \
                        f(conics), f(opacities), f(colors), f(depths),        \
                        i(ids), i(starts), i(counts), f(bg), o(out_color),    \
                        o(out_invdepth), o(out_depth), o(out_alpha),          \
                        static_cast<int*>(out_n_contrib), o(out_log_t),       \
                        width, height, tile_x, tile_y, grid_x);
  switch (channels) {
    RASTER_FWD_CASE(1)
    RASTER_FWD_CASE(2)
    RASTER_FWD_CASE(3)
    RASTER_FWD_CASE(4)
    RASTER_FWD_CASE(5)
    RASTER_FWD_CASE(6)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RASTER_FWD_CASE
}
