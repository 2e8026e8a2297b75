// Probe kernels for Hopper (sm_90a): small kernels that each check one
// primitive the tile rasterizer (csrc/raster_fwd.cu) is built from, and two
// that dump a tile's per-(pixel, pair) alpha and a one-batch blend, so that a
// rasterizer fault on the card can be bisected down to its primitive.
//
// They replace the TPU probes of scripts/tpu_prims.py and scripts/tpu_dbg.py:
//   P1 probe_tile_coords  <- k_iota        (tpu_prims.py:18)
//   P2 probe_row_cumsum   <- k_cumsum      (tpu_prims.py:44)
//   P3 probe_offset_copy  <- k_dma         (tpu_prims.py:68)
//   P4 probe_pair_alpha   <- k_alpha       (tpu_prims.py:93)
//   D1 probe_tile_alpha   <- make_kernel(with_loop) -> kern (tpu_dbg.py:54)
//   D2 probe_tile_blend   <- blend_kernel  (tpu_dbg.py:141)
// Each computes what its TPU kernel computes; where a probe exists to check a
// mechanism, it checks the Hopper one (a warp-shuffle scan, not the TPU's
// triangular matmul; cp.async copies from an offset read on the device, not
// scalar prefetch and a DMA semaphore). The plain PyTorch version of each is
// beside its wrapper in ops/probes.py. This file is compiled with
// --fmad=false (ops/_build.py): every f32 operation rounds on its own, in
// the plain versions' order, so that on the card a probe and its plain
// version can agree bit for bit and any difference points at a fault.
//
// What bounds them on an H100: D1 and D2 write a (tiles, 256, 256) f32 dump,
// 655 MB at 800x800, so both are bound by device-memory bytes; their stores
// are laid out so that a warp writes 32 neighbouring floats (D1: one thread
// per pair, pixel rows in a loop; D2: results staged in shared memory and
// written by the whole block). P1-P4 work on a few hundred KB and are bound
// by launch latency; `probe_launch_floor` launches an empty kernel, whose
// time is that floor.
//
// cp.async layout (D1, D2): pairs are loaded by their sorted Gaussian id
// straight from the per-Gaussian arrays (means2d (P, 2), conics (P, 3),
// opacities, colors (P, C), depths), so a field of a Gaussian sits at no
// better than 4-byte alignment. Each field is therefore copied by its own
// 4-byte cp.async (cp.async.ca, which takes 4, 8 or 16 bytes) into a
// field-major shared array [field][lane]; no gather pass lays the pairs out
// for 16-byte copies. P3 copies 16 bytes at a time (cp.async.cg) when the
// start, the row length and the base are multiples of 4 floats, else 4.
//
// Semantics held to the TPU probes and the forward kernel:
//   * tile-local integer pixel coordinates, p % 16 and p / 16, offset by the
//     tile's origin (raster.py:435 tile_pixel_coords);
//   * power = -0.5 (a dx^2 + c dy^2) - b dx dy,
//     alpha = min(0.99, op exp(min(power, 0))); D1 and D2 zero it where
//     power > 0, alpha < 1/255 or the lane is past the tile's pair count;
//   * D2: w = alpha exp(exclusive sum of log1p(-alpha)) while the inclusive
//     sum is >= ln 1e-4 (the script's non-sticky test: every log1p(-alpha)
//     is <= 0, so the inclusive sum only falls and the test marks a prefix);
//     columns 0-7 sum w * payload (C colours, 1/depth, depth, zeros),
//     column 8 is log T, column 9 the count of lanes that pass the test
//     (lanes past the pair count included, as on the TPU), the rest zero.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // pixels of a 16x16 tile
constexpr int kChunk = 256;          // pairs per batch (the TPU CHUNK)
constexpr int kMaxBatches = 64;      // tpu_dbg.py:85
constexpr int kBlendCols = 10;       // 8 payload sums, log T, n_contrib
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kLogTEps = -9.210340371976182f;  // logf(1e-4)

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float pair_power(float fx, float fy, float mx,
                                            float my, float a, float b,
                                            float c) {
  const float dx = fx - mx;
  const float dy = fy - my;
  return -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
}

__device__ __forceinline__ float raw_alpha(float power, float op) {
  return fminf(kAlphaMax, op * expf(fminf(power, 0.0f)));
}

// alpha with the forward kernel's skips (and the lane mask) zeroed
__device__ __forceinline__ float masked_alpha(float fx, float fy, float mx,
                                              float my, float a, float b,
                                              float c, float op, bool valid) {
  const float power = pair_power(fx, fy, mx, my, a, b, c);
  const float alpha = raw_alpha(power, op);
  return (power > 0.0f || alpha < kAlphaEps || !valid) ? 0.0f : alpha;
}

// ---- P1: pixel coordinates of a grid of 16x16 tiles -----------------------
__global__ void __launch_bounds__(kPix)
tile_coords_kernel(float* __restrict__ out, int grid_x) {
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int tx = (t % grid_x) * kTile;
  const int ty = (t / grid_x) * kTile;
  reinterpret_cast<float2*>(out)[t * kPix + p] =
      make_float2(static_cast<float>(tx + p % kTile),
                  static_cast<float>(ty + p / kTile));
}

// ---- P2: row-wise inclusive scan ------------------------------------------
// One block per row, one thread per element: a warp scan by shuffles, then
// one shared-memory pass that scans the warp totals and adds them back.
__global__ void __launch_bounds__(1024)
row_cumsum_kernel(const float* __restrict__ in, float* __restrict__ out,
                  int cols) {
  __shared__ float warp_total[32];
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const size_t at = static_cast<size_t>(blockIdx.x) * cols + i;
  float v = in[at];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_total[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    float w = lane < n_warps ? warp_total[lane] : 0.0f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += u;
    }
    if (lane < n_warps) warp_total[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_total[warp - 1];
  out[at] = v;
}

// ---- P3: copies data[:, s:s+width] for starts read on the device ----------
// One block per start. The start is loaded from device memory by the block
// itself, so the copy's source is known only on the device; the rows go
// through shared memory by cp.async. Columns outside [0, cols) read as 0.
__global__ void __launch_bounds__(256)
offset_copy_kernel(const float* __restrict__ data,
                   const int* __restrict__ starts, float* __restrict__ out,
                   int rows, int cols, int width, int base_aligned16) {
  extern __shared__ float buf[];  // rows * width
  const int s = starts[blockIdx.x];
  const int n = rows * width;
  const bool vec = base_aligned16 && s >= 0 && s + width <= cols &&
                   ((s | cols | width) & 3) == 0;
  if (vec) {
    const int w4 = width >> 2;
    for (int q = threadIdx.x; q < rows * w4; q += blockDim.x) {
      const int r = q / w4;
      const int c = (q - r * w4) << 2;
      cp_async16(&buf[r * width + c],
                 data + static_cast<size_t>(r) * cols + s + c);
    }
  } else {
    for (int q = threadIdx.x; q < n; q += blockDim.x) {
      const int r = q / width;
      const int col = s + (q - r * width);
      if (col >= 0 && col < cols)
        cp_async4(&buf[q], data + static_cast<size_t>(r) * cols + col);
      else
        buf[q] = 0.0f;
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float* dst = out + static_cast<size_t>(blockIdx.x) * n;
  for (int q = threadIdx.x; q < n; q += blockDim.x) dst[q] = buf[q];
}

// ---- P4: alpha of every (pixel, pair) of a tile at the origin -------------
// d is (>= 6, n_pairs): rows mx, my, conic a, b, c, opacity. No skip mask.
__global__ void __launch_bounds__(256)
pair_alpha_kernel(const float* __restrict__ d, float* __restrict__ out,
                  int n_pairs) {
  const int p = blockIdx.x;
  const float fx = static_cast<float>(p % kTile);
  const float fy = static_cast<float>(p / kTile);
  for (int j = threadIdx.x; j < n_pairs; j += blockDim.x) {
    const float power =
        pair_power(fx, fy, d[j], d[n_pairs + j], d[2 * n_pairs + j],
                   d[3 * n_pairs + j], d[4 * n_pairs + j]);
    out[static_cast<size_t>(p) * n_pairs + j] =
        raw_alpha(power, d[5 * n_pairs + j]);
  }
}

// ---- D1: per-tile (pixel, pair) alpha of the tile's first 256 pairs -------
// Fields staged per lane: mx, my, a, b, c, op.
constexpr int kGeomFields = 6;

__device__ __forceinline__ void stage_geometry(
    float (*dst)[kChunk], int lane, int k, int count, int start,
    const int* __restrict__ ids, const float* __restrict__ means2d,
    const float* __restrict__ conics, const float* __restrict__ opacities) {
  if (k < count) {
    const size_t g = static_cast<size_t>(ids[start + k]);
    cp_async4(&dst[0][lane], means2d + 2 * g);
    cp_async4(&dst[1][lane], means2d + 2 * g + 1);
    cp_async4(&dst[2][lane], conics + 3 * g);
    cp_async4(&dst[3][lane], conics + 3 * g + 1);
    cp_async4(&dst[4][lane], conics + 3 * g + 2);
    cp_async4(&dst[5][lane], opacities + g);
  } else {
#pragma unroll
    for (int f = 0; f < kGeomFields; ++f) dst[f][lane] = 0.0f;
  }
}

// One block per tile, one thread per lane (pair): thread l walks the 256
// pixels of its tile and writes out[t, p, l], so a warp stores 32
// neighbouring floats. With kWalkAll the block streams every batch of 256
// pairs (up to kMaxBatches) through a two-stage cp.async ring, batch b + 1
// in flight while batch b is waited for, and keeps batch 0; without it, it
// stages batch 0 alone. Both write the same bits.
template <bool kWalkAll>
__global__ void __launch_bounds__(kChunk)
tile_alpha_kernel(const float* __restrict__ means2d,
                  const float* __restrict__ conics,
                  const float* __restrict__ opacities,
                  const int* __restrict__ ids, const int* __restrict__ starts,
                  const int* __restrict__ counts, float* __restrict__ out,
                  int grid_x) {
  __shared__ float ring[kWalkAll ? 2 : 1][kGeomFields][kChunk];
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int start = starts[t];
  const int count = counts[t];
  const float ox = static_cast<float>((t % grid_x) * kTile);
  const float oy = static_cast<float>((t / grid_x) * kTile);
  float* dst = out + static_cast<size_t>(t) * kPix * kChunk + lane;

  const int n_batches =
      kWalkAll ? min((count + kChunk - 1) / kChunk, kMaxBatches) : 1;
  if (n_batches > 0)
    stage_geometry(ring[0], lane, lane, count, start, ids, means2d, conics,
                   opacities);
  cp_async_commit();
  for (int b = 0; b < n_batches; ++b) {
    if constexpr (kWalkAll) {
      if (b + 1 < n_batches)
        stage_geometry(ring[(b + 1) & 1], lane, (b + 1) * kChunk + lane,
                       count, start, ids, means2d, conics, opacities);
    }
    cp_async_commit();  // possibly empty: keeps one group per batch
    cp_async_wait<1>();  // batch b has landed
    __syncthreads();
    if (b == 0) {
      const float mx = ring[0][0][lane], my = ring[0][1][lane];
      const float a = ring[0][2][lane], bb = ring[0][3][lane];
      const float c = ring[0][4][lane], op = ring[0][5][lane];
      const bool valid = lane < count;
      for (int p = 0; p < kPix; ++p) {
        const float fx = ox + static_cast<float>(p % kTile);
        const float fy = oy + static_cast<float>(p / kTile);
        dst[static_cast<size_t>(p) * kChunk] =
            masked_alpha(fx, fy, mx, my, a, bb, c, op, valid);
      }
    }
    __syncthreads();  // the slot read here is restaged two batches on
  }
  if (n_batches == 0)  // kWalkAll with an empty tile: every lane is masked
    for (int p = 0; p < kPix; ++p) dst[static_cast<size_t>(p) * kChunk] = 0.0f;
}

// ---- D2: one-batch blend of each tile --------------------------------------
// One block per tile. Thread l stages pair l of batch 0 (geometry, C
// colours and the raw depth, turned into 1/safe depth and safe depth after
// the copy lands); then thread p blends its pixel over the staged pairs in
// order; the block writes the (256, 256) result rows through shared memory.
template <int C>
__global__ void __launch_bounds__(kPix)
tile_blend_kernel(const float* __restrict__ means2d,
                  const float* __restrict__ conics,
                  const float* __restrict__ opacities,
                  const float* __restrict__ colors,
                  const float* __restrict__ depths,
                  const int* __restrict__ ids, const int* __restrict__ starts,
                  const int* __restrict__ counts, float* __restrict__ out,
                  int grid_x) {
  constexpr int NP = C + 2;  // payload: colours, inverse depth, depth
  __shared__ float f[kGeomFields + NP][kChunk];
  __shared__ float res[kPix][kBlendCols + 1];  // +1: no bank conflicts
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = starts[t];
  const int count = counts[t];

  stage_geometry(f, tid, tid, count, start, ids, means2d, conics, opacities);
  if (tid < count) {
    const size_t g = static_cast<size_t>(ids[start + tid]);
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      cp_async4(&f[kGeomFields + ch][tid], colors + g * C + ch);
    cp_async4(&f[kGeomFields + C + 1][tid], depths + g);
  } else {
#pragma unroll
    for (int ch = 0; ch < NP; ++ch) f[kGeomFields + ch][tid] = 0.0f;
  }
  cp_async_commit();
  cp_async_wait<0>();
  if (tid < count) {  // this thread's own copy has landed
    const float d = f[kGeomFields + C + 1][tid];
    const float sd = fabsf(d) <= FLT_MAX ? d : 1.0f;  // NaN/inf -> 1
    f[kGeomFields + C][tid] = 1.0f / sd;
    f[kGeomFields + C + 1][tid] = sd;
  }
  __syncthreads();

  const float fx = static_cast<float>((t % grid_x) * kTile + tid % kTile);
  const float fy = static_cast<float>((t / grid_x) * kTile + tid / kTile);
  const int m = min(count, kChunk);
  float acc[NP];
#pragma unroll
  for (int ch = 0; ch < NP; ++ch) acc[ch] = 0.0f;
  float s = 0.0f;  // log T: sum of log1p(-alpha) over the passing lanes
  int nc = 0;
  bool crossed = false;
  for (int j = 0; j < m; ++j) {
    const float alpha = masked_alpha(fx, fy, f[0][j], f[1][j], f[2][j],
                                     f[3][j], f[4][j], f[5][j], true);
    if (alpha == 0.0f) {  // log1p(-0) = 0: passes, adds nothing
      ++nc;
      continue;
    }
    const float s_incl = s + log1pf(-alpha);
    if (s_incl < kLogTEps) {  // this lane and every later one fail
      crossed = true;
      break;
    }
    const float w = alpha * expf(s);
#pragma unroll
    for (int ch = 0; ch < NP; ++ch) acc[ch] += w * f[kGeomFields + ch][j];
    s = s_incl;
    ++nc;
  }
  if (!crossed) nc += kChunk - m;  // masked lanes pass with alpha 0

#pragma unroll
  for (int ch = 0; ch < NP; ++ch) res[tid][ch] = acc[ch];
#pragma unroll
  for (int ch = NP; ch < 8; ++ch) res[tid][ch] = 0.0f;
  res[tid][8] = s;
  res[tid][9] = static_cast<float>(nc);
  __syncthreads();
  float* dst = out + static_cast<size_t>(t) * kPix * kChunk;
  for (int q = tid; q < kPix * kChunk; q += kPix) {
    const int p = q / kChunk;
    const int col = q - p * kChunk;
    dst[q] = col < kBlendCols ? res[p][col] : 0.0f;
  }
}

int launch_error() { return static_cast<int>(cudaGetLastError()); }

// does nothing: its time is the floor under P1-P4's
__global__ void empty_kernel() {}

}  // namespace

// One launch of an empty kernel (one warp), the launch floor of the probes.
extern "C" int probe_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return launch_error();
}

// Plain C entry points, bound with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for arguments it does
// not take).

extern "C" int probe_tile_coords(void* out, int n_tiles, int grid_x,
                                 void* stream) {
  if (n_tiles < 0 || grid_x <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return launch_error();
  tile_coords_kernel<<<n_tiles, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), grid_x);
  return launch_error();
}

extern "C" int probe_row_cumsum(const void* in, void* out, int rows, int cols,
                                void* stream) {
  if (rows < 0 || cols <= 0 || cols > 1024 || cols % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return launch_error();
  row_cumsum_kernel<<<rows, cols, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), cols);
  return launch_error();
}

extern "C" int probe_offset_copy(const void* data, const void* starts,
                                 void* out, int n_starts, int rows, int cols,
                                 int width, int base_aligned16,
                                 void* stream) {
  const size_t smem = static_cast<size_t>(rows) * width * sizeof(float);
  if (n_starts < 0 || rows <= 0 || cols <= 0 || width <= 0 ||
      smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_starts == 0) return launch_error();
  offset_copy_kernel<<<n_starts, 256, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int*>(starts),
      static_cast<float*>(out), rows, cols, width, base_aligned16);
  return launch_error();
}

extern "C" int probe_pair_alpha(const void* d, void* out, int n_pairs,
                                void* stream) {
  if (n_pairs <= 0) return static_cast<int>(cudaErrorInvalidValue);
  pair_alpha_kernel<<<kPix, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<float*>(out), n_pairs);
  return launch_error();
}

extern "C" int probe_tile_alpha(const void* means2d, const void* conics,
                                const void* opacities, const void* ids,
                                const void* starts, const void* counts,
                                void* out, int num_tiles, int grid_x,
                                int walk_all, void* stream) {
  if (num_tiles < 0 || grid_x <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return launch_error();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const float*>(means2d);
  const auto* c = static_cast<const float*>(conics);
  const auto* o = static_cast<const float*>(opacities);
  const auto* i = static_cast<const int*>(ids);
  const auto* st = static_cast<const int*>(starts);
  const auto* n = static_cast<const int*>(counts);
  auto* y = static_cast<float*>(out);
  if (walk_all)
    tile_alpha_kernel<true><<<num_tiles, kChunk, 0, s>>>(m, c, o, i, st, n,
                                                         y, grid_x);
  else
    tile_alpha_kernel<false><<<num_tiles, kChunk, 0, s>>>(m, c, o, i, st, n,
                                                          y, grid_x);
  return launch_error();
}

extern "C" int probe_tile_blend(const void* means2d, const void* conics,
                                const void* opacities, const void* colors,
                                const void* depths, const void* ids,
                                const void* starts, const void* counts,
                                void* out, int num_tiles, int channels,
                                int grid_x, void* stream) {
  if (num_tiles < 0 || grid_x <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return launch_error();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const float*>(means2d);
  const auto* c = static_cast<const float*>(conics);
  const auto* o = static_cast<const float*>(opacities);
  const auto* col = static_cast<const float*>(colors);
  const auto* d = static_cast<const float*>(depths);
  const auto* i = static_cast<const int*>(ids);
  const auto* st = static_cast<const int*>(starts);
  const auto* n = static_cast<const int*>(counts);
  auto* y = static_cast<float*>(out);
#define PROBE_BLEND_CASE(CH)                                                \
  case CH:                                                                  \
    tile_blend_kernel<CH><<<num_tiles, kPix, 0, s>>>(m, c, o, col, d, i, st, \
                                                     n, y, grid_x);         \
    break;
  switch (channels) {
    PROBE_BLEND_CASE(1)
    PROBE_BLEND_CASE(2)
    PROBE_BLEND_CASE(3)
    PROBE_BLEND_CASE(4)
    PROBE_BLEND_CASE(5)
    PROBE_BLEND_CASE(6)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PROBE_BLEND_CASE
  return launch_error();
}
