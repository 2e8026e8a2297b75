// Backward tile rasterizer for Hopper (sm_90a): replays each tile's
// depth-sorted (tile, Gaussian) pairs back to front and writes every pair's
// gradient into the pair's own slot; a second kernel sums each Gaussian's
// slots in a fixed order. No atomics anywhere, so two runs on the same
// inputs give the same bits.
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
// What bounds it on an H100: instruction issue, not device memory (a pair's
// Gaussian is read once per tile, its gradient row written once). Per
// (warp, pair) the replay evaluates the quadratic form and one expf on
// every lane, and where a lane contributes also the transmittance, the
// gradients and their sum over the warp's 32 pixels: with a warp butterfly
// per pair, 5 shuffles for each of the C + 8 values. On the 800p training
// step most (warp, pair) replayed have a contributing lane, so the
// butterflies, the evaluation and the log-domain transmittance (log1pf,
// expf and a division per contributing pixel) shared the time (PERF.md).
//
// What the design does about it: one block per tile, each thread covering
// kPix = 2 pixels of a column (a warp: 16 x 4 pixels of a 16 x 16 tile), so
// that a warp's reduction and loop overhead serve twice the pixels. Per
// pixel the thread keeps its cotangent, T_final, n_contrib and two running
// values in registers: the product of 1 / (1 - alpha) over the
// contributing pairs replayed so far, so that T_j = T_final * product (one
// reciprocal per contributing pixel, which dL/dalpha reuses, instead of a
// log1pf, an expf and a division), and the suffix.
//  * Staging: batches of kBatch pairs, each pair's fields copied by
//    `cp.async` into a two-stage ring (batch b + 1 in flight while batch b
//    replays; sorted ids read one batch further ahead), then packed into
//    one 64-byte record per pair: geometry in two vector loads, payload
//    (colours, 1/depth, depth) in two more.
//  * Warp cull: when a pair is packed, one thread computes its cull box
//    (raster_common.cuh) and sets a bit for every warp whose pixel rectangle
//    it touches. A warp walks only the pairs with its bit set and below its
//    largest n_contrib: one uniform branch skips the evaluation, the
//    reduction and the partial-sum write of a pair it cannot see.
//  * Groups: a warp takes the next kGroup pairs it does not cull and
//    evaluates them on both pixels independently of one another (no branch
//    between them, so their latencies overlap), then runs the recurrence
//    over them; a pair's gradients from the two pixels are added in the
//    thread before the warp sums them.
//  * Reduce-scatter: each lane holds the group's gradients in registers,
//    then halving exchanges (xor 16, 8, ...) leave each set of
//    32 / kGroup lanes with one pair's partial sums and a short butterfly
//    finishes them: 6 shuffles per value for 4 pairs instead of 20. A
//    group where no lane contributes is skipped whole. The order of the
//    additions is fixed by lane and pair.
//  * Occupancy: each block size has an instantiation whose registers are
//    capped so that kSmWarps warps share an SM.
//  * Block sum: a warp's partial row for a pair goes to shared memory with
//    a flag; after the batch the block adds, in warp order, the rows of the
//    warps that wrote one, and writes every row of the batch (zeros too)
//    with coalesced stores. Rows past every pixel's n_contrib are written
//    as zeros at the end, so the caller allocates the pair buffer empty.
// The TPU structure (chunk-major 128-lane layout, DMA units, the head
// read-modify-write, pixel-monomial matmuls, split_dot) is not carried over,
// and neither is the slot mask of the padded pair buffer: pairs are sized
// exactly.
//
// The per-Gaussian reduction: one warp per Gaussian reads the Gaussian's
// pair slots (the binning's `gaussian_slots`, ascending slot order, run
// `gaussian_offsets[g]` .. `[g + 1]`) 32 at a time, loads those rows with
// all lanes into shared memory, and lane k adds column k row by row, so
// each sum is taken in slot order whatever the launch. Bound by bytes: each
// pair row is read once.
//
// The constants below were chosen by measuring each step of the design at
// 800p (PERF.md): the cull, groups of 4 pairs (2 and 8 were slower), the
// running product for T (the log domain was slower), 2 pixels per thread
// and 20 warps per SM.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "raster_common.cuh"

namespace {

using raster::cp_async4;
using raster::cp_async_commit;
using raster::cp_async_wait;
using raster::kAlphaMax;

constexpr int kMaxTilePixels = 512;
constexpr int kPix = 2;         // pixels per thread, consecutive rows
constexpr int kMaxThreads = kMaxTilePixels / kPix;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kBatch = 64;      // pairs staged per batch
constexpr int kGroup = 4;       // pairs per group and reduce-scatter
constexpr int kHalvings = 2;    // lg(kGroup): its halving exchanges
static_assert(1 << kHalvings == kGroup, "kHalvings is lg(kGroup)");
// warps per SM the launch bounds make room for (registers capped to fit)
constexpr int kSmWarps = 20;
constexpr int kRec = 16;     // packed record: mx my a b | c op - - | payload
constexpr unsigned kFullMask = 0xffffffffu;

template <int C>
struct Smem {
  static constexpr int kRaw = 6 + C + 1;  // mx my a b c op colours depth
  float raw[2][kBatch][kRaw];             // the cp.async ring
  float4 rec[kBatch][kRec / 4];           // packed pairs of this batch
  unsigned mask[kBatch];                  // warps that may see the pair
  unsigned char wrote[kMaxWarps][kBatch]; // warp w's partial row is valid
  float4 rect[kMaxWarps];                 // each warp's pixel rectangle
  int warp_max[kMaxWarps];                // each warp's largest n_contrib
};

template <int C, int kBlockThreads>
__global__ void __launch_bounds__(kBlockThreads,
                                  kSmWarps * 32 / kBlockThreads > 1
                                      ? kSmWarps * 32 / kBlockThreads
                                      : 1)
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
  constexpr int kRaw = Smem<C>::kRaw;
  static_assert(NP <= kRec - 8, "payload does not fit the packed record");
  __shared__ Smem<C> sm;
  extern __shared__ float s_part[];  // (warps, kBatch, K) partial rows

  const int n = blockDim.x;
  const int n_warps = n / 32;
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

  // per pixel: cotangent, T_final, n_contrib, and the running values
  float g[kPix][NP], fy[kPix], t_final[kPix], back[kPix];
  int nc[kPix];
  int m = 0;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int py = oy + kPix * (tid / tile_x) + i;
    fy[i] = static_cast<float>(py);
    float g_a = 0.0f, log_tf = 0.0f;
    nc[i] = 0;
#pragma unroll
    for (int ch = 0; ch < NP; ++ch) g[i][ch] = 0.0f;
    if (px < width && py < height) {
      const int pix = py * width + px;
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        g[i][ch] = g_color[static_cast<size_t>(pix) * C + ch];
      g[i][C] = g_invdepth[pix];
      g[i][C + 1] = g_depth[pix];
      g_a = g_alpha[pix];
      log_tf = log_t_final[pix];
      nc[i] = n_contrib[pix];
    }
    float g_bg = 0.0f;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) g_bg += g[i][ch] * bg[ch];
    t_final[i] = expf(log_tf);
    back[i] = t_final[i] * (g_bg - g_a);  // T_final (<g,bg> - g_a)
    m = max(m, nc[i]);
  }

  // the tile replays pairs [0, min(count, max n_contrib)) only; each warp
  // pairs below its own largest n_contrib
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(kFullMask, m, off));
  if (lane == 0) sm.warp_max[warp] = m;
  if (tid < n_warps)
    sm.rect[tid] = raster::warp_rect(tid, tile_x, kPix, ox, oy);
  __syncthreads();
  int end = 0;
  for (int w = 0; w < n_warps; ++w) end = max(end, sm.warp_max[w]);
  end = min(end, count);
  const int warp_end = min(sm.warp_max[warp], count);

  // batch b holds pairs [hi - nb, hi), hi = end - b * batch; thread
  // tid < nb stages pair hi - nb + tid
  const int batch = min(kBatch, n);
  const int n_batches = (end + batch - 1) / batch;
  auto batch_lo = [&](int b) { return max(end - (b + 1) * batch, 0); };
  auto batch_n = [&](int b) { return end - b * batch - batch_lo(b); };
  auto stage = [&](int b, int gid) {
    if (tid < batch_n(b)) {
      float* dst = sm.raw[b & 1][tid];
      const size_t q = static_cast<size_t>(gid);
      cp_async4(dst + 0, means2d + 2 * q);
      cp_async4(dst + 1, means2d + 2 * q + 1);
      cp_async4(dst + 2, conics + 3 * q);
      cp_async4(dst + 3, conics + 3 * q + 1);
      cp_async4(dst + 4, conics + 3 * q + 2);
      cp_async4(dst + 5, opacities + q);
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        cp_async4(dst + 6 + ch, colors + q * C + ch);
      cp_async4(dst + 6 + C, depths + q);
    }
    cp_async_commit();  // empty groups too: wait_group 1 means "b landed"
  };
  auto sorted_id = [&](int b) {
    return b < n_batches && tid < batch_n(b) ? ids[start + batch_lo(b) + tid]
                                             : 0;
  };
  if (n_batches > 0) stage(0, sorted_id(0));
  int next_gid = sorted_id(1);

  // T_j = T_final / prod_{i >= j} (1 - alpha_i) over contributing pairs:
  // `grow` is that product's inverse
  float grow[kPix];
  float suffix[kPix];  // sum of alpha T <g, payload> over pairs > j
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    grow[i] = 1.0f;
    suffix[i] = 0.0f;
  }

  for (int b = 0; b < n_batches; ++b) {
    const int lo = batch_lo(b);
    const int nb = batch_n(b);
    if (b + 1 < n_batches) {
      stage(b + 1, next_gid);
      next_gid = sorted_id(b + 2);
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();
    // batch b landed; the previous batch's records and partials are read
    __syncthreads();
    if (tid < nb) {
      const float* r = sm.raw[b & 1][tid];
      const float mx = r[0], my = r[1], a = r[2], bb = r[3], c = r[4],
                  op = r[5];
      const float d = r[6 + C];
      const float sd = fabsf(d) <= FLT_MAX ? d : 1.0f;  // NaN/inf -> 1
      float pay[kRec - 8];
#pragma unroll
      for (int ch = 0; ch < kRec - 8; ++ch)
        pay[ch] = ch < C ? r[6 + ch] : 0.0f;
      pay[C] = 1.0f / sd;
      pay[C + 1] = sd;
      sm.rec[tid][0] = make_float4(mx, my, a, bb);
      sm.rec[tid][1] = make_float4(c, op, 0.0f, 0.0f);
      sm.rec[tid][2] = make_float4(pay[0], pay[1], pay[2], pay[3]);
      sm.rec[tid][3] = make_float4(pay[4], pay[5], pay[6], pay[7]);
      unsigned mask = (1u << n_warps) - 1u;  // n_warps <= kMaxWarps = 8
      const float4 box = raster::cull_box(mx, my, a, bb, c, op);
      for (int w = 0; w < n_warps; ++w)
        if (raster::rect_outside(box, sm.rect[w])) mask &= ~(1u << w);
      sm.mask[tid] = mask;
    }
    for (int i = lane; i < batch; i += 32) sm.wrote[warp][i] = 0;
    __syncthreads();

    // this warp's replay of the batch, back to front, kGroup pairs at a time
    int jj = min(nb, warp_end - lo) - 1;
    while (jj >= 0) {
      // the group: the next kGroup pairs this warp does not cull (-1: none)
      int js[kGroup];
#pragma unroll
      for (int s = 0; s < kGroup; ++s) {
        while (jj >= 0 && !((sm.mask[jj] >> warp) & 1u)) --jj;
        js[s] = jj;
        if (jj >= 0) --jj;
      }
      if (js[0] < 0) break;
      // their evaluations on this thread's pixels, independent of one
      // another
      raster::Eval e[kGroup][kPix];
      bool live[kGroup][kPix];
#pragma unroll
      for (int s = 0; s < kGroup; ++s) {
        const int j = max(js[s], 0);
        const float4 g0 = sm.rec[j][0];
        const float4 g1 = sm.rec[j][1];
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          e[s][i] = raster::eval_pair(fx, fy[i], g0.x, g0.y, g0.z, g0.w,
                                      g1.x, g1.y);
          live[s][i] = js[s] >= 0 && lo + js[s] < nc[i] && !e[s][i].skip;
        }
      }
      // the recurrence over them, back to front, pixel by pixel
      float v[kGroup][6];     // geometry gradients of the group's pairs
      float wt[kGroup][kPix]; // their weights alpha T (payload: w g)
      bool any = false;
#pragma unroll
      for (int s = 0; s < kGroup; ++s) {
#pragma unroll
        for (int k = 0; k < 6; ++k) v[s][k] = 0.0f;
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          wt[s][i] = 0.0f;
          if (!live[s][i]) continue;
          any = true;
          const raster::Eval& ev = e[s][i];
          const float alpha = ev.alpha;
          const float inv_one_m = __frcp_rn(fmaxf(1.0f - alpha, 1e-6f));
          grow[i] *= inv_one_m;
          const float T = t_final[i] * grow[i];
          const float w = alpha * T;
          const float4* rec = sm.rec[js[s]];
          const float4 p0 = rec[2];
          const float4 p1 = rec[3];
          const float pay[8] = {p0.x, p0.y, p0.z, p0.w,
                                p1.x, p1.y, p1.z, p1.w};
          float gc = 0.0f;
#pragma unroll
          for (int ch = 0; ch < NP; ++ch) gc += g[i][ch] * pay[ch];
          const float dalpha = T * gc - (suffix[i] + back[i]) * inv_one_m;
          suffix[i] += w * gc;
          wt[s][i] = w;
          // zero gradient through the clamp
          if (ev.alpha_raw <= kAlphaMax) {
            const float4 g0 = rec[0];
            const float a = g0.z, bb = g0.w, c = rec[1].x;
            const float dx = ev.dx, dy = ev.dy;
            const float q = dalpha * alpha;  // dL/dpower
            v[s][0] += q * (a * dx + bb * dy);
            v[s][1] += q * (c * dy + bb * dx);
            v[s][2] += -0.5f * q * dx * dx;
            v[s][3] += -q * dx * dy;
            v[s][4] += -0.5f * q * dy * dy;
            v[s][5] += dalpha * ev.G;
          }
        }
      }
      if (!__any_sync(kFullMask, any)) continue;  // no lane contributes
      int my_jj = -1;  // lane s: the batch index of the group's pair s
#pragma unroll
      for (int s = 0; s < kGroup; ++s)
        if (lane == s) my_jj = js[s];

      // reduce-scatter: value k of slot s, summed over the warp's lanes
      auto value = [&](int s, int k) {
        if (k < 6) return v[s][k];
        float x = wt[s][0] * g[0][k - 6];
#pragma unroll
        for (int i = 1; i < kPix; ++i) x += wt[s][i] * g[i][k - 6];
        return x;
      };
      constexpr int kHalf0 = kGroup / 2;
      float r[kHalf0][K];
      {
        const bool upper = lane & 16;
#pragma unroll
        for (int i = 0; i < kHalf0; ++i) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float lo_v = value(i, k);
            const float hi_v = value(i + kHalf0, k);
            r[i][k] = (upper ? hi_v : lo_v) +
                      __shfl_xor_sync(kFullMask, upper ? lo_v : hi_v, 16);
          }
        }
      }
#pragma unroll
      for (int h = 1; h < kHalvings; ++h) {
        const int half = kGroup >> (h + 1);
        const int off = 16 >> h;
        const bool upper = lane & off;
#pragma unroll
        for (int i = 0; i < half; ++i) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float lo_v = r[i][k];
            const float hi_v = r[i + half][k];
            r[i][k] = (upper ? hi_v : lo_v) +
                      __shfl_xor_sync(kFullMask, upper ? lo_v : hi_v, off);
          }
        }
      }
#pragma unroll
      for (int off = 16 / kGroup; off > 0; off >>= 1) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          r[0][k] += __shfl_xor_sync(kFullMask, r[0][k], off);
      }
      // lanes [s * 32 / kGroup, (s + 1) * 32 / kGroup) now hold slot s
      constexpr int kSpan = 32 / kGroup;
      const int slot_jj = __shfl_sync(kFullMask, my_jj, lane / kSpan);
      if (lane % kSpan == 0 && slot_jj >= 0) {
        float* dst = s_part + (warp * kBatch + slot_jj) * K;
#pragma unroll
        for (int k = 0; k < K; ++k) dst[k] = r[0][k];
        sm.wrote[warp][slot_jj] = 1;
      }
    }
    __syncthreads();
    // sum the warps' partial rows in warp order; rows of the batch are
    // adjacent in out_pairs, and every one is written
    for (int e = tid; e < nb * K; e += n) {
      const int row = e / K;
      float s = 0.0f;
      for (int w = 0; w < n_warps; ++w)
        if (sm.wrote[w][row])
          s += s_part[(w * kBatch + row) * K + e - row * K];
      out_pairs[static_cast<size_t>(start + lo) * K + e] = s;
    }
  }
  // pairs no pixel replays (past every pixel's n_contrib)
  for (int e = tid; e < (count - end) * K; e += n)
    out_pairs[static_cast<size_t>(start + end) * K + e] = 0.0f;
}

constexpr int kSegWarps = 8;   // Gaussians per block of the segment sum
constexpr int kSegMaxK = 16;   // widest pair row it takes

__global__ void __launch_bounds__(kSegWarps * 32)
segment_sum_kernel(const float* __restrict__ pair_grads,
                   const int* __restrict__ slots,
                   const int* __restrict__ offsets, int num_gaussians, int k,
                   float* __restrict__ out) {
  __shared__ float s_rows[kSegWarps][32 * kSegMaxK];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = blockIdx.x * kSegWarps + warp;
  if (gid >= num_gaussians) return;  // whole warps: no block barrier below
  float* rows = s_rows[warp];
  const int o0 = offsets[gid];
  const int o1 = offsets[gid + 1];
  float s = 0.0f;  // column `lane`
  for (int base = o0; base < o1; base += 32) {
    const int m = min(32, o1 - base);
    const int slot = lane < m ? slots[base + lane] : 0;
    // the m rows, element e = (row e / k, column e % k), all lanes loading
    for (int e0 = 0; e0 < m * k; e0 += 32) {
      const int e = e0 + lane;
      const int row = min(e / k, 31);
      const int src = __shfl_sync(kFullMask, slot, row);
      if (e < m * k)
        rows[e] = pair_grads[static_cast<size_t>(src) * k + (e - row * k)];
    }
    __syncwarp();
    if (lane < k)
      for (int row = 0; row < m; ++row) s += rows[row * k + lane];
    __syncwarp();
  }
  if (lane < k) out[static_cast<size_t>(gid) * k + lane] = s;
}

// One tile per block, n / kPix threads: the instantiation for the block
// size whose launch bounds leave room for kSmWarps warps per SM.
template <int C, int kBlockThreads>
int launch_tiles(int num_tiles, int threads, cudaStream_t stream,
                 const float* means2d, const float* conics,
                 const float* opacities, const float* colors,
                 const float* depths, const int* ids, const int* starts,
                 const int* counts, const float* bg, const float* log_t_final,
                 const int* n_contrib, const float* g_color,
                 const float* g_invdepth, const float* g_depth,
                 const float* g_alpha, float* out_pairs, int width,
                 int height, int tile_x, int tile_y, int grid_x) {
  constexpr int K = C + 8;
  const size_t part =
      static_cast<size_t>(threads / 32) * kBatch * K * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      raster_bwd_kernel<C, kBlockThreads>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(part));
  if (err != cudaSuccess) return static_cast<int>(err);
  raster_bwd_kernel<C, kBlockThreads><<<num_tiles, threads, part, stream>>>(
      means2d, conics, opacities, colors, depths, ids, starts, counts, bg,
      log_t_final, n_contrib, g_color, g_invdepth, g_depth, g_alpha,
      out_pairs, width, height, tile_x, tile_y, grid_x);
  return static_cast<int>(cudaGetLastError());
}

template <int C, typename... Args>
int launch(int threads, Args... args) {
  return threads <= 128 ? launch_tiles<C, 128>(args...)
                        : launch_tiles<C, kMaxThreads>(args...);
}

}  // namespace

// Plain C entry points, bound with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for arguments it does
// not take). Every row of `out_pairs` is written.
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
  const int threads = n / kPix;
  if (n <= 0 || n > kMaxTilePixels || tile_y % kPix || threads % 32 ||
      num_tiles < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto i = [](const void* q) { return static_cast<const int*>(q); };
#define RASTER_BWD_CASE(CH)                                                   \
  case CH:                                                                    \
    return launch<CH>(threads, num_tiles, threads,                          \
                      static_cast<cudaStream_t>(stream),                      \
                      f(means2d), f(conics), f(opacities), f(colors),         \
                      f(depths), i(ids), i(starts), i(counts), f(bg),         \
                      f(log_t_final), i(n_contrib), f(g_color),               \
                      f(g_invdepth), f(g_depth), f(g_alpha),                  \
                      static_cast<float*>(out_pairs), width, height, tile_x,  \
                      tile_y, grid_x);
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
}

extern "C" int segment_sum(const void* pair_grads, const void* slots,
                           const void* offsets, int num_gaussians, int k,
                           void* out, void* stream) {
  if (num_gaussians < 0 || k <= 0 || k > kSegMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_gaussians == 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (num_gaussians + kSegWarps - 1) / kSegWarps;
  segment_sum_kernel<<<blocks, kSegWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pair_grads), static_cast<const int*>(slots),
      static_cast<const int*>(offsets), num_gaussians, k,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
