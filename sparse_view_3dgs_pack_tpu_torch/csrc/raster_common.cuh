// What the tile rasterizer kernels (csrc/raster_fwd.cu, csrc/raster_bwd.cu)
// share: the constants of the blend, the per-(pair, pixel) evaluation (power,
// alpha and the skip test), the per-pair cull box that a warp tests its
// pixel rectangle against, that rectangle, and the cp.async helpers that
// stage pairs into shared memory.
//
// The cull box's plain version is `cull_box_torch` in ops/raster.py (the same
// arithmetic in the same order, no contracted multiply-adds); its constants
// are CULL_SLACK, CULL_MAX_SLACK, CULL_MARGIN and CULL_SPAN there.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace raster {

constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kLogTEps = -9.210340371976182f;  // logf(1e-4): the stop
constexpr float kCullSlack = 64.0f / 8388608.0f;  // 64 * 2^-23
constexpr float kCullMaxSlack = 0.25f;
constexpr float kCullMargin = 1.0f;
constexpr float kCullSpan = 65536.0f;

// One (pair, pixel) evaluation: power = -1/2 d^T Q d with d = pixel - mean,
// G = exp(min(power, 0)), alpha = min(0.99, op G); the pair is skipped
// where power > 0 or alpha < 1/255. The quadratic form is rounded term by
// term in the plain version's order, with no contracted multiply-add: for a
// thin Gaussian its terms cancel, and contracting them moved log T_final up
// to 2e-5 from the plain version's on the cull-stress frame (PERF.md).
struct Eval {
  float dx, dy, power, G, alpha_raw, alpha;
  bool skip;
};

__device__ __forceinline__ Eval eval_pair(float fx, float fy, float mx,
                                          float my, float a, float b,
                                          float c, float op) {
  Eval e;
  e.dx = fx - mx;
  e.dy = fy - my;
  e.power = __fsub_rn(
      __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(a, e.dx), e.dx),
                                 __fmul_rn(__fmul_rn(c, e.dy), e.dy))),
      __fmul_rn(__fmul_rn(b, e.dx), e.dy));
  e.G = expf(fminf(e.power, 0.0f));
  e.alpha_raw = op * e.G;
  e.alpha = fminf(kAlphaMax, e.alpha_raw);
  e.skip = e.power > 0.0f || e.alpha < kAlphaEps;
  return e;
}

// [x_lo, x_hi, y_lo, y_hi]: no pixel (x, y) with coordinates in
// [0, kCullSpan) outside the box passes the alpha >= 1/255 test.
// op exp(power) >= 1/255 <=> 1/2 d^T Q d <= t = ln(255 op), so
// |dx| <= sqrt(2t c / det), |dy| <= sqrt(2t a / det), det = ac - b^2. t is
// raised by 1e-5 and by 1 + 2 slack, slack = kCullSlack ac / det (the f32
// rounding of the quadratic form, whose terms reach 4 ac / det times its
// value as det -> 0), then one pixel of margin. Everything where it cannot
// say (an input NaN or inf, a <= 0, det <= 0, slack > kCullMaxSlack, a conic
// large enough to overflow the quadratic form); empty where op < 1/255.
__device__ __forceinline__ float4 cull_box(float mx, float my, float a,
                                           float b, float c, float op) {
  const float inf = __int_as_float(0x7f800000);
  const bool finite = isfinite(mx) && isfinite(my) && isfinite(a) &&
                      isfinite(b) && isfinite(c) && isfinite(op);
  if (finite && op < kAlphaEps) return make_float4(inf, -inf, inf, -inf);
  const float ac = __fmul_rn(a, c);
  const float det = __fsub_rn(ac, __fmul_rn(b, b));
  const float slack = __fmul_rn(kCullSlack, __fdiv_rn(ac, det));
  const float t =
      __fmul_rn(__fadd_rn(logf(__fmul_rn(255.0f, op)), 1e-5f),
                __fadd_rn(1.0f, __fmul_rn(2.0f, slack)));
  const float two_t = __fmul_rn(2.0f, t);
  const float rx = __fadd_rn(
      __fsqrt_rn(__fdiv_rn(__fmul_rn(two_t, c), det)), kCullMargin);
  const float ry = __fadd_rn(
      __fsqrt_rn(__fdiv_rn(__fmul_rn(two_t, a), det)), kCullMargin);
  const float span = __fadd_rn(__fadd_rn(fabsf(mx), fabsf(my)), kCullSpan);
  const float big =
      __fmul_rn(__fmul_rn(fmaxf(fmaxf(a, fabsf(b)), c), span), span);
  const bool sure = finite && a > 0.0f && det > 0.0f &&
                    slack <= kCullMaxSlack && big <= 1e37f;
  if (!sure) return make_float4(-inf, inf, -inf, inf);
  return make_float4(__fsub_rn(mx, rx), __fadd_rn(mx, rx),
                     __fsub_rn(my, ry), __fadd_rn(my, ry));
}

// The pixel rectangle [x0, x1, y0, y1] (inclusive, image coordinates) that
// holds the pixels of warp `w` of a tile tile_x wide with its origin at
// (ox, oy), thread t of the block covering column t % tile_x of the `pix`
// rows pix (t / tile_x) + i, i < pix (`warp_pixels` in ops/raster.py).
__device__ __forceinline__ float4 warp_rect(int w, int tile_x, int pix,
                                            int ox, int oy) {
  const int first = 32 * w, last = first + 31;
  const int r0 = first / tile_x, r1 = last / tile_x;
  const bool one_row = r0 == r1;
  const int x0 = one_row ? first % tile_x : 0;
  const int x1 = one_row ? last % tile_x : tile_x - 1;
  return make_float4(static_cast<float>(ox + x0), static_cast<float>(ox + x1),
                     static_cast<float>(oy + pix * r0),
                     static_cast<float>(oy + pix * r1 + pix - 1));
}

__device__ __forceinline__ bool rect_outside(float4 box, float4 rect) {
  return rect.y < box.x || rect.x > box.y || rect.w < box.z || rect.z > box.w;
}

// One 4-byte asynchronous copy from device to shared memory.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
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

}  // namespace raster
