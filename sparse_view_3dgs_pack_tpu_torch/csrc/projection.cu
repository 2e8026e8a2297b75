// The per-Gaussian projection for Hopper (sm_90a), forward and backward:
// from the raw parameters (xyz, log scales, logit opacity, unnormalised
// quaternion, the SH features) to what the binning and the rasterizer
// read (means2d, depth, conic, colour, opacity, radius, binning rect), and
// from the gradients of those back to the raw parameters.
//
// Replaces no TPU kernel: XLA fused the JAX projection
// (sparse_view_3dgs_pack_tpu/ops/projection.py) into the jitted step. The
// port ran it as some 400 elementwise PyTorch launches forward and 770
// backward, each moving whole (P,) vectors through device memory, with
// every intermediate saved for autograd. The plain versions are
// `project_raw_torch` (the forward; autograd gives its backward) and
// `project_backward_torch` in ops/projection.py.
//
// What bounds it on an H100: device memory. Per Gaussian the forward reads
// 59 floats (xyz 3, log scales 3, opacity 1, quaternion 4, SH 48) and
// writes 13 (means2d 2, depth 1, conic 3, colour 3, opacity 1, radius 1,
// rect 2): 288 B against ~470 f32 operations. The backward reads the 59
// again and 10 cotangents and writes 59 gradients: 512 B against ~1,500
// operations. At 3.35 TB/s that is 0.26 + 0.46 ms for 3M Gaussians; the
// operations take a tenth of that.
//
// What the design does about it:
//  * One thread per Gaussian, all arithmetic in registers in f32, nothing
//    saved between the two kernels but the inputs: the backward recomputes
//    its Gaussian's forward (the same device function, so the same bits,
//    `valid` included) and writes the raw parameters' gradients directly.
//  * The 45-float SH rows (and their gradients) are 180 B apart and not
//    16-B aligned: a thread striding through its own row would touch a new
//    sector per float. Each warp stages its 32 rows through shared memory
//    with coalesced loads (stores, in the backward), rows padded to an odd
//    stride so that the threads' row reads fall in distinct banks.
//  * Rounding: compiled with --fmad=false (ops/_build.py), and every
//    expression written in the plain version's order, so each operation
//    rounds as its PyTorch counterpart does on the card (IEEE division and
//    square root, the same expf / logf); the 4x4 products and the two
//    norms (the quaternion's, the view direction's) sum in the order
//    cuBLAS and PyTorch's reductions take there. So the forward is the
//    plain version's bit for bit: the depths that the sort keys are made
//    of, and the ceil()s of the radius and of the binning rect, with them.
//    (Summed in their written order, 1% of the depths were an ulp off, 4
//    in a million ceil()s flipped, and a 1080p frame's tie-broken sort
//    moved a pixel by 0.065.)
//  * The cotangents are read with a row stride: the rasterizer's
//    per-Gaussian gradients arrive as column slices of one array.
//  * One instantiation per colour count (1, 3); the SH degree, precomputed
//    colours, an activated opacity in place of the logit and FSGS's
//    confidence are runtime arguments, uniform over the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;      // 4 warps; each stages its own 32 rows
constexpr int kCam = 35;           // viewmat 16, full_proj 16, centre 3
constexpr int kCull = 16;          // the reference's getRect tile
constexpr int kMaxRest = 15;       // SH coefficients above the DC one

// the plain version's constants, rounded from double as PyTorch rounds a
// Python float it meets in a float32 operation
#define F32(x) static_cast<float>(x)
// (utils/sh.py's C0, C1, C2, C3)
constexpr double kC0 = 0.28209479177387814;
constexpr double kC1 = 0.4886025119029199;
constexpr double kC2_0 = 1.0925484305920792, kC2_1 = -1.0925484305920792,
                 kC2_2 = 0.31539156525252005, kC2_3 = -1.0925484305920792,
                 kC2_4 = 0.5462742152960396;
constexpr double kC3_0 = -0.5900435899266435, kC3_1 = 2.890611442640554,
                 kC3_2 = -0.4570457994644658, kC3_3 = 0.3731763325901154,
                 kC3_4 = -0.4570457994644658, kC3_5 = 1.445305721320277,
                 kC3_6 = -0.5900435899266435;

struct Args {
  const float *xyz, *scaling, *opacity, *rotation, *f_dc, *f_rest,
      *colors_precomp, *confidence, *viewmat, *full_proj, *cam_center;
  int P, n_rest, sh_degree, width, height, opacity_activated, antialiasing;
  float focal_x, focal_y, lim_x, lim_y, scale_modifier;
};

struct FwdOut {
  float *means2d, *depths, *conics, *colors, *opacities;
  int *radii, *rect_radii;
};

struct Cotangents {
  const float *means2d, *depths, *conics, *colors, *opacities;
  long long s_means2d, s_depths, s_conics, s_colors, s_opacities;
};

struct BwdOut {
  float *xyz, *scaling, *opacity, *rotation, *f_dc, *f_rest, *colors_precomp;
};

// torch.clamp / maximum / minimum: NaN in, NaN out
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

// ops/binning.py::_trunc_clip: int32(clamp(v, -1, hi)) clipped to [0, hi]
__device__ __forceinline__ int trunc_clip(float v, int hi) {
  const int k = static_cast<int>(clamp(v, -1.f, static_cast<float>(hi)));
  return min(max(k, 0), hi);
}

// Everything of one Gaussian's forward that either kernel reads.
struct Geo {
  float s_exp[3], sig;                   // exp(log scales), sigmoid(logit)
  float m[3], s[3], q[4], op;            // after the confidence
  float pv[3], ph[4], pw, tz;
  bool in_front, valid;
  float ss, n, qn[4], R[3][3], sms[3], s2[3], cov[6];
  float rx, ry, cx, cy, tx, ty, iz, jx0, jx2, jy1, jy2;
  float t0[3], t1[3], St0[3], St1[3];
  float cxx, cxy, cyy, det_cov, cxd, cyd, det_dil, det_inv, ratio, h;
  float radius, means2d[2];
};

// (x, y, z, 1) . row, summed as cuBLAS sums the plain version's (P, 4) x
// (4, 4) product on an H100: x * row[0], then two fused multiply-adds,
// then + row[3] (bitwise on every row of 1M, PERF.md)
__device__ __forceinline__ float row_dot(const float* m, const float* row) {
  return __fmaf_rn(m[2], row[2], __fmaf_rn(m[1], row[1], m[0] * row[0])) +
         row[3];
}

// cov index of the symmetric (a, b): xx xy xz yy yz zz
__device__ __forceinline__ int sym(int a, int b) {
  const int lo = min(a, b), hi = max(a, b);
  return lo == 0 ? hi : (lo == 1 ? 2 + hi : 5);
}

__device__ __forceinline__ void geometry(const Args& a, const float* cam,
                                         long long i, Geo& g) {
  const float* V = cam;
  const float* F = cam + 16;
  for (int k = 0; k < 3; ++k) {
    g.m[k] = a.xyz[3 * i + k];
    g.s_exp[k] = expf(a.scaling[3 * i + k]);
    g.s[k] = g.s_exp[k];
  }
  for (int k = 0; k < 4; ++k) g.q[k] = a.rotation[4 * i + k];
  if (a.opacity_activated) {
    g.sig = 0.f;
    g.op = a.opacity[i];
  } else {
    g.sig = 1.f / (1.f + expf(-a.opacity[i]));
    g.op = g.sig;
  }
  if (a.confidence) {
    const float c = a.confidence[i], omc = 1.f - c;
    for (int k = 0; k < 3; ++k) {
      g.m[k] = g.m[k] * c + g.m[k] * omc;
      g.s[k] = g.s[k] * c + g.s[k] * omc;
    }
    for (int k = 0; k < 4; ++k) g.q[k] = g.q[k] * c + g.q[k] * omc;
    g.op = g.op * c + g.op * omc;
  }
  for (int r = 0; r < 3; ++r) g.pv[r] = row_dot(g.m, V + 4 * r);
  for (int r = 0; r < 4; ++r) g.ph[r] = row_dot(g.m, F + 4 * r);
  g.pw = 1.f / (g.ph[3] + F32(1e-7));
  g.in_front = g.pv[2] > F32(0.2);
  g.tz = g.in_front ? g.pv[2] : 1.f;

  // the 3D covariance (R S)(R S)^T of the normalised quaternion
  const float* q = g.q;
  g.ss = sqrtf((q[0] * q[0] + q[2] * q[2]) + (q[1] * q[1] + q[3] * q[3]) +
               F32(1e-24));
  g.n = clamp_min(g.ss, F32(1e-12));
  for (int k = 0; k < 4; ++k) g.qn[k] = q[k] / g.n;
  const float w = g.qn[0], qx = g.qn[1], qy = g.qn[2], qz = g.qn[3];
  g.R[0][0] = 1.f - 2.f * (qy * qy + qz * qz);
  g.R[0][1] = 2.f * (qx * qy - w * qz);
  g.R[0][2] = 2.f * (qx * qz + w * qy);
  g.R[1][0] = 2.f * (qx * qy + w * qz);
  g.R[1][1] = 1.f - 2.f * (qx * qx + qz * qz);
  g.R[1][2] = 2.f * (qy * qz - w * qx);
  g.R[2][0] = 2.f * (qx * qz - w * qy);
  g.R[2][1] = 2.f * (qy * qz + w * qx);
  g.R[2][2] = 1.f - 2.f * (qx * qx + qy * qy);
  for (int j = 0; j < 3; ++j) {
    g.sms[j] = a.scale_modifier * g.s[j];
    g.s2[j] = g.sms[j] * g.sms[j];
  }
  for (int ia = 0; ia < 3; ++ia)
    for (int ib = ia; ib < 3; ++ib)
      g.cov[sym(ia, ib)] = g.R[ia][0] * g.R[ib][0] * g.s2[0] +
                           g.R[ia][1] * g.R[ib][1] * g.s2[1] +
                           g.R[ia][2] * g.R[ib][2] * g.s2[2];

  // the EWA Jacobian, clamped to 1.3 tan_fov, and the 2D covariance
  g.rx = g.pv[0] / g.tz;
  g.ry = g.pv[1] / g.tz;
  g.cx = clamp(g.rx, -a.lim_x, a.lim_x);
  g.cy = clamp(g.ry, -a.lim_y, a.lim_y);
  g.tx = g.cx * g.tz;
  g.ty = g.cy * g.tz;
  g.iz = 1.f / g.tz;
  g.jx0 = a.focal_x * g.iz;
  g.jx2 = -a.focal_x * g.tx * g.iz * g.iz;
  g.jy1 = a.focal_y * g.iz;
  g.jy2 = -a.focal_y * g.ty * g.iz * g.iz;
  for (int k = 0; k < 3; ++k) {
    g.t0[k] = g.jx0 * V[k] + g.jx2 * V[8 + k];
    g.t1[k] = g.jy1 * V[4 + k] + g.jy2 * V[8 + k];
  }
  for (int r = 0; r < 3; ++r) {
    g.St0[r] = g.cov[sym(r, 0)] * g.t0[0] + g.cov[sym(r, 1)] * g.t0[1] +
               g.cov[sym(r, 2)] * g.t0[2];
    g.St1[r] = g.cov[sym(r, 0)] * g.t1[0] + g.cov[sym(r, 1)] * g.t1[1] +
               g.cov[sym(r, 2)] * g.t1[2];
  }
  g.cxx = g.t0[0] * g.St0[0] + g.t0[1] * g.St0[1] + g.t0[2] * g.St0[2];
  g.cxy = g.t0[0] * g.St1[0] + g.t0[1] * g.St1[1] + g.t0[2] * g.St1[2];
  g.cyy = g.t1[0] * g.St1[0] + g.t1[1] * g.St1[1] + g.t1[2] * g.St1[2];
  g.det_cov = g.cxx * g.cyy - g.cxy * g.cxy;
  g.cxd = g.cxx + F32(0.3);
  g.cyd = g.cyy + F32(0.3);
  g.det_dil = g.cxd * g.cyd - g.cxy * g.cxy;
  g.det_inv = 1.f / (g.det_dil == 0.f ? 1.f : g.det_dil);
  if (a.antialiasing) {
    g.ratio = g.det_cov / g.det_dil;
    g.h = sqrtf(clamp_min(g.ratio, F32(2.5e-5)));
  } else {
    g.ratio = 0.f;
    g.h = 1.f;
  }

  // the 3-sigma radius, the pixel centre and the tile-rect cull
  const float mid = 0.5f * (g.cxd + g.cyd);
  const float disc = sqrtf(clamp_min(mid * mid - g.det_dil, F32(0.1)));
  g.radius = ceilf(3.f * sqrtf(tmax(mid + disc, mid - disc)));
  g.means2d[0] = ((g.ph[0] * g.pw + 1.f) * a.width - 1.f) * 0.5f;
  g.means2d[1] = ((g.ph[1] * g.pw + 1.f) * a.height - 1.f) * 0.5f;
  const int gx = (a.width + kCull - 1) / kCull;
  const int gy = (a.height + kCull - 1) / kCull;
  const float tile = static_cast<float>(kCull);
  const int x0 = trunc_clip((g.means2d[0] - g.radius) / tile, gx);
  const int x1 = trunc_clip((g.means2d[0] + g.radius + tile - 1.f) / tile, gx);
  const int y0 = trunc_clip((g.means2d[1] - g.radius) / tile, gy);
  const int y1 = trunc_clip((g.means2d[1] + g.radius + tile - 1.f) / tile, gy);
  g.valid = g.in_front && g.det_dil != 0.f && (x1 - x0) * (y1 - y0) > 0;
}

// The SH basis of bands 1..3 at the unit direction (x, y, z), rounded as
// utils/sh.py::eval_sh rounds it (b[k - 1] multiplies coefficient k).
__device__ __forceinline__ void sh_values(int deg, float x, float y, float z,
                                          float* b) {
  b[0] = -(F32(kC1) * y);
  b[1] = F32(kC1) * z;
  b[2] = -(F32(kC1) * x);
  if (deg < 2) return;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  b[3] = F32(kC2_0) * xy;
  b[4] = F32(kC2_1) * yz;
  b[5] = F32(kC2_2) * (2.f * zz - xx - yy);
  b[6] = F32(kC2_3) * xz;
  b[7] = F32(kC2_4) * (xx - yy);
  if (deg < 3) return;
  b[8] = F32(kC3_0) * y * (3.f * xx - yy);
  b[9] = F32(kC3_1) * xy * z;
  b[10] = F32(kC3_2) * y * (4.f * zz - xx - yy);
  b[11] = F32(kC3_3) * z * (2.f * zz - 3.f * xx - 3.f * yy);
  b[12] = F32(kC3_4) * x * (4.f * zz - xx - yy);
  b[13] = F32(kC3_5) * z * (xx - yy);
  b[14] = F32(kC3_6) * x * (xx - 3.f * yy);
}

// d/d(direction) of sum_k w[k - 1] * b_k, bands 1..deg
__device__ __forceinline__ void sh_dir_grad(int deg, float x, float y,
                                            float z, const float* w,
                                            float* gd) {
  const float c1 = F32(kC1);
  gd[0] = -c1 * w[2];
  gd[1] = -c1 * w[0];
  gd[2] = c1 * w[1];
  if (deg < 2) return;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  float c;
  c = F32(kC2_0);
  gd[0] += w[3] * c * y;
  gd[1] += w[3] * c * x;
  c = F32(kC2_1);
  gd[1] += w[4] * c * z;
  gd[2] += w[4] * c * y;
  c = F32(kC2_2);
  gd[0] += w[5] * -2.f * c * x;
  gd[1] += w[5] * -2.f * c * y;
  gd[2] += w[5] * 4.f * c * z;
  c = F32(kC2_3);
  gd[0] += w[6] * c * z;
  gd[2] += w[6] * c * x;
  c = F32(kC2_4);
  gd[0] += w[7] * 2.f * c * x;
  gd[1] += w[7] * -2.f * c * y;
  if (deg < 3) return;
  c = F32(kC3_0);
  gd[0] += w[8] * 6.f * c * xy;
  gd[1] += w[8] * 3.f * c * (xx - yy);
  c = F32(kC3_1);
  gd[0] += w[9] * c * yz;
  gd[1] += w[9] * c * xz;
  gd[2] += w[9] * c * xy;
  c = F32(kC3_2);
  gd[0] += w[10] * -2.f * c * xy;
  gd[1] += w[10] * c * (4.f * zz - xx - 3.f * yy);
  gd[2] += w[10] * 8.f * c * yz;
  c = F32(kC3_3);
  gd[0] += w[11] * -6.f * c * xz;
  gd[1] += w[11] * -6.f * c * yz;
  gd[2] += w[11] * c * (6.f * zz - 3.f * xx - 3.f * yy);
  c = F32(kC3_4);
  gd[0] += w[12] * c * (4.f * zz - 3.f * xx - yy);
  gd[1] += w[12] * -2.f * c * xy;
  gd[2] += w[12] * 8.f * c * xz;
  c = F32(kC3_5);
  gd[0] += w[13] * 2.f * c * xz;
  gd[1] += w[13] * -2.f * c * yz;
  gd[2] += w[13] * c * (xx - yy);
  c = F32(kC3_6);
  gd[0] += w[14] * 3.f * c * (xx - yy);
  gd[1] += w[14] * -6.f * c * xy;
}

// The view direction from the camera centre, normalised as the plain
// version does (its norm clamped at 1e-12).
struct Dir {
  float d[3], norm, nrm, dn[3];
};

__device__ __forceinline__ void view_dir(const Geo& g, const float* cam,
                                         Dir& v) {
  for (int k = 0; k < 3; ++k) v.d[k] = g.m[k] - cam[32 + k];
  v.norm = sqrtf((v.d[0] * v.d[0] + v.d[2] * v.d[2]) + v.d[1] * v.d[1]);
  v.nrm = clamp_min(v.norm, F32(1e-12));
  for (int k = 0; k < 3; ++k) v.dn[k] = v.d[k] / v.nrm;
}

// The row stride of a warp's staged SH rows: odd, so that 32 threads
// reading their own rows at one offset hit 32 distinct banks.
__host__ __device__ __forceinline__ int row_stride(int len) {
  return len | 1;
}

// Copies the warp's `rows` rows of `len` floats from `src` into `dst`
// (stride `ld`), coalesced: consecutive lanes, consecutive floats.
__device__ __forceinline__ void stage_rows(const float* src, float* dst,
                                           int rows, int len, int ld,
                                           int lane) {
  const int n = rows * len;
  if (ld == len) {
    for (int k = lane; k < n; k += 32) dst[k] = src[k];
  } else {
    for (int k = lane; k < n; k += 32) dst[(k / len) * ld + k % len] = src[k];
  }
}

__device__ __forceinline__ void unstage_rows(const float* src, float* dst,
                                             int rows, int len, int ld,
                                             int lane) {
  const int n = rows * len;
  if (ld == len) {
    for (int k = lane; k < n; k += 32) dst[k] = src[k];
  } else {
    for (int k = lane; k < n; k += 32) dst[k] = src[(k / len) * ld + k % len];
  }
}

__device__ __forceinline__ void load_camera(const Args& a, float* cam) {
  if (threadIdx.x < 16) cam[threadIdx.x] = a.viewmat[threadIdx.x];
  else if (threadIdx.x < 32) cam[threadIdx.x] = a.full_proj[threadIdx.x - 16];
  else if (threadIdx.x < kCam) cam[threadIdx.x] = a.cam_center[threadIdx.x - 32];
  __syncthreads();
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    project_fwd_kernel(const Args a, const FwdOut o) {
  extern __shared__ float rows[];
  __shared__ float cam[kCam];
  load_camera(a, cam);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          warp * 32;
  const long long i = first + lane;
  const int len = a.n_rest * C, ld = row_stride(len);
  float* mine = rows + warp * 32 * ld;
  const bool sh = a.colors_precomp == nullptr;
  if (sh && a.sh_degree > 0 && first < a.P) {
    const int n = static_cast<int>(min(32LL, a.P - first));
    stage_rows(a.f_rest + first * len, mine, n, len, ld, lane);
    __syncwarp();
  }
  if (i >= a.P) return;

  Geo g;
  geometry(a, cam, i, g);
  o.means2d[2 * i] = g.means2d[0];
  o.means2d[2 * i + 1] = g.means2d[1];
  o.depths[i] = g.valid ? g.pv[2] : INFINITY;
  o.conics[3 * i] = g.cyd * g.det_inv;
  o.conics[3 * i + 1] = -g.cxy * g.det_inv;
  o.conics[3 * i + 2] = g.cxd * g.det_inv;

  if (sh) {
    const float cf = a.confidence ? a.confidence[i] : 1.f;
    const float omc = 1.f - cf;
    const auto coef = [&](float v) {
      return a.confidence ? v * cf + v * omc : v;
    };
    float val[C];
    for (int c = 0; c < C; ++c) val[c] = F32(kC0) * coef(a.f_dc[C * i + c]);
    if (a.sh_degree > 0) {
      Dir v;
      view_dir(g, cam, v);
      float b[kMaxRest];
      sh_values(a.sh_degree, v.dn[0], v.dn[1], v.dn[2], b);
      const int nb = (a.sh_degree + 1) * (a.sh_degree + 1) - 1;
      const float* row = mine + lane * ld;
#pragma unroll
      for (int k = 0; k < kMaxRest; ++k)
        if (k < nb)
#pragma unroll
          for (int c = 0; c < C; ++c)
            val[c] = val[c] + b[k] * coef(row[k * C + c]);
    }
    for (int c = 0; c < C; ++c)
      o.colors[C * i + c] = clamp_min(val[c] + 0.5f, 0.f);
  } else {
    for (int c = 0; c < C; ++c)
      o.colors[C * i + c] = a.colors_precomp[C * i + c];
  }

  const float op_final = g.valid ? g.op * g.h : 0.f;
  o.opacities[i] = op_final;
  const bool finite = isfinite(g.radius);
  o.radii[i] = (g.valid && finite)
                   ? static_cast<int>(tmin(g.radius, F32(1e7))) : 0;
  // the binning rect: the alpha >= 1/255 ellipse's box, within the radius
  const float two_l = 2.f * logf(clamp_min(op_final, F32(1e-12)) * 255.f);
  const float rxr = ceilf(sqrtf(clamp_min(two_l * g.cxd, 0.f))) + 1.f;
  const float ryr = ceilf(sqrtf(clamp_min(two_l * g.cyd, 0.f))) + 1.f;
  const float rect_x = tmin(g.radius, rxr), rect_y = tmin(g.radius, ryr);
  const bool keep = g.valid && op_final >= F32(1.0 / 255.0) && finite &&
                    isfinite(rect_x) && isfinite(rect_y);
  o.rect_radii[2 * i] = keep ? static_cast<int>(tmin(rect_x, F32(1e7))) : 0;
  o.rect_radii[2 * i + 1] =
      keep ? static_cast<int>(tmin(rect_y, F32(1e7))) : 0;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    project_bwd_kernel(const Args a, const Cotangents gin, const BwdOut o) {
  extern __shared__ float rows[];
  __shared__ float cam[kCam];
  load_camera(a, cam);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          warp * 32;
  if (first >= a.P) return;       // a warp past the last Gaussian
  const long long i = first + lane;
  const bool live = i < a.P;
  const int n_rows = static_cast<int>(min(32LL, a.P - first));
  const int len = a.n_rest * C, ld = row_stride(len);
  float* mine = rows + warp * 32 * ld;
  const bool sh = a.colors_precomp == nullptr;
  if (sh && len > 0) {
    if (a.sh_degree > 0)
      stage_rows(a.f_rest + first * len, mine, n_rows, len, ld, lane);
    __syncwarp();
  }

  if (live) {
    Geo g;
    geometry(a, cam, i, g);
    const float zero = 0.f;

    // means2d <- clip space
    const float g_px = gin.means2d[i * gin.s_means2d] * 0.5f * a.width;
    const float g_py = gin.means2d[i * gin.s_means2d + 1] * 0.5f * a.height;
    const float g_pw = g_px * g.ph[0] + g_py * g.ph[1];
    const float g_ph0 = g_px * g.pw, g_ph1 = g_py * g.pw;
    const float g_ph3 = -g_pw * (g.pw * g.pw);
    const float* V = cam;
    const float* F = cam + 16;
    float g_m[3];
    for (int k = 0; k < 3; ++k)
      g_m[k] = g_ph0 * F[k] + g_ph1 * F[4 + k] + g_ph3 * F[12 + k];

    // conics, opacities (and antialiasing's h), depths <- 2D covariance
    const float* gc = gin.conics + i * gin.s_conics;
    const float g_opa = gin.opacities[i * gin.s_opacities];
    float g_cyd = gc[0] * g.det_inv;
    float g_cxy = -(gc[1] * g.det_inv);
    float g_cxd = gc[2] * g.det_inv;
    const float g_det_inv = gc[0] * g.cyd - gc[1] * g.cxy + gc[2] * g.cxd;
    float g_det_dil =
        g.det_dil == 0.f ? zero : -g_det_inv * (g.det_inv * g.det_inv);
    float g_cxx = 0.f, g_cyy = 0.f;
    if (a.antialiasing) {
      const float g_h = g.valid ? g_opa * g.op : zero;
      const float g_ratio =
          g.ratio >= F32(2.5e-5) ? g_h / (2.f * g.h) : zero;
      const float g_det_cov = g_ratio / g.det_dil;
      g_det_dil = g_det_dil - g_ratio * (g.ratio / g.det_dil);
      g_cxx = g_det_cov * g.cyy;
      g_cyy = g_det_cov * g.cxx;
      g_cxy = g_cxy - 2.f * (g_det_cov * g.cxy);
    }
    float g_op = g.valid ? g_opa * g.h : zero;
    g_cxx = g_cxx + g_cxd + g_det_dil * g.cyd;
    g_cyy = g_cyy + g_cyd + g_det_dil * g.cxd;
    g_cxy = g_cxy - 2.f * (g_det_dil * g.cxy);

    // 2D covariance <- the Jacobian's rows and the 3D covariance
    float g_t0[3], g_t1[3], g_cov[6];
    for (int k = 0; k < 3; ++k) {
      g_t0[k] = 2.f * g_cxx * g.St0[k] + g_cxy * g.St1[k];
      g_t1[k] = 2.f * g_cyy * g.St1[k] + g_cxy * g.St0[k];
    }
    for (int ia = 0; ia < 3; ++ia)
      for (int ib = ia; ib < 3; ++ib)
        g_cov[sym(ia, ib)] =
            ia == ib ? g_cxx * g.t0[ia] * g.t0[ia] +
                           g_cxy * g.t0[ia] * g.t1[ia] +
                           g_cyy * g.t1[ia] * g.t1[ia]
                     : 2.f * g_cxx * g.t0[ia] * g.t0[ib] +
                           g_cxy * (g.t0[ia] * g.t1[ib] +
                                    g.t0[ib] * g.t1[ia]) +
                           2.f * g_cyy * g.t1[ia] * g.t1[ib];

    // the Jacobian <- camera space (the clamp passes x, y inside it)
    const float g_jx0 = g_t0[0] * V[0] + g_t0[1] * V[1] + g_t0[2] * V[2];
    const float g_jx2 = g_t0[0] * V[8] + g_t0[1] * V[9] + g_t0[2] * V[10];
    const float g_jy1 = g_t1[0] * V[4] + g_t1[1] * V[5] + g_t1[2] * V[6];
    const float g_jy2 = g_t1[0] * V[8] + g_t1[1] * V[9] + g_t1[2] * V[10];
    const float g_iz = g_jx0 * a.focal_x + g_jy1 * a.focal_y +
                       2.f * g_jx2 * (-a.focal_x * g.tx) * g.iz +
                       2.f * g_jy2 * (-a.focal_y * g.ty) * g.iz;
    const float g_tx = g_jx2 * (-a.focal_x) * g.iz * g.iz;
    const float g_ty = g_jy2 * (-a.focal_y) * g.iz * g.iz;
    float g_tz = -g_iz * (g.iz * g.iz) + g_tx * g.cx + g_ty * g.cy;
    const float g_rx =
        (g.rx >= -a.lim_x && g.rx <= a.lim_x) ? g_tx * g.tz : zero;
    const float g_ry =
        (g.ry >= -a.lim_y && g.ry <= a.lim_y) ? g_ty * g.tz : zero;
    float g_pv[3] = {g_rx / g.tz, g_ry / g.tz,
                     g.valid ? gin.depths[i * gin.s_depths] : zero};
    g_tz = g_tz - g_rx * (g.rx / g.tz) - g_ry * (g.ry / g.tz);
    g_pv[2] = g_pv[2] + (g.in_front ? g_tz : zero);
    for (int k = 0; k < 3; ++k)
      g_m[k] = g_m[k] + g_pv[0] * V[k] + g_pv[1] * V[4 + k] +
               g_pv[2] * V[8 + k];

    // the 3D covariance <- scales and the rotation
    float g_s[3], G[3][3];
    for (int j = 0; j < 3; ++j) {
      float acc = 0.f;
      for (int ia = 0; ia < 3; ++ia)
        for (int ib = ia; ib < 3; ++ib)
          acc = acc + g_cov[sym(ia, ib)] * g.R[ia][j] * g.R[ib][j];
      g_s[j] = acc * 2.f * g.sms[j] * a.scale_modifier;
    }
    for (int ia = 0; ia < 3; ++ia) {
      float M[3];
      for (int ib = 0; ib < 3; ++ib)
        M[ib] = ia == ib ? 2.f * g_cov[sym(ia, ia)] : g_cov[sym(ia, ib)];
      for (int j = 0; j < 3; ++j)
        G[ia][j] = g.s2[j] * (M[0] * g.R[0][j] + M[1] * g.R[1][j] +
                              M[2] * g.R[2][j]);
    }
    const float w = g.qn[0], x = g.qn[1], y = g.qn[2], z = g.qn[3];
    float g_qn[4];
    g_qn[0] = 2.f * (-z * G[0][1] + y * G[0][2] + z * G[1][0] -
                     x * G[1][2] - y * G[2][0] + x * G[2][1]);
    g_qn[1] = -4.f * x * (G[1][1] + G[2][2]) +
              2.f * (y * (G[0][1] + G[1][0]) + z * (G[0][2] + G[2][0]) +
                     w * (G[2][1] - G[1][2]));
    g_qn[2] = -4.f * y * (G[0][0] + G[2][2]) +
              2.f * (x * (G[0][1] + G[1][0]) + w * (G[0][2] - G[2][0]) +
                     z * (G[1][2] + G[2][1]));
    g_qn[3] = -4.f * z * (G[0][0] + G[1][1]) +
              2.f * (w * (G[1][0] - G[0][1]) + x * (G[0][2] + G[2][0]) +
                     y * (G[1][2] + G[2][1]));
    const float dot =
        g_qn[0] * w + g_qn[1] * x + g_qn[2] * y + g_qn[3] * z;
    const float g_ss = g.ss >= F32(1e-12) ? -dot / g.n : zero;
    float g_q[4];
    for (int k = 0; k < 4; ++k) g_q[k] = g_qn[k] / g.n + g.q[k] * (g_ss / g.ss);

    // colours: the SH coefficients and the view direction
    const float cf = a.confidence ? a.confidence[i] : 1.f;
    const float* gcol = gin.colors + i * gin.s_colors;
    if (sh) {
      const float omc = 1.f - cf;
      const auto coef = [&](float v) {
        return a.confidence ? v * cf + v * omc : v;
      };
      const auto scaled = [&](float v) { return a.confidence ? v * cf : v; };
      float val[C], g_v[C];
      for (int c = 0; c < C; ++c) val[c] = F32(kC0) * coef(a.f_dc[C * i + c]);
      float* row = mine + lane * ld;
      if (a.sh_degree > 0) {
        Dir v;
        view_dir(g, cam, v);
        float b[kMaxRest], wk[kMaxRest];
        sh_values(a.sh_degree, v.dn[0], v.dn[1], v.dn[2], b);
        const int nb = (a.sh_degree + 1) * (a.sh_degree + 1) - 1;
#pragma unroll
        for (int k = 0; k < kMaxRest; ++k)
          if (k < nb)
#pragma unroll
            for (int c = 0; c < C; ++c)
              val[c] = val[c] + b[k] * coef(row[k * C + c]);
#pragma unroll
        for (int c = 0; c < C; ++c)
          g_v[c] = val[c] + 0.5f >= 0.f ? gcol[c] : zero;
#pragma unroll
        for (int k = 0; k < kMaxRest; ++k) {
          float acc = 0.f;
          if (k < nb) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
              acc = acc + g_v[c] * coef(row[k * C + c]);
              row[k * C + c] = scaled(b[k] * g_v[c]);   // own row: in place
            }
          }
          wk[k] = acc;
        }
        for (int k = nb * C; k < len; ++k) row[k] = 0.f;
        float g_dn[3];
        sh_dir_grad(a.sh_degree, v.dn[0], v.dn[1], v.dn[2], wk, g_dn);
        const float g_dot =
            g_dn[0] * v.dn[0] + g_dn[1] * v.dn[1] + g_dn[2] * v.dn[2];
        const float g_nrm = v.norm >= F32(1e-12) ? -g_dot / v.nrm : zero;
        const float g_norm = v.norm != 0.f ? g_nrm / v.norm : zero;
        for (int k = 0; k < 3; ++k)
          g_m[k] = g_m[k] + g_dn[k] / v.nrm + g_norm * v.d[k];
      } else {
        for (int c = 0; c < C; ++c)
          g_v[c] = val[c] + 0.5f >= 0.f ? gcol[c] : zero;
        for (int k = 0; k < len; ++k) row[k] = 0.f;
      }
      for (int c = 0; c < C; ++c)
        o.f_dc[C * i + c] = scaled(F32(kC0) * g_v[c]);
    } else {
      for (int c = 0; c < C; ++c) o.colors_precomp[C * i + c] = gcol[c];
    }

    if (a.confidence) {
      for (int k = 0; k < 3; ++k) {
        g_m[k] = g_m[k] * cf;
        g_s[k] = g_s[k] * cf;
      }
      for (int k = 0; k < 4; ++k) g_q[k] = g_q[k] * cf;
      g_op = g_op * cf;
    }
    for (int k = 0; k < 3; ++k) {
      o.xyz[3 * i + k] = g_m[k];
      o.scaling[3 * i + k] = g_s[k] * g.s_exp[k];
    }
    for (int k = 0; k < 4; ++k) o.rotation[4 * i + k] = g_q[k];
    o.opacity[i] =
        a.opacity_activated ? g_op : g_op * (1.f - g.sig) * g.sig;
  }
  if (sh && len > 0) {
    __syncwarp();
    unstage_rows(mine, o.f_rest + first * len, n_rows, len, ld, lane);
  }
}

template <int C>
int launch_fwd(const Args& a, const FwdOut& o, cudaStream_t stream) {
  const int blocks = (a.P + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * kThreads * row_stride(a.n_rest * C);
  project_fwd_kernel<C><<<blocks, kThreads, smem, stream>>>(a, o);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_bwd(const Args& a, const Cotangents& g, const BwdOut& o,
               cudaStream_t stream) {
  const int blocks = (a.P + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * kThreads * row_stride(a.n_rest * C);
  project_bwd_kernel<C><<<blocks, kThreads, smem, stream>>>(a, g, o);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* xyz, const void* scaling, const void* opacity,
               const void* rotation, const void* f_dc, const void* f_rest,
               const void* colors_precomp, const void* confidence,
               const void* viewmat, const void* full_proj,
               const void* cam_center, int P, int n_rest, int sh_degree,
               int width, int height, int opacity_activated,
               int antialiasing, float focal_x, float focal_y, float lim_x,
               float lim_y, float scale_modifier) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  return Args{f(xyz), f(scaling), f(opacity), f(rotation), f(f_dc),
              f(f_rest), f(colors_precomp), f(confidence), f(viewmat),
              f(full_proj), f(cam_center), P, n_rest, sh_degree, width,
              height, opacity_activated, antialiasing, focal_x, focal_y,
              lim_x, lim_y, scale_modifier};
}

bool bad_shape(int P, int channels, int n_rest, int sh_degree) {
  return P < 0 || (channels != 1 && channels != 3) || n_rest < 0 ||
         n_rest > kMaxRest || sh_degree < 0 || sh_degree > 3;
}

}  // namespace

extern "C" int project_fwd(
    const void* xyz, const void* scaling, const void* opacity,
    const void* rotation, const void* f_dc, const void* f_rest,
    const void* colors_precomp, const void* confidence, const void* viewmat,
    const void* full_proj, const void* cam_center, void* means2d,
    void* depths, void* conics, void* colors, void* opacities, void* radii,
    void* rect_radii, int P, int channels, int n_rest, int sh_degree,
    int width, int height, int opacity_activated, int antialiasing,
    float focal_x, float focal_y, float lim_x, float lim_y,
    float scale_modifier, void* stream) {
  if (bad_shape(P, channels, n_rest, sh_degree))
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return static_cast<int>(cudaGetLastError());
  const Args a = make_args(xyz, scaling, opacity, rotation, f_dc, f_rest,
                           colors_precomp, confidence, viewmat, full_proj,
                           cam_center, P, n_rest, sh_degree, width, height,
                           opacity_activated, antialiasing, focal_x, focal_y,
                           lim_x, lim_y, scale_modifier);
  const FwdOut o{static_cast<float*>(means2d), static_cast<float*>(depths),
                 static_cast<float*>(conics), static_cast<float*>(colors),
                 static_cast<float*>(opacities), static_cast<int*>(radii),
                 static_cast<int*>(rect_radii)};
  const auto s = static_cast<cudaStream_t>(stream);
  return channels == 1 ? launch_fwd<1>(a, o, s) : launch_fwd<3>(a, o, s);
}

extern "C" int project_bwd(
    const void* xyz, const void* scaling, const void* opacity,
    const void* rotation, const void* f_dc, const void* f_rest,
    const void* colors_precomp, const void* confidence, const void* viewmat,
    const void* full_proj, const void* cam_center, const void* g_means2d,
    const void* g_depths, const void* g_conics, const void* g_colors,
    const void* g_opacities, void* d_xyz, void* d_scaling, void* d_opacity,
    void* d_rotation, void* d_f_dc, void* d_f_rest, void* d_colors_precomp,
    int P, int channels, int n_rest, int sh_degree, int width, int height,
    int opacity_activated, int antialiasing, int s_means2d, int s_depths,
    int s_conics, int s_colors, int s_opacities, float focal_x,
    float focal_y, float lim_x, float lim_y, float scale_modifier,
    void* stream) {
  if (bad_shape(P, channels, n_rest, sh_degree))
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return static_cast<int>(cudaGetLastError());
  const Args a = make_args(xyz, scaling, opacity, rotation, f_dc, f_rest,
                           colors_precomp, confidence, viewmat, full_proj,
                           cam_center, P, n_rest, sh_degree, width, height,
                           opacity_activated, antialiasing, focal_x, focal_y,
                           lim_x, lim_y, scale_modifier);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const Cotangents g{f(g_means2d), f(g_depths), f(g_conics), f(g_colors),
                     f(g_opacities), s_means2d, s_depths, s_conics,
                     s_colors, s_opacities};
  const auto w = [](void* p) { return static_cast<float*>(p); };
  const BwdOut o{w(d_xyz), w(d_scaling), w(d_opacity), w(d_rotation),
                 w(d_f_dc), w(d_f_rest), w(d_colors_precomp)};
  const auto s = static_cast<cudaStream_t>(stream);
  return channels == 1 ? launch_bwd<1>(a, g, o, s)
                       : launch_bwd<3>(a, g, o, s);
}
