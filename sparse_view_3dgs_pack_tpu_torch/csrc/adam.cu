// Adam for Hopper (sm_90a): one step of every tensor of one optimizer
// call in one launch, the moments and the parameters updated in place.
//
// Replaces no TPU kernel: XLA fused the JAX package's `adam_update`
// (sparse_view_3dgs_pack_tpu/train/optim.py) into the jitted step. The
// port ran it as some 15 elementwise PyTorch launches a parameter group
// (the moments, the square root, two divisions, the copy back, three
// `torch.where`s under a visibility mask), each reading and writing whole
// tensors, after copying three host numbers to the card for the bias
// corrections. The plain version is `adam_update_torch` (and
// `exposure_adam_update_torch`) in train/optim.py.
//
// What bounds it on an H100: device memory. Each value is read once from
// p, g, m and v and written once to p, m and v: 28 B against 11 f32
// operations. At 3.35 TB/s a 6.1M-Gaussian model (360M values over six
// groups) takes 3.0 ms, a 3M one 1.5 ms.
//
// What the design does about it:
//  * One launch for every tensor of the call. The C entry packs a table of
//    each tensor's pointers, length, row width and learning rate into the
//    kernel's arguments (by value: nothing is copied to the card and
//    nothing waits), with the first block of each tensor. Each block takes
//    a fixed-size chunk of one tensor; the wrapper (ops/adam.py::plan)
//    plans the chunks.
//  * 16-byte loads and stores (float4) where the tensor's four pointers
//    are 16-B aligned, with a scalar tail; a view at an odd offset takes
//    the scalar path all through.
//  * The bias corrections 1 - b^t are computed in the kernel from the
//    integer step, as the plain version computes them on the card: powf on
//    float32 copies of b and t.
//  * Under the optional (N,) visibility mask, the rows outside it are
//    neither read nor written (sparse Adam): a float4 that straddles such
//    a row is done value by value.
//  * Rounding: compiled with --fmad=false (ops/_build.py), each expression
//    written in the plain version's order, the scalars the plain version's
//    Python floats rounded to float32, so each operation rounds as its
//    PyTorch counterpart does on the card (IEEE division and square root):
//    the result is the plain version's bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTensors = 48;    // keeps the table under 4 KB of arguments

struct Tensor {
  float* p;
  const float* g;
  float* m;
  float* v;
  int n;        // values
  int width;    // values a row (the mask's unit)
  int vec;      // p, g, m and v 16-B aligned
  float lr;
};

struct Table {
  Tensor t[kMaxTensors];
  int first[kMaxTensors + 1];   // each tensor's first block; [count]: all
  int count;
  int chunk;                    // values a block, a multiple of 4
};

struct Coeffs {
  float b1, c1, b2, c2, eps;   // β1, 1 - β1, β2, 1 - β2, ε as float32
  int step;                    // t, after this step's increment
  int square_first;            // v: c2·(g·g), else (c2·g)·g
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       float lr, float bc1, float bc2,
                                       const Coeffs& c) {
  m = c.b1 * m + c.c1 * g;
  v = c.b2 * v + (c.square_first ? c.c2 * (g * g) : (c.c2 * g) * g);
  p = p - lr * (m / bc1) / (sqrtf(v / bc2) + c.eps);
}

__device__ __forceinline__ void update_one(const Tensor& t, int e, float bc1,
                                           float bc2, const Coeffs& c) {
  float p = t.p[e], m = t.m[e], v = t.v[e];
  update(p, __ldg(t.g + e), m, v, t.lr, bc1, bc2, c);
  t.p[e] = p;
  t.m[e] = m;
  t.v[e] = v;
}

__device__ __forceinline__ bool visible(const unsigned char* mask,
                                        const Tensor& t, int e) {
  return mask == nullptr
         || mask[static_cast<unsigned>(e) / static_cast<unsigned>(t.width)];
}

__global__ void __launch_bounds__(kThreads)
    adam_kernel(const Table tab, const Coeffs c,
                const unsigned char* __restrict__ mask) {
  const int b = blockIdx.x;
  int i = 0;   // this block's tensor: the last whose first block is ≤ b
  while (i + 1 < tab.count && tab.first[i + 1] <= b) ++i;
  const Tensor& t = tab.t[i];
  const float bc1 = 1.0f - powf(c.b1, static_cast<float>(c.step));
  const float bc2 = 1.0f - powf(c.b2, static_cast<float>(c.step));
  const int start = (b - tab.first[i]) * tab.chunk;
  const int end = t.n - start < tab.chunk ? t.n : start + tab.chunk;
  int tail = start;
  if (t.vec) {
    tail = start + ((end - start) & ~3);
    for (int e = start + 4 * threadIdx.x; e < tail; e += 4 * kThreads) {
      unsigned vis = 0xfu;
      if (mask != nullptr) {
        vis = 0u;
        for (int k = 0; k < 4; ++k)
          vis |= visible(mask, t, e + k) ? 1u << k : 0u;
      }
      if (vis == 0xfu) {
        float4 p = *reinterpret_cast<const float4*>(t.p + e);
        const float4 g = __ldg(reinterpret_cast<const float4*>(t.g + e));
        float4 m = *reinterpret_cast<const float4*>(t.m + e);
        float4 v = *reinterpret_cast<const float4*>(t.v + e);
        update(p.x, g.x, m.x, v.x, t.lr, bc1, bc2, c);
        update(p.y, g.y, m.y, v.y, t.lr, bc1, bc2, c);
        update(p.z, g.z, m.z, v.z, t.lr, bc1, bc2, c);
        update(p.w, g.w, m.w, v.w, t.lr, bc1, bc2, c);
        *reinterpret_cast<float4*>(t.p + e) = p;
        *reinterpret_cast<float4*>(t.m + e) = m;
        *reinterpret_cast<float4*>(t.v + e) = v;
      } else {
        for (int k = 0; k < 4; ++k)
          if (vis >> k & 1u) update_one(t, e + k, bc1, bc2, c);
      }
    }
  }
  for (int e = tail + threadIdx.x; e < end; e += kThreads)
    if (visible(mask, t, e)) update_one(t, e, bc1, bc2, c);
}

}  // namespace

// One Adam step of `count` tensors. `ptrs`: p, g, m, v of each tensor in
// turn; `ints`: n, row width, 16-B aligned (0/1) of each; `lrs`: each
// tensor's learning rate; `first`: each tensor's first block, then the
// number of blocks; `chunk`: values a block; `mask`: (N,) bool or null.
extern "C" int adam_multi(int count, const unsigned long long* ptrs,
                          const int* ints, const float* lrs,
                          const int* first, int chunk, const void* mask,
                          int step, float b1, float c1, float b2, float c2,
                          float eps, int square_first, void* stream) {
  if (count < 1 || count > kMaxTensors || chunk < 4 || chunk % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Table tab{};
  for (int i = 0; i < count; ++i) {
    Tensor& t = tab.t[i];
    t.p = reinterpret_cast<float*>(ptrs[4 * i]);
    t.g = reinterpret_cast<const float*>(ptrs[4 * i + 1]);
    t.m = reinterpret_cast<float*>(ptrs[4 * i + 2]);
    t.v = reinterpret_cast<float*>(ptrs[4 * i + 3]);
    t.n = ints[3 * i];
    t.width = ints[3 * i + 1];
    t.vec = ints[3 * i + 2];
    t.lr = lrs[i];
  }
  for (int i = 0; i <= count; ++i) tab.first[i] = first[i];
  tab.count = count;
  tab.chunk = chunk;
  const Coeffs c{b1, c1, b2, c2, eps, step, square_first};
  const int blocks = first[count];
  if (blocks > 0)
    adam_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        tab, c, static_cast<const unsigned char*>(mask));
  return static_cast<int>(cudaGetLastError());
}
