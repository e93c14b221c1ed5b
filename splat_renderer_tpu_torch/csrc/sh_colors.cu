// SH lighting, hand-written for Hopper (sm_90a): one thread a splat
// computes what render/sh.py::apply_sh_plain computes as some 150 plane
// operations over the whole set: the camera -> splat direction, its
// reciprocal length, the real SH basis of bands 1..degree, the channels'
// sums over the coefficient rows and the clip into [0, 1].
//
// Replaces no TPU kernel: the JAX package's apply_sh
// (splat_renderer_tpu/render/sh.py) is plain jnp, which XLA fuses into one
// program.  PyTorch runs the same plane operations one launch at a time,
// and issuing them took the host about 1.7 ms a frame at 1M splats while
// the device waited; this kernel is one launch.
//
// What bounds it on the H100: bytes.  At degree 3 a splat reads 6 float32
// planes and 45 coefficients (204 B) and writes 3 colours (12 B): 216 MB at
// 1M splats, 65 us at 3.35 TB/s.  Its ~140 flops and one reciprocal square
// root are far below the FP32 rate.
// Design: one thread a splat (grid-stride), neighbouring threads on
// neighbouring splats, so every plane's and every coefficient row's loads
// coalesce whatever the element stride, and the stores coalesce.  At 40
// registers a thread (ptxas: degree 3; 32 for 1 and 2) six blocks fit on
// an SM, and their independent loads keep HBM busy.  Every input is read in
// place at its own strides (the modeler's columns of (N, 3) tensors, the
// rows of one (3, R, N) coefficient tensor, a camera that is a view of a
// (V, 3) tensor), so nothing is copied and nothing waits on the host.  The
// degree is a compile-time instantiation (1, 2, 3), so a call that
// truncates the bands evaluates exactly the plain path's rows.
//
// Bit-equal to the plain path on the card: the same operations in the same
// order, each rounded once (the library is built with -fmad=false and
// without fast math): the squared length summed left to right plus its
// floor, rsqrtf as torch.rsqrt calls it for float32, each basis plane as
// sh_basis_planes builds it (a Python scalar times a plane first, then the
// products and differences left to right), then c = c + b_k * coeff_k in
// band order and torch's NaN-propagating maximum and minimum for the clip.
// The Python scalars are rounded to float32 by the wrapper, as PyTorch
// rounds a scalar against a float32 tensor.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// enough blocks to fill the card several times over; the grid-stride loop
// takes the rest
constexpr long long kMaxBlocks = 8192;
constexpr int kPlanes = 6;
enum Plane { kPx, kPy, kPz, kCr, kCg, kCb };

struct Planes {
  const float* p[kPlanes];
  long long stride[kPlanes];  // in elements
};

// channel ch's coefficient k of splat i at c[ch][k * row[ch] + i * col[ch]]
struct Coeffs {
  const float* c[3];
  long long row[3], col[3];
};

// the plain path's Python scalars as float32, in the wrapper's order
struct Consts {
  float c1_neg, c1;  // -SH_C1, SH_C1
  float c2[5];       // SH_C2
  float c3[7];       // SH_C3
  float floor;       // the squared length's floor (1e-20)
};

// torch.maximum / torch.minimum: a NaN operand comes out as it went in
__device__ __forceinline__ float t_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float t_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

template <int DEGREE>
__global__ void __launch_bounds__(kThreads)
sh_colors_kernel(Planes in, Coeffs co, const float* __restrict__ cam, long long cam_stride,
                 Consts k, float* __restrict__ out, long long n) {
  constexpr int R = DEGREE == 1 ? 3 : (DEGREE == 2 ? 8 : 15);
  const float cam0 = cam[0], cam1 = cam[cam_stride], cam2 = cam[2 * cam_stride];
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += step) {
    const float dx = __ldg(in.p[kPx] + i * in.stride[kPx]) - cam0;
    const float dy = __ldg(in.p[kPy] + i * in.stride[kPy]) - cam1;
    const float dz = __ldg(in.p[kPz] + i * in.stride[kPz]) - cam2;
    const float inv = rsqrtf(dx * dx + dy * dy + dz * dz + k.floor);
    const float x = dx * inv, y = dy * inv, z = dz * inv;

    // ---- sh_basis_planes ----
    float b[R];
    b[0] = k.c1_neg * y;
    b[1] = k.c1 * z;
    b[2] = k.c1_neg * x;
    if constexpr (DEGREE >= 2) {
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      b[3] = k.c2[0] * xy;
      b[4] = k.c2[1] * yz;
      b[5] = k.c2[2] * (2.0f * zz - xx - yy);
      b[6] = k.c2[3] * xz;
      b[7] = k.c2[4] * (xx - yy);
      if constexpr (DEGREE >= 3) {
        b[8] = k.c3[0] * y * (3.0f * xx - yy);
        b[9] = k.c3[1] * xy * z;
        b[10] = k.c3[2] * y * (4.0f * zz - xx - yy);
        b[11] = k.c3[3] * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
        b[12] = k.c3[4] * x * (4.0f * zz - xx - yy);
        b[13] = k.c3[5] * z * (xx - yy);
        b[14] = k.c3[6] * x * (xx - 3.0f * yy);
      }
    }

    // ---- each channel: base + sum_k b_k * coeff_k in band order, clipped ----
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float* c = co.c[ch] + i * co.col[ch];
      float v = __ldg(in.p[kCr + ch] + i * in.stride[kCr + ch]);
#pragma unroll
      for (int j = 0; j < R; ++j) v = v + b[j] * __ldg(c + j * co.row[ch]);
      out[ch * n + i] = t_min(t_max(v, 0.0f), 1.0f);
    }
  }
}

template <int DEGREE>
int launch(const Planes& in, const Coeffs& co, const float* cam, long long cam_stride,
           const Consts& k, float* out, long long n, cudaStream_t stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  sh_colors_kernel<DEGREE><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      in, co, cam, cam_stride, k, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch on `stream` over n splats.  inputs: px py pz cr cg cb, then
// the r, g, b coefficient tensors (9 pointers); strides: the six planes'
// element strides, then each coefficient tensor's (row, element) strides
// (12 values); cam_pos: (3,) with its stride; consts: the Consts fields in
// order (15 floats); out: (3, n) contiguous float32, the lit cr, cg, cb
// rows.
// degree: 1, 2 or 3, the bands evaluated (each coefficient tensor holds at
// least that degree's rows).  Returns the CUDA error code of the launch (0
// for n == 0, which launches nothing).
extern "C" int sh_colors_forward(const float* const* inputs, const long long* strides,
                                 const float* cam_pos, long long cam_stride,
                                 const float* consts, float* out, long long n, int degree,
                                 void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Planes in;
  for (int p = 0; p < kPlanes; ++p) {
    in.p[p] = inputs[p];
    in.stride[p] = strides[p];
  }
  Coeffs co;
  for (int ch = 0; ch < 3; ++ch) {
    co.c[ch] = inputs[kPlanes + ch];
    co.row[ch] = strides[kPlanes + 2 * ch];
    co.col[ch] = strides[kPlanes + 2 * ch + 1];
  }
  Consts k;
  k.c1_neg = consts[0];
  k.c1 = consts[1];
  for (int j = 0; j < 5; ++j) k.c2[j] = consts[2 + j];
  for (int j = 0; j < 7; ++j) k.c3[j] = consts[7 + j];
  k.floor = consts[14];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case 1: return launch<1>(in, co, cam_pos, cam_stride, k, out, n, st);
    case 2: return launch<2>(in, co, cam_pos, cam_stride, k, out, n, st);
    case 3: return launch<3>(in, co, cam_pos, cam_stride, k, out, n, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
