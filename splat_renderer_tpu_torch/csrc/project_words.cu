// Splat projection straight to the packed record words, hand-written for
// Hopper (sm_90a): one thread a splat computes everything
// render/projector.py::splat_screen_words_plain computes as some 300 plane
// operations over the whole set: the clip coordinates, the depth, the
// screen radius over the 6 axial offsets, the Lambert light, the oriented
// ellipse (foreshortened, EWA disc or full-covariance 3D Gaussian), the
// anti-aliasing dilation, the snap onto the record grids and the packing
// into words (render/packing.py).
//
// Replaces no TPU kernel: the JAX package's projector
// (splat_renderer_tpu/render/projector.py) is plain jnp, which XLA fuses
// into one program.  PyTorch runs the same plane operations one launch at
// a time, and issuing them took the host about 3.5 ms a frame at 1M
// splats while the device waited; this kernel is one launch.
//
// What bounds it on the H100: bytes.  A splat reads 11 float32 planes
// (44 B; 18, 72 B, for a 3D Gaussian) and writes four int64 words and its
// float32 depth (36 B): 80 MB at 1M splats, 24 us at 3.35 TB/s.  Its ~300
// flops (~400 for a 3D Gaussian), eight square roots, a dozen divides and
// at most one atan2f are far below the FP32 rate.
// Design: one thread a splat, neighbouring threads on neighbouring splats,
// so every plane's loads coalesce whatever its element stride (the
// modeler's planes are columns of (N, 3) tensors, stride 3, read in place)
// and every store coalesces.  The camera (19 floats) and the light
// direction (3) are read from device memory, so nothing of the call waits
// on the host.  Each branch of the plain path is a compile-time
// instantiation (ellipse model x dilation), chosen from the config.
//
// Bit-equal to the plain path on the card: the same operations in the same
// order, each rounded once (the library is built with -fmad=false and
// without fast math): IEEE divides as `div`/`rdiv` compute them,
// __fsqrt_rn for sqrt_rn (a float64 square root rounded to float32 rounds
// the same), atan2f as torch.atan2 calls it, rintf for torch.round (half to
// even), the C cast for .to(torch.int64), torch's floor remainder for
// % 256, the shifts on unsigned bits as torch shifts int64, NaN-propagating
// minimum / maximum / clamp as torch's (fminf / fmaxf alone drop a NaN),
// and every Python scalar of the plain path rounded to float32 as PyTorch
// rounds it against a float32 tensor (static_cast<float> of the double,
// here and in the wrapper's ctypes floats).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// px py pz radius cr cg cb opacity nx ny nz, then a 3D Gaussian's scales
// and quaternion (read by the kCov3d instantiations only)
constexpr int kPlanes = 18;
enum Plane {
  kPx, kPy, kPz, kRadius, kCr, kCg, kCb, kOpacity, kNx, kNy, kNz,
  kSx, kSy, kSz, kQw, kQx, kQy, kQz
};
enum Ellipse { kIsotropic = 0, kForeshorten = 1, kEwa = 2, kCov3d = 3 };

// the plain path's Python scalars, as PyTorch rounds them to float32
constexpr float kTiny = static_cast<float>(1e-8);  // _safe's floor, the norms' floor
constexpr float kFront = static_cast<float>(1e-6);  // w above this is in front
constexpr float kRatioLo = static_cast<float>(0.05);

struct Planes {
  const float* p[kPlanes];
  long long stride[kPlanes];  // in elements
};

struct Scalars {
  float half_w, half_h;  // 0.5 * width, 0.5 * height
  float r_cap;
  float pos_scale, pos_offset, pos_max;
  float color_scale;
  float pi, angle_scale;
  float ratio_min, ratio_scale;  // 1 / RATIO_SCALE, RATIO_SCALE
  float ambient, diffuse;
  float s2, aa;  // sigma^2 and aa_dilation
  float sigma;
};

struct Camera {
  const float* vp;
  long long vp_row, vp_col;  // element strides of view_proj
  const float* cam;
  long long cam_stride;
  const float* light;  // the normalised light direction, 3 contiguous floats
};

struct Words {
  long long* dk;
  long long* w_pos;
  long long* w_ro;
  long long* w_rgb;
  float* depth;
};

// torch.maximum / torch.minimum: a NaN operand comes out as it went in
__device__ __forceinline__ float t_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float t_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// torch.clamp with scalar bounds: NaN passes through
__device__ __forceinline__ float t_clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
// _torch_util.clip: jnp.clip as minimum(maximum(t, lo), hi)
__device__ __forceinline__ float t_clip(float v, float lo, float hi) {
  return t_min(t_max(v, lo), hi);
}
// projector._safe
__device__ __forceinline__ float safe_w(float w) { return fabsf(w) < kTiny ? kTiny : w; }
// torch.round(v).to(torch.int64)
__device__ __forceinline__ long long round_i64(float v) {
  return static_cast<long long>(rintf(v));
}
// int64 << k as torch computes it: on the unsigned bits
__device__ __forceinline__ long long shl(long long a, int k) {
  return static_cast<long long>(static_cast<unsigned long long>(a) << k);
}

template <int ELLIPSE, bool AA>
__global__ void __launch_bounds__(kThreads)
project_words_kernel(Planes in, Camera cam, Scalars s, Words out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float px = in.p[kPx][i * in.stride[kPx]];
  const float py = in.p[kPy][i * in.stride[kPy]];
  const float pz = in.p[kPz][i * in.stride[kPz]];
  const float rad = in.p[kRadius][i * in.stride[kRadius]];
  const float nx = in.p[kNx][i * in.stride[kNx]];
  const float ny = in.p[kNy][i * in.stride[kNy]];
  const float nz = in.p[kNz][i * in.stride[kNz]];
  float vp[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) vp[j][k] = cam.vp[j * cam.vp_row + k * cam.vp_col];
  const float cam0 = cam.cam[0], cam1 = cam.cam[cam.cam_stride];
  const float cam2 = cam.cam[2 * cam.cam_stride];

  // ---- project_planes ----
  float clip[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) clip[j] = vp[j][0] * px + vp[j][1] * py + vp[j][2] * pz + vp[j][3];
  const float w = clip[3];
  const float sw = safe_w(w);
  const float cx = (clip[0] / sw + 1.0f) * s.half_w;
  const float cy = (1.0f - clip[1] / sw) * s.half_h;
  const float dx = px - cam0, dy = py - cam1, dz = pz - cam2;
  const float dist = __fsqrt_rn(dx * dx + dy * dy + dz * dz);
  // the 6 offsets' clip coordinates are clip_center +- r * VP_column
  float screen_radius = 0.0f;
  bool valid = w > kFront;
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const float sr = (side == 0 ? 1.0f : -1.0f) * rad;
      const float wp = clip[3] + sr * vp[3][axis];
      valid = valid && (wp > kFront);
      const float swp = safe_w(wp);
      const float sx = ((clip[0] + sr * vp[0][axis]) / swp + 1.0f) * s.half_w;
      const float sy = (1.0f - (clip[1] + sr * vp[1][axis]) / swp) * s.half_h;
      const float ddx = sx - cx;
      const float ddy = sy - cy;
      screen_radius = t_max(screen_radius, __fsqrt_rn(ddx * ddx + ddy * ddy));
    }
  }
  const float proj_radius = valid ? t_min(screen_radius, s.r_cap) : 0.0f;
  const float depth = valid ? dist : __int_as_float(0x7f800000);  // +inf when culled

  // ---- shade_planes ----
  const float diffuse =
      t_max(nx * cam.light[0] + ny * cam.light[1] + nz * cam.light[2], 0.0f);
  const float lamb = s.ambient + s.diffuse * diffuse;

  float ell_radius = proj_radius;
  float angle = 0.0f, ratio = 1.0f;
  if (ELLIPSE == kEwa || ELLIPSE == kCov3d) {
    const float inv_w2 = 1.0f / (sw * sw);
    // J rows: d sx / dp_k = Wh (vp0k w - clip0 vp3k)/w^2,
    //         d sy / dp_k = -Hh (vp1k w - clip1 vp3k)/w^2
    float j0[3], j1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      j0[k] = s.half_w * (vp[0][k] * w - clip[0] * vp[3][k]) * inv_w2;
      j1[k] = -s.half_h * (vp[1][k] * w - clip[1] * vp[3][k]) * inv_w2;
    }
    float m00, m01, m11;
    if (ELLIPSE == kEwa) {
      // projector._disc_covariance: r^2 (J J^T - (J n)(J n)^T)
      const float nlen = t_max(__fsqrt_rn(nx * nx + ny * ny + nz * nz), kTiny);
      const float ux = nx / nlen, uy = ny / nlen, uz = nz / nlen;
      const float a00 = j0[0] * j0[0] + j0[1] * j0[1] + j0[2] * j0[2];
      const float a01 = j0[0] * j1[0] + j0[1] * j1[1] + j0[2] * j1[2];
      const float a11 = j1[0] * j1[0] + j1[1] * j1[1] + j1[2] * j1[2];
      const float jn0 = j0[0] * ux + j0[1] * uy + j0[2] * uz;
      const float jn1 = j1[0] * ux + j1[1] * uy + j1[2] * uz;
      const float r2 = rad * rad;
      m00 = r2 * (a00 - jn0 * jn0);
      m01 = r2 * (a01 - jn0 * jn1);
      m11 = r2 * (a11 - jn1 * jn1);
    } else {
      // projector._gaussian_covariance: (J R S)(J R S)^T, R from the
      // normalised quaternion (properties.quat_rotation)
      const float qw = in.p[kQw][i * in.stride[kQw]];
      const float qx = in.p[kQx][i * in.stride[kQx]];
      const float qy = in.p[kQy][i * in.stride[kQy]];
      const float qz = in.p[kQz][i * in.stride[kQz]];
      const float qn = t_max(__fsqrt_rn(qw * qw + qx * qx + qy * qy + qz * qz), kTiny);
      const float a = qw / qn, b = qx / qn, c = qy / qn, d = qz / qn;
      const float rot[3][3] = {
          {1.0f - 2.0f * (c * c + d * d), 2.0f * (b * c - a * d), 2.0f * (b * d + a * c)},
          {2.0f * (b * c + a * d), 1.0f - 2.0f * (b * b + d * d), 2.0f * (c * d - a * b)},
          {2.0f * (b * d - a * c), 2.0f * (c * d + a * b), 1.0f - 2.0f * (b * b + c * c)},
      };
      const float sc[3] = {in.p[kSx][i * in.stride[kSx]], in.p[kSy][i * in.stride[kSy]],
                           in.p[kSz][i * in.stride[kSz]]};
      float u0[3], u1[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        u0[k] = (j0[0] * rot[0][k] + j0[1] * rot[1][k] + j0[2] * rot[2][k]) * sc[k];
        u1[k] = (j1[0] * rot[0][k] + j1[1] * rot[1][k] + j1[2] * rot[2][k]) * sc[k];
      }
      m00 = u0[0] * u0[0] + u0[1] * u0[1] + u0[2] * u0[2];
      m01 = u0[0] * u1[0] + u0[1] * u1[1] + u0[2] * u1[2];
      m11 = u1[0] * u1[0] + u1[1] * u1[1] + u1[2] * u1[2];
    }
    // closed-form 2x2 symmetric eigendecomposition
    const float half_tr = 0.5f * (m00 + m11);
    const float half_df = 0.5f * (m00 - m11);
    const float root = __fsqrt_rn(half_df * half_df + m01 * m01);
    const float lam_hi = t_max(half_tr + root, 0.0f);
    const float lam_lo = t_max(half_tr - root, 0.0f);
    const float major = __fsqrt_rn(lam_hi);
    const float minor = __fsqrt_rn(lam_lo);
    // minor-axis direction = eigenvector of lam_lo: (m01, lam_lo - m00)
    angle = atan2f(lam_lo - m00, m01);
    // a Gaussian's major standard deviation is sigma * radius
    const float major_r = ELLIPSE == kCov3d ? major / s.sigma : major;
    ell_radius = valid ? t_min(major_r, s.r_cap) : 0.0f;
    ratio = t_clip(minor / t_max(major, kTiny), kRatioLo, 1.0f);
  } else if (ELLIPSE == kForeshorten) {
    const float vn = t_max(__fsqrt_rn(dx * dx + dy * dy + dz * dz), kTiny);
    const float cos_view = (nx * dx + ny * dy + nz * dz) / vn;
    // tip = position + radius * normal, projected with the same clip
    // algebra as the 6-offset radius (clip_tip = clip + r*(VP @ n))
    const float tc0 = clip[0] + rad * (vp[0][0] * nx + vp[0][1] * ny + vp[0][2] * nz);
    const float tc1 = clip[1] + rad * (vp[1][0] * nx + vp[1][1] * ny + vp[1][2] * nz);
    const float tc3 = clip[3] + rad * (vp[3][0] * nx + vp[3][1] * ny + vp[3][2] * nz);
    const float stw = safe_w(tc3);
    const float tip_x = (tc0 / stw + 1.0f) * s.half_w;
    const float tip_y = (1.0f - tc1 / stw) * s.half_h;
    angle = atan2f(tip_y - cy, tip_x - cx);
    ratio = t_clip(fabsf(cos_view), kRatioLo, 1.0f);
  }

  float opacity = in.p[kOpacity][i * in.stride[kOpacity]];
  if (AA) {
    const float lam1 = s.s2 * ell_radius * ell_radius;
    const float lam2 = lam1 * ratio * ratio;
    const float lam1d = lam1 + s.aa;
    const float lam2d = lam2 + s.aa;
    const bool alive = ell_radius > 0.0f;  // never resurrect culled splats
    if (alive) {
      opacity = opacity * __fsqrt_rn((lam1 / lam1d) * (lam2 / lam2d));
      // re-cap: the dilated major axis may exceed r_cap
      ell_radius = t_min(__fsqrt_rn(lam1d / s.s2), s.r_cap);
      ratio = __fsqrt_rn(lam2d / lam1d);
    } else {
      ell_radius = 0.0f;
    }
  }

  // ---- screen_planes: clip, then round half to even ----
  const long long cx_fx = round_i64(t_clamp((cx + s.pos_offset) * s.pos_scale, 0.0f, s.pos_max));
  const long long cy_fx = round_i64(t_clamp((cy + s.pos_offset) * s.pos_scale, 0.0f, s.pos_max));
  const long long r_fx = round_i64(t_clamp(ell_radius * s.pos_scale, 0.0f, s.pos_max));
  const float cr = in.p[kCr][i * in.stride[kCr]] * lamb;
  const float cg = in.p[kCg][i * in.stride[kCg]] * lamb;
  const float cb = in.p[kCb][i * in.stride[kCb]] * lamb;
  const long long op8 = round_i64(t_clamp(opacity, 0.0f, 1.0f) * s.color_scale);
  const long long r8 = round_i64(t_clamp(cr, 0.0f, 1.0f) * s.color_scale);
  const long long g8 = round_i64(t_clamp(cg, 0.0f, 1.0f) * s.color_scale);
  const long long b8 = round_i64(t_clamp(cb, 0.0f, 1.0f) * s.color_scale);
  long long ang8 = round_i64((angle + s.pi) * s.angle_scale) % 256;  // floor remainder
  if (ang8 < 0) ang8 += 256;
  const long long ratio8 = round_i64(t_clamp(ratio, s.ratio_min, 1.0f) * s.ratio_scale);

  // ---- splat_screen_words: packing.depth_bits and the three words ----
  const unsigned int bits = __float_as_uint(depth);
  const unsigned int key = (bits >> 31) ? ~bits : (bits | 0x80000000u);
  out.dk[i] = static_cast<long long>(key);
  out.w_pos[i] = cx_fx | shl(cy_fx, 16);
  out.w_ro[i] = r_fx | shl(ang8, 16) | shl(ratio8, 24);
  out.w_rgb[i] = r8 | shl(g8, 8) | shl(b8, 16) | shl(op8, 24);
  out.depth[i] = depth;
}

template <int ELLIPSE, bool AA>
int launch(const Planes& in, const Camera& cam, const Scalars& s, const Words& out,
           long long n, cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  project_words_kernel<ELLIPSE, AA>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(in, cam, s, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch on `stream` over n splats.  planes: the 18 plane pointers in
// the order of the Plane enum, each with its element stride (the seven of a
// 3D Gaussian may be null where ellipse is not 3); vp: view_proj
// (4, 4) with its row and column strides; cam: cam_pos (3,) with its
// stride; light: 3 contiguous floats; scalars: the Scalars fields in order
// (16 floats); out: dk, w_pos, w_ro, w_rgb (int64) and depth (float32),
// n contiguous elements each.  ellipse: 0 isotropic, 1 foreshorten,
// 2 EWA, 3 3D Gaussian; aa: 1 for the dilation.  Returns the CUDA error
// code of the launch (0 for n == 0, which launches nothing).
extern "C" int project_words_forward(const float* const* planes, const long long* strides,
                                     const float* vp, long long vp_row, long long vp_col,
                                     const float* cam_pos, long long cam_stride,
                                     const float* light, const float* scalars,
                                     long long* dk, long long* w_pos, long long* w_ro,
                                     long long* w_rgb, float* depth, long long n, int ellipse,
                                     int aa, void* stream) {
  if (n < 0 || n > 0x7fffffffLL * kThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Planes in;
  for (int k = 0; k < kPlanes; ++k) {
    in.p[k] = planes[k];
    in.stride[k] = strides[k];
  }
  const Camera cam{vp, vp_row, vp_col, cam_pos, cam_stride, light};
  const Scalars s{scalars[0], scalars[1], scalars[2],  scalars[3],  scalars[4],
                  scalars[5], scalars[6], scalars[7],  scalars[8],  scalars[9],
                  scalars[10], scalars[11], scalars[12], scalars[13], scalars[14],
                  scalars[15]};
  const Words out{dk, w_pos, w_ro, w_rgb, depth};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ellipse * 2 + (aa ? 1 : 0)) {
    case 0: return launch<kIsotropic, false>(in, cam, s, out, n, st);
    case 1: return launch<kIsotropic, true>(in, cam, s, out, n, st);
    case 2: return launch<kForeshorten, false>(in, cam, s, out, n, st);
    case 3: return launch<kForeshorten, true>(in, cam, s, out, n, st);
    case 4: return launch<kEwa, false>(in, cam, s, out, n, st);
    case 5: return launch<kEwa, true>(in, cam, s, out, n, st);
    case 6: return launch<kCov3d, false>(in, cam, s, out, n, st);
    case 7: return launch<kCov3d, true>(in, cam, s, out, n, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
