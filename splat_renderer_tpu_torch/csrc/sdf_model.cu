// The modeler's per-point math (M1), hand-written for Hopper (sm_90a): a
// frame's seed points -> surface points -> splat planes in two launches.
//
// sdf_descent (launch D) maps the generator's uniforms onto the faces of the
// scene's bounding box grown by aabb_scale (points/seeding.py), or reads the
// points it is handed, then runs the projection steps of
// points/projection.py::project_to_surface in registers and writes px, py,
// pz.  sdf_probe (launch C) evaluates the 7 taps of
// points/curvature.py::curvature_probe around each settled point and writes
// the other 8 planes of points/properties.py::derive_splats.  One thread a
// point, grid-stride.
//
// Replaces no TPU kernel: the JAX modeler is plain jnp that XLA fuses.
// PyTorch runs the same tree walk as some 680 launches of small elementwise
// kernels over (N, 3) and (7, N, 3) tensors, each a round trip through HBM
// and a host dispatch; at 1M points that held the frame about 13.6 ms.
//
// The CSG tree is data (sdf/program.py): a postfix program of (code,
// offset) pairs, an offset into a packed float32 parameter block, read the
// same by every thread (warp-uniform dispatch) and evaluated with a small
// per-thread stack of (distance, gradient).  Of an operation's subtrees the
// one needing the deeper stack comes first, so 16 slots hold any tree of
// fewer than 2^16 leaves; an operation flagged kSwapped takes its operands
// back in the tree's order.  Any structure runs on the one binary; a
// structure change costs no build.
//
// What bounds it on the H100: neither bytes nor flops.  D reads 12 bytes a
// point and writes 12, C reads 12 and writes 32: 68 MB at 1M points, 20 us
// at 3.35 TB/s.  The demo tree's 12 evaluations a point (5 steps, 7 taps)
// are some 1,500 flops and 110 IEEE divides and square roots: 1.5 GFLOP,
// 22 us at 67 TFLOP/s, against the divides' multi-instruction sequences.
//
// Bit-equal to the plain path on the card: the same operations in the same
// order, each rounded once (built with -fmad=false, no fast math; IEEE `/`
// and sqrtf as torch's CUDA kernels do them), NaN-propagating clamps,
// minima and maxima as torch's, torch.sign's (0 < a) - (a < 0).  Where the
// plain path reduces, the kernel associates as torch 2.11's CUDA reductions
// do on the card (tests/test_torch_sdf_model.py reads them off the card):
//   torch.sum over a 3-wide last dim               (v0 + v2) + v1
//   torch.linalg.vector_norm over it               sqrtf((x0^2 + x2^2) + x1^2)
//   torch.mean over the 6 taps' rows               ((((r0 + r4) + (r1 + r5)) + r2) + r3) * f
//                                                  (f = float(N) / float(6 N))
//   torch.sum of the 6 face areas                  ((a0 + a4) + a2) + ((a1 + a5) + a3)
//   torch.cumsum of them                           left to right
//   a tensor over a Python scalar c                x * (1.0f / float(c))

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// enough blocks to fill the card several times over; the grid-stride loop
// takes the rest
constexpr long long kMaxBlocks = 8192;
// the deepest evaluation stack a program may need (sdf/program.py
// STACK_LIMIT, which flattens no deeper tree)
constexpr int kStack = 16;
// on an operation's code: its right subtree was evaluated first, so its
// left operand is on top (sdf/program.py SWAPPED)
constexpr int kSwapped = 1 << 8;
constexpr float kEps = 1e-4f;      // sdf/primitives.py and points/projection.py _EPS
constexpr float kNormEps = 1e-8f;  // points/curvature.py _EPS

// sdf/program.py CODES: the 7 primitives, then the 6 operations
enum Code {
  kSphere, kBox, kTorus, kCapsule, kCylinder, kEllipsoid, kRoundBox,
  kUnion, kIntersection, kSubtraction, kSmoothUnion, kSmoothIntersection, kSmoothSubtraction
};

// the plane rows of the output, derive_splats' keys in order
enum Row { kPx, kPy, kPz, kRadius, kCr, kCg, kCb, kOpacity, kNx, kNy, kNz, kRows };

struct Field {
  float d, x, y, z;  // distance and gradient
};

// ---- torch's elementwise semantics ----
// clamp(v, min=lo): NaN passes
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_max(float v, float hi) { return v != v ? v : fminf(v, hi); }
// clamp(v, lo, hi) with scalar or tensor bounds
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : (lo != lo ? lo : (hi != hi ? hi : fminf(fmaxf(v, lo), hi)));
}
// torch.minimum / torch.maximum: a NaN operand comes out as it went in
__device__ __forceinline__ float t_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float t_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float t_sign(float a) {
  return static_cast<float>((0.0f < a) - (a < 0.0f));
}
// torch.sum over a 3-wide last dim, as the card associates it
__device__ __forceinline__ float sum3(float v0, float v1, float v2) { return (v0 + v2) + v1; }
// sdf/primitives.py _length (the squares rounded, then summed) and
// torch.linalg.vector_norm, which the card reduces the same way
__device__ __forceinline__ float length3(float x, float y, float z) {
  return sqrtf(sum3(x * x, y * y, z * z));
}
__device__ __forceinline__ float length2(float x, float z) { return sqrtf(x * x + z * z); }

__device__ __forceinline__ Field neg(Field f) { return {-f.d, -f.x, -f.y, -f.z}; }
__device__ __forceinline__ Field pick(bool take_a, Field a, Field b) { return take_a ? a : b; }

// ---- the primitives (sdf/primitives.py), points in the primitive's frame ----
__device__ __forceinline__ Field sdg_sphere(float x, float y, float z, float radius) {
  const float d = length3(x, y, z);
  const float c = clamp_min(d, kEps);
  return {d - radius, x / c, y / c, z / c};
}

__device__ __forceinline__ Field sdg_box(float x, float y, float z, float hx, float hy,
                                         float hz) {
  const float qx = fabsf(x) - hx, qy = fabsf(y) - hy, qz = fabsf(z) - hz;
  const float wx = clamp_min(qx, 0.0f), wy = clamp_min(qy, 0.0f), wz = clamp_min(qz, 0.0f);
  const float wlen = length3(wx, wy, wz);
  const float g = t_max(t_max(qx, qz), qy);  // amax: NaN wins, else order-free
  const float dist = wlen + clamp_max(g, 0.0f);
  const float sx = t_sign(x), sy = t_sign(y), sz = t_sign(z);
  const float c = clamp_min(wlen, kEps);
  const bool pick_x = (qx > qy) & (qx > qz);
  const bool pick_y = (!pick_x) & (qy > qz);
  if (g > 0.0f) return {dist, sx * (wx / c), sy * (wy / c), sz * (wz / c)};
  return {dist, sx * (pick_x ? 1.0f : 0.0f), sy * (pick_y ? 1.0f : 0.0f),
          sz * ((pick_x | pick_y) ? 0.0f : 1.0f)};
}

__device__ __forceinline__ Field sdg_torus(float x, float y, float z, float major,
                                           float minor) {
  const float lxz = length2(x, z);
  const float q0 = lxz - major, q1 = y;
  const float lq = length2(q0, q1);
  const float dist = lq - minor;
  const bool ok = (lxz > kEps) & (lq > kEps);
  const float cx = clamp_min(lxz, kEps);
  const float dx0 = x / cx, dx1 = z / cx;
  const float cq = clamp_min(lq, kEps);
  const float dd0 = q0 / cq, dd1 = q1 / cq;
  if (ok) return {dist, dx0 * dd0, dd1, dx1 * dd0};
  return {dist, 0.0f, 1.0f, 0.0f};
}

__device__ __forceinline__ Field sdg_capsule(float x, float y, float z, float height,
                                             float radius) {
  const float half_h = height * 0.5f;
  const float cy = clamp(y, -half_h, half_h);
  const float q0 = x - 0.0f, q1 = y - cy, q2 = z - 0.0f;
  const float d = length3(q0, q1, q2);
  const float c = clamp_min(d, kEps);
  if (d > kEps) return {d - radius, q0 / c, q1 / c, q2 / c};
  return {d - radius, 0.0f, t_sign(y), 0.0f};
}

__device__ __forceinline__ Field sdg_cylinder(float x, float y, float z, float height,
                                              float radius) {
  const float hh = height * 0.5f;
  const float rl = length2(x, z);
  const float qx = rl - radius;
  const float qy = fabsf(y) - hh;
  const float wx = clamp_min(qx, 0.0f), wy = clamp_min(qy, 0.0f);
  const float outside = sqrtf(wx * wx + wy * wy);
  const float dist = outside + clamp_max(t_max(qx, qy), 0.0f);
  const float safe_rl = clamp_min(rl, kEps);
  const float rx = rl > kEps ? x / safe_rl : 1.0f;
  const float rz = rl > kEps ? z / safe_rl : 0.0f;
  const float sy = y >= 0.0f ? 1.0f : -1.0f;
  const float inv_out = 1.0f / clamp_min(outside, kEps);
  if ((qx > 0.0f) | (qy > 0.0f)) return {dist, wx * rx * inv_out, wy * sy * inv_out, wx * rz * inv_out};
  const bool pick_r = qx > qy;  // nearest interior face: side wall vs cap
  return {dist, pick_r ? rx : 0.0f, pick_r ? 0.0f : sy, pick_r ? rz : 0.0f};
}

__device__ __forceinline__ Field sdg_ellipsoid(float x, float y, float z, float ra, float rb,
                                               float rc) {
  const float r2a = ra * ra, r2b = rb * rb, r2c = rc * rc;
  const float pra = x / ra, prb = y / rb, prc = z / rc;
  const float p2a = x / r2a, p2b = y / r2b, p2c = z / r2c;
  const float k0 = length3(pra, prb, prc);
  const float k1 = length3(p2a, p2b, p2c);
  if (k0 < kEps) return {-t_min(t_min(ra, rc), rb), 0.0f, 1.0f, 0.0f};
  const float safe_k0 = clamp_min(k0, kEps), safe_k1 = clamp_min(k1, kEps);
  const float dist = k0 * (k0 - 1.0f) / safe_k1;
  const float a = 2.0f * k0 - 1.0f;
  return {dist,
          (a * (p2a / safe_k0) - dist * ((p2a / r2a) / safe_k1)) / safe_k1,
          (a * (p2b / safe_k0) - dist * ((p2b / r2b) / safe_k1)) / safe_k1,
          (a * (p2c / safe_k0) - dist * ((p2c / r2c) / safe_k1)) / safe_k1};
}

__device__ __forceinline__ Field sdg_round_box(float x, float y, float z, float sx, float sy,
                                               float sz, float rounding) {
  Field f = sdg_box(x, y, z, clamp_min(sx - rounding, kEps), clamp_min(sy - rounding, kEps),
                    clamp_min(sz - rounding, kEps));
  f.d = f.d - rounding;
  return f;
}

// primitive `code` at world point (px, py, pz); q: its parameters, the
// centre first
__device__ __forceinline__ Field primitive(int code, const float* __restrict__ q, float px,
                                           float py, float pz) {
  const float x = px - __ldg(q), y = py - __ldg(q + 1), z = pz - __ldg(q + 2);
  switch (code) {
    case kSphere: return sdg_sphere(x, y, z, __ldg(q + 3));
    case kBox: return sdg_box(x, y, z, __ldg(q + 3), __ldg(q + 4), __ldg(q + 5));
    case kTorus: return sdg_torus(x, y, z, __ldg(q + 3), __ldg(q + 4));
    case kCapsule: return sdg_capsule(x, y, z, __ldg(q + 3), __ldg(q + 4));
    case kCylinder: return sdg_cylinder(x, y, z, __ldg(q + 3), __ldg(q + 4));
    case kEllipsoid: return sdg_ellipsoid(x, y, z, __ldg(q + 3), __ldg(q + 4), __ldg(q + 5));
    default: return sdg_round_box(x, y, z, __ldg(q + 3), __ldg(q + 4), __ldg(q + 5), __ldg(q + 6));
  }
}

// ---- the operations (sdf/ops.py) ----
__device__ __forceinline__ Field smooth_union(Field a, Field b, float k) {
  const float k4 = k * 4.0f;
  const float m = clamp_min(k4 - fabsf(a.d - b.d), 0.0f);
  const float h = m / k4;
  const float dist = t_min(a.d, b.d) - h * h * k4 * 0.25f;
  const float h_grad = m / (2.0f * k4);
  const float t = a.d < b.d ? h_grad : 1.0f - h_grad;
  return {dist, a.x + t * (b.x - a.x), a.y + t * (b.y - a.y), a.z + t * (b.z - a.z)};
}

__device__ __forceinline__ Field operation(int code, const float* __restrict__ q, Field a,
                                           Field b) {
  switch (code) {
    case kUnion: return pick(a.d < b.d, a, b);
    case kIntersection: return pick(a.d > b.d, a, b);
    case kSubtraction: b = neg(b); return pick(a.d > b.d, a, b);
    case kSmoothUnion: return smooth_union(a, b, __ldg(q));
    case kSmoothIntersection: return neg(smooth_union(neg(a), neg(b), __ldg(q)));
    default: return neg(smooth_union(neg(a), b, __ldg(q)));  // kSmoothSubtraction
  }
}

// The scene's (distance, gradient) at (px, py, pz): the postfix program
// `prog` (n (code, offset) pairs) over the parameter block `par`.  The top
// of the stack stays in registers.
__device__ Field evaluate(const int2* __restrict__ prog, int n, const float* __restrict__ par,
                          float px, float py, float pz) {
  Field stack[kStack];
  int sp = 0;
  Field top = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < n; ++i) {
    const int2 ins = __ldg(prog + i);
    if (ins.x <= kRoundBox) {
      if (i > 0) stack[sp++] = top;
      top = primitive(ins.x, par + ins.y, px, py, pz);
    } else {
      const Field below = stack[--sp];
      const bool swapped = ins.x & kSwapped;
      top = operation(ins.x & ~kSwapped, par + ins.y, swapped ? top : below,
                      swapped ? below : top);
    }
  }
  return top;
}

// ---- seeding (points/seeding.py, SDFScene.seeding_aabb) ----
struct Seeding {
  float lo[3], d[3];  // the grown box's low corner and extent
  float cdf[5];       // the face CDF's first five entries
};

__device__ Seeding seeding(const int2* __restrict__ bounds, int n_bounds,
                           const float* __restrict__ par, float half_scale) {
  float lo[3], hi[3];
  for (int i = 0; i < n_bounds; ++i) {
    const int2 b = __ldg(bounds + i);
    const float* q = par + b.y;
    float ext[3];
    switch (b.x) {
      case kSphere: ext[0] = ext[1] = ext[2] = __ldg(q + 3); break;
      case kTorus: {
        const float outer = __ldg(q + 3) + __ldg(q + 4);
        ext[0] = outer; ext[1] = __ldg(q + 4); ext[2] = outer;
        break;
      }
      case kCapsule: {
        const float r = __ldg(q + 4);
        ext[0] = r; ext[1] = __ldg(q + 3) * 0.5f + r; ext[2] = r;
        break;
      }
      case kCylinder: {
        const float r = __ldg(q + 4);
        ext[0] = r; ext[1] = __ldg(q + 3) * 0.5f; ext[2] = r;
        break;
      }
      default:  // box, ellipsoid, round box: centre -/+ the 3-vector after it
        ext[0] = __ldg(q + 3); ext[1] = __ldg(q + 4); ext[2] = __ldg(q + 5);
    }
    for (int c = 0; c < 3; ++c) {
      const float l = __ldg(q + c) - ext[c], h = __ldg(q + c) + ext[c];
      lo[c] = i == 0 ? l : t_min(lo[c], l);
      hi[c] = i == 0 ? h : t_max(hi[c], h);
    }
  }
  Seeding s;
  for (int c = 0; c < 3; ++c) {
    const float center = (lo[c] + hi[c]) * 0.5f;
    const float ext = (hi[c] - lo[c]) * half_scale;
    s.lo[c] = center - ext;
    s.d[c] = (center + ext) - s.lo[c];
  }
  // face order -X +X -Y +Y -Z +Z
  const float yz = s.d[1] * s.d[2], xz = s.d[0] * s.d[2], xy = s.d[0] * s.d[1];
  const float area[6] = {yz, yz, xz, xz, xy, xy};
  const float total = ((area[0] + area[4]) + area[2]) + ((area[1] + area[5]) + area[3]);
  float run = area[0];
  for (int f = 0; f < 5; ++f) {
    if (f > 0) run = run + area[f];
    s.cdf[f] = run / total;
  }
  return s;
}

template <bool SEEDED>
__global__ void __launch_bounds__(kThreads)
sdf_descent_kernel(const int2* __restrict__ prog, int n_code, const int2* __restrict__ bounds,
                   int n_bounds, const float* __restrict__ par, const float* __restrict__ uf,
                   const float* __restrict__ uv, const float* __restrict__ pts,
                   long long pts_row, long long pts_col, float half_scale, int steps,
                   float* __restrict__ out, long long n) {
  Seeding s;
  if (SEEDED) s = seeding(bounds, n_bounds, par, half_scale);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    float p[3];
    if (SEEDED) {
      const float f = __ldg(uf + i);
      int face = 0;
#pragma unroll
      for (int k = 0; k < 5; ++k) face += f > s.cdf[k];
      const float u = __ldg(uv + 2 * i), v = __ldg(uv + 2 * i + 1);
      const int axis = face >> 1;
      const float hi = static_cast<float>(face & 1);
      const float unit[3] = {axis == 0 ? hi : u, axis == 1 ? hi : (axis == 0 ? u : v),
                             axis == 2 ? hi : v};
#pragma unroll
      for (int c = 0; c < 3; ++c) p[c] = s.lo[c] + unit[c] * s.d[c];
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) p[c] = __ldg(pts + i * pts_row + c * pts_col);
    }
    for (int step = 0; step < steps; ++step) {
      const Field f = evaluate(prog, n_code, par, p[0], p[1], p[2]);
      const float glen = length3(f.x, f.y, f.z);
      if (glen > kEps) {
        const float c = clamp_min(glen, kEps);
        p[0] = p[0] - f.x / c * f.d;
        p[1] = p[1] - f.y / c * f.d;
        p[2] = p[2] - f.z / c * f.d;
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) out[(kPx + c) * n + i] = p[c];
  }
}

// curvature_probe's and derive_splats' Python scalars as float32, in the
// wrapper's order (ops/sdf_model.py probe_scalars)
struct ProbeConsts {
  float radius;       // probe_radius
  float mean_factor;  // torch.mean's float(N) / float(6 N)
  float inv_range;    // 1 / float(curvature_range - 0.0)
  float min_scale;    // curvature_min_scale
  float span;         // 1.0 - curvature_min_scale
  float base_radius, base_opacity;
};

__global__ void __launch_bounds__(kThreads)
sdf_probe_kernel(const int2* __restrict__ prog, int n_code, const float* __restrict__ par,
                 ProbeConsts k, int color_signed, float* __restrict__ out, long long n) {
  const float r = k.radius;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float px = out[kPx * n + i], py = out[kPy * n + i], pz = out[kPz * n + i];
    float cn[3];     // the centre tap's normal
    float var[6];    // 1 - dot(tap normal, centre normal), taps 1..6
#pragma unroll 1
    for (int t = 0; t < 7; ++t) {
      // tap t's offset: 0, then +-r along x, y, z
      const float o = t & 1 ? r : -r;
      const Field f = evaluate(prog, n_code, par, px + ((t + 1) >> 1 == 1 ? o : 0.0f),
                               py + ((t + 1) >> 1 == 2 ? o : 0.0f),
                               pz + ((t + 1) >> 1 == 3 ? o : 0.0f));
      const float c = clamp_min(length3(f.x, f.y, f.z), kNormEps);
      const float nx = f.x / c, ny = f.y / c, nz = f.z / c;
      if (t == 0) {
        cn[0] = nx; cn[1] = ny; cn[2] = nz;
      } else {
        var[t - 1] = 1.0f - sum3(nx * cn[0], ny * cn[1], nz * cn[2]);
      }
    }
    const float avg = ((((var[0] + var[4]) + (var[1] + var[5])) + var[2]) + var[3]) *
                      k.mean_factor;
    const float t = clamp((avg - 0.0f) * k.inv_range, 0.0f, 1.0f);
    const float flatness = 1.0f - t * t * (3.0f - 2.0f * t);
    const float scale = k.min_scale + k.span * flatness;
    out[kRadius * n + i] = k.base_radius * scale;
    float col[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      col[c] = color_signed ? cn[c] * 0.5f + 0.5f : fabsf(cn[c]) * 0.8f + 0.2f;
    out[kCr * n + i] = col[0];
    out[kCg * n + i] = col[1];
    out[kCb * n + i] = col[2];
    out[kOpacity * n + i] = k.base_opacity;
    out[kNx * n + i] = cn[0];
    out[kNy * n + i] = cn[1];
    out[kNz * n + i] = cn[2];
  }
}

unsigned int blocks_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

// Launch D on `stream` over n points.  program: n_code (code, offset)
// pairs, the postfix tree, then n_bounds pairs, the bounding-box
// primitives (int32, device); params: the packed block (float32, device).
// uf (n,) and uv (n, 2) contiguous uniforms seed the points on the box
// grown by 2 * half_scale; with uf null, pts (n, 3) at element strides
// (pts_row, pts_col) are the start.  steps projection steps; out: (11, n)
// contiguous float32, rows px, py, pz written.  Returns the CUDA error code
// of the launch (0 for n == 0, which launches nothing).
extern "C" int sdf_descent(const int* program, int n_code, int n_bounds, const float* params,
                           const float* uf, const float* uv, const float* pts,
                           long long pts_row, long long pts_col, float half_scale, int steps,
                           float* out, long long n, void* stream) {
  if (n < 0 || n_code < 1 || (uf != nullptr && n_bounds < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int2* prog = reinterpret_cast<const int2*>(program);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (uf != nullptr) {
    sdf_descent_kernel<true><<<blocks_for(n), kThreads, 0, st>>>(
        prog, n_code, prog + n_code, n_bounds, params, uf, uv, nullptr, 0, 0, half_scale,
        steps, out, n);
  } else {
    sdf_descent_kernel<false><<<blocks_for(n), kThreads, 0, st>>>(
        prog, n_code, prog + n_code, n_bounds, params, nullptr, nullptr, pts, pts_row,
        pts_col, half_scale, steps, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch C on `stream` over n points: out's rows px, py, pz (launch D's)
// are read, radius, cr, cg, cb, opacity, nx, ny, nz written.  consts: the
// ProbeConsts fields in order (7 floats); color_signed: 1 for
// "normal_signed" colour, 0 for "normal_abs".  Returns the CUDA error code
// of the launch (0 for n == 0).
extern "C" int sdf_probe(const int* program, int n_code, const float* params,
                         const float* consts, int color_signed, float* out, long long n,
                         void* stream) {
  if (n < 0 || n_code < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  ProbeConsts k;
  k.radius = consts[0];
  k.mean_factor = consts[1];
  k.inv_range = consts[2];
  k.min_scale = consts[3];
  k.span = consts[4];
  k.base_radius = consts[5];
  k.base_opacity = consts[6];
  sdf_probe_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int2*>(program), n_code, params, k, color_signed, out, n);
  return static_cast<int>(cudaGetLastError());
}
