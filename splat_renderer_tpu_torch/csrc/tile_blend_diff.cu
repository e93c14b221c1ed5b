// Differentiable per-tile splat compositing, forward and backward,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels splat_renderer_tpu/ops/
// tile_blend_diff.py::_make_fwd_kernel (forward) and ::_make_bwd_kernel
// (backward).  The plain twin is ops/tile_blend_diff.py::
// blend_planes_plain; the gradients are those of its autograd.
//
// Inputs are continuous float32 record planes in canonical order (N, nf),
// nf = 8 isotropic [cx cy r op cr cg cb d] or 10 oriented
// [cx cy r op cr cg cb ang ratio d], and each tile's depth-ordered run of
// record ranks (render/binning.py::bin_planes_diff).  Per (record, pixel):
//   scale = r (isotropic) or r * max(ratio, 1e-3) (oriented, distance in
//   the ellipse frame), inv_s2 = 1 / max(scale^2, 1e-12),
//   shape = exp(-dist2 * inv_s2 / (2 sigma^2)) inside dist2 <= margin^2
//   scale^2 and r >= min_screen_radius, else 0,
//   a = min(op * shape, alpha_cap).
// Forward, per pixel, front to back with no early exit (truncation would
// bias the gradients): C += rgb a T, D += d a T, T *= 1 - a; the outputs
// are C, alpha = 1 - T and D (the alpha-weighted depth).
//
// Backward (the blend adjoint): for pixel cotangents gC, gA, gD and
// w_i = gC . rgb_i + gD d_i,
//   dL/da_i = T_i (w_i - R_i + gA Q_i),
// where R_i = sum_{k>i} w_k a_k prod_{i<j<k} (1 - a_j) is what follows
// record i as seen through it and Q_i = prod_{j>i} (1 - a_j); gated to 0
// where op * shape >= alpha_cap, then chained to every field term for term
// as the TPU kernel does.  The TPU kernel writes the suffix as U_total -
// prefix and divides by 1 - a_i: in float32 that cancellation is magnified
// by 1 / (1 - a_i), up to 1e7 (the alpha cap) where an opacity-1 splat's
// centre nearly meets a pixel centre.  Here R and Q come from back-to-front
// recurrences with no
// division: a first pass stores each 32-record chunk's composite (R, Q)
// per pixel in `scratch`, a pass over the chunks back to front turns them
// into suffixes, and the main pass walks the chunks forward, computing T_i
// forward inside a chunk (held in registers) and the adjoint back to front.
// The per-record sum over a tile's pixels is a warp shuffle sum followed by
// a fixed-order sum over warps in shared memory: no float atomics, so two
// runs give the same bits.  Each pair writes its row of nf gradients to
// its pre-sort slot (c * n + rank); slots are unique, so the write is an
// assignment and the wrapper's sum over the cap slots of a record is
// deterministic too.
//
// What bounds it on the H100: arithmetic.  A pair reads nf * 4 bytes of
// record and is evaluated against every pixel of its tile (256 for 16x16
// tiles): some 10 FP32 operations for the support test, and inside the
// support one expf and about 15 (forward) or 45 (backward) more.  The
// backward runs each pair's support test three times and its expf twice
// (pass 1, then pass 2's forward and backward walks over a chunk), where a
// one-pass adjoint reading the forward's residuals would run each once,
// and pays the per-record warp sums (8 or 11 fields) and two barriers per
// chunk of 32 records.
//
// Design: one CTA per tile, one thread per pixel (tile_pixels must be a
// multiple of 32 and at most 1024).  Records are staged through shared
// memory in chunks, each decoded once (cull, ellipse cos/sin, cutoff,
// inv_s2).  Built with -fmad=false like tile_blend.cu: the support cutoff
// is a hard threshold and must round as the PyTorch twin does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct DiffParams {
  float min_r;            // min_screen_radius
  float margin2;          // bounds_margin^2
  float neg_inv_2sigma2;  // -0.5 / sigma^2
  float alpha_cap;        // 1 - 1e-7 in float32
  int tiles_x;
  int tile_w;
  int tile_h;
};

constexpr int kFwdChunk = 256;  // records staged per forward chunk
constexpr int kBwdChunk = 32;   // records staged per backward chunk
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void ellipse_cos_sin(float x, float& c, float& s) {
  // render/blend.py::ellipse_cos_sin, float32 coefficients in hex
  const float x2 = x * x;
  s = x * (0x1.fffff6p-1f
           + x2 * (-0x1.5554dep-3f
                   + x2 * (0x1.110a9p-7f
                           + x2 * (-0x1.9f7ff4p-13f
                                   + x2 * (0x1.6aee7ep-19f + x2 * -0x1.60c69p-26f)))));
  c = 0x1p+0f
      + x2 * (-0x1.fffffap-2f
              + x2 * (0x1.555508p-5f
                      + x2 * (-0x1.6c1098p-10f
                              + x2 * (0x1.9fa10cp-16f
                                      + x2 * (-0x1.2320aap-22f + x2 * 0x1.dd704ap-30f)))));
}

// One record decoded for the pixel loop.
struct Rec {
  float cx, cy, op, cut2, inv_s2, cr, cg, cb, d;
  float ca, sa, rr;    // oriented only
  float r, ratio;      // backward's record-scale terms
};

template <bool ORIENTED>
__device__ __forceinline__ Rec load_rec(const float* __restrict__ planes, int rank,
                                        const DiffParams& p) {
  constexpr int nf = ORIENTED ? 10 : 8;
  const float* q = planes + static_cast<size_t>(rank) * nf;
  Rec v;
  v.cx = q[0];
  v.cy = q[1];
  v.r = q[2];
  v.op = q[3];
  v.cr = q[4];
  v.cg = q[5];
  v.cb = q[6];
  v.d = q[nf - 1];
  float scale = v.r;
  v.ca = v.sa = 0.0f;
  v.rr = 1.0f;
  v.ratio = 1.0f;
  if (ORIENTED) {
    v.ratio = q[8];
    v.rr = fmaxf(v.ratio, 1e-3f);
    ellipse_cos_sin(q[7], v.ca, v.sa);
    scale = v.r * v.rr;
  }
  const float scale2 = scale * scale;
  // a culled record gets a negative cutoff: no pixel is inside its support
  v.cut2 = (v.r >= p.min_r) ? p.margin2 * scale2 : -1.0f;
  v.inv_s2 = 1.0f / fmaxf(scale2, 1e-12f);
  return v;
}

// distance^2 of pixel (px, py) to record j in its ellipse frame; u, vr out
template <bool ORIENTED>
__device__ __forceinline__ float dist2_of(float dx, float dy, float ca, float sa,
                                          float rr, float& u, float& vr) {
  if (ORIENTED) {
    u = ca * dx + sa * dy;
    vr = (-sa * dx + ca * dy) * rr;
    return u * u + vr * vr;
  }
  u = vr = 0.0f;
  return dx * dx + dy * dy;
}

template <bool ORIENTED>
__global__ void __launch_bounds__(1024) diff_fwd_kernel(const int* __restrict__ offsets,
                                const int* __restrict__ pair_rank,
                                const float* __restrict__ planes,
                                float* __restrict__ tile_color,
                                float* __restrict__ tile_alpha,
                                float* __restrict__ tile_depth, DiffParams p) {
  __shared__ float s_cx[kFwdChunk], s_cy[kFwdChunk], s_op[kFwdChunk];
  __shared__ float s_cut2[kFwdChunk], s_inv_s2[kFwdChunk];
  __shared__ float s_r[kFwdChunk], s_g[kFwdChunk], s_b[kFwdChunk], s_d[kFwdChunk];
  __shared__ float s_ca[ORIENTED ? kFwdChunk : 1], s_sa[ORIENTED ? kFwdChunk : 1],
      s_rr[ORIENTED ? kFwdChunk : 1];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = static_cast<float>((t % p.tiles_x) * p.tile_w + tid % p.tile_w) + 0.5f;
  const float py = static_cast<float>((t / p.tiles_x) * p.tile_h + tid / p.tile_w) + 0.5f;
  const int start = offsets[t];
  const int end = offsets[t + 1];

  float trans = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, cd = 0.0f;
  for (int base = start; base < end; base += kFwdChunk) {
    const int n = min(kFwdChunk, end - base);
    for (int j = tid; j < n; j += blockDim.x) {
      const Rec v = load_rec<ORIENTED>(planes, pair_rank[base + j], p);
      s_cx[j] = v.cx;
      s_cy[j] = v.cy;
      s_op[j] = v.op;
      s_cut2[j] = v.cut2;
      s_inv_s2[j] = v.inv_s2;
      s_r[j] = v.cr;
      s_g[j] = v.cg;
      s_b[j] = v.cb;
      s_d[j] = v.d;
      if (ORIENTED) {
        s_ca[j] = v.ca;
        s_sa[j] = v.sa;
        s_rr[j] = v.rr;
      }
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      float u, vr;
      const float d2 = dist2_of<ORIENTED>(px - s_cx[j], py - s_cy[j],
                                          ORIENTED ? s_ca[j] : 0.0f,
                                          ORIENTED ? s_sa[j] : 0.0f,
                                          ORIENTED ? s_rr[j] : 1.0f, u, vr);
      if (d2 <= s_cut2[j]) {
        const float shape = expf(p.neg_inv_2sigma2 * (d2 * s_inv_s2[j]));
        const float a = fminf(s_op[j] * shape, p.alpha_cap);
        const float w = a * trans;
        cr += s_r[j] * w;
        cg += s_g[j] * w;
        cb += s_b[j] * w;
        cd += s_d[j] * w;
        trans *= 1.0f - a;
      }
    }
    __syncthreads();  // before the next chunk overwrites the staging
  }

  const size_t pix = static_cast<size_t>(t) * blockDim.x + tid;
  tile_color[pix * 3 + 0] = cr;
  tile_color[pix * 3 + 1] = cg;
  tile_color[pix * 3 + 2] = cb;
  tile_alpha[pix] = 1.0f - trans;
  tile_depth[pix] = cd;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;  // lane 0 holds the sum, in a fixed order
}

// MAXT: the largest block this instantiation launches with, so ptxas fits
// its registers (the per-chunk T and shape arrays live there) to the block
template <bool ORIENTED, int MAXT>
__global__ void __launch_bounds__(MAXT) diff_bwd_kernel(const int* __restrict__ offsets,
                                const int* __restrict__ pair_rank,
                                const int* __restrict__ pair_slot,
                                const int* __restrict__ chunk_off,
                                const float* __restrict__ planes,
                                const float* __restrict__ g_color,
                                const float* __restrict__ g_alpha,
                                const float* __restrict__ g_depth,
                                float* __restrict__ scratch,
                                float* __restrict__ grad_slots, DiffParams p) {
  // per-pixel sums per record: cx cy sum(g_nd2 nd2) op cr cg cb d
  // [+ g_ca g_sa sum(g_vr vr)]
  constexpr int NR = ORIENTED ? 11 : 8;
  constexpr int nf = ORIENTED ? 10 : 8;
  __shared__ Rec s_rec[kBwdChunk];
  __shared__ int s_slot[kBwdChunk];
  extern __shared__ float s_part[];  // [warps][kBwdChunk][NR]

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int tp = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = tp >> 5;
  const float px = static_cast<float>((t % p.tiles_x) * p.tile_w + tid % p.tile_w) + 0.5f;
  const float py = static_cast<float>((t / p.tiles_x) * p.tile_h + tid / p.tile_w) + 0.5f;
  const int start = offsets[t];
  const int end = offsets[t + 1];
  const int nchunks = (end - start + kBwdChunk - 1) / kBwdChunk;

  const size_t pix = static_cast<size_t>(t) * tp + tid;
  const float gcr = g_color[pix * 3 + 0], gcg = g_color[pix * 3 + 1],
              gcb = g_color[pix * 3 + 2];
  const float gd = g_depth[pix];
  const float ga_out = g_alpha[pix];
  // this pixel's (R, Q) per chunk: slot c at mine[2c * tp], mine[(2c+1) * tp]
  float* mine = scratch + static_cast<size_t>(chunk_off[t]) * 2 * tp + tid;

  auto stage = [&](int base, int n) {
    if (tid < n) {
      s_rec[tid] = load_rec<ORIENTED>(planes, pair_rank[base + tid], p);
      s_slot[tid] = pair_slot[base + tid];
    }
    __syncthreads();
  };

  // pass 1: each chunk's own composite relative to its start,
  // R_c = sum_k w_k a_k prod_{j<k}(1 - a_j), Q_c = prod_k (1 - a_k)
  for (int c = 0; c < nchunks; ++c) {
    const int base = start + c * kBwdChunk;
    const int n = min(kBwdChunk, end - base);
    stage(base, n);
    float r = 0.0f, q = 1.0f;
    for (int j = 0; j < n; ++j) {
      const Rec& v = s_rec[j];
      float u, vr;
      const float d2 = dist2_of<ORIENTED>(px - v.cx, py - v.cy, v.ca, v.sa, v.rr, u, vr);
      if (d2 <= v.cut2) {
        const float a = fminf(v.op * expf(p.neg_inv_2sigma2 * (d2 * v.inv_s2)), p.alpha_cap);
        const float w_pan = ((v.cr * gcr + v.cg * gcg) + v.cb * gcb) + v.d * gd;
        r += (w_pan * a) * q;
        q *= 1.0f - a;
      }
    }
    mine[(2 * c) * tp] = r;
    mine[(2 * c + 1) * tp] = q;
    __syncthreads();  // before the next chunk overwrites the staging
  }
  // suffix over chunks, back to front: slot c becomes the composite of all
  // records after chunk c, relative to its end
  {
    float ra = 0.0f, qa = 1.0f;
    for (int c = nchunks - 1; c >= 0; --c) {
      const float rc = mine[(2 * c) * tp], qc = mine[(2 * c + 1) * tp];
      mine[(2 * c) * tp] = ra;
      mine[(2 * c + 1) * tp] = qa;
      ra = rc + qc * ra;
      qa = qc * qa;
    }
  }

  // pass 2: forward over chunks; inside a chunk, T_i forward, then the
  // adjoint back to front with R_i = w_{i+1} a_{i+1} + (1 - a_{i+1}) R_{i+1}
  // (what follows record i, seen through it) and Q_i = prod_{j>i} (1 - a_j):
  //   dL/da_i = T_i (w_i - R_i + gA Q_i)
  float trans = 1.0f;
  for (int c = 0; c < nchunks; ++c) {
    const int base = start + c * kBwdChunk;
    const int n = min(kBwdChunk, end - base);
    stage(base, n);
    float t_loc[kBwdChunk], s_loc[kBwdChunk];
#pragma unroll
    for (int j = 0; j < kBwdChunk; ++j) {
      if (j < n) {
        const Rec& v = s_rec[j];
        float u, vr;
        const float d2 = dist2_of<ORIENTED>(px - v.cx, py - v.cy, v.ca, v.sa, v.rr, u, vr);
        t_loc[j] = trans;
        s_loc[j] = 0.0f;
        if (d2 <= v.cut2) {
          s_loc[j] = expf(p.neg_inv_2sigma2 * (d2 * v.inv_s2));
          trans *= 1.0f - fminf(v.op * s_loc[j], p.alpha_cap);
        }
      }
    }
    float r = mine[(2 * c) * tp];
    float q = mine[(2 * c + 1) * tp];
#pragma unroll
    for (int jj = 0; jj < kBwdChunk; ++jj) {
      const int j = kBwdChunk - 1 - jj;
      if (j < n) {  // n is the same for the whole block
        const Rec& v = s_rec[j];
        const float dx = px - v.cx;
        const float dy = py - v.cy;
        float u, vr;
        const float d2 = dist2_of<ORIENTED>(dx, dy, v.ca, v.sa, v.rr, u, vr);
        const bool in = d2 <= v.cut2;
        float g[NR];
#pragma unroll
        for (int f = 0; f < NR; ++f) g[f] = 0.0f;
        if (in) {
          const float nd2 = d2 * v.inv_s2;
          const float shape = s_loc[j];
          const float a_raw = v.op * shape;
          const float a = fminf(a_raw, p.alpha_cap);
          const float ti = t_loc[j];
          const float w_pan = ((v.cr * gcr + v.cg * gcg) + v.cb * gcb) + v.d * gd;
          const float at = a * ti;
          const float ga = ti * ((w_pan - r) + ga_out * q);
          const float g_prod = (a_raw < p.alpha_cap) ? ga : 0.0f;
          const float g_nd2 = ((g_prod * v.op) * p.neg_inv_2sigma2) * shape;
          const float g_dist2 = g_nd2 * v.inv_s2;
          if (ORIENTED) {
            const float g_u = (g_dist2 * 2.0f) * u;
            const float g_vr = (g_dist2 * 2.0f) * vr;
            g[0] = -(g_u * v.ca + g_vr * (-v.sa * v.rr));
            g[1] = -(g_u * v.sa + g_vr * (v.ca * v.rr));
            g[8] = g_u * dx + (g_vr * dy) * v.rr;
            g[9] = g_u * dy - (g_vr * dx) * v.rr;
            g[10] = g_vr * vr;
          } else {
            g[0] = (g_dist2 * -2.0f) * dx;
            g[1] = (g_dist2 * -2.0f) * dy;
          }
          g[2] = g_nd2 * nd2;
          g[3] = g_prod * shape;
          g[4] = gcr * at;
          g[5] = gcg * at;
          g[6] = gcb * at;
          g[7] = gd * at;
          r = w_pan * a + (1.0f - a) * r;
          q *= 1.0f - a;
        }
        float* part = s_part + (static_cast<size_t>(warp) * kBwdChunk + j) * NR;
        if (__any_sync(kFull, in)) {
#pragma unroll
          for (int f = 0; f < NR; ++f) {
            const float sum = warp_sum(g[f]);
            if (lane == 0) part[f] = sum;
          }
        } else if (lane == 0) {
#pragma unroll
          for (int f = 0; f < NR; ++f) part[f] = 0.0f;
        }
      }
    }
    __syncthreads();
    if (tid < n) {
      // fixed-order sum over warps, then the record-scale terms
      float s[NR];
#pragma unroll
      for (int f = 0; f < NR; ++f) s[f] = 0.0f;
      for (int w = 0; w < nwarps; ++w) {
        const float* part = s_part + (static_cast<size_t>(w) * kBwdChunk + tid) * NR;
#pragma unroll
        for (int f = 0; f < NR; ++f) s[f] += part[f];
      }
      const Rec& v = s_rec[tid];
      float* row = grad_slots + static_cast<size_t>(s_slot[tid]) * nf;
      row[0] = s[0];
      row[1] = s[1];
      row[3] = s[3];
      row[4] = s[4];
      row[5] = s[5];
      row[6] = s[6];
      row[nf - 1] = s[7];
      if (ORIENTED) {
        const float sc = v.r * v.rr;
        const float live = (sc * sc > 1e-12f) ? 1.0f : 0.0f;
        row[2] = ((s[2] * -2.0f) * live) / fmaxf(v.r, 1e-9f);
        row[7] = -s[8] * v.sa + s[9] * v.ca;
        const float g_rr = s[10] / v.rr + ((s[2] * -2.0f) * live) / v.rr;
        row[8] = (v.ratio >= 1e-3f) ? g_rr : 0.0f;
      } else {
        const float live = (v.r * v.r > 1e-12f) ? 1.0f : 0.0f;
        row[2] = ((s[2] * -2.0f) * live) / fmaxf(v.r, 1e-9f);
      }
    }
    __syncthreads();  // before the next chunk overwrites staging and sums
  }
}

DiffParams make_params(int tiles_x, int tile_w, int tile_h, float min_r, float margin2,
                       float neg_inv_2sigma2, float alpha_cap) {
  return DiffParams{min_r, margin2, neg_inv_2sigma2, alpha_cap, tiles_x, tile_w, tile_h};
}

}  // namespace

// Forward: composite every tile.  Device pointers: offsets (T+1) and
// pair_rank (P) int32, planes (N, nf) float32 in canonical order; outputs
// tile_color (T, tp, 3), tile_alpha (T, tp), tile_depth (T, tp) float32,
// tp = tile_w * tile_h, a multiple of 32 and at most 1024.  Launches on
// `stream` without synchronising; returns cudaGetLastError().
extern "C" int tile_blend_diff_forward(const int* offsets, const int* pair_rank,
                                       const float* planes, float* tile_color,
                                       float* tile_alpha, float* tile_depth,
                                       int num_tiles, int tiles_x, int tile_w,
                                       int tile_h, int oriented, float min_r,
                                       float margin2, float neg_inv_2sigma2,
                                       float alpha_cap, void* stream) {
  const DiffParams p = make_params(tiles_x, tile_w, tile_h, min_r, margin2,
                                   neg_inv_2sigma2, alpha_cap);
  const int threads = tile_w * tile_h;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (oriented)
    diff_fwd_kernel<true><<<num_tiles, threads, 0, s>>>(
        offsets, pair_rank, planes, tile_color, tile_alpha, tile_depth, p);
  else
    diff_fwd_kernel<false><<<num_tiles, threads, 0, s>>>(
        offsets, pair_rank, planes, tile_color, tile_alpha, tile_depth, p);
  return static_cast<int>(cudaGetLastError());
}

// Backward: per-pair gradient rows.  Inputs as the forward's plus
// pair_slot (P) int32, chunk_off (T+1) int32 (tile t's first 32-record
// chunk among all tiles' chunks: the exclusive cumsum of ceil(count / 32))
// and the cotangents g_color (T, tp, 3), g_alpha and g_depth (T, tp);
// scratch holds 2 * tp floats per chunk.  Writes row pair_slot[i] of
// grad_slots (cap * N, nf) float32 for every pair i of every run (the
// caller zeroes it first).  Returns cudaGetLastError().
extern "C" int tile_blend_diff_backward(
    const int* offsets, const int* pair_rank, const int* pair_slot, const int* chunk_off,
    const float* planes, const float* g_color, const float* g_alpha, const float* g_depth,
    float* scratch, float* grad_slots, int num_tiles, int tiles_x, int tile_w, int tile_h,
    int oriented, float min_r, float margin2, float neg_inv_2sigma2, float alpha_cap,
    void* stream) {
  const DiffParams p = make_params(tiles_x, tile_w, tile_h, min_r, margin2,
                                   neg_inv_2sigma2, alpha_cap);
  const int threads = tile_w * tile_h;
  const int nr = oriented ? 11 : 8;
  const size_t smem = static_cast<size_t>(threads / 32) * kBwdChunk * nr * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TBD_BWD(O, M)                                                                    \
  diff_bwd_kernel<O, M><<<num_tiles, threads, smem, s>>>(offsets, pair_rank, pair_slot, \
                                                          chunk_off, planes, g_color,    \
                                                          g_alpha, g_depth, scratch,     \
                                                          grad_slots, p)
  if (oriented) {
    if (threads <= 256) TBD_BWD(true, 256);
    else if (threads <= 512) TBD_BWD(true, 512);
    else TBD_BWD(true, 1024);
  } else {
    if (threads <= 256) TBD_BWD(false, 256);
    else if (threads <= 512) TBD_BWD(false, 512);
    else TBD_BWD(false, 1024);
  }
#undef TBD_BWD
  return static_cast<int>(cudaGetLastError());
}
