// Per-tile front-to-back splat compositing, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels splat_renderer_tpu/ops/tile_blend.py::
// _make_tile_kernel (one grid step per nonempty tile, the Engine default)
// and ::_make_kernel (one grid step per record window).  Both compute this
// image; so does render/compositor.py::render_tiles, which the plain twin
// in ops/tile_blend.py mirrors.
//
// What it computes, per tile: the tile's run of records, depth-ordered by
// the binner, is composited front to back over the tile's pixels.  Each
// record is dequantized from its three u32 words (multiplies by the INV_*
// constants only), culled below min_screen_radius, and gives
//   alpha = opacity * exp(d2 * coef)   inside d2 <= margin2 * scale2
// (or hard coverage for the opaque and opaque+quad profiles), with d2
// measured in the oriented ellipse frame when the profile is oriented.
// Per pixel: color += rgb * alpha * T;  T *= 1 - alpha.
//
// What bounds it on the H100: per (pixel, record) pair the work is some 15
// to 25 FP32 operations and, inside the support, one expf, on FP32 units
// outside the tensor cores; a record costs 16 bytes of gathered reads
// (rank + three words) against hundreds of pixel evaluations, so device
// memory is not the limit.  What is: arithmetic per pair, the barrier per
// chunk of records, the latency of the gathered record loads, and the
// imbalance between tiles (a silhouette tile holds many more records than
// a background tile).
//
// Design: one CTA per tile, one thread per pixel.  The tile's records are
// staged through shared memory in chunks of blockDim records: each thread
// gathers one record by rank and decodes it once (dequantization, cull,
// ellipse cos/sin, coef), so the per-pixel loop reads only broadcast
// shared memory.  T and the colour stay in registers; a pixel stops at
// T <= eps, and a block vote (__syncthreads_or) stops loading chunks once
// every pixel has stopped.  Zero-alpha records are skipped, which is exact.
//
// Bit-level parity: the support cutoff is a hard threshold (one ulp in d2
// flips a pixel's alpha by ~0.011), so d2, the ellipse rotation, the
// cos/sin polynomial and the dequantization must round exactly as the
// PyTorch and JAX versions do.  The library is built with -fmad=false (no
// multiply-add contraction) and without fast math (IEEE division for coef,
// expf not __expf).  The polynomial coefficients are the float32 values of
// the decimal constants in render/blend.py::ellipse_cos_sin, written in
// hex.  Transmittance is the plain sequential product here and a
// 128-record Hillis-Steele product on the TPU, so images agree within
// 2e-5, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct BlendParams {
  float inv_ps;           // 1 / pos_scale
  float pos_offset;       // screen-grid origin shift (px)
  float min_r;            // min_screen_radius
  float margin2;          // bounds_margin^2
  float neg_inv_2sigma2;  // -0.5 / sigma^2
  float eps;              // transmittance floor for early exit
  float inv_color;        // INV_COLOR_SCALE
  float inv_angle;        // INV_ANGLE_SCALE
  float inv_ratio;        // INV_RATIO_SCALE
  float pi;               // float32(pi)
  int tiles_x;
  int tile_w;
  int tile_h;
};

enum Shape { kGauss = 0, kOpaque = 1, kQuad = 2 };

constexpr int kFields = 11;  // shared-memory planes per staged record

__device__ __forceinline__ void ellipse_cos_sin(float x, float& c, float& s) {
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

__device__ __forceinline__ float u2f(uint32_t v) {
  return static_cast<float>(static_cast<int>(v));
}

template <bool ORIENTED, int SHAPE>
__global__ void tile_blend_kernel(const int* __restrict__ offsets,
                                  const int* __restrict__ pair_rank,
                                  const int* __restrict__ rec_pos,
                                  const int* __restrict__ rec_ro,
                                  const int* __restrict__ rec_rgb,
                                  float* __restrict__ tile_color,
                                  float* __restrict__ tile_alpha,
                                  BlendParams p) {
  extern __shared__ float smem[];
  const int chunk = blockDim.x;
  float* s_cx = smem;
  float* s_cy = s_cx + chunk;
  float* s_op = s_cy + chunk;
  float* s_cut2 = s_op + chunk;  // margin2*scale2 (Gaussian) or scale2
  float* s_coef = s_cut2 + chunk;
  float* s_r = s_coef + chunk;
  float* s_g = s_r + chunk;
  float* s_b = s_g + chunk;
  float* s_ca = s_b + chunk;
  float* s_sa = s_ca + chunk;
  float* s_rr = s_sa + chunk;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = t % p.tiles_x;
  const int ty = t / p.tiles_x;
  const float px = static_cast<float>(tx * p.tile_w + tid % p.tile_w) + 0.5f;
  const float py = static_cast<float>(ty * p.tile_h + tid / p.tile_w) + 0.5f;
  const int start = offsets[t];
  const int end = offsets[t + 1];

  float trans = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;

  for (int base = start; base < end; base += chunk) {
    const int n = min(chunk, end - base);
    if (tid < n) {
      // gather one record by rank and decode it once for the whole tile
      const int rank = pair_rank[base + tid];
      const uint32_t wp = static_cast<uint32_t>(rec_pos[rank]);
      const uint32_t wr = static_cast<uint32_t>(rec_ro[rank]);
      const uint32_t wc = static_cast<uint32_t>(rec_rgb[rank]);
      const float r = u2f(wr & 0xFFFFu) * p.inv_ps;
      float op = u2f(wc >> 24) * p.inv_color;
      if (!(r >= p.min_r)) op = 0.0f;
      s_cx[tid] = u2f(wp & 0xFFFFu) * p.inv_ps - p.pos_offset;
      s_cy[tid] = u2f(wp >> 16) * p.inv_ps - p.pos_offset;
      s_op[tid] = op;
      float scale = r;
      if (ORIENTED) {
        const float ang = u2f((wr >> 16) & 0xFFu) * p.inv_angle - p.pi;
        const float rr = fmaxf(u2f(wr >> 24) * p.inv_ratio, 1e-3f);
        float c, s;
        ellipse_cos_sin(ang, c, s);
        s_ca[tid] = c;
        s_sa[tid] = s;
        s_rr[tid] = rr;
        scale = r * rr;
      }
      const float scale2 = scale * scale;
      s_cut2[tid] = (SHAPE == kGauss) ? p.margin2 * scale2 : scale2;
      s_coef[tid] = p.neg_inv_2sigma2 / fmaxf(scale2, 1e-12f);
      s_r[tid] = u2f(wc & 0xFFu) * p.inv_color;
      s_g[tid] = u2f((wc >> 8) & 0xFFu) * p.inv_color;
      s_b[tid] = u2f((wc >> 16) & 0xFFu) * p.inv_color;
    }
    __syncthreads();

    if (trans > p.eps) {
      for (int j = 0; j < n; ++j) {
        const float dx = px - s_cx[j];
        const float dy = py - s_cy[j];
        float u = 0.0f, vr = 0.0f, d2;
        if (ORIENTED) {
          const float ca = s_ca[j], sa = s_sa[j];
          u = ca * dx + sa * dy;
          vr = (-sa * dx + ca * dy) * s_rr[j];
          d2 = u * u + vr * vr;
        } else {
          d2 = dx * dx + dy * dy;
        }
        const float cut2 = s_cut2[j];
        float alpha;
        if (SHAPE == kGauss) {
          alpha = (d2 <= cut2) ? s_op[j] * expf(d2 * s_coef[j]) : 0.0f;
        } else if (SHAPE == kOpaque) {
          alpha = (d2 <= cut2) ? s_op[j] : 0.0f;
        } else {
          const bool inside = ORIENTED ? (u * u <= cut2 && vr * vr <= cut2)
                                       : (dx * dx <= cut2 && dy * dy <= cut2);
          alpha = inside ? s_op[j] : 0.0f;
        }
        if (alpha > 0.0f) {
          const float w = alpha * trans;
          cr += s_r[j] * w;
          cg += s_g[j] * w;
          cb += s_b[j] * w;
          trans *= 1.0f - alpha;
          if (trans <= p.eps) break;
        }
      }
    }
    // the vote doubles as the barrier before the next chunk overwrites smem
    if (!__syncthreads_or(trans > p.eps)) break;
  }

  const size_t pix = static_cast<size_t>(t) * blockDim.x + tid;
  tile_color[pix * 3 + 0] = cr;
  tile_color[pix * 3 + 1] = cg;
  tile_color[pix * 3 + 2] = cb;
  tile_alpha[pix] = 1.0f - trans;
}

template <bool ORIENTED, int SHAPE>
void launch(int num_tiles, int threads, size_t smem, cudaStream_t stream,
            const int* offsets, const int* pair_rank, const int* rec_pos,
            const int* rec_ro, const int* rec_rgb, float* tile_color,
            float* tile_alpha, const BlendParams& p) {
  tile_blend_kernel<ORIENTED, SHAPE><<<num_tiles, threads, smem, stream>>>(
      offsets, pair_rank, rec_pos, rec_ro, rec_rgb, tile_color, tile_alpha, p);
}

}  // namespace

// Composite every tile.  Pointers are device pointers: offsets (T+1) int32,
// pair_rank (P) int32, rec_pos/rec_ro/rec_rgb (N) int32 bit patterns of the
// u32 words in canonical (rank) order; outputs tile_color (T, tp, 3) and
// tile_alpha (T, tp) float32 with tp = tile_w * tile_h <= 1024.
// shape: 0 Gaussian, 1 opaque ellipse, 2 opaque quad.  Launches on
// `stream` without synchronising; returns cudaGetLastError().
extern "C" int tile_blend_forward(const int* offsets, const int* pair_rank,
                                  const int* rec_pos, const int* rec_ro,
                                  const int* rec_rgb, float* tile_color,
                                  float* tile_alpha, int num_tiles,
                                  int tiles_x, int tile_w, int tile_h,
                                  int oriented, int shape, float inv_ps,
                                  float pos_offset, float min_r, float margin2,
                                  float neg_inv_2sigma2, float eps,
                                  float inv_color, float inv_angle,
                                  float inv_ratio, float pi, void* stream) {
  const BlendParams p{inv_ps,    pos_offset, min_r,     margin2, neg_inv_2sigma2,
                      eps,       inv_color,  inv_angle, inv_ratio, pi,
                      tiles_x,   tile_w,     tile_h};
  const int threads = tile_w * tile_h;
  const size_t smem = static_cast<size_t>(threads) * kFields * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TB_ARGS num_tiles, threads, smem, s, offsets, pair_rank, rec_pos, rec_ro, \
                rec_rgb, tile_color, tile_alpha, p
  if (oriented) {
    if (shape == kGauss) launch<true, kGauss>(TB_ARGS);
    else if (shape == kOpaque) launch<true, kOpaque>(TB_ARGS);
    else launch<true, kQuad>(TB_ARGS);
  } else {
    if (shape == kGauss) launch<false, kGauss>(TB_ARGS);
    else if (shape == kOpaque) launch<false, kOpaque>(TB_ARGS);
    else launch<false, kQuad>(TB_ARGS);
  }
#undef TB_ARGS
  return static_cast<int>(cudaGetLastError());
}
