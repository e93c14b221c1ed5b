// Per-tile front-to-back splat compositing, hand-written for Hopper (sm_90a).
//
// Two kernels share every device function of this file, so they cannot
// drift apart:
//
//   tile_blend_kernel     one CTA per tile.  Replaces the Pallas TPU kernels
//                         splat_renderer_tpu/ops/tile_blend.py::
//                         _make_tile_kernel (one grid step per nonempty tile,
//                         the Engine default) and ::_make_kernel (one grid
//                         step per record window).
//   tile_blend_xp_kernel  a persistent grid over the nonempty tiles with a
//                         cross-tile prefetch.  Replaces ::_make_tile_kernel_xp
//                         (each grid step starts the next tile's first copy
//                         before its own compute).
//
// Both compute the image of render/compositor.py::render_tiles, which the
// plain twin in ops/tile_blend.py mirrors, and with WITH_DEPTH also the
// G-buffer's premultiplied depth (the TPU kernels' `with_depth` stream).
//
// What it computes, per tile: the tile's run of records, depth-ordered by
// the binner, is composited front to back over the tile's pixels.  Each
// record is dequantized from its three u32 words (multiplies by the INV_*
// constants only), culled below min_screen_radius, and gives
//   alpha = opacity * exp(d2 * coef)   inside d2 <= margin2 * scale2
// (or hard coverage for the opaque and opaque+quad profiles), with d2
// measured in the oriented ellipse frame when the profile is oriented.
// Per pixel: w = alpha * T;  color += rgb * w;  depth += d * w;
// T *= 1 - alpha.  The depth of a record is the bit pattern of its depth
// key with the sign bit cleared (render/packing.py::depth_bits' inverse for
// the positive depths projection emits), read as a float.
//
// What bounds it on the H100: per (pixel, record) pair the work is some 15
// to 25 FP32 operations and, inside the support, one expf, on FP32 units
// outside the tensor cores; a record costs 16 bytes of gathered reads
// (rank + three words; 20 with depth) against hundreds of pixel
// evaluations, so device memory is not the limit.  What is: arithmetic per
// pair, the barrier per chunk of records, the latency of the gathered
// record loads, and the imbalance between tiles (a silhouette tile holds
// many more records than a background tile).
//
// Design of tile_blend_kernel: one CTA per tile, one thread per pixel.  The
// tile's records are staged through shared memory in chunks of blockDim
// records: each thread gathers one record by rank and decodes it once
// (dequantization, cull, ellipse cos/sin, coef), so the per-pixel loop reads
// only broadcast shared memory.  T and the colour stay in registers; a
// pixel stops at T <= eps, and a block vote (__syncthreads_or) stops
// loading chunks once every pixel has stopped.  Zero-alpha records are
// skipped, which is exact.
//
// Design of tile_blend_xp_kernel: the TPU kernel hides the latency of each
// tile's FIRST record copy under the previous tile's compute.  Here a
// persistent grid (a multiple of the SM count, from the occupancy query)
// walks the compact list of nonempty tiles in a fixed stride, so a CTA
// knows its next tile without atomics and an empty tile is never visited
// (the wrapper zeroes the outputs).  The prefetch is a plain register
// prefetch: before the pixel loop over a tile's first chunk, each thread
// issues the gathered loads (rank, then the three or four words) of the
// NEXT tile's first chunk into registers, and decodes them into shared
// memory only after the loop.  The loads are a dependent gather (the words'
// addresses come from the rank), which cp.async cannot chase without a
// second round trip through shared memory; registers can, and the pixel
// loop neither reads nor writes them, so the whole gather is in flight
// under the compute.  Two staging buffers alternate per staged chunk: a
// chunk is written into the buffer that was last read two chunks ago, and
// the barrier that published the chunk in between separates that read from
// this write, so a tile change needs no extra barrier.  Later chunks of a
// tile load as tile_blend_kernel's do (vote, stage, barrier).  Per pixel the
// fold order is the same, so the outputs equal tile_blend_kernel's bit for
// bit at every eps.
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

#include <type_traits>

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

// The binner's tables and the kernels' outputs (device pointers).
struct Stream {
  const int* offsets;    // (T+1) tile t's run is pairs [offsets[t], offsets[t+1])
  const int* pair_rank;  // (P) rank of each pair's record
  const int* rec_pos;    // (N) word planes in canonical (rank) order
  const int* rec_ro;
  const int* rec_rgb;
  const int* rec_depth;  // (N) depth bit patterns; read only WITH_DEPTH
  float* tile_color;     // (T, tp, 3)
  float* tile_alpha;     // (T, tp)
  float* tile_depth;     // (T, tp); written only WITH_DEPTH
};

enum Shape { kGauss = 0, kOpaque = 1, kQuad = 2 };

// shared-memory planes per staged record (one more with depth)
constexpr int kFields = 11;

__host__ __device__ constexpr int num_fields(bool with_depth) {
  return kFields + (with_depth ? 1 : 0);
}

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

// One staging buffer: `chunk` records, one plane per decoded field.
struct Stage {
  float *cx, *cy, *op, *cut2, *coef, *r, *g, *b, *ca, *sa, *rr, *d;
};

__device__ __forceinline__ Stage stage_at(float* base, int chunk) {
  Stage s;
  s.cx = base;
  s.cy = s.cx + chunk;
  s.op = s.cy + chunk;
  s.cut2 = s.op + chunk;  // margin2*scale2 (Gaussian) or scale2
  s.coef = s.cut2 + chunk;
  s.r = s.coef + chunk;
  s.g = s.r + chunk;
  s.b = s.g + chunk;
  s.ca = s.b + chunk;
  s.sa = s.ca + chunk;
  s.rr = s.sa + chunk;
  s.d = s.rr + chunk;  // present only WITH_DEPTH
  return s;
}

// A record's words as gathered from device memory, not yet decoded.
struct Raw {
  uint32_t wp, wr, wc;
  float d;
};

// Gather pair `idx`'s record by rank.
template <bool WITH_DEPTH>
__device__ __forceinline__ Raw load_raw(const Stream& st, int idx) {
  // read-only data: __ldg takes the non-coherent path
  const int rank = __ldg(st.pair_rank + idx);
  Raw raw;
  raw.wp = static_cast<uint32_t>(__ldg(st.rec_pos + rank));
  raw.wr = static_cast<uint32_t>(__ldg(st.rec_ro + rank));
  raw.wc = static_cast<uint32_t>(__ldg(st.rec_rgb + rank));
  raw.d = WITH_DEPTH ? __int_as_float(__ldg(st.rec_depth + rank)) : 0.0f;
  return raw;
}

// Decode one record once for the whole tile, into slot `j` of a stage.
template <bool ORIENTED, int SHAPE, bool WITH_DEPTH>
__device__ __forceinline__ void decode_store(const Stage& s, int j, const Raw& raw,
                                             const BlendParams& p) {
  const uint32_t wp = raw.wp, wr = raw.wr, wc = raw.wc;
  const float r = u2f(wr & 0xFFFFu) * p.inv_ps;
  float op = u2f(wc >> 24) * p.inv_color;
  if (!(r >= p.min_r)) op = 0.0f;
  s.cx[j] = u2f(wp & 0xFFFFu) * p.inv_ps - p.pos_offset;
  s.cy[j] = u2f(wp >> 16) * p.inv_ps - p.pos_offset;
  s.op[j] = op;
  float scale = r;
  if (ORIENTED) {
    const float ang = u2f((wr >> 16) & 0xFFu) * p.inv_angle - p.pi;
    const float rr = fmaxf(u2f(wr >> 24) * p.inv_ratio, 1e-3f);
    float c, sn;
    ellipse_cos_sin(ang, c, sn);
    s.ca[j] = c;
    s.sa[j] = sn;
    s.rr[j] = rr;
    scale = r * rr;
  }
  const float scale2 = scale * scale;
  s.cut2[j] = (SHAPE == kGauss) ? p.margin2 * scale2 : scale2;
  s.coef[j] = p.neg_inv_2sigma2 / fmaxf(scale2, 1e-12f);
  s.r[j] = u2f(wc & 0xFFu) * p.inv_color;
  s.g[j] = u2f((wc >> 8) & 0xFFu) * p.inv_color;
  s.b[j] = u2f((wc >> 16) & 0xFFu) * p.inv_color;
  if (WITH_DEPTH) s.d[j] = raw.d;
}

// One pixel's accumulators.
struct Pixel {
  float px, py;
  float trans;
  float cr, cg, cb, cd;
};

// Fold the n staged records of `s` into one pixel, front to back.
template <bool ORIENTED, int SHAPE, bool WITH_DEPTH>
__device__ __forceinline__ void composite_chunk(const Stage& s, int n, Pixel& q,
                                                const BlendParams& p) {
  if (!(q.trans > p.eps)) return;
  for (int j = 0; j < n; ++j) {
    const float dx = q.px - s.cx[j];
    const float dy = q.py - s.cy[j];
    float u = 0.0f, vr = 0.0f, d2;
    if (ORIENTED) {
      const float ca = s.ca[j], sa = s.sa[j];
      u = ca * dx + sa * dy;
      vr = (-sa * dx + ca * dy) * s.rr[j];
      d2 = u * u + vr * vr;
    } else {
      d2 = dx * dx + dy * dy;
    }
    const float cut2 = s.cut2[j];
    float alpha;
    if (SHAPE == kGauss) {
      alpha = (d2 <= cut2) ? s.op[j] * expf(d2 * s.coef[j]) : 0.0f;
    } else if (SHAPE == kOpaque) {
      alpha = (d2 <= cut2) ? s.op[j] : 0.0f;
    } else {
      const bool inside = ORIENTED ? (u * u <= cut2 && vr * vr <= cut2)
                                   : (dx * dx <= cut2 && dy * dy <= cut2);
      alpha = inside ? s.op[j] : 0.0f;
    }
    if (alpha > 0.0f) {
      const float w = alpha * q.trans;
      q.cr += s.r[j] * w;
      q.cg += s.g[j] * w;
      q.cb += s.b[j] * w;
      if (WITH_DEPTH) q.cd += s.d[j] * w;
      q.trans *= 1.0f - alpha;
      if (q.trans <= p.eps) break;
    }
  }
}

__device__ __forceinline__ Pixel pixel_of(int t, int tid, const BlendParams& p) {
  const int tx = t % p.tiles_x;
  const int ty = t / p.tiles_x;
  Pixel q;
  q.px = static_cast<float>(tx * p.tile_w + tid % p.tile_w) + 0.5f;
  q.py = static_cast<float>(ty * p.tile_h + tid / p.tile_w) + 0.5f;
  q.trans = 1.0f;
  q.cr = q.cg = q.cb = q.cd = 0.0f;
  return q;
}

template <bool WITH_DEPTH>
__device__ __forceinline__ void store_pixel(const Stream& st, int t, int tid,
                                            const Pixel& q) {
  const size_t pix = static_cast<size_t>(t) * blockDim.x + tid;
  st.tile_color[pix * 3 + 0] = q.cr;
  st.tile_color[pix * 3 + 1] = q.cg;
  st.tile_color[pix * 3 + 2] = q.cb;
  st.tile_alpha[pix] = 1.0f - q.trans;
  if (WITH_DEPTH) st.tile_depth[pix] = q.cd;
}

template <bool ORIENTED, int SHAPE, bool WITH_DEPTH>
__global__ void tile_blend_kernel(Stream st, BlendParams p) {
  extern __shared__ float smem[];
  const int chunk = blockDim.x;
  const Stage s = stage_at(smem, chunk);

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = st.offsets[t];
  const int end = st.offsets[t + 1];
  Pixel q = pixel_of(t, tid, p);

  for (int base = start; base < end; base += chunk) {
    const int n = min(chunk, end - base);
    if (tid < n) {
      decode_store<ORIENTED, SHAPE, WITH_DEPTH>(
          s, tid, load_raw<WITH_DEPTH>(st, base + tid), p);
    }
    __syncthreads();
    composite_chunk<ORIENTED, SHAPE, WITH_DEPTH>(s, n, q, p);
    // the vote doubles as the barrier before the next chunk overwrites smem
    if (!__syncthreads_or(q.trans > p.eps)) break;
  }
  store_pixel<WITH_DEPTH>(st, t, tid, q);
}

// Persistent grid over the compact list of nonempty tiles: CTA b takes list
// slots b, b + gridDim, ...  *n_list (a device scalar) is the list's length.
template <bool ORIENTED, int SHAPE, bool WITH_DEPTH>
__global__ void tile_blend_xp_kernel(Stream st, const int* __restrict__ tile_list,
                                     const int* __restrict__ n_list, BlendParams p) {
  extern __shared__ float smem[];
  const int chunk = blockDim.x;
  const int stage_floats = chunk * num_fields(WITH_DEPTH);
  const int tid = threadIdx.x;
  const int n_tiles = *n_list;

  int slot = blockIdx.x;
  // prologue: this CTA's first tile has nothing to hide behind
  Raw raw = {0u, 0u, 0u, 0.0f};
  bool have = false;
  if (slot < n_tiles) {
    const int t = tile_list[slot];
    const int start = st.offsets[t];
    have = tid < st.offsets[t + 1] - start;
    if (have) raw = load_raw<WITH_DEPTH>(st, start + tid);
  }

  int staged = 0;  // chunks staged so far by this CTA; buffer = staged & 1
  for (; slot < n_tiles; slot += gridDim.x) {
    const int t = tile_list[slot];
    const int start = st.offsets[t];
    const int end = st.offsets[t + 1];
    Pixel q = pixel_of(t, tid, p);

    // chunk 0 comes from the registers prefetched under the previous tile
    Stage s = stage_at(smem + (staged & 1) * stage_floats, chunk);
    ++staged;
    if (have) decode_store<ORIENTED, SHAPE, WITH_DEPTH>(s, tid, raw, p);
    __syncthreads();

    // start the next tile's first gather; nothing below touches `raw`
    const int next = slot + gridDim.x;
    have = false;
    if (next < n_tiles) {
      const int tn = tile_list[next];
      const int sn = st.offsets[tn];
      have = tid < st.offsets[tn + 1] - sn;
      if (have) raw = load_raw<WITH_DEPTH>(st, sn + tid);
    }

    composite_chunk<ORIENTED, SHAPE, WITH_DEPTH>(s, min(chunk, end - start), q, p);

    // later chunks of this tile: vote, stage into the other buffer, publish
    for (int base = start + chunk; base < end; base += chunk) {
      if (!__syncthreads_or(q.trans > p.eps)) break;
      const int n = min(chunk, end - base);
      s = stage_at(smem + (staged & 1) * stage_floats, chunk);
      ++staged;
      if (tid < n) {
        decode_store<ORIENTED, SHAPE, WITH_DEPTH>(
            s, tid, load_raw<WITH_DEPTH>(st, base + tid), p);
      }
      __syncthreads();
      composite_chunk<ORIENTED, SHAPE, WITH_DEPTH>(s, n, q, p);
    }
    store_pixel<WITH_DEPTH>(st, t, tid, q);
  }
}

template <bool ORIENTED, int SHAPE, bool WITH_DEPTH>
cudaError_t launch(int num_tiles, int threads, cudaStream_t stream, const Stream& st,
                   const BlendParams& p) {
  const size_t smem = static_cast<size_t>(threads) * num_fields(WITH_DEPTH) * sizeof(float);
  auto kernel = tile_blend_kernel<ORIENTED, SHAPE, WITH_DEPTH>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<num_tiles, threads, smem, stream>>>(st, p);
  return cudaGetLastError();
}

template <bool ORIENTED, int SHAPE, bool WITH_DEPTH>
cudaError_t launch_xp(int num_tiles, int threads, cudaStream_t stream, const Stream& st,
                      const int* tile_list, const int* n_list, const BlendParams& p) {
  const size_t smem =
      2 * static_cast<size_t>(threads) * num_fields(WITH_DEPTH) * sizeof(float);
  auto kernel = tile_blend_xp_kernel<ORIENTED, SHAPE, WITH_DEPTH>;
  // two buffers of a 1024-pixel tile need 88 to 96 KB: above the 48 KB a
  // kernel gets without asking
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  // every CTA resident at once; never more CTAs than tiles
  const int grid = num_tiles < sms * per_sm ? num_tiles : sms * per_sm;
  kernel<<<grid, threads, smem, stream>>>(st, tile_list, n_list, p);
  return cudaGetLastError();
}

// Pick the instantiation for (oriented, shape, with_depth).
template <typename F>
cudaError_t dispatch(int oriented, int shape, int with_depth, F&& f) {
#define TB_CASE(O, S)                                          \
  if (with_depth) return f(std::integral_constant<bool, O>{},  \
                           std::integral_constant<int, S>{},   \
                           std::true_type{});                  \
  return f(std::integral_constant<bool, O>{}, std::integral_constant<int, S>{}, \
           std::false_type{});
  if (oriented) {
    if (shape == kGauss) { TB_CASE(true, kGauss) }
    if (shape == kOpaque) { TB_CASE(true, kOpaque) }
    TB_CASE(true, kQuad)
  }
  if (shape == kGauss) { TB_CASE(false, kGauss) }
  if (shape == kOpaque) { TB_CASE(false, kOpaque) }
  TB_CASE(false, kQuad)
#undef TB_CASE
}

}  // namespace

// Composite every tile.  Pointers are device pointers: offsets (T+1) int32,
// pair_rank (P) int32, rec_pos/rec_ro/rec_rgb (N) int32 bit patterns of the
// u32 words in canonical (rank) order; outputs tile_color (T, tp, 3) and
// tile_alpha (T, tp) float32 with tp = tile_w * tile_h <= 1024.  With
// rec_depth (N, int32 bit patterns of the records' float depths) and
// tile_depth (T, tp) both non-null, the premultiplied depth sum is written
// too; both null selects the instantiation without the depth plane.
// shape: 0 Gaussian, 1 opaque ellipse, 2 opaque quad.
//
// tile_list null: one CTA per tile (tile_blend_kernel).  tile_list (T int32,
// the nonempty tiles first) and n_list (one int32 on the device, their
// number) non-null: the persistent cross-tile-prefetch kernel
// (tile_blend_xp_kernel), which visits only the listed tiles; the caller
// zeroes the outputs.
//
// Launches on `stream` without synchronising; returns the CUDA error code
// of the launch (0 = success).
extern "C" int tile_blend_forward(const int* offsets, const int* pair_rank,
                                  const int* rec_pos, const int* rec_ro,
                                  const int* rec_rgb, const int* rec_depth,
                                  float* tile_color, float* tile_alpha,
                                  float* tile_depth, const int* tile_list,
                                  const int* n_list, int num_tiles,
                                  int tiles_x, int tile_w, int tile_h,
                                  int oriented, int shape, float inv_ps,
                                  float pos_offset, float min_r, float margin2,
                                  float neg_inv_2sigma2, float eps,
                                  float inv_color, float inv_angle,
                                  float inv_ratio, float pi, void* stream) {
  const BlendParams p{inv_ps,    pos_offset, min_r,     margin2, neg_inv_2sigma2,
                      eps,       inv_color,  inv_angle, inv_ratio, pi,
                      tiles_x,   tile_w,     tile_h};
  const Stream st{offsets,  pair_rank,  rec_pos,    rec_ro,    rec_rgb,
                  rec_depth, tile_color, tile_alpha, tile_depth};
  const int with_depth = (rec_depth != nullptr && tile_depth != nullptr) ? 1 : 0;
  if ((rec_depth != nullptr) != (tile_depth != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((tile_list != nullptr) != (n_list != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = tile_w * tile_h;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dispatch(oriented, shape, with_depth, [&](auto o, auto sh, auto wd) {
    constexpr bool O = decltype(o)::value;
    constexpr int S = decltype(sh)::value;
    constexpr bool D = decltype(wd)::value;
    if (tile_list != nullptr) {
      return launch_xp<O, S, D>(num_tiles, threads, s, st, tile_list, n_list, p);
    }
    return launch<O, S, D>(num_tiles, threads, s, st, p);
  });
  return static_cast<int>(err);
}
