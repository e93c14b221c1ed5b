// Per-tile front-to-back splat compositing, hand-written for Hopper (sm_90a).
//
// Two kernels share every device function of this file (they are two entry
// points of one body, `run`), so they cannot drift apart:
//
//   tile_blend_kernel     one CTA per tile.  Replaces the Pallas TPU kernels
//                         splat_renderer_tpu/ops/tile_blend.py::
//                         _make_tile_kernel (one grid step per nonempty tile,
//                         the Engine default) and ::_make_kernel (one grid
//                         step per record window).
//   tile_blend_xp_kernel  a persistent grid over the nonempty tiles, heaviest
//                         first, whose record gathers run ahead across tile
//                         boundaries.  Replaces ::_make_tile_kernel_xp (each
//                         grid step starts the next tile's first copy before
//                         its own compute).
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
// What bounds it on the H100: operations, not bytes, and in practice one
// warp's latency.  A record costs 16 bytes of gathered reads (rank + three
// words; 20 with depth) against hundreds of pixel evaluations.  Only about
// a tenth of a tile's (record, pixel) evaluations fall inside a record's
// support; a silhouette tile holds many times the mean tile's records, and
// inside it the records pile up on a few pixel blocks; the fold is
// sequential per pixel.  So the kernel's time is the walk of the busiest
// warp of the heaviest tile: what counts is how few records that warp
// evaluates, how many cycles one evaluation keeps it waiting, and that it
// waits for nobody.  There are no matrix products here, so the tensor
// cores (wgmma) have no part.
//
// Design.
// * One thread per pixel, a warp over a compact 8x4 pixel block (for tiles
//   whose width is a multiple of 8 and height of 4; other tiles fall back
//   to 32 consecutive pixels of the row-major order).  The output layout
//   (T, tp, 3) stays row-major in the tile.
// * Every warp walks the tile's run on its own: no block barrier, nothing
//   shared between warps.  With a barrier per staged chunk a tile costs the
//   sum over chunks of its slowest warp; the busiest warp changes with
//   depth, so that sum was about twice the busiest warp's own work.  A warp
//   whose pixels have all stopped leaves the tile at once.  The price is
//   that each warp gathers and half-decodes every record of the run (warps
//   that walk close together share the sectors in L1).
// * Warp-level culling.  Per 32 records each lane decodes ONE record as far
//   as the test needs (centre, cutoff, ratio) and tests it against the
//   rectangle of the centres of the warp's pixels that are still alive (the
//   distance of the nearest point, squared, against the record's cutoff;
//   warp_cull.cuh's `cull_live`); a ballot gives the warp its live records,
//   and the pixel loop walks the set bits in ascending order, so the fold
//   stays front to back.  A skipped record has alpha 0 at every alive pixel of
//   the warp, and a stopped pixel takes nothing: the image does not change
//   by a bit.  The rectangle shrinks whenever a pixel stops (at most 32
//   times a tile).  For the isotropic profiles the test is exact (float
//   subtraction, squaring and addition are monotone under
//   round-to-nearest); for the oriented ones it is the isotropic test
//   against cut2 / min(1, rr)^2, widened by kCullSlack for the rounding of
//   the rotation.
// * Packed staging, per warp.  Only the live records are decoded in full
//   (colour, coef's IEEE division, the ellipse polynomial), by their lanes,
//   into the warp's slot of shared memory: two or three float4 a record,
//   (cx, cy, cut2, coef), (op, r, g, b) and, when the profile is oriented or
//   the depth rides along, (ca, sa, rr, d), read back as 16-byte broadcast
//   loads.  Two slots alternate, so one __syncwarp per 32 records orders
//   the writes and the reads.  A record that can never contribute (culled
//   below min_screen_radius, or opacity 0) gets cut2 = -1 and is never live.
// * The pixel loop takes the live records four at a time (two in the
//   1024-thread blocks, for registers): their alphas are independent of each
//   other and of T, every lane runs the same instructions (no branch on
//   "inside"), the fold selects instead of branching, and the next batch is
//   evaluated beside the current batch's fold, so the only serial chain is
//   T's.  A record that contributes nothing adds +0 and multiplies T by 1:
//   the same bits as skipping it.
// * Every gather in flight under compute.  A warp takes 64 records a step,
//   two per lane.  The gather is dependent (rank, then the three or four
//   words by rank), which cp.async cannot chase without a second trip
//   through shared memory, so it is a register pipeline: the words of the
//   next step and the ranks of the step after it are loading while this
//   step computes.
// * tile_blend_xp_kernel walks the compact list of nonempty tiles, sorted by
//   record count (descending), in a fixed snake stride: CTA b of G takes
//   list slots b, 2G-1-b, 2G+b, ..., so each CTA gets a like share of heavy
//   and light tiles, the heaviest start first, no tile needs an atomic, and
//   an empty tile is never visited (the wrapper zeroes the outputs).  Its
//   warps go from tile to tile on their own and their pipelines run across
//   the boundary.  When a warp leaves a tile early its registers hold later
//   steps of that tile, and the next tile's first gather starts then,
//   exposed.
// * Early stop: a pixel takes nothing more once its T <= eps (after the
//   record that brought it there).  At eps = 0 only pixels whose T is
//   exactly 0 stop; in a deep tile most do, by underflow.
// * The walk counter (tile_blend_kernel only): with BlendParams::walked
//   set, each CTA adds, with one atomic at its end, the run positions its
//   tile's walk took: its longest warp's, each warp's up to the end of the
//   32-record group in which its last pixel stopped, or the whole run.  The
//   plain twin counts the same walk at its exact stop, so the two differ by
//   less than one group a nonempty tile.  Null, nothing is counted; the
//   outputs are the same bits either way.
//
// Bit-level parity: the support cutoff is a hard threshold (one ulp in d2
// flips a pixel's alpha by ~0.011), so d2, the ellipse rotation, the
// cos/sin polynomial and the dequantization must round exactly as the
// PyTorch and JAX versions do.  The library is built with -fmad=false (no
// multiply-add contraction) and without fast math (IEEE division for coef,
// expf not __expf).  The polynomial coefficients are the float32 values of
// the decimal constants in render/blend.py::ellipse_cos_sin, written in
// hex (warp_cull.cuh, shared with tile_blend_diff.cu).  Transmittance is
// the plain sequential product here and a 128-record Hillis-Steele product
// on the TPU, so images agree within 2e-5, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "warp_cull.cuh"

namespace {

using warp_cull::kFull;
using warp_cull::Rect;

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
  long long* walked;      // nullable: the walk counter (file note)
};

// The binner's tables and the kernels' outputs (device pointers).
struct Stream {
  const int* offsets;    // (T+1) tile t's run is pairs [offsets[t], offsets[t+1])
  const int* pair_rank;  // (P) index of each pair's record
  const int* rec_pos;    // (N) word planes, indexed by pair_rank
  const int* rec_ro;
  const int* rec_rgb;
  const int* rec_depth;  // (N) depth bit patterns; read only WITH_DEPTH
  float* tile_color;     // (T, tp, 3)
  float* tile_alpha;     // (T, tp)
  float* tile_depth;     // (T, tp); written only WITH_DEPTH
};

enum Shape { kGauss = 0, kOpaque = 1, kQuad = 2 };

// float4 per staged record
__host__ __device__ constexpr int num_vecs(bool oriented, bool with_depth) {
  return (oriented || with_depth) ? 3 : 2;
}

__device__ __forceinline__ float u2f(uint32_t v) {
  return static_cast<float>(static_cast<int>(v));
}

// A warp's staging slot: 32 decoded records, a (cx, cy, cut2, coef),
// b (op, r, g, b), c (ca, sa, rr, d; present when oriented or with depth).
struct Stage {
  float4 *a, *b, *c;
};

__device__ __forceinline__ Stage stage_at(float4* base) {
  Stage s;
  s.a = base;
  s.b = base + 32;
  s.c = base + 64;
  return s;
}

// A record's words as gathered from device memory, not yet decoded.
struct Raw {
  uint32_t wp, wr, wc;
  float d;
};

// Gather a record's words by rank.
template <bool WITH_DEPTH>
__device__ __forceinline__ Raw load_words(const Stream& st, int rank) {
  // read-only data: __ldg takes the non-coherent path, through L1, where
  // the warps of a tile that walk close together find each other's sectors
  Raw raw;
  raw.wp = static_cast<uint32_t>(__ldg(st.rec_pos + rank));
  raw.wr = static_cast<uint32_t>(__ldg(st.rec_ro + rank));
  raw.wc = static_cast<uint32_t>(__ldg(st.rec_rgb + rank));
  raw.d = WITH_DEPTH ? __int_as_float(__ldg(st.rec_depth + rank)) : 0.0f;
  return raw;
}

// What the culling test reads of a record: decoded first, for every record.
struct Reach {
  float cx, cy, cut2, rr, scale2, op;
};

template <bool ORIENTED, int SHAPE>
__device__ __forceinline__ Reach decode_reach(const Raw& raw, const BlendParams& p) {
  const uint32_t wp = raw.wp, wr = raw.wr, wc = raw.wc;
  const float r = u2f(wr & 0xFFFFu) * p.inv_ps;
  Reach v;
  v.op = u2f(wc >> 24) * p.inv_color;
  if (!(r >= p.min_r)) v.op = 0.0f;
  v.cx = u2f(wp & 0xFFFFu) * p.inv_ps - p.pos_offset;
  v.cy = u2f(wp >> 16) * p.inv_ps - p.pos_offset;
  float scale = r;
  v.rr = 1.0f;
  if (ORIENTED) {
    v.rr = fmaxf(u2f(wr >> 24) * p.inv_ratio, 1e-3f);
    scale = r * v.rr;
  }
  v.scale2 = scale * scale;
  // margin2*scale2 (Gaussian) or scale2; -1 for a record whose alpha is 0
  // everywhere: no pixel is inside its support
  v.cut2 = (v.op > 0.0f) ? ((SHAPE == kGauss) ? p.margin2 * v.scale2 : v.scale2) : -1.0f;
  return v;
}

// The rest of a live record's decoding, into slot `j` of the warp's stage.
template <bool ORIENTED, int SHAPE, bool WITH_DEPTH>
__device__ __forceinline__ void decode_store(const Stage& s, int j, const Raw& raw,
                                             const Reach& v, const BlendParams& p) {
  const uint32_t wr = raw.wr, wc = raw.wc;
  s.a[j] = make_float4(v.cx, v.cy, v.cut2, p.neg_inv_2sigma2 / fmaxf(v.scale2, 1e-12f));
  s.b[j] = make_float4(v.op, u2f(wc & 0xFFu) * p.inv_color,
                       u2f((wc >> 8) & 0xFFu) * p.inv_color,
                       u2f((wc >> 16) & 0xFFu) * p.inv_color);
  if (ORIENTED) {
    float c, sn;
    warp_cull::ellipse_cos_sin(u2f((wr >> 16) & 0xFFu) * p.inv_angle - p.pi, c, sn);
    s.c[j] = make_float4(c, sn, v.rr, raw.d);
  } else if (WITH_DEPTH) {
    s.c[j] = make_float4(0.0f, 0.0f, 1.0f, raw.d);
  }
}

// One pixel's accumulators.
struct Pixel {
  float px, py;
  float trans;
  float cr, cg, cb, cd;
};

// One staged record's alpha at one pixel (0 outside the support), its colour
// and its depth.  No branch: every lane of the warp runs the same
// instructions, so the records of a batch overlap in the pipeline.
template <bool ORIENTED, int SHAPE, bool WITH_DEPTH>
__device__ __forceinline__ float alpha_of(const Stage& s, int j, const Pixel& q, float4& b,
                                          float& dep) {
  const float4 a = s.a[j];
  b = s.b[j];
  const float dx = q.px - a.x;
  const float dy = q.py - a.y;
  float u = 0.0f, vr = 0.0f, d2;
  dep = 0.0f;
  if (ORIENTED) {
    const float4 c = s.c[j];
    u = c.x * dx + c.y * dy;
    vr = (-c.y * dx + c.x * dy) * c.z;
    d2 = u * u + vr * vr;
    dep = c.w;
  } else {
    d2 = dx * dx + dy * dy;
    if (WITH_DEPTH) dep = s.c[j].w;
  }
  const float cut2 = a.z;
  bool inside;
  if (SHAPE == kQuad) {
    inside = ORIENTED ? (u * u <= cut2 && vr * vr <= cut2)
                      : (dx * dx <= cut2 && dy * dy <= cut2);
  } else {
    inside = d2 <= cut2;
  }
  const float alpha = (SHAPE == kGauss) ? b.x * expf(d2 * a.w) : b.x;
  return inside ? alpha : 0.0f;
}

constexpr int kPer = 2;    // records a lane gathers per step of a warp's walk
constexpr int kStep = 32 * kPer;

// BATCH live records of a warp's stage, evaluated together at one pixel:
// their alphas are independent of each other and of T.
template <int BATCH>
struct Batch {
  float alpha[BATCH], r[BATCH], g[BATCH], b[BATCH], dep[BATCH];
};

// Take the next BATCH set bits of `live` (ascending) and evaluate them; past
// the last live record the batch repeats it with alpha 0.
template <bool ORIENTED, int SHAPE, bool WITH_DEPTH, int BATCH>
__device__ __forceinline__ Batch<BATCH> take_batch(const Stage& s, unsigned& live,
                                                   const Pixel& q) {
  Batch<BATCH> bt;
  int j = 0;
#pragma unroll
  for (int k = 0; k < BATCH; ++k) {
    const bool valid = live != 0u;
    j = valid ? __ffs(live) - 1 : j;
    live &= live - 1;
    float4 rgb;
    const float alpha = alpha_of<ORIENTED, SHAPE, WITH_DEPTH>(s, j, q, rgb, bt.dep[k]);
    bt.alpha[k] = valid ? alpha : 0.0f;
    bt.r[k] = rgb.y;
    bt.g[k] = rgb.z;
    bt.b[k] = rgb.w;
  }
  return bt;
}

// Fold a batch into the pixel, front to back.  The only serial chain is T.
// No branch and no conditional assignment: a record that contributes
// nothing (alpha 0, or the pixel has stopped) adds w = +0 to sums that are
// never -0 and multiplies T by 1, which leaves the same bits as skipping it,
// and keeps the whole batch one basic block that the next batch's
// evaluation can be scheduled into.
template <bool WITH_DEPTH, int BATCH>
__device__ __forceinline__ void fold_batch(const Batch<BATCH>& bt, Pixel& q, bool& alive,
                                           const BlendParams& p) {
#pragma unroll
  for (int k = 0; k < BATCH; ++k) {
    const bool take = alive && bt.alpha[k] > 0.0f;
    const float w = take ? bt.alpha[k] * q.trans : 0.0f;
    q.cr += bt.r[k] * w;
    q.cg += bt.g[k] * w;
    q.cb += bt.b[k] * w;
    if (WITH_DEPTH) q.cd += bt.dep[k] * w;
    q.trans *= take ? 1.0f - bt.alpha[k] : 1.0f;
    alive = q.trans > p.eps;
  }
}

// Fold the live records of a warp's stage into one pixel, BATCH at a time,
// software-pipelined: the next batch's alphas are evaluated beside the
// current batch's fold.
template <bool ORIENTED, int SHAPE, bool WITH_DEPTH, int BATCH>
__device__ __forceinline__ void composite_live(const Stage& s, unsigned live, Pixel& q,
                                               bool& alive, const BlendParams& p) {
  Batch<BATCH> cur = take_batch<ORIENTED, SHAPE, WITH_DEPTH, BATCH>(s, live, q);
  while (live != 0u) {
    const Batch<BATCH> next = take_batch<ORIENTED, SHAPE, WITH_DEPTH, BATCH>(s, live, q);
    fold_batch<WITH_DEPTH, BATCH>(cur, q, alive, p);
    cur = next;
  }
  fold_batch<WITH_DEPTH, BATCH>(cur, q, alive, p);
}

// Thread `tid`'s pixel of tile t (warp_cull::tile_pixel's mapping) and its
// index in the tile's row-major layout.
__device__ __forceinline__ Pixel pixel_of(int t, int tid, const BlendParams& p, int& pix) {
  const int tx = t % p.tiles_x;
  const int ty = t / p.tiles_x;
  int lx, ly;
  warp_cull::tile_pixel(tid, p.tile_w, p.tile_h, lx, ly);
  pix = ly * p.tile_w + lx;
  Pixel q;
  q.px = static_cast<float>(tx * p.tile_w + lx) + 0.5f;
  q.py = static_cast<float>(ty * p.tile_h + ly) + 0.5f;
  q.trans = 1.0f;
  q.cr = q.cg = q.cb = q.cd = 0.0f;
  return q;
}

template <bool WITH_DEPTH>
__device__ __forceinline__ void store_pixel(const Stream& st, int t, int tp, int pix,
                                            const Pixel& q) {
  const size_t at = static_cast<size_t>(t) * tp + pix;
  st.tile_color[at * 3 + 0] = q.cr;
  st.tile_color[at * 3 + 1] = q.cg;
  st.tile_color[at * 3 + 2] = q.cb;
  st.tile_alpha[at] = 1.0f - q.trans;
  if (WITH_DEPTH) st.tile_depth[at] = q.cd;
}

// Where a warp is in its sequence of steps: kStep records [base, ...) of
// tile t's run, which ends at `end`; t < 0 past the last step.
struct Cursor {
  int t, base, end, rnd;
};

// The schedule of one CTA: its tiles in order.  XP false: tile blockIdx.x
// alone.  XP true: slots b, 2G-1-b, 2G+b, ... of tile_list[0 .. n_tiles)
// (round r of the snake takes slot r*G + b when r is even, r*G + G-1-b when
// odd).
template <bool XP>
struct Schedule {
  const int* offsets;
  const int* tile_list;
  int n_tiles;

  __device__ __forceinline__ void tile_at(Cursor& c, int rnd) const {
    c.rnd = rnd;
    c.t = -1;
    c.base = c.end = 0;
    int t;
    if (XP) {
      const int g = gridDim.x, b = blockIdx.x;
      const int slot = rnd * g + ((rnd & 1) ? g - 1 - b : b);
      if (slot >= n_tiles) return;
      t = tile_list[slot];
    } else {
      if (rnd > 0) return;
      t = blockIdx.x;
    }
    c.t = t;
    c.base = offsets[t];
    c.end = offsets[t + 1];
  }
  // the step after c: the tile's next kStep records, or the next tile's first
  __device__ __forceinline__ Cursor after(Cursor c) const {
    if (c.t < 0) return c;
    c.base += kStep;
    if (c.base >= c.end) tile_at(c, c.rnd + 1);
    return c;
  }
};

// The ranks of a step's records: lane's record i is base + 32 i + lane.
__device__ __forceinline__ void load_ranks(const Stream& st, const Cursor& c, int lane,
                                           int (&rk)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = c.base + 32 * i + lane;
    rk[i] = (c.t >= 0 && idx < c.end) ? __ldg(st.pair_rank + idx) : -1;
  }
}

template <bool WITH_DEPTH>
__device__ __forceinline__ void load_step(const Stream& st, const int (&rk)[kPer],
                                          Raw (&rw)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (rk[i] >= 0) rw[i] = load_words<WITH_DEPTH>(st, rk[i]);
  }
}

// The body of both kernels.  Every warp walks its CTA's tiles on its own:
// no barrier, nothing shared between warps.
template <bool ORIENTED, int SHAPE, bool WITH_DEPTH, bool XP, int BATCH>
__device__ __forceinline__ void run(const Stream& st, const int* __restrict__ tile_list,
                                    const int* __restrict__ n_list, const BlendParams& p) {
  extern __shared__ float4 smem[];
  constexpr int kVecs = num_vecs(ORIENTED, WITH_DEPTH);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tp = p.tile_w * p.tile_h;
  // two staging slots per warp, taken in turn
  float4* const slots = smem + (tid >> 5) * (2 * 32 * kVecs);
  const Schedule<XP> sched{st.offsets, tile_list, XP ? *n_list : 0};

  // the pipeline: words of the current step (c0) and of the next (c1) in
  // registers, ranks of the one after (c2)
  Cursor c0, c1, c2;
  int rk[kPer];
  Raw w0[kPer], w1[kPer];
  auto prime = [&](int rnd) {  // (re)fill it from the first step of a tile
    sched.tile_at(c0, rnd);
    while (c0.t >= 0 && c0.base >= c0.end) sched.tile_at(c0, c0.rnd + 1);  // no records
    load_ranks(st, c0, lane, rk);
    load_step<WITH_DEPTH>(st, rk, w0);
    c1 = sched.after(c0);
    load_ranks(st, c1, lane, rk);
    load_step<WITH_DEPTH>(st, rk, w1);
    c2 = sched.after(c1);
    load_ranks(st, c2, lane, rk);
  };
  int rnd = 0;
  if (!XP) {
    // this CTA's tile, which may hold nothing
    const int t = blockIdx.x;
    if (st.offsets[t] >= st.offsets[t + 1]) {
      int pix;
      const Pixel q = pixel_of(t, tid, p, pix);
      if (tid < tp) store_pixel<WITH_DEPTH>(st, t, tp, pix, q);
      return;
    }
  }
  prime(rnd);

  int turn = 0;  // staging slot of the next group
  while (c0.t >= 0) {
    const int t = c0.t;
    rnd = c0.rnd;
    int pix;
    Pixel q = pixel_of(t, tid, p, pix);
    bool alive = q.trans > p.eps;
    unsigned alive_mask = __ballot_sync(kFull, alive);
    // the centres of the warp's pixels that are still alive: a pixel that
    // has stopped takes nothing more, so a record that misses this
    // rectangle changes no output
    Rect rc = warp_cull::warp_rect(q.px, q.py, alive);
    bool stopped = alive_mask == 0u;
    int stop_at;  // !XP: the walk's end, set where every pixel of the warp has stopped

    while (!stopped && c0.t == t) {
      // this step's records, 32 at a time, in run order
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const bool valid = c0.base + 32 * i + lane < c0.end;
        Reach v;
        bool lv = false;
        if (valid) {
          v = decode_reach<ORIENTED, SHAPE>(w0[i], p);
          lv = warp_cull::cull_live<!ORIENTED && SHAPE == kQuad>(
              v.cx, v.cy, warp_cull::cull_bound<ORIENTED, SHAPE == kQuad>(v.cut2, v.rr), rc);
        }
        const unsigned live = __ballot_sync(kFull, lv);
        if (live != 0u) {
          const Stage s = stage_at(slots + (turn & 1) * (32 * kVecs));
          ++turn;
          if (lv) decode_store<ORIENTED, SHAPE, WITH_DEPTH>(s, lane, w0[i], v, p);
          // publishes the slot; the slot written next was last read before
          // this barrier
          __syncwarp();
          composite_live<ORIENTED, SHAPE, WITH_DEPTH, BATCH>(s, live, q, alive, p);
          const unsigned now = __ballot_sync(kFull, alive);
          if (now != alive_mask) {  // pixels stopped: the warp's rectangle shrinks
            alive_mask = now;
            if (now == 0u) {
              stopped = true;
              if (!XP) stop_at = min(c0.base + 32 * (i + 1), c0.end);
              break;
            }
            rc = warp_cull::warp_rect(q.px, q.py, alive);
          }
        }
      }
      if (stopped) break;
      // advance: the next step's words have been in flight under this one
      c0 = c1;
#pragma unroll
      for (int i = 0; i < kPer; ++i) w0[i] = w1[i];
      c1 = c2;
      load_step<WITH_DEPTH>(st, rk, w1);
      c2 = sched.after(c2);
      load_ranks(st, c2, lane, rk);
    }
    if (tid < tp) store_pixel<WITH_DEPTH>(st, t, tp, pix, q);
    if (!XP && p.walked != nullptr) {
      // the warp's walk, kept in its own staging slot, which its one tile no
      // longer uses (no pixel is alive at all where eps >= 1)
      __syncwarp();
      if (lane == 0) {
        const int end = !(1.0f > p.eps) ? st.offsets[t] : stopped ? stop_at : st.offsets[t + 1];
        *reinterpret_cast<int*>(slots) = end - st.offsets[t];
      }
    }
    // every pixel of the warp stopped before the tile's run ended: the
    // registers hold later steps of that tile; start over at the next tile
    if (stopped) prime(rnd + 1);
  }
  if (!XP && p.walked != nullptr) {
    // the tile's walk is its longest warp's
    __syncthreads();
    if (tid == 0) {
      int most = 0;
      for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
        most = max(most, *reinterpret_cast<const int*>(smem + w * (2 * 32 * kVecs)));
      }
      atomicAdd(reinterpret_cast<unsigned long long*>(p.walked),
                static_cast<unsigned long long>(most));
    }
  }
}

// MAXT: the largest block an instantiation launches with (512 or 1024), so
// that the smaller tiles get the registers they can use: two batches of 4
// records are in flight per pixel there, of 2 in the 1024-thread blocks.
__host__ __device__ constexpr int batch_of(int maxt) { return maxt > 512 ? 2 : 4; }

template <bool ORIENTED, int SHAPE, bool WITH_DEPTH, int MAXT>
__global__ void __launch_bounds__(MAXT) tile_blend_kernel(Stream st, BlendParams p) {
  run<ORIENTED, SHAPE, WITH_DEPTH, false, batch_of(MAXT)>(st, nullptr, nullptr, p);
}

// Persistent grid over the compact list of nonempty tiles, heaviest first;
// *n_list (a device scalar) is the list's length.
template <bool ORIENTED, int SHAPE, bool WITH_DEPTH, int MAXT>
__global__ void __launch_bounds__(MAXT) tile_blend_xp_kernel(Stream st, const int* __restrict__ tile_list,
                                     const int* __restrict__ n_list, BlendParams p) {
  run<ORIENTED, SHAPE, WITH_DEPTH, true, batch_of(MAXT)>(st, tile_list, n_list, p);
}

// What a launch of `threads` threads needs and gets: dynamic shared memory,
// registers per thread, resident CTAs per SM, and the persistent grid.
struct LaunchInfo {
  size_t smem;
  int regs, per_sm, sms;
};

// `query` false: only the shared memory (what the per-tile launch needs).
template <typename K>
cudaError_t launch_info(K kernel, int threads, bool oriented, bool with_depth, bool query,
                        LaunchInfo* info) {
  // two staging buffers; above the 48 KB a kernel gets without asking for
  // the larger tiles
  info->smem = 2 * static_cast<size_t>(threads) * num_vecs(oriented, with_depth) * sizeof(float4);
  cudaError_t err = cudaSuccess;
  if (info->smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(info->smem));
    if (err != cudaSuccess) return err;
  }
  if (!query) return cudaSuccess;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  info->regs = attr.numRegs;
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&info->sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info->per_sm, kernel, threads,
                                                       info->smem);
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

// a block is the tile's pixels padded to whole warps
int block_threads(int tile_w, int tile_h) { return (tile_w * tile_h + 31) / 32 * 32; }

}  // namespace

// Composite every tile.  Pointers are device pointers: offsets (T+1) int32,
// pair_rank (P) int32, rec_pos/rec_ro/rec_rgb (N) int32 bit patterns of the
// u32 words, indexed by pair_rank; outputs tile_color (T, tp, 3) and
// tile_alpha (T, tp) float32 with tp = tile_w * tile_h <= 1024.  With
// rec_depth (N, int32 bit patterns of the records' float depths) and
// tile_depth (T, tp) both non-null, the premultiplied depth sum is written
// too; both null selects the instantiation without the depth plane.
// shape: 0 Gaussian, 1 opaque ellipse, 2 opaque quad.
//
// tile_list null: one CTA per tile (tile_blend_kernel).  tile_list (T int32,
// the nonempty tiles first, heaviest first) and n_list (one int32 on the
// device, their number) non-null: the persistent kernel
// (tile_blend_xp_kernel), which visits only the listed tiles; the caller
// zeroes the outputs.
//
// walked (one int64 on the device, or null): the per-tile kernel adds the
// run positions each tile's walk took (the file note's walk counter); the
// persistent kernel takes none.
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
                                  float inv_ratio, float pi, long long* walked,
                                  void* stream) {
  const BlendParams p{inv_ps,    pos_offset, min_r,     margin2, neg_inv_2sigma2,
                      eps,       inv_color,  inv_angle, inv_ratio, pi,
                      tiles_x,   tile_w,     tile_h,    walked};
  const Stream st{offsets,  pair_rank,  rec_pos,    rec_ro,    rec_rgb,
                  rec_depth, tile_color, tile_alpha, tile_depth};
  const int with_depth = (rec_depth != nullptr && tile_depth != nullptr) ? 1 : 0;
  if ((rec_depth != nullptr) != (tile_depth != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((tile_list != nullptr) != (n_list != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (walked != nullptr && tile_list != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = block_threads(tile_w, tile_h);
  if (threads > 1024 || num_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dispatch(oriented, shape, with_depth, [&](auto o, auto sh, auto wd) {
    constexpr bool O = decltype(o)::value;
    constexpr int S = decltype(sh)::value;
    constexpr bool D = decltype(wd)::value;
    auto go = [&](auto per_tile, auto persistent) {
      LaunchInfo info;
      cudaError_t e;
      if (tile_list != nullptr) {
        if ((e = launch_info(persistent, threads, O, D, true, &info)) != cudaSuccess) return e;
        if (info.per_sm < 1) return cudaErrorLaunchOutOfResources;
        // every CTA resident at once; never more CTAs than tiles
        const int full = info.sms * info.per_sm;
        persistent<<<num_tiles < full ? num_tiles : full, threads, info.smem, s>>>(
            st, tile_list, n_list, p);
      } else {
        if ((e = launch_info(per_tile, threads, O, D, false, &info)) != cudaSuccess) return e;
        per_tile<<<num_tiles, threads, info.smem, s>>>(st, p);
      }
      return cudaGetLastError();
    };
    if (threads <= 512) {
      return go(tile_blend_kernel<O, S, D, 512>, tile_blend_xp_kernel<O, S, D, 512>);
    }
    return go(tile_blend_kernel<O, S, D, 1024>, tile_blend_xp_kernel<O, S, D, 1024>);
  });
  return static_cast<int>(err);
}

// What the instantiation for (oriented, shape, with_depth, xp) gets at this
// tile shape: out[0] registers per thread, out[1] resident CTAs per SM,
// out[2] SMs, out[3] dynamic shared memory in bytes.  Host pointer; returns
// the CUDA error code.
extern "C" int tile_blend_launch_info(int oriented, int shape, int with_depth, int xp,
                                      int tile_w, int tile_h, int* out) {
  const int threads = block_threads(tile_w, tile_h);
  const cudaError_t err = dispatch(oriented, shape, with_depth, [&](auto o, auto sh, auto wd) {
    constexpr bool O = decltype(o)::value;
    constexpr int S = decltype(sh)::value;
    constexpr bool D = decltype(wd)::value;
    LaunchInfo info;
    cudaError_t e;
    if (threads <= 512) {
      e = xp ? launch_info(tile_blend_xp_kernel<O, S, D, 512>, threads, O, D, true, &info)
             : launch_info(tile_blend_kernel<O, S, D, 512>, threads, O, D, true, &info);
    } else {
      e = xp ? launch_info(tile_blend_xp_kernel<O, S, D, 1024>, threads, O, D, true, &info)
             : launch_info(tile_blend_kernel<O, S, D, 1024>, threads, O, D, true, &info);
    }
    if (e != cudaSuccess) return e;
    out[0] = info.regs;
    out[1] = info.per_sm;
    out[2] = info.sms;
    out[3] = static_cast<int>(info.smem);
    return cudaSuccess;
  });
  return static_cast<int>(err);
}
