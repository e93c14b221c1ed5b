// Differentiable per-tile splat compositing, forward and backward,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels splat_renderer_tpu/ops/
// tile_blend_diff.py::_make_fwd_kernel (forward, :136) and
// ::_make_bwd_kernel (backward, :199).  The plain twin is
// ops/tile_blend_diff.py::blend_planes_plain; the gradients are those of
// its autograd.  ops/tile_blend_diff.py::diff_fold_plain mirrors the
// forward's sequential fold and its residual layout, ::blend_adjoint_plain
// the backward's recurrence, in plain PyTorch.
//
// Inputs are continuous float32 record planes in canonical order (N, nf),
// nf = 8 isotropic [cx cy r op cr cg cb d] or 10 oriented
// [cx cy r op cr cg cb ang ratio d], and each tile's depth-ordered run of
// record ranks (render/binning.py::bin_planes_diff, which clips opacity and
// colour and writes culled depths as 0: every plane is finite).  Per
// (record, pixel):
//   scale = r (isotropic) or r * max(ratio, 1e-3) (oriented, distance in
//   the ellipse frame), inv_s2 = 1 / max(scale^2, 1e-12),
//   shape = exp(-dist2 * inv_s2 / (2 sigma^2)) inside dist2 <= margin^2
//   scale^2 and r >= min_screen_radius, else 0,
//   a = min(op * shape, alpha_cap).
// Forward, per pixel, front to back with no early exit (truncation would
// bias the gradients): C += rgb a T, D += d a T, T *= 1 - a; the outputs
// are C, alpha = 1 - T and D (the alpha-weighted depth).  When a gradient
// will be asked for, the forward also leaves each pixel's T at the start of
// every backward chunk (one float per pixel per `bwd_chunk` records).
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
// recurrences with no division, in ONE pass over the pair stream: a tile's
// chunks are walked last to first with R and Q carried in registers; inside
// a chunk T_i is rebuilt forward from the chunk-start T the forward left
// (the same products in the same order, so the same bits), and the adjoint
// runs back to front.
//
// What bounds both on the H100: operations, not bytes, and in practice the
// walk of the heaviest tile's busiest warp.  A pair reads nf * 4 bytes of
// record and is evaluated against every pixel of its tile (256 for 16x16
// tiles): some 6 FP32 operations for the support test, and inside the
// support one expf and about 14 (forward) or 43 (backward) more, plus the
// sum of each record's 8 or 11 gradient terms over the tile's pixels.  A
// training frame has a few hundred nonempty tiles and its heaviest holds
// several times the mean; inside it the records pile up on a few pixel
// blocks, and each pixel's fold is serial.  So the time is the latency of
// that warp's walk, not the card's arithmetic rate.  There are no matrix
// products, so the tensor cores (wgmma) have no part.
//
// Design of the forward: one CTA per tile, one thread per pixel (tile_pixels
// a multiple of 32, at most 1024), a warp over a compact 8x4 pixel block
// where the tile allows it (warp_cull.cuh's `tile_pixel`; row-major warps in
// other tiles).  The outputs stay row-major in the tile.
// * Every warp walks the tile's run on its own: no block barrier, nothing
//   shared between warps.  It leaves the tile when all its pixels have
//   stopped (below).
// * Warp-level culling.  Per 32 records each lane decodes ONE record as far
//   as the test needs (centre, ratio, cutoff) and tests it against the
//   rectangle of the centres of the warp's pixels still alive (`cull_live`,
//   the test tile_blend.cu and the backward use); a ballot gives the live
//   records, and the pixel loop walks the set bits in ascending order, so
//   the fold stays front to back.  A culled record has d2 > cut2 at every
//   alive pixel of the warp, so the old per-pixel test skipped it too:
//   exactly for isotropic records, and for oriented ones under the
//   kCullSlack widening warp_cull.cuh documents.
// * Exact-zero stop, not an early exit.  A pixel whose T is exactly +0
//   takes nothing more.  With finite planes that changes no bit: w = a * 0
//   = +0, c + rgb * (+0) = c (the sums are never -0), 0 * (1 - a) = 0.
//   Nothing truncates at T > 0.  In a deep tile every pixel ends at 0 by
//   underflow; the warp's rectangle shrinks as its pixels stop (at most 32
//   times a tile), and the warp leaves when all 32 have.
// * Staging per warp.  Only live records are decoded in full (colour,
//   inv_s2's IEEE division, the ellipse polynomial), by their lanes, into
//   the warp's slot of shared memory, three float4 a record: (cx, cy, cut2,
//   inv_s2), (op, r, g, b), (ca, sa, rr, d), read back as 16-byte broadcast
//   loads.  Two slots alternate, so one __syncwarp per 32 records orders the
//   writes and the reads.
// * Batches of 4 live records (2 in 1024-thread blocks, for registers):
//   their alphas are independent of each other and of T, every lane runs
//   the same instructions (no branch on "inside": a lane outside selects
//   alpha 0), and the next batch is evaluated beside the current batch's
//   fold, so the only serial chain is T's.  A record with alpha 0 adds
//   w = +0 and multiplies T by 1: the same bits as skipping it.
// * Gathers in flight under compute: a register pipeline, as in
//   tile_blend.cu.  A warp takes 64 records a step (32 in 1024-thread
//   blocks); the rows of the next step and the ranks of the step after it
//   load while this step computes.  Rows are read where they lie: an
//   isotropic row (32 B, the wrapper makes the base 16-byte aligned) as two
//   16-byte loads, an oriented row (40 B, so only 8-byte aligned) as five
//   8-byte loads.
// * The residual: with a backward chunk BC of 8, 16 or 32, each lane stores
//   its pixel's T (__stcs: written once, read once) at every BC-record
//   boundary, at row chunk_row(t, start, BC) + (i - start) / BC and its
//   pixel's row-major column, the layout the backward reads.  A 32-record
//   ballot word spans 32 / BC chunks: its live mask is folded piece by
//   piece, each piece after its row is stored, also when the warp culled
//   the whole piece.  When the warp leaves, it stores 0 (its T) in every
//   row left.  BC = 0 (no gradient asked for) shares the body.
// Bit-equal to the sequential fold that tests every pixel against every
// record: per evaluation the op sequence is expf(neg_inv_2sigma2 * (d2 *
// inv_s2)), fminf(op * shape, cap), w = a * T, the colour and depth sums,
// T *= 1 - a, in record order per pixel; what the design skips (culled
// records, stopped pixels) changes no bit, as said above.
//
// Design of the backward: one CTA per tile, one thread per pixel, a warp
// over a compact 8x4 pixel block where the tile allows it.
// * Warp-level culling: per chunk each lane tests one record against the
//   warp's rectangle of pixel centres (`cull_live`; oriented records against
//   cut2 / min(1, rr)^2 widened by kCullSlack), and a ballot gives the warp
//   its live records.  A dead record costs the warp nothing: no test per
//   pixel, no shuffles, no stores; the cross-warp sum reads each warp's mask
//   of the records it wrote.
// * One support test and one expf per evaluation: the forward walk keeps
//   T_i and shape_i of the evaluations inside the support in shared memory
//   (thread-private columns, no bank conflicts) and their mask in a
//   register, so the loops stay rolled, the kernel small in registers and
//   instruction cache, and the adjoint walk re-reads them.
// * Both walks take a warp's live records in batches (4 forward; 4
//   isotropic, 2 oriented, 1 in 1024-thread blocks backward): the shapes,
//   the gradient terms and the warp sums of a batch are independent and
//   overlap in the pipeline; only T forward and R, Q backward are serial.
//   Lanes outside a record's support compute on stale values and select 0.
// * The per-record sum over a warp's pixels is a halving butterfly: each
//   round exchanges half of the remaining values with __shfl_xor_sync (8
//   values over 32 lanes take 9 shuffles, 11 padded to 16 take 16), then
//   one lane per value writes it.  The sum over warps runs in warp order
//   over the live warps, by one thread per (record, value).  The order of
//   additions is fixed by lane and warp index: no float atomics, two runs
//   give the same bits.
// * Staging off the critical path: the rows of the next chunk (the one
//   before, in record order) are copied into shared memory by cp.async while
//   this chunk computes, with their ranks loaded a chunk earlier still, and
//   decoded (cull, ellipse cos/sin, cutoff, inv_s2) by the threads that
//   copied them; three record buffers and two partial-sum buffers leave ONE
//   barrier per chunk.
// Each pair writes its row of nf gradients to its pre-sort slot
// (c * n + rank); slots are unique, so the write is an assignment and the
// wrapper's sum over the cap slots of a record is deterministic too.
//
// Built with -fmad=false like tile_blend.cu: the support cutoff is a hard
// threshold and must round as the PyTorch twin does.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_cull.cuh"

namespace {

using warp_cull::ellipse_cos_sin;
using warp_cull::kFull;
using warp_cull::Rect;

struct DiffParams {
  float min_r;            // min_screen_radius
  float margin2;          // bounds_margin^2
  float neg_inv_2sigma2;  // -0.5 / sigma^2
  float alpha_cap;        // 1 - 1e-7 in float32
  int tiles_x;
  int tile_w;
  int tile_h;
};

constexpr int kMaxBwdChunk = 32;  // a backward chunk's records fit one 32-bit mask
constexpr int kFwdBatch = 4;  // records of the backward's forward walk evaluated together

// Row of t_start that holds tile t's first backward chunk, for a run that
// starts at pair `start`: the sum of ceil(count / bc) over the tiles before t
// is at most start / bc + t, so the tiles' rows never overlap and
// pairs / bc + tiles rows hold them all, without a table.
__device__ __forceinline__ size_t chunk_row(int t, int start, int bc) {
  return static_cast<size_t>(start / bc + t);
}

// A record's support from its radius and ratio: rr (1 when isotropic),
// scale^2 and the cutoff on dist2, negative for a record culled below
// min_screen_radius (no pixel is inside its support).
template <bool ORIENTED>
__device__ __forceinline__ void support_of(float r, float ratio, const DiffParams& p, float& rr,
                                           float& scale2, float& cut2) {
  float scale = r;
  rr = 1.0f;
  if (ORIENTED) {
    rr = fmaxf(ratio, 1e-3f);
    scale = r * rr;
  }
  scale2 = scale * scale;
  cut2 = (r >= p.min_r) ? p.margin2 * scale2 : -1.0f;
}

// One record decoded for the pixel loop.
struct Rec {
  float cx, cy, op, cut2, inv_s2, cr, cg, cb, d;
  float ca, sa, rr;    // oriented only
  float r, ratio;      // backward's record-scale terms
};

// Decode the nf floats of one record's row at q (device or shared memory).
template <bool ORIENTED>
__device__ __forceinline__ Rec decode_rec(const float* q, const DiffParams& p) {
  constexpr int nf = ORIENTED ? 10 : 8;
  Rec v;
  v.cx = q[0];
  v.cy = q[1];
  v.r = q[2];
  v.op = q[3];
  v.cr = q[4];
  v.cg = q[5];
  v.cb = q[6];
  v.d = q[nf - 1];
  v.ca = v.sa = 0.0f;
  v.ratio = ORIENTED ? q[8] : 1.0f;
  if (ORIENTED) ellipse_cos_sin(q[7], v.ca, v.sa);
  float scale2;
  support_of<ORIENTED>(v.r, v.ratio, p, v.rr, scale2, v.cut2);
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

// ---- the forward (K4) ----

// A record's row as gathered from device memory: its nf floats.
template <bool ORIENTED>
struct Row {
  float f[ORIENTED ? 10 : 8];
};

// Gather row `rank`.  Read-only data: __ldg takes the non-coherent path,
// through L1, where the warps of a tile that walk close together find each
// other's sectors.
template <bool ORIENTED>
__device__ __forceinline__ void load_row(const float* __restrict__ planes, int rank,
                                         Row<ORIENTED>& w) {
  if constexpr (ORIENTED) {  // 40-byte rows: 8-byte aligned
    const float2* q = reinterpret_cast<const float2*>(planes + static_cast<size_t>(rank) * 10);
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const float2 v = __ldg(q + i);
      w.f[2 * i] = v.x;
      w.f[2 * i + 1] = v.y;
    }
  } else {  // 32-byte rows of a 16-byte aligned base
    const float4* q = reinterpret_cast<const float4*>(planes + static_cast<size_t>(rank) * 8);
    const float4 lo = __ldg(q), hi = __ldg(q + 1);
    w.f[0] = lo.x;
    w.f[1] = lo.y;
    w.f[2] = lo.z;
    w.f[3] = lo.w;
    w.f[4] = hi.x;
    w.f[5] = hi.y;
    w.f[6] = hi.z;
    w.f[7] = hi.w;
  }
}

// What the culling test reads of a record: decoded first, for every record.
struct Reach {
  float cx, cy, rr, scale2, cut2;
};

template <bool ORIENTED>
__device__ __forceinline__ Reach decode_reach(const Row<ORIENTED>& w, const DiffParams& p) {
  Reach v;
  v.cx = w.f[0];
  v.cy = w.f[1];
  float ratio = 1.0f;
  if constexpr (ORIENTED) ratio = w.f[8];
  support_of<ORIENTED>(w.f[2], ratio, p, v.rr, v.scale2, v.cut2);
  return v;
}

// A warp's staging slot: 32 decoded records, a (cx, cy, cut2, inv_s2),
// b (op, r, g, b), c (ca, sa, rr, d).
struct Stage {
  float4 *a, *b, *c;
};

constexpr int kFwdVecs = 3;  // float4 per staged record

__device__ __forceinline__ Stage stage_at(float4* base) {
  return Stage{base, base + 32, base + 64};
}

// The rest of a live record's decoding, into slot j of the warp's stage.
template <bool ORIENTED>
__device__ __forceinline__ void decode_store(const Stage& s, int j, const Row<ORIENTED>& w,
                                             const Reach& v) {
  constexpr int nf = ORIENTED ? 10 : 8;
  s.a[j] = make_float4(v.cx, v.cy, v.cut2, 1.0f / fmaxf(v.scale2, 1e-12f));
  s.b[j] = make_float4(w.f[3], w.f[4], w.f[5], w.f[6]);
  float ca = 0.0f, sa = 0.0f;
  if constexpr (ORIENTED) ellipse_cos_sin(w.f[7], ca, sa);
  s.c[j] = make_float4(ca, sa, v.rr, w.f[nf - 1]);
}

// One pixel's accumulators.
struct Pixel {
  float px, py;
  float trans;
  float cr, cg, cb, cd;
};

// BATCH live records of a warp's stage evaluated at one pixel: their alphas
// are independent of each other and of T.
template <int BATCH>
struct Batch {
  float alpha[BATCH], r[BATCH], g[BATCH], b[BATCH], dep[BATCH];
};

// Take the next BATCH set bits of `live` (ascending) and evaluate them, each
// with the old kernel's op sequence.  No branch: a lane outside a record's
// support selects alpha 0, and past the last live record the batch repeats
// it with alpha 0.
template <bool ORIENTED, int BATCH>
__device__ __forceinline__ Batch<BATCH> take_batch(const Stage& s, unsigned& live,
                                                   const Pixel& q, const DiffParams& p) {
  Batch<BATCH> bt;
  int j = 0;
#pragma unroll
  for (int k = 0; k < BATCH; ++k) {
    const bool valid = live != 0u;
    j = valid ? __ffs(live) - 1 : j;
    live &= live - 1;
    const float4 a = s.a[j], rgb = s.b[j], c = s.c[j];
    float u, vr;
    const float d2 = dist2_of<ORIENTED>(q.px - a.x, q.py - a.y, c.x, c.y, c.z, u, vr);
    const float shape = expf(p.neg_inv_2sigma2 * (d2 * a.w));
    const float al = fminf(rgb.x * shape, p.alpha_cap);
    bt.alpha[k] = (valid && d2 <= a.z) ? al : 0.0f;
    bt.r[k] = rgb.y;
    bt.g[k] = rgb.z;
    bt.b[k] = rgb.w;
    bt.dep[k] = c.w;
  }
  return bt;
}

// Fold a batch into the pixel, front to back: w = a T, the sums, T *= 1 - a.
// The only serial chain is T.  An alpha of 0 adds w = +0 to sums that are
// never -0 and multiplies T by 1: the same bits as skipping the record.
template <int BATCH>
__device__ __forceinline__ void fold_batch(const Batch<BATCH>& bt, Pixel& q) {
#pragma unroll
  for (int k = 0; k < BATCH; ++k) {
    const float w = bt.alpha[k] * q.trans;
    q.cr += bt.r[k] * w;
    q.cg += bt.g[k] * w;
    q.cb += bt.b[k] * w;
    q.cd += bt.dep[k] * w;
    q.trans *= 1.0f - bt.alpha[k];
  }
}

// Fold the records of `live` into the pixel, BATCH at a time,
// software-pipelined: the next batch is evaluated beside the current fold.
template <bool ORIENTED, int BATCH>
__device__ __forceinline__ void composite_live(const Stage& s, unsigned live, Pixel& q,
                                               const DiffParams& p) {
  Batch<BATCH> cur = take_batch<ORIENTED, BATCH>(s, live, q, p);
  while (live != 0u) {
    const Batch<BATCH> next = take_batch<ORIENTED, BATCH>(s, live, q, p);
    fold_batch<BATCH>(cur, q);
    cur = next;
  }
  fold_batch<BATCH>(cur, q);
}

// BC: the backward's chunk when its residual is asked for (8, 16 or 32: T
// at the start of every BC records goes to t_start), 0 when it is not.
// MAXT: the largest block the instantiation launches with; the 1024-thread
// blocks take 32 records a step and batches of 2, for registers.
template <bool ORIENTED, int BC, int MAXT>
__global__ void __launch_bounds__(MAXT) diff_fwd_kernel(const int* __restrict__ offsets,
                                const int* __restrict__ pair_rank,
                                const float* __restrict__ planes,
                                float* __restrict__ tile_color,
                                float* __restrict__ tile_alpha,
                                float* __restrict__ tile_depth,
                                float* __restrict__ t_start, DiffParams p) {
  constexpr int kPer = MAXT > 512 ? 1 : 2;  // records a lane gathers per step
  constexpr int kStep = 32 * kPer;
  constexpr int kBatch = MAXT > 512 ? 2 : 4;
  constexpr int kBC = BC > 0 ? BC : 32;
  constexpr unsigned kPiece = kBC == 32 ? 0xFFFFFFFFu : (1u << kBC) - 1u;
  extern __shared__ float4 smem[];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tp = blockDim.x;
  const int start = offsets[t];
  const int end = offsets[t + 1];
  int lx, ly;
  warp_cull::tile_pixel(tid, p.tile_w, p.tile_h, lx, ly);
  const int pix = ly * p.tile_w + lx;  // row-major in the tile
  Pixel q;
  q.px = static_cast<float>((t % p.tiles_x) * p.tile_w + lx) + 0.5f;
  q.py = static_cast<float>((t / p.tiles_x) * p.tile_h + ly) + 0.5f;
  q.trans = 1.0f;
  q.cr = q.cg = q.cb = q.cd = 0.0f;

  if (start < end) {  // the whole block agrees
    // this pixel's column of its tile's first residual row
    float* const ts = t_start + (BC > 0 ? chunk_row(t, start, kBC) * tp + pix : 0);
    // two staging slots per warp, taken in turn
    float4* const slots = smem + (tid >> 5) * (2 * 32 * kFwdVecs);
    int turn = 0;

    // the gather pipeline: rows of this step (w0) and the next (w1) in
    // registers, ranks of the step after (rk)
    int rk[kPer];
    Row<ORIENTED> w0[kPer], w1[kPer];
    auto load_ranks = [&](int base) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = base + 32 * i + lane;
        rk[i] = idx < end ? __ldg(pair_rank + idx) : -1;
      }
    };
    auto load_rows = [&](Row<ORIENTED>(&w)[kPer]) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (rk[i] >= 0) load_row<ORIENTED>(planes, rk[i], w[i]);
      }
    };
    load_ranks(start);
    load_rows(w0);
    load_ranks(start + kStep);
    load_rows(w1);
    load_ranks(start + 2 * kStep);

    // the centres of the warp's pixels still alive: a pixel at T = +0 takes
    // nothing more, so a record that misses this rectangle changes no output
    unsigned alive_mask = kFull;
    Rect rc = warp_cull::warp_rect(q.px, q.py, true);
    int done = 0;  // records behind the warp when it stops
    for (int base = start; base < end; base += kStep) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int g0 = base + 32 * i;  // this word's first record
        if (g0 >= end) break;
        Reach v;
        bool lv = false;
        if (g0 + lane < end) {
          v = decode_reach<ORIENTED>(w0[i], p);
          lv = warp_cull::cull_live<false>(
              v.cx, v.cy, warp_cull::cull_bound<ORIENTED, false>(v.cut2, v.rr), rc);
        }
        const unsigned live = __ballot_sync(kFull, lv);
        const Stage s = stage_at(slots + (turn & 1) * (32 * kFwdVecs));
        if (live != 0u) {
          ++turn;
          if (lv) decode_store<ORIENTED>(s, lane, w0[i], v);
          // publishes the slot; the slot written next was last read before
          // this barrier
          __syncwarp();
        }
        if (BC == 0) {
          if (live != 0u) composite_live<ORIENTED, kBatch>(s, live, q, p);
        } else {
          // the word's chunks in order: each chunk's row, then its records
#pragma unroll
          for (int k = 0; k < 32 / kBC; ++k) {
            const int rel = g0 - start + k * kBC;
            if (rel >= end - start) break;
            __stcs(ts + static_cast<size_t>(rel / kBC) * tp, q.trans);
            const unsigned piece = live & (kPiece << (k * kBC));
            if (piece != 0u) composite_live<ORIENTED, kBatch>(s, piece, q, p);
          }
        }
        if (live != 0u) {
          const unsigned now = __ballot_sync(kFull, q.trans > 0.0f);
          if (now != alive_mask) {  // pixels stopped: the rectangle shrinks
            alive_mask = now;
            if (now == 0u) {
              done = g0 - start + 32;
              break;
            }
            rc = warp_cull::warp_rect(q.px, q.py, q.trans > 0.0f);
          }
        }
      }
      if (alive_mask == 0u) break;
      // advance: the next step's rows have been in flight under this one
#pragma unroll
      for (int i = 0; i < kPer; ++i) w0[i] = w1[i];
      load_rows(w1);
      load_ranks(base + 3 * kStep);
    }
    // every pixel of the warp stopped: the rows of the chunks left hold its
    // T, which is 0
    if (BC > 0 && alive_mask == 0u) {
      const int nchunks = (end - start + kBC - 1) / kBC;
      for (int c = done / kBC; c < nchunks; ++c) __stcs(ts + static_cast<size_t>(c) * tp, 0.0f);
    }
  }

  const size_t at = static_cast<size_t>(t) * tp + pix;
  tile_color[at * 3 + 0] = q.cr;
  tile_color[at * 3 + 1] = q.cg;
  tile_color[at * 3 + 2] = q.cb;
  tile_alpha[at] = 1.0f - q.trans;
  tile_depth[at] = q.cd;
}

// A decoded record in shared memory: four float4 and its gradient slot.
//   a = (cx, cy, cut2, inv_s2)   b = (op, cr, cg, cb)
//   c = (d, ca, sa, rr)          e = (r, ratio, cull bound, -)
struct RecBuf {
  float4 a[kMaxBwdChunk], b[kMaxBwdChunk], c[kMaxBwdChunk], e[kMaxBwdChunk];
  int slot[kMaxBwdChunk];
};

constexpr int kRawStride = 12;  // floats per raw row in shared memory (16-byte aligned)

// Sum each of g[0..NRP)'s values over the warp's 32 lanes with the halving
// butterfly and write value f to out[f] (f < NR).  Lane and round fix the
// order of every addition.  out null: the sums are dropped.
template <int NR, int NRP>
__device__ __forceinline__ void warp_reduce_store(float (&g)[NRP], int lane, float* out) {
  static_assert(NRP == 8 || NRP == 16, "8 or 16 values");
  int bit = 16;
#pragma unroll
  for (int half = NRP / 2; half >= 1; half >>= 1, bit >>= 1) {
    const bool hi = (lane & bit) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = hi ? g[i] : g[i + half];
      const float keep = hi ? g[i + half] : g[i];
      g[i] = keep + __shfl_xor_sync(kFull, send, bit);
    }
  }
  // every lane now holds value (lane / (32 / NRP)) summed over NRP lanes
  for (; bit >= 1; bit >>= 1) g[0] += __shfl_xor_sync(kFull, g[0], bit);
  constexpr int kLanesPerValue = 32 / NRP;
  const int f = lane / kLanesPerValue;
  if (out != nullptr && (lane & (kLanesPerValue - 1)) == 0 && f < NR) out[f] = g[0];
}

// MAXT: the largest block this instantiation launches with
template <bool ORIENTED, int MAXT>
__global__ void __launch_bounds__(MAXT) diff_bwd_kernel(const int* __restrict__ offsets,
                                const int* __restrict__ pair_rank,
                                const int* __restrict__ pair_slot,
                                const float* __restrict__ planes,
                                const float* __restrict__ g_color,
                                const float* __restrict__ g_alpha,
                                const float* __restrict__ g_depth,
                                const float* __restrict__ t_start,
                                float* __restrict__ grad_slots, int bc, DiffParams p) {
  // per-pixel sums per record: cx cy sum(g_nd2 nd2) op cr cg cb d
  // [+ g_ca g_sa sum(g_vr vr)]
  constexpr int NR = ORIENTED ? 11 : 8;
  constexpr int NRP = ORIENTED ? 16 : 8;  // padded to a power of two
  constexpr int nf = ORIENTED ? 10 : 8;
  // records per batch of the adjoint walk, by the registers the block allows
  constexpr int BB = MAXT > 512 ? 1 : (ORIENTED ? 2 : 4);
  __shared__ RecBuf s_rec[3];
  __shared__ __align__(16) float s_raw[kMaxBwdChunk * kRawStride];
  __shared__ unsigned s_live[2][32];
  // [2][warps][bc][NR] partial sums, then T_i and shape_i: [bc][threads] each
  extern __shared__ float s_dyn[];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int tp = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = tp >> 5;
  const int start = offsets[t];
  const int cnt = offsets[t + 1] - start;
  if (cnt <= 0) return;  // the caller zeroed the rows
  const int nchunks = (cnt + bc - 1) / bc;

  float* s_part = s_dyn;
  const int part_floats = nwarps * bc * NR;
  float* s_t = s_dyn + 2 * part_floats + tid;  // column tid: T_i at row i
  float* s_s = s_t + bc * tp;                  // shape_i

  // this thread's pixel: a warp covers an 8x4 block where the tile allows it
  int lx, ly;
  warp_cull::tile_pixel(tid, p.tile_w, p.tile_h, lx, ly);
  const int pixel = ly * p.tile_w + lx;
  const float px = static_cast<float>((t % p.tiles_x) * p.tile_w + lx) + 0.5f;
  const float py = static_cast<float>((t / p.tiles_x) * p.tile_h + ly) + 0.5f;
  const Rect rc = warp_cull::warp_rect(px, py, true);  // the warp's pixel centres

  const size_t pix = static_cast<size_t>(t) * tp + pixel;
  const float gcr = g_color[pix * 3 + 0], gcg = g_color[pix * 3 + 1],
              gcb = g_color[pix * 3 + 2];
  const float gd = g_depth[pix];
  const float ga_out = g_alpha[pix];
  const float* t_mine = t_start + chunk_row(t, start, bc) * tp + pixel;

  // ---- staging: thread j < bc owns record j of every chunk ----
  int rank_n = 0, slot_n = 0, slot_d = 0;
  auto chunk_len = [&](int c) { return min(bc, cnt - c * bc); };
  auto load_ranks = [&](int c) {  // into registers, a chunk ahead of its rows
    if (c >= 0 && tid < chunk_len(c)) {
      rank_n = pair_rank[start + c * bc + tid];
      slot_n = pair_slot[start + c * bc + tid];
    }
  };
  auto copy_rows = [&](int c) {  // asynchronous: planes row -> s_raw row
    if (tid < chunk_len(c)) {
      const float* src = planes + static_cast<size_t>(rank_n) * nf;
      float* dst = s_raw + tid * kRawStride;
      if (ORIENTED) {  // 40-byte rows are 8-byte aligned
#pragma unroll
        for (int i = 0; i < 5; ++i) __pipeline_memcpy_async(dst + 2 * i, src + 2 * i, 8);
      } else {  // 32-byte rows of a 16-byte aligned base
        __pipeline_memcpy_async(dst, src, 16);
        __pipeline_memcpy_async(dst + 4, src + 4, 16);
      }
      slot_d = slot_n;
    }
    __pipeline_commit();
  };
  auto decode_rows = [&](int c, RecBuf& rb) {  // by the thread that copied them
    __pipeline_wait_prior(0);
    if (tid < chunk_len(c)) {
      const Rec v = decode_rec<ORIENTED>(s_raw + tid * kRawStride, p);
      rb.a[tid] = make_float4(v.cx, v.cy, v.cut2, v.inv_s2);
      rb.b[tid] = make_float4(v.op, v.cr, v.cg, v.cb);
      rb.c[tid] = make_float4(v.d, v.ca, v.sa, v.rr);
      rb.e[tid] = make_float4(v.r, v.ratio,
                              warp_cull::cull_bound<ORIENTED, false>(v.cut2, v.rr), 0.0f);
      rb.slot[tid] = slot_d;
    }
  };

  load_ranks(nchunks - 1);
  copy_rows(nchunks - 1);
  load_ranks(nchunks - 2);
  decode_rows(nchunks - 1, s_rec[0]);
  __syncthreads();

  // what follows the current record, seen through it (R), and the product
  // of 1 - a over the records behind it (Q), carried from chunk to chunk
  float r_acc = 0.0f, q_acc = 1.0f;
  // this pixel's T at the start of the chunk, read a chunk ahead
  float trans_n = t_mine[static_cast<size_t>(nchunks - 1) * tp];
  int k = 0;  // chunks done; record buffer k % 3, partial-sum buffer k & 1
  for (int c = nchunks - 1; c >= 0; --c, ++k) {
    const RecBuf& rb = s_rec[k % 3];
    float* part = s_part + (k & 1) * part_floats + warp * bc * NR;
    const int n = chunk_len(c);
    float trans = trans_n;
    if (c > 0) {
      trans_n = t_mine[static_cast<size_t>(c - 1) * tp];
      copy_rows(c - 1);
      load_ranks(c - 2);
    }

    // the records this warp's pixels can touch
    const unsigned live = __ballot_sync(
        kFull, lane < n && warp_cull::cull_live<false>(rb.a[lane].x, rb.a[lane].y,
                                                       rb.e[lane].z, rc));

    // forward inside the chunk: T_i and shape_i of the evaluations inside.
    // kFwdBatch records at a time: their shapes are independent (every lane
    // runs the same instructions), only the product T is serial.
    unsigned inside = 0u;   // this pixel is inside record j's support
    unsigned touched = 0u;  // some pixel of the warp is
    for (unsigned m = live; m != 0u;) {
      int j[kFwdBatch];
      float shape[kFwdBatch];
      bool in[kFwdBatch];
#pragma unroll
      for (int b = 0; b < kFwdBatch; ++b) {
        // past the last live record the batch repeats it, outside
        const bool valid = m != 0u;
        j[b] = valid ? __ffs(m) - 1 : j[b > 0 ? b - 1 : 0];
        m &= m - 1;
        const float4 a = rb.a[j[b]];
        const float4 cc = ORIENTED ? rb.c[j[b]] : make_float4(0.0f, 0.0f, 0.0f, 1.0f);
        float u, vr;
        const float d2 = dist2_of<ORIENTED>(px - a.x, py - a.y, cc.y, cc.z, cc.w, u, vr);
        shape[b] = expf(p.neg_inv_2sigma2 * (d2 * a.w));
        in[b] = valid && d2 <= a.z;
      }
#pragma unroll
      for (int b = 0; b < kFwdBatch; ++b) {
        if (in[b]) {
          s_t[j[b] * tp] = trans;
          s_s[j[b] * tp] = shape[b];
          trans *= 1.0f - fminf(rb.b[j[b]].x * shape[b], p.alpha_cap);
          inside |= 1u << j[b];
        }
        if (__any_sync(kFull, in[b])) touched |= 1u << j[b];
      }
    }

    // the adjoint, back to front:
    //   R_i = w_{i+1} a_{i+1} + (1 - a_{i+1}) R_{i+1},  Q_i = prod_{j>i} (1 - a_j)
    //   dL/da_i = T_i (w_i - R_i + gA Q_i)
    // BB records at a time: only R and Q are serial; the warp sums of the
    // records of a batch run side by side.  Lanes outside a record's
    // support compute on stale values and select 0.
    for (unsigned m = touched; m != 0u;) {
      int j[BB];
      bool valid[BB];
      float g[BB][NRP];
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        valid[b] = m != 0u;
        j[b] = valid[b] ? 31 - __clz(m) : j[b > 0 ? b - 1 : 0];
        m &= ~(1u << j[b]);
        const bool in = valid[b] && ((inside >> j[b]) & 1u) != 0u;
        const float4 a = rb.a[j[b]], rgb = rb.b[j[b]], cc = rb.c[j[b]];
        const float dx = px - a.x;
        const float dy = py - a.y;
        float u, vr;
        const float d2 = dist2_of<ORIENTED>(dx, dy, cc.y, cc.z, cc.w, u, vr);
        const float nd2 = d2 * a.w;
        const float shape = s_s[j[b] * tp];
        const float a_raw = rgb.x * shape;
        const float al = fminf(a_raw, p.alpha_cap);
        const float ti = s_t[j[b] * tp];
        const float w_pan = ((rgb.y * gcr + rgb.z * gcg) + rgb.w * gcb) + cc.x * gd;
        const float at = al * ti;
        const float ga = ti * ((w_pan - r_acc) + ga_out * q_acc);
        const float g_prod = (a_raw < p.alpha_cap) ? ga : 0.0f;
        const float g_nd2 = ((g_prod * rgb.x) * p.neg_inv_2sigma2) * shape;
        const float g_dist2 = g_nd2 * a.w;
#pragma unroll
        for (int f = 0; f < NRP; ++f) g[b][f] = 0.0f;
        if (ORIENTED) {
          const float g_u = (g_dist2 * 2.0f) * u;
          const float g_vr = (g_dist2 * 2.0f) * vr;
          g[b][0] = -(g_u * cc.y + g_vr * (-cc.z * cc.w));
          g[b][1] = -(g_u * cc.z + g_vr * (cc.y * cc.w));
          g[b][8] = g_u * dx + (g_vr * dy) * cc.w;
          g[b][9] = g_u * dy - (g_vr * dx) * cc.w;
          g[b][10] = g_vr * vr;
        } else {
          g[b][0] = (g_dist2 * -2.0f) * dx;
          g[b][1] = (g_dist2 * -2.0f) * dy;
        }
        g[b][2] = g_nd2 * nd2;
        g[b][3] = g_prod * shape;
        g[b][4] = gcr * at;
        g[b][5] = gcg * at;
        g[b][6] = gcb * at;
        g[b][7] = gd * at;
#pragma unroll
        for (int f = 0; f < NR; ++f) g[b][f] = in ? g[b][f] : 0.0f;
        r_acc = in ? w_pan * al + (1.0f - al) * r_acc : r_acc;
        q_acc = in ? q_acc * (1.0f - al) : q_acc;
      }
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        warp_reduce_store<NR, NRP>(g[b], lane, valid[b] ? part + j[b] * NR : nullptr);
      }
    }
    const unsigned wrote = touched;
    if (lane == 0) s_live[k & 1][warp] = wrote;

    if (c > 0) decode_rows(c - 1, s_rec[(k + 1) % 3]);
    __syncthreads();

    // the sum over warps, in warp order over the warps that wrote, one
    // thread per (record, value); then the record-scale terms.  bc * NRP
    // and the block are multiples of 32, so whole warps take each trip.
    const float* all = s_part + (k & 1) * part_floats;
    for (int idx = tid; idx < bc * NRP; idx += tp) {
      const int j = idx / NRP;
      const int f = idx % NRP;
      const bool mine = j < n && f < NR;
      float s = 0.0f;
      if (mine) {
        for (int w = 0; w < nwarps; ++w) {
          if ((s_live[k & 1][w] >> j) & 1u) s += all[(w * bc + j) * NR + f];
        }
      }
      const float4 e = rb.e[j], cc = rb.c[j];
      float* row = grad_slots + static_cast<size_t>(rb.slot[j]) * nf;
      const float sc = ORIENTED ? e.x * cc.w : e.x;
      const float alive = (sc * sc > 1e-12f) ? 1.0f : 0.0f;
      if (ORIENTED) {
        const int group = lane & ~(NRP - 1);
        const float s2 = __shfl_sync(kFull, s, group + 2);
        const float s9 = __shfl_sync(kFull, s, group + 9);
        if (mine) {
          if (f == 2) {
            row[2] = ((s * -2.0f) * alive) / fmaxf(e.x, 1e-9f);
          } else if (f < 7) {
            row[f] = s;
          } else if (f == 7) {
            row[nf - 1] = s;
          } else if (f == 8) {
            row[7] = -s * cc.z + s9 * cc.y;
          } else if (f == 10) {
            const float g_rr = s / cc.w + ((s2 * -2.0f) * alive) / cc.w;
            row[8] = (e.y >= 1e-3f) ? g_rr : 0.0f;
          }
        }
      } else if (mine) {
        if (f == 2) {
          row[2] = ((s * -2.0f) * alive) / fmaxf(e.x, 1e-9f);
        } else {
          row[f] = s;  // f == 7 is the depth, row nf - 1 = 7
        }
      }
    }
    // no barrier here: the next chunk works in the other buffers
  }
}

DiffParams make_params(int tiles_x, int tile_w, int tile_h, float min_r, float margin2,
                       float neg_inv_2sigma2, float alpha_cap) {
  return DiffParams{min_r, margin2, neg_inv_2sigma2, alpha_cap, tiles_x, tile_w, tile_h};
}

bool valid_chunk(int bc) { return bc == 8 || bc == 16 || bc == 32; }

size_t bwd_smem(int threads, int oriented, int bc) {
  const size_t nr = oriented ? 11 : 8;
  return (2 * static_cast<size_t>(threads / 32) * bc * nr + 2 * static_cast<size_t>(bc) * threads)
         * sizeof(float);
}

// Pick the backward's instantiation for (oriented, threads).
template <typename F>
cudaError_t dispatch_bwd(int oriented, int threads, F&& f) {
#define TBD_CASE(O, M) return f(diff_bwd_kernel<O, M>)
  if (oriented) {
    if (threads <= 256) TBD_CASE(true, 256);
    if (threads <= 512) TBD_CASE(true, 512);
    TBD_CASE(true, 1024);
  }
  if (threads <= 256) TBD_CASE(false, 256);
  if (threads <= 512) TBD_CASE(false, 512);
  TBD_CASE(false, 1024);
#undef TBD_CASE
}

// The forward's dynamic shared memory: two staging slots of 32 records a warp.
size_t fwd_smem(int threads) {
  return 2 * static_cast<size_t>(threads) * kFwdVecs * sizeof(float4);
}

// Pick the forward's instantiation for (oriented, bc, threads); bc 0: no
// residual.
template <typename F>
cudaError_t dispatch_fwd(int oriented, int bc, int threads, F&& f) {
#define TBD_BC(O, M)                                  \
  if (bc == 0) return f(diff_fwd_kernel<O, 0, M>);   \
  if (bc == 8) return f(diff_fwd_kernel<O, 8, M>);   \
  if (bc == 16) return f(diff_fwd_kernel<O, 16, M>); \
  return f(diff_fwd_kernel<O, 32, M>);
  if (oriented) {
    if (threads <= 512) { TBD_BC(true, 512) }
    TBD_BC(true, 1024)
  }
  if (threads <= 512) { TBD_BC(false, 512) }
  TBD_BC(false, 1024)
#undef TBD_BC
}

// Lift a kernel's dynamic shared memory limit where it needs more than the
// 48 KB it gets without asking.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// Forward: composite every tile.  Device pointers: offsets (T+1) and
// pair_rank (P) int32, planes (N, nf) float32 in canonical order, 16-byte
// aligned; outputs tile_color (T, tp, 3), tile_alpha (T, tp), tile_depth
// (T, tp) float32, tp = tile_w * tile_h, a multiple of 32 and at most 1024.
// With t_start (P / bwd_chunk + T rows of tp float32) non-null it also
// writes each pixel's transmittance at the start of every backward chunk
// (tile t's chunks from row offsets[t] / bwd_chunk + t); bwd_chunk is 8, 16
// or 32.  Launches on `stream` without synchronising; returns the CUDA
// error code.
extern "C" int tile_blend_diff_forward(const int* offsets, const int* pair_rank,
                                       const float* planes, float* tile_color,
                                       float* tile_alpha, float* tile_depth,
                                       float* t_start, int bwd_chunk, int num_tiles, int tiles_x,
                                       int tile_w, int tile_h, int oriented, float min_r,
                                       float margin2, float neg_inv_2sigma2,
                                       float alpha_cap, void* stream) {
  const DiffParams p = make_params(tiles_x, tile_w, tile_h, min_r, margin2,
                                   neg_inv_2sigma2, alpha_cap);
  const int threads = tile_w * tile_h;
  if (!valid_chunk(bwd_chunk) || (reinterpret_cast<uintptr_t>(planes) & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = fwd_smem(threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bc = t_start != nullptr ? bwd_chunk : 0;
  const cudaError_t err = dispatch_fwd(oriented, bc, threads, [&](auto kernel) {
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<num_tiles, threads, smem, s>>>(offsets, pair_rank, planes, tile_color, tile_alpha,
                                            tile_depth, t_start, p);
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

// Backward: per-pair gradient rows.  Inputs as the forward's plus
// pair_slot (P) int32, the cotangents g_color (T, tp, 3), g_alpha and
// g_depth (T, tp), and the forward's t_start for the same bwd_chunk;
// planes must be 16-byte aligned.  Writes row pair_slot[i] of
// grad_slots (cap * N, nf) float32 for every pair i of every run (the
// caller zeroes it first).  Returns the CUDA error code.
extern "C" int tile_blend_diff_backward(
    const int* offsets, const int* pair_rank, const int* pair_slot, const float* planes, const float* g_color, const float* g_alpha, const float* g_depth,
    const float* t_start, float* grad_slots, int bwd_chunk, int num_tiles, int tiles_x,
    int tile_w, int tile_h, int oriented, float min_r, float margin2, float neg_inv_2sigma2,
    float alpha_cap, void* stream) {
  const DiffParams p = make_params(tiles_x, tile_w, tile_h, min_r, margin2,
                                   neg_inv_2sigma2, alpha_cap);
  const int threads = tile_w * tile_h;
  if (!valid_chunk(bwd_chunk) || (reinterpret_cast<uintptr_t>(planes) & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = bwd_smem(threads, oriented, bwd_chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dispatch_bwd(oriented, threads, [&](auto kernel) {
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<num_tiles, threads, smem, s>>>(offsets, pair_rank, pair_slot, planes,
                                            g_color, g_alpha, g_depth, t_start, grad_slots,
                                            bwd_chunk, p);
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

// What an instantiation gets at this tile shape and chunk: the backward's,
// or with `forward` the forward's with its residual: out[0] registers per
// thread, out[1] resident CTAs per SM, out[2] SMs, out[3] dynamic shared
// memory in bytes.  Host pointer.
extern "C" int tile_blend_diff_launch_info(int oriented, int tile_w, int tile_h,
                                           int bwd_chunk, int forward, int* out) {
  const int threads = tile_w * tile_h;
  const size_t smem = forward ? fwd_smem(threads) : bwd_smem(threads, oriented, bwd_chunk);
  auto query = [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes attr;
    if ((e = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return e;
    int device = 0;
    if ((e = cudaGetDevice(&device)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&out[2], cudaDevAttrMultiProcessorCount, device))
        != cudaSuccess) return e;
    out[0] = attr.numRegs;
    out[3] = static_cast<int>(smem);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, threads, smem);
  };
  const cudaError_t err = forward ? dispatch_fwd(oriented, bwd_chunk, threads, query)
                                  : dispatch_bwd(oriented, threads, query);
  return static_cast<int>(err);
}
