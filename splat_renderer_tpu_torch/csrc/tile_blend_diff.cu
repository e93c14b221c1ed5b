// Differentiable per-tile splat compositing, forward and backward,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels splat_renderer_tpu/ops/
// tile_blend_diff.py::_make_fwd_kernel (forward) and ::_make_bwd_kernel
// (backward).  The plain twin is ops/tile_blend_diff.py::
// blend_planes_plain; the gradients are those of its autograd, and
// ops/tile_blend_diff.py::blend_adjoint_plain mirrors the backward's
// recurrence in plain PyTorch.
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
// What bounds it on the H100: operations, not bytes, and in practice the
// walk of the heaviest tile.  A pair reads nf * 4 bytes of record and is
// evaluated against every pixel of its tile (256 for 16x16 tiles): some 10
// FP32 operations for the support test, and inside the support one expf
// and about 15 (forward) or 45 (backward) more, plus the sum of each
// record's 8 or 11 gradient terms over the tile's pixels.  A training
// frame has a few hundred nonempty tiles and its heaviest holds several
// times the mean, so the time is the latency of that tile's chunk loop
// (cull, forward, adjoint, reduction, one barrier), not the card's
// arithmetic rate.  There are no matrix products, so the tensor cores
// (wgmma) have no part.
//
// Design of the backward: one CTA per tile, one thread per pixel
// (tile_pixels a multiple of 32, at most 1024), a warp over a compact 8x4
// pixel block where the tile allows it.
// * Warp-level culling: per chunk each lane tests one record against the
//   warp's rectangle of pixel centres (warp_cull.cuh's `cull_live`, the test
//   tile_blend.cu uses: nearest-point distance against the cutoff; oriented
//   records against cut2 / min(1, rr)^2 widened by kCullSlack), and a
//   ballot gives the warp its live records.  A dead record costs the warp
//   nothing: no test per pixel, no shuffles, no stores; the cross-warp sum
//   reads each warp's mask of the records it wrote.
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
// Design of the forward: one CTA per tile, one thread per pixel, records
// staged through shared memory in chunks of 256, each decoded once.
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

constexpr int kFwdChunk = 256;  // records staged per forward chunk
constexpr int kMaxBwdChunk = 32;  // a backward chunk's records fit one 32-bit mask
constexpr int kFwdBatch = 4;  // records of the backward's forward walk evaluated together

// Row of t_start that holds tile t's first backward chunk, for a run that
// starts at pair `start`: the sum of ceil(count / bc) over the tiles before t
// is at most start / bc + t, so the tiles' rows never overlap and
// pairs / bc + tiles rows hold them all, without a table.
__device__ __forceinline__ size_t chunk_row(int t, int start, int bc) {
  return static_cast<size_t>(start / bc + t);
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

// BC: the backward's chunk when its residual is asked for (8, 16 or 32: T
// at the start of every BC records goes to t_start), 0 when it is not.
template <bool ORIENTED, int BC>
__global__ void __launch_bounds__(1024) diff_fwd_kernel(const int* __restrict__ offsets,
                                const int* __restrict__ pair_rank,
                                const float* __restrict__ planes,
                                float* __restrict__ tile_color,
                                float* __restrict__ tile_alpha,
                                float* __restrict__ tile_depth,
                                float* __restrict__ t_start, DiffParams p) {
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
      const Rec v = decode_rec<ORIENTED>(
          planes + static_cast<size_t>(pair_rank[base + j]) * (ORIENTED ? 10 : 8), p);
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
    auto blend = [&](int j) {
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
    };
    if (BC == 0) {
      for (int j = 0; j < n; ++j) blend(j);
    } else {
      // in runs of BC records (kFwdChunk is a multiple of BC), so that the
      // residual costs the record loop no test; a full run is unrolled, which
      // lets its records' shared-memory loads overlap (it made this form
      // faster than the plain loop, residual and all)
      constexpr int kRun = BC > 0 ? BC : 1;
      float* ts = t_start + (chunk_row(t, start, kRun) + (base - start) / kRun) * blockDim.x + tid;
      for (int j0 = 0; j0 < n; j0 += kRun, ts += blockDim.x) {
        __stcs(ts, trans);  // written once, read once by the backward: streaming
        if (j0 + kRun <= n) {
#pragma unroll
          for (int j = 0; j < kRun; ++j) blend(j0 + j);
        } else {
          for (int j = j0; j < n; ++j) blend(j);
        }
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

}  // namespace

// Forward: composite every tile.  Device pointers: offsets (T+1) and
// pair_rank (P) int32, planes (N, nf) float32 in canonical order; outputs
// tile_color (T, tp, 3), tile_alpha (T, tp), tile_depth (T, tp) float32,
// tp = tile_w * tile_h, a multiple of 32 and at most 1024.  With t_start
// (P / bwd_chunk + T rows of tp float32) non-null it also writes each
// pixel's transmittance at the start of every backward chunk (tile t's
// chunks from row offsets[t] / bwd_chunk + t); bwd_chunk is 8, 16 or 32.
// Launches on `stream` without synchronising; returns the CUDA error code.
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
  if (!valid_chunk(bwd_chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TBD_FWD(O, C)                                                                       \
  diff_fwd_kernel<O, C><<<num_tiles, threads, 0, s>>>(offsets, pair_rank, planes, tile_color, \
                                                      tile_alpha, tile_depth, t_start, p)
  const int bc = t_start != nullptr ? bwd_chunk : 0;
  if (oriented) {
    if (bc == 0) TBD_FWD(true, 0);
    else if (bc == 8) TBD_FWD(true, 8);
    else if (bc == 16) TBD_FWD(true, 16);
    else TBD_FWD(true, 32);
  } else {
    if (bc == 0) TBD_FWD(false, 0);
    else if (bc == 8) TBD_FWD(false, 8);
    else if (bc == 16) TBD_FWD(false, 16);
    else TBD_FWD(false, 32);
  }
#undef TBD_FWD
  return static_cast<int>(cudaGetLastError());
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
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kernel<<<num_tiles, threads, smem, s>>>(offsets, pair_rank, pair_slot, planes,
                                            g_color, g_alpha, g_depth, t_start, grad_slots,
                                            bwd_chunk, p);
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

// What the backward's instantiation gets at this tile shape and chunk:
// out[0] registers per thread, out[1] resident CTAs per SM, out[2] SMs,
// out[3] dynamic shared memory in bytes.  Host pointer.
extern "C" int tile_blend_diff_launch_info(int oriented, int tile_w, int tile_h,
                                           int bwd_chunk, int* out) {
  const int threads = tile_w * tile_h;
  const size_t smem = bwd_smem(threads, oriented, bwd_chunk);
  const cudaError_t err = dispatch_bwd(oriented, threads, [&](auto kernel) {
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    cudaFuncAttributes attr;
    if ((e = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return e;
    int device = 0;
    if ((e = cudaGetDevice(&device)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&out[2], cudaDevAttrMultiProcessorCount, device))
        != cudaSuccess) return e;
    out[0] = attr.numRegs;
    out[3] = static_cast<int>(smem);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, threads, smem);
  });
  return static_cast<int>(err);
}
