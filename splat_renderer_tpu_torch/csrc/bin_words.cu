// Tile binning of the projector's record words, hand-written for Hopper
// (sm_90a): render/binning.py::bin_packed_words on CUDA tensors.  It
// computes what the plain path (`bin_packed_words_plain`, whose pair stage
// is `_pair_stage`) computes, bit for bit, in five steps:
//
//   1. footprint: one thread a record decodes its words (`_word_geometry`),
//      computes its clamped tile window (`_footprint_cols`: isotropic,
//      oriented ellipse or opaque square, the cap's shrink toward the
//      centre tile) and the diagonal-corner prune (`_diag_prune`), and
//      writes its live-pair count, its packed window and the int32 record
//      planes (rec_pos, rec_ro, rec_rgb, and rec_depth for the G-buffer);
//   2. an exclusive scan of the counts (cub::DeviceScan): each record's
//      first pair and P, the live pairs, which the wrapper reads back
//      (4 bytes) to size the sort;
//   3. emit: one thread a record writes its live pairs, record-major:
//      key (tile << 32) | depth key, value the record's index;
//   4. one stable radix sort of the P pairs (cub::DeviceRadixSort) over
//      the key's low 32 + bit_length(num_tiles) bits;
//   5. ranges: one thread a sorted pair writes its tile and, where the
//      tile changes, the offsets of every tile up to it; the tail
//      [P, N*cap) gets the sentinel tile; counts are the offsets'
//      differences.
//
// Replaces no TPU kernel: the JAX package's binner
// (splat_renderer_tpu/render/binning.py) is jnp that XLA fuses.  PyTorch
// ran the plain path as some 180 launches over int64 (cap, N) slot planes,
// sorted all N*cap slots (mostly the sentinel tile) and counted them with
// a histogram whose atomics all hit the sentinel's one counter.
//
// What bounds it on the H100: bytes.  The words are read once (32 B a
// record) and the records written as int32 planes (12-16 B); the P live
// pairs are written (12 B), sorted (about six 8-bit passes of 12 B read
// and written), and their tiles and ranks written once more (8 B); the
// tail is filled.  Nothing counts a pair twice into one address, so there
// are no atomics, and every output is deterministic.
//
// The order: equal keys keep their emit order through the stable sort,
// and the emit order is record order (a record has at most one pair a
// tile), so each tile's run is in (depth key, input index) order, the
// canonical order, as the plain path's stable sort of record-major slots
// leaves it.
//
// Bit-equal arithmetic: the footprint's float operations are the plain
// path's, in its order, each rounded once (the library is built with
// -fmad=false and without fast math): IEEE divides for `div`,
// __fsqrt_rn for sqrt_rn, the fixed polynomial of blend.ellipse_cos_sin,
// floorf and the truncating cast for floor(...).to(int64), and every
// Python scalar rounded to float32 as PyTorch rounds it against a float32
// tensor (the wrapper's ctypes floats).

#include <cuda_runtime.h>

// cub (and the Thrust parts it includes) inside a namespace of this
// library's own, so its kernels cannot meet the copies other libraries of
// the process carry
#define CUB_WRAPPED_NAMESPACE splat_bin_words
#define THRUST_WRAPPED_NAMESPACE splat_bin_words
#include <cub/device/device_radix_sort.cuh>
#include <cub/device/device_scan.cuh>

namespace {

namespace cubw = CUB_NS_QUALIFIER;

constexpr int kThreads = 256;
constexpr long long kInfKey = 0xFF800000LL;  // the depth key of +inf (culled)
enum Footprint { kIsotropic = 0, kEllipse = 1, kSquare = 2 };

// cfg's numbers, as float32 where the plain path computes in float32
struct Geometry {
  float inv_ps;  // 1 / pos_scale: the grid step and the footprint's slack
  float pos_offset;
  float inv_angle_scale, pi, inv_ratio_scale;
  float bounds_margin, min_radius;
  float tile_w, tile_h, width, height;
  int tiles_x, tiles_y, cap;
  int footprint;  // Footprint
  int prune;      // the diagonal-corner prune (all but opaque squares)
};

// A Python float literal as PyTorch applies it to a float32 tensor: the
// double rounded to float32 (a float literal would round the decimal once)
#define F32(x) static_cast<float>(x)

// blend.ellipse_cos_sin: the fixed polynomials, op for op
__device__ __forceinline__ void ellipse_cos_sin(float x, float& c, float& s) {
  const float x2 = x * x;
  s = x * (F32(9.999997070e-01) +
           x2 * (F32(-1.666657722e-01) +
                 x2 * (F32(8.332558118e-03) +
                       x2 * (F32(-1.981257552e-04) +
                             x2 * (F32(2.704051213e-06) + x2 * F32(-2.053424453e-08))))));
  c = F32(9.999999923e-01) +
      x2 * (F32(-4.999999177e-01) +
            x2 * (F32(4.166652436e-02) +
                  x2 * (F32(-1.388797039e-03) +
                        x2 * (F32(2.477342375e-05) +
                              x2 * (F32(-2.711336876e-07) + x2 * F32(1.736911667e-09))))));
}

// _footprint_cols.tile_of: clamp(floor(div(v, t)), 0, n_t - 1).to(int64)
__device__ __forceinline__ int tile_of(float v, float t, int n_t) {
  const float f = floorf(v / t);
  return static_cast<int>(fminf(fmaxf(f, 0.0f), static_cast<float>(n_t - 1)));
}

// the low 32 bits of a u32 word held in int64 (packing.as_int32_bits)
__device__ __forceinline__ int low32(long long w) {
  return static_cast<int>(static_cast<unsigned int>(w));
}

// Step 1.  foot[i]: x = tx0 | ty0 << 16; y = w | h << 12 | (skip + 1) << 24,
// skip the pruned footprint slot (-1: none); written for live records only.
// cnt[n] = 0, so the scan's last entry is P.
__global__ void __launch_bounds__(kThreads)
footprint_kernel(const long long* __restrict__ dk, const long long* __restrict__ w_pos,
                 const long long* __restrict__ w_ro, const long long* __restrict__ w_rgb,
                 Geometry g, int n, int* __restrict__ rec_pos, int* __restrict__ rec_ro,
                 int* __restrict__ rec_rgb, int* __restrict__ rec_depth,
                 int2* __restrict__ foot, int* __restrict__ cnt) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i > n) return;
  if (i == n) {
    cnt[n] = 0;
    return;
  }
  const long long key = dk[i], pos = w_pos[i], ro = w_ro[i];
  rec_pos[i] = low32(pos);
  rec_ro[i] = low32(ro);
  rec_rgb[i] = low32(w_rgb[i]);
  if (rec_depth != nullptr) rec_depth[i] = static_cast<int>(key & 0x7FFFFFFFLL);

  // _word_geometry
  const float cx = static_cast<float>(pos & 0xFFFF) * g.inv_ps - g.pos_offset;
  const float cy = static_cast<float>(pos >> 16) * g.inv_ps - g.pos_offset;
  const float r = static_cast<float>(ro & 0xFFFF) * g.inv_ps;

  // _footprint_cols
  const float pad = r * g.bounds_margin;
  float hx = pad, hy = pad;
  if (g.footprint != kIsotropic) {
    const float ang = static_cast<float>((ro >> 16) & 0xFF) * g.inv_angle_scale - g.pi;
    const float ratio = static_cast<float>(ro >> 24) * g.inv_ratio_scale;
    float ca, sa;
    ellipse_cos_sin(ang, ca, sa);
    const float rr = fminf(fmaxf(ratio, 0.0f), 1.0f);
    if (g.footprint == kSquare) {
      const float aca = fabsf(ca), asa = fabsf(sa);
      hx = pad * (rr * aca + asa) + g.inv_ps;
      hy = pad * (rr * asa + aca) + g.inv_ps;
    } else {
      const float r2 = rr * rr;
      hx = pad * __fsqrt_rn(sa * sa + r2 * ca * ca) + g.inv_ps;
      hy = pad * __fsqrt_rn(ca * ca + r2 * sa * sa) + g.inv_ps;
    }
  }
  const float bmin_x = cx - hx, bmax_x = cx + hx;
  const float bmin_y = cy - hy, bmax_y = cy + hy;
  int tx0 = tile_of(bmin_x, g.tile_w, g.tiles_x);
  int ty0 = tile_of(bmin_y, g.tile_h, g.tiles_y);
  const int tx1 = tile_of(bmax_x, g.tile_w, g.tiles_x);
  const int ty1 = tile_of(bmax_y, g.tile_h, g.tiles_y);
  const bool alive = key < kInfKey && r >= g.min_radius && bmax_x >= 0.0f &&
                     bmax_y >= 0.0f && bmin_x < g.width && bmin_y < g.height;
  if (!alive) {
    cnt[i] = 0;
    return;
  }
  // shrink to <= cap tiles, keeping the window centred on the centre tile
  const int w = min(tx1 - tx0 + 1, g.cap);
  const int h = min(ty1 - ty0 + 1, max(g.cap / w, 1));
  const int ctx = tile_of(cx, g.tile_w, g.tiles_x);
  const int cty = tile_of(cy, g.tile_h, g.tiles_y);
  tx0 = min(max(ctx - (w - 1) / 2, tx0), tx1 - w + 1);
  ty0 = min(max(cty - (h - 1) / 2, ty0), ty1 - h + 1);

  // _diag_prune
  int skip = -1;
  const int cix = ctx - tx0, ciy = cty - ty0;
  if (g.prune && w == 2 && h == 2 && cix >= 0 && cix <= 1 && ciy >= 0 && ciy <= 1) {
    const float dx = cx - static_cast<float>(tx0 + 1) * g.tile_w;
    const float dy = cy - static_cast<float>(ty0 + 1) * g.tile_h;
    const float pad2 = r * g.bounds_margin + g.inv_ps;
    if (dx * dx + dy * dy > pad2 * pad2) skip = (1 - ciy) * 2 + (1 - cix);
  }
  foot[i] = make_int2(tx0 | (ty0 << 16), w | (h << 12) | ((skip + 1) << 24));
  cnt[i] = w * h - (skip >= 0 ? 1 : 0);
}

// Step 3.  Record i's pairs go to [off[i], off[i + 1]), in footprint slot
// order (row-major over its window, the pruned slot left out).
__global__ void __launch_bounds__(kThreads)
emit_kernel(const long long* __restrict__ dk, const int2* __restrict__ foot,
            const int* __restrict__ off, int n, int tiles_x,
            unsigned long long* __restrict__ keys, int* __restrict__ vals) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  int k = off[i];
  if (off[i + 1] == k) return;
  const int2 f = foot[i];
  const int tx0 = f.x & 0xFFFF, ty0 = f.x >> 16;
  const int w = f.y & 0xFFF, h = (f.y >> 12) & 0xFFF, skip = (f.y >> 24) - 1;
  const unsigned long long dkey = static_cast<unsigned long long>(dk[i]);
  for (int c = 0; c < w * h; ++c) {
    if (c == skip) continue;
    const int dy = c / w;
    const unsigned long long tile = (ty0 + dy) * tiles_x + tx0 + (c - dy * w);
    keys[k] = (tile << 32) | dkey;
    vals[k] = static_cast<int>(i);
    ++k;
  }
}

// Step 5.  Thread i < p: pair i's tile, and where the tile changes from
// pair i - 1's, offsets[t] = i for every tile t in (previous tile, tile];
// the last pair writes offsets (tile, num_tiles] = p.  Each offset is
// written by one thread.  Threads in [p, slots): the tail, sentinel tile
// and rank 0.  With p = 0 the first num_tiles + 1 threads zero the offsets.
__global__ void __launch_bounds__(kThreads)
ranges_kernel(const unsigned long long* __restrict__ keys, int p, long long slots,
              int num_tiles, int* __restrict__ offsets, int* __restrict__ pair_tile,
              int* __restrict__ pair_rank) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < p) {
    const int tile = static_cast<int>(keys[i] >> 32);
    pair_tile[i] = tile;
    const int prev = i == 0 ? -1 : static_cast<int>(keys[i - 1] >> 32);
    for (int t = prev + 1; t <= tile; ++t) offsets[t] = static_cast<int>(i);
    if (i == p - 1)
      for (int t = tile + 1; t <= num_tiles; ++t) offsets[t] = p;
  } else if (i < slots) {
    pair_tile[i] = num_tiles;
    pair_rank[i] = 0;
  }
  if (p == 0 && i <= num_tiles) offsets[i] = 0;
}

__global__ void __launch_bounds__(kThreads)
counts_kernel(const int* __restrict__ offsets, int num_tiles, int* __restrict__ counts) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t < num_tiles) counts[t] = offsets[t + 1] - offsets[t];
}

unsigned int blocks(long long items) {
  return static_cast<unsigned int>((items + kThreads - 1) / kThreads);
}

}  // namespace

// cub's scratch bytes: bytes[0] for the scan of n + 1 counts, bytes[1] for
// the sort of p pairs over end_bit bits.  Launches nothing.
extern "C" int bin_words_scratch(int n, int p, int end_bit, unsigned long long* bytes) {
  size_t scan = 0, sort = 0;
  cudaError_t err = cubw::DeviceScan::ExclusiveSum(nullptr, scan, static_cast<const int*>(nullptr),
                                                   static_cast<int*>(nullptr), n + 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cubw::DeviceRadixSort::SortPairs(
      nullptr, sort, static_cast<const unsigned long long*>(nullptr),
      static_cast<unsigned long long*>(nullptr), static_cast<const int*>(nullptr),
      static_cast<int*>(nullptr), p, 0, end_bit);
  bytes[0] = scan;
  bytes[1] = sort;
  return static_cast<int>(err);
}

// Steps 1 and 2 on `stream` over n records: dk, w_pos, w_ro, w_rgb (n
// int64 each); fscalars the Geometry floats in order (11), iscalars its
// ints (tiles_x, tiles_y, cap, footprint, prune); out the int32 planes
// rec_pos, rec_ro, rec_rgb and rec_depth (null: not wanted), foot (n
// int2), cnt (n + 1 int32) and off (n + 1 int32: each record's first pair,
// off[n] = P); scratch of scratch_bytes for the scan.  Returns the first
// CUDA error.
extern "C" int bin_words_count(const long long* dk, const long long* w_pos, const long long* w_ro,
                               const long long* w_rgb, const float* fscalars, const int* iscalars,
                               int n, int* rec_pos, int* rec_ro, int* rec_rgb, int* rec_depth,
                               void* foot, int* cnt, int* off, void* scratch,
                               unsigned long long scratch_bytes, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{fscalars[0], fscalars[1], fscalars[2], fscalars[3], fscalars[4],
                   fscalars[5], fscalars[6], fscalars[7], fscalars[8], fscalars[9],
                   fscalars[10], iscalars[0], iscalars[1], iscalars[2], iscalars[3],
                   iscalars[4]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  footprint_kernel<<<blocks(n + 1LL), kThreads, 0, st>>>(
      dk, w_pos, w_ro, w_rgb, g, n, rec_pos, rec_ro, rec_rgb, rec_depth,
      static_cast<int2*>(foot), cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t bytes = scratch_bytes;
  err = cubw::DeviceScan::ExclusiveSum(scratch, bytes, cnt, off, n + 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Steps 3 to 5 on `stream`, after bin_words_count and the read-back of
// p = off[n]: keys_in, keys_out (p uint64) and vals_in (p int32) are the
// sort's buffers, scratch of scratch_bytes its scratch; pair_rank and
// pair_tile (slots = n * cap int32 each), offsets (num_tiles + 1) and counts
// (num_tiles) int32 are the outputs; the sort's values land in
// pair_rank[:p].  Returns the first CUDA error.
extern "C" int bin_words_pairs(const long long* dk, const void* foot, const int* off, int n, int p,
                               long long slots, int tiles_x, int num_tiles, int end_bit,
                               unsigned long long* keys_in, unsigned long long* keys_out,
                               int* vals_in, void* scratch, unsigned long long scratch_bytes,
                               int* pair_rank, int* pair_tile, int* offsets, int* counts,
                               void* stream) {
  if (n < 0 || p < 0 || p > slots || num_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p > 0) {
    emit_kernel<<<blocks(n), kThreads, 0, st>>>(dk, static_cast<const int2*>(foot), off, n,
                                                tiles_x, keys_in, vals_in);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    size_t bytes = scratch_bytes;
    err = cubw::DeviceRadixSort::SortPairs(scratch, bytes, keys_in, keys_out, vals_in, pair_rank,
                                           p, 0, end_bit, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long items = slots > num_tiles + 1LL ? slots : num_tiles + 1LL;
  ranges_kernel<<<blocks(items), kThreads, 0, st>>>(keys_out, p, slots, num_tiles, offsets,
                                                    pair_tile, pair_rank);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  counts_kernel<<<blocks(num_tiles), kThreads, 0, st>>>(offsets, num_tiles, counts);
  return static_cast<int>(cudaGetLastError());
}
