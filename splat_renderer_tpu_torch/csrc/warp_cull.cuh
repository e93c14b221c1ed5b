// What the blend kernels of tile_blend.cu and tile_blend_diff.cu share, so
// that it exists once: the pixel-to-lane mapping (a warp over a compact 8x4
// pixel block), the rectangle of a warp's pixel centres, the warp-level
// culling test, and the ellipse frame's cos/sin polynomial.
//
// ops/tile_blend.py mirrors the mapping (`warp_pixels`, `warp_rects`) and
// the test (`cull_live_plain`, CULL_SLACK) in plain PyTorch, operation for
// operation; the CPU tests hold the mirror against the twins' alphas.  Change
// them together.

#pragma once

#include <cuda_runtime.h>

namespace warp_cull {

constexpr unsigned kFull = 0xFFFFFFFFu;
// The oriented culling bound is widened by this factor: the rotation's
// cos^2 + sin^2 is within 2e-6 of 1 and u, vr round a few ulps.
constexpr float kCullSlack = 1.001f;

// render/blend.py::ellipse_cos_sin: the float32 values of its decimal
// coefficients, written in hex.
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

// Thread `tid`'s pixel (lx, ly) inside a tile of tile_w x tile_h pixels.  A
// warp covers an 8x4 block where tile_w is a multiple of 8 and tile_h of 4;
// other tiles take 32 consecutive pixels of the row-major order.  Threads
// past the tile's last pixel (a block padded to whole warps) shadow it.
__device__ __forceinline__ void tile_pixel(int tid, int tile_w, int tile_h, int& lx, int& ly) {
  if ((tile_w & 7) == 0 && (tile_h & 3) == 0) {
    const int warp = tid >> 5, lane = tid & 31;
    const int wx = tile_w >> 3;
    lx = (warp % wx) * 8 + (lane & 7);
    ly = (warp / wx) * 4 + (lane >> 3);
  } else {
    const int i = min(tid, tile_w * tile_h - 1);
    lx = i % tile_w;
    ly = i / tile_w;
  }
}

// Pixel centres [x0, x1] x [y0, y1].
struct Rect {
  float x0, x1, y0, y1;
};

// The bounding rectangle of the centres (px, py) of the warp's lanes that
// pass `take` (at least one does); every lane gets it.
__device__ __forceinline__ Rect warp_rect(float px, float py, bool take) {
  const float big = 3.0e38f;
  Rect rc{take ? px : big, take ? px : -big, take ? py : big, take ? py : -big};
  for (int o = 16; o > 0; o >>= 1) {
    rc.x0 = fminf(rc.x0, __shfl_xor_sync(kFull, rc.x0, o));
    rc.x1 = fmaxf(rc.x1, __shfl_xor_sync(kFull, rc.x1, o));
    rc.y0 = fminf(rc.y0, __shfl_xor_sync(kFull, rc.y0, o));
    rc.y1 = fmaxf(rc.y1, __shfl_xor_sync(kFull, rc.y1, o));
  }
  return rc;
}

// A record's cutoff as a bound on the squared screen distance from its
// centre.  Isotropic: cut2 itself.  Oriented: d2 >= min(1, rr)^2 (dx^2 +
// dy^2) up to the rotation's rounding, hence cut2 / min(1, rr)^2, widened by
// kCullSlack; the oriented quad's two half-plane tests imply d2 <= 2 cut2.
// A record that can never contribute keeps its negative cut2.
template <bool ORIENTED, bool QUAD>
__device__ __forceinline__ float cull_bound(float cut2, float rr) {
  if (!ORIENTED) return cut2;
  const float rrm = fminf(rr, 1.0f);
  float bound = (cut2 / (rrm * rrm)) * kCullSlack;
  if (QUAD) bound = bound * 2.0f;
  return bound;
}

// Can a record with centre (cx, cy) and `bound` (cull_bound) reach any pixel
// centre of `rc`?  False only when it cannot: the nearest point's squared
// distance against the bound, which for the isotropic profiles is exact
// (float subtraction, squaring and addition are monotone under
// round-to-nearest).  BOXED (the isotropic quad): per axis.
template <bool BOXED>
__device__ __forceinline__ bool cull_live(float cx, float cy, float bound, const Rect& rc) {
  const float dxn = fmaxf(fmaxf(rc.x0 - cx, cx - rc.x1), 0.0f);
  const float dyn = fmaxf(fmaxf(rc.y0 - cy, cy - rc.y1), 0.0f);
  if (BOXED) return dxn * dxn <= bound && dyn * dyn <= bound;
  return dxn * dxn + dyn * dyn <= bound;
}

}  // namespace warp_cull
