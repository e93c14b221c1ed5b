"""Sort-based tile binning: canonical record order + (tile, rank) pair sort.

Counterpart of `splat_renderer_tpu/render/binning.py`, exact profile only,
in a layout suited to the GPU:

1. Record stage: records are ordered by (depth_bits, input index), the
   pipeline's canonical compositing order (bit-equal depths are common on
   symmetric scenes, so the input-index tie-break is part of the
   semantics).  A record's position in that order is its *rank*.
2. Pair stage: each record expands into up to `tiles_per_splat_cap`
   (tile, rank) pairs, slot-major, padded to N*cap with the sentinel tile
   `num_tiles` for inactive slots.  One `torch.sort` of the int64 key
   `(tile << 32) | rank` orders them; no payload rides along, because the
   rank is in the key.  Ranks are unique, so every tile's run is exactly
   depth-ordered with deterministic ties.
3. Per-tile counts come from `bincount`, offsets from `cumsum`.

The blend reads a tile's run [offsets[t], offsets[t+1]) and gathers each
record's words by rank from the canonical-order word planes.

Three binners share the pair stage (`_pair_stage`): `bin_packed_words` (the
exact pipeline's quantized words), `bin_planes_diff` (the differentiable
render's continuous f32 planes, read by csrc/tile_blend_diff.cu) and
`bin_splats` (float records for the plain tile compositor).  The TPU
package's 128-lane window tables (`stream_tables`, `block_*`) are not ported:
a CUDA block walks its tile's run itself.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .._torch_util import div, sqrt_rn
from ..config import RenderConfig
from .blend import ellipse_cos_sin
from .packing import INV_ANGLE_SCALE, INV_RATIO_SCALE, as_int32_bits

Binned = Dict[str, torch.Tensor]

# depth key of +inf (culled records): 0x7F800000 | 0x80000000
_INF_KEY = 0xFF800000


def _footprint_cols(
    cx: torch.Tensor,
    cy: torch.Tensor,
    radius: torch.Tensor,
    depth_valid: torch.Tensor,
    cfg: RenderConfig,
    ang: Optional[torch.Tensor] = None,
    ratio: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Clamped tile ranges (tx0, ty0, w, h) per splat (int64).

    Bounds = centre +- bounds_margin * radius; for oriented profiles the
    exact axis-aligned extents of the rotated support ellipse (or square,
    cfg.quad) plus 1/pos_scale px of slack.  Footprints larger than
    tiles_per_splat_cap tiles shrink toward the centre tile; splats below
    min_screen_radius, culled or off screen get w = h = 0.
    """
    cap = cfg.tiles_per_splat_cap
    pad = radius * cfg.bounds_margin
    if ang is not None:
        ca, sa = ellipse_cos_sin(ang)
        rr = torch.clamp(ratio, 0.0, 1.0)
        slack = 1.0 / cfg.pos_scale
        if cfg.opaque and cfg.quad:
            aca, asa = torch.abs(ca), torch.abs(sa)
            hx = pad * (rr * aca + asa) + slack
            hy = pad * (rr * asa + aca) + slack
        else:
            r2 = rr * rr
            hx = pad * sqrt_rn(sa * sa + r2 * ca * ca) + slack
            hy = pad * sqrt_rn(ca * ca + r2 * sa * sa) + slack
    else:
        hx = pad
        hy = pad
    bmin_x, bmax_x = cx - hx, cx + hx
    bmin_y, bmax_y = cy - hy, cy + hy

    tw, th = float(cfg.tile_w), float(cfg.tile_h)

    def tile_of(v, t, n_t):
        return torch.clamp(torch.floor(div(v, t)), 0, n_t - 1).to(torch.int64)

    tx0 = tile_of(bmin_x, tw, cfg.tiles_x)
    ty0 = tile_of(bmin_y, th, cfg.tiles_y)
    tx1 = tile_of(bmax_x, tw, cfg.tiles_x)
    ty1 = tile_of(bmax_y, th, cfg.tiles_y)

    alive = (
        depth_valid
        & (radius >= cfg.min_screen_radius)
        & (bmax_x >= 0)
        & (bmax_y >= 0)
        & (bmin_x < cfg.width)
        & (bmin_y < cfg.height)
    )

    w = tx1 - tx0 + 1
    h = ty1 - ty0 + 1
    # shrink to <= cap tiles, keeping the window centred on the centre tile
    w_c = torch.clamp(w, max=cap)
    h_c = torch.minimum(h, torch.clamp(cap // w_c, min=1))
    ctx = tile_of(cx, tw, cfg.tiles_x)
    cty = tile_of(cy, th, cfg.tiles_y)
    tx0 = torch.clamp(ctx - (w_c - 1) // 2, min=tx0, max=tx1 - w_c + 1)
    ty0 = torch.clamp(cty - (h_c - 1) // 2, min=ty0, max=ty1 - h_c + 1)

    w_c = torch.where(alive, w_c, 0)
    h_c = torch.where(alive, h_c, 0)
    return tx0, ty0, w_c, h_c


def _diag_prune(
    cx: torch.Tensor,
    cy: torch.Tensor,
    radius: torch.Tensor,
    tx0: torch.Tensor,
    ty0: torch.Tensor,
    w: torch.Tensor,
    h: torch.Tensor,
    cfg: RenderConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Diagonal-corner disc prune for 2x2 footprints.

    A splat whose padded bbox spans a 2x2 tile block always covers the two
    edge-adjacent tiles but misses the diagonal one whenever the shared
    interior corner lies outside its support disc (+1/pos_scale px slack);
    dropping that pair is exact.  Returns (c_d, miss): the footprint slot
    (row-major dy*w + dx) of the diagonal tile and whether to prune it.
    Square (cfg.quad) footprints reach every tile of their AABB.
    """
    tw, th = float(cfg.tile_w), float(cfg.tile_h)
    ctx = torch.clamp(torch.floor(div(cx, tw)), 0, cfg.tiles_x - 1).to(torch.int64)
    cty = torch.clamp(torch.floor(div(cy, th)), 0, cfg.tiles_y - 1).to(torch.int64)
    cix = ctx - tx0
    ciy = cty - ty0
    applicable = (
        (w == 2) & (h == 2)
        & (cix >= 0) & (cix <= 1) & (ciy >= 0) & (ciy <= 1)
    )
    corner_x = (tx0 + 1).to(torch.float32) * tw
    corner_y = (ty0 + 1).to(torch.float32) * th
    dx = cx - corner_x
    dy = cy - corner_y
    pad = radius * cfg.bounds_margin + 1.0 / cfg.pos_scale
    miss = applicable & (dx * dx + dy * dy > pad * pad)
    if cfg.opaque and cfg.quad:
        miss = torch.zeros_like(miss)
    c_d = (1 - ciy) * 2 + (1 - cix)
    return c_d, miss


def _pair_stage(
    cx: torch.Tensor,
    cy: torch.Tensor,
    radius: torch.Tensor,
    depth_valid: torch.Tensor,
    cfg: RenderConfig,
    ang: Optional[torch.Tensor] = None,
    ratio: Optional[torch.Tensor] = None,
) -> Binned:
    """Expand canonical-order records (rank = row) into (tile, rank) pairs
    and sort them.

    Slot-major (cap, n) expansion: slot c * n + rank holds footprint tile c
    of record `rank`, or the sentinel tile `num_tiles`.  One sort of the
    int64 key `(tile << 32) | rank` orders the N*cap slots; its indices are
    each sorted pair's slot (`pair_slot`), which the differentiable blend
    uses to put per-pair gradients back at their record.  Returns offsets,
    counts, pair_tile, pair_rank (int64) and pair_slot (int64).
    """
    n = cx.shape[0]
    cap = cfg.tiles_per_splat_cap
    num_tiles = cfg.num_tiles
    device = cx.device
    tx0, ty0, w, h = _footprint_cols(cx, cy, radius, depth_valid, cfg,
                                     ang=ang, ratio=ratio)
    c_d, miss = _diag_prune(cx, cy, radius, tx0, ty0, w, h, cfg)

    c = torch.arange(cap, device=device)[:, None]  # (cap, 1)
    dy = c // torch.clamp(w, min=1)[None, :]
    dx = c - dy * w[None, :]
    tile = (ty0[None, :] + dy) * cfg.tiles_x + (tx0[None, :] + dx)
    active = (c < (w * h)[None, :]) & ~((c == c_d[None, :]) & miss[None, :])
    tile = torch.where(active, tile, num_tiles)
    rank = torch.arange(n, device=device)[None, :]
    keys, pair_slot = torch.sort(((tile << 32) | rank).reshape(-1))
    pair_tile = keys >> 32

    counts = torch.bincount(pair_tile, minlength=num_tiles + 1)[:num_tiles]
    offsets = torch.zeros(num_tiles + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(counts, 0)
    return {
        "offsets": offsets,
        "counts": counts,
        "pair_tile": pair_tile,
        "pair_rank": keys & 0xFFFFFFFF,
        "pair_slot": pair_slot,
    }


def canonical_order(dkeys: torch.Tensor) -> torch.Tensor:
    """Input indices in canonical compositing order: ascending
    (depth key, input index).  A stable sort of the keys is exactly that."""
    return torch.sort(dkeys, stable=True).indices


def canonical_sort_data(splat_data: torch.Tensor) -> torch.Tensor:
    """Sort (N, 10) records into canonical order: ascending depth (column
    7), ties broken by input index."""
    order = torch.sort(splat_data[:, 7], stable=True).indices
    return splat_data[order]


def bin_packed_words(
    dkeys: torch.Tensor,  # (N,) int64 depth keys (packing.depth_bits)
    w_pos: torch.Tensor,  # (N,) int64 cx_fx | cy_fx << 16
    w_ro: torch.Tensor,  # (N,) int64 r_fx | ang8 << 16 | ratio8 << 24
    w_rgb: torch.Tensor,  # (N,) int64 r8 | g8 << 8 | b8 << 16 | op8 << 24
    cfg: RenderConfig,
    compact_to: Optional[int] = None,
    class_caps: Optional[Tuple[int, int]] = None,
    with_depth: bool = False,
) -> Binned:
    """Bin the projector's words into depth-ordered per-tile runs.

    Returns:
      offsets (T+1,) int32: tile t's run is pairs [offsets[t], offsets[t+1])
      counts (T,) int32: exact pairs per tile
      pair_rank (N*cap,) int32: rank of each pair's record, sorted by
          (tile, rank); the inactive tail holds the sentinel pairs
      pair_tile (N*cap,) int32: tile of each pair (num_tiles = inactive)
      rec_pos, rec_ro, rec_rgb (N,) int32: the records' words in canonical
          order (bit patterns of the u32 words), indexed by rank
      order (N,) int64: input index of each rank
      rec_depth (N,) int32, only with_depth (the G-buffer stream): the bit
          pattern of each record's float depth, `dk & 0x7FFFFFFF`, the
          inverse of `packing.depth_bits` for the positive depths
          projection emits (culled records read +inf and have no pairs).
          Records stay in canonical order and pairs carry ranks, so depth
          is one more plane indexed by rank: no sort payload, as the TPU
          package's pair stream needs.

    Only the exact profile is implemented: the JAX package's fast_math and
    depth_key_order orderings, compact_to (band compaction) and class_caps
    (class-partitioned expansion) raise NotImplementedError.
    """
    if cfg.fast_math or cfg.depth_key_order:
        raise NotImplementedError(
            "fast_math / depth_key_order pair orderings are not ported; "
            "the PyTorch binner implements the exact profile only"
        )
    if compact_to is not None or class_caps is not None:
        raise NotImplementedError("compact_to and class_caps are not ported")
    ps, po = cfg.pos_scale, cfg.pos_offset
    inv_ps = 1.0 / ps

    # ---- record stage: canonical rank ----
    order = canonical_order(dkeys)
    dk_s, w_pos, w_ro, w_rgb = dkeys[order], w_pos[order], w_ro[order], w_rgb[order]

    # footprints from the sorted words (unpacked values are grid-exact f32)
    f = lambda x: x.to(torch.float32)
    cx = f(w_pos & 0xFFFF) * inv_ps - po
    cy = f(w_pos >> 16) * inv_ps - po
    r = f(w_ro & 0xFFFF) * inv_ps
    if cfg.oriented:
        ang = f((w_ro >> 16) & 0xFF) * INV_ANGLE_SCALE - math.pi
        ratio = f(w_ro >> 24) * INV_RATIO_SCALE
    else:
        ang = ratio = None
    pairs = _pair_stage(cx, cy, r, dk_s < _INF_KEY, cfg, ang=ang, ratio=ratio)
    out = {
        "offsets": pairs["offsets"].to(torch.int32),
        "counts": pairs["counts"].to(torch.int32),
        "pair_rank": pairs["pair_rank"].to(torch.int32),
        "pair_tile": pairs["pair_tile"].to(torch.int32),
        "rec_pos": as_int32_bits(w_pos),
        "rec_ro": as_int32_bits(w_ro),
        "rec_rgb": as_int32_bits(w_rgb),
        "order": order,
    }
    if with_depth:
        out["rec_depth"] = (dk_s & 0x7FFFFFFF).to(torch.int32)
    return out


def bin_splats(splat_data_sorted: torch.Tensor, cfg: RenderConfig) -> Binned:
    """Bin (N, 10) float records that are already in canonical order (see
    `canonical_sort_data`) into per-tile runs, for the plain tile
    compositor (`render/compositor.py::render_tiles`).

    Returns pair_splat (the row of each sorted pair's record) and pair_tile
    (int64, N*cap; the inactive tail holds the sentinel tile num_tiles), and
    offsets (T+1,) and counts (T,) (int64).  Integer structure only: the
    caller passes detached records.
    """
    d = splat_data_sorted
    pairs = _pair_stage(
        d[:, 0], d[:, 1], d[:, 2], torch.isfinite(d[:, 7]), cfg,
        ang=d[:, 8] if cfg.oriented else None,
        ratio=d[:, 9] if cfg.oriented else None,
    )
    return {
        "pair_splat": pairs["pair_rank"],
        "pair_tile": pairs["pair_tile"],
        "offsets": pairs["offsets"],
        "counts": pairs["counts"],
    }


# Field order of the differentiable blend's record planes (the columns of
# bin_planes_diff's "planes"); oriented profiles append the ellipse fields,
# and depth is always last.
DIFF_FIELDS = ("cx", "cy", "radius", "opacity", "r", "g", "b")
DIFF_FIELDS_ORIENTED = DIFF_FIELDS + ("angle", "ratio")


def diff_fields(cfg: RenderConfig) -> Tuple[str, ...]:
    base = DIFF_FIELDS_ORIENTED if cfg.oriented else DIFF_FIELDS
    return base + ("depth",)


def bin_planes_diff(planes: Dict[str, torch.Tensor], cfg: RenderConfig) -> Binned:
    """Binning for the differentiable blend over continuous (N,) planes
    (`projector.shade_planes` fields, keyed as in DIFF_FIELDS).

    Returns:
      offsets (T+1,), counts (T,) int32: tile t's run is pairs
          [offsets[t], offsets[t+1])
      pair_tile, pair_rank, pair_slot (N*cap,) int32: each sorted pair's
          tile, record rank and pre-sort slot (c * n + rank)
      src (N,) int64: input index of each rank
      planes (N, nf) float32: the diff_fields columns in canonical order,
          opacity and colour clipped to [0, 1], culled records' inf depth
          written as 0 (0 * inf would poison the blend's sums)

    Records are ranked by (depth, input index), as the JAX package's
    two-key sort does.  All integer structure comes from detached values;
    `planes` stays differentiable (a gather), which the plain twin of
    ops/tile_blend_diff.py relies on.  The clip to [0, 1] uses
    `torch.clamp`, which passes the gradient inside the interval: the JAX
    package's custom VJP passes it through unchanged, and callers hand in
    values already clipped (render/diff.py).
    """
    fields = diff_fields(cfg)
    depth = planes["depth"]
    src = torch.sort(depth.detach(), stable=True).indices
    depth_s = depth[src]
    finite = torch.isfinite(depth_s)
    cols = [
        torch.clamp(planes[k], 0.0, 1.0)[src] if k in ("opacity", "r", "g", "b")
        else planes[k][src]
        for k in fields[:-1]
    ]
    cols.append(torch.where(finite, depth_s, 0.0))
    stacked = torch.stack(cols, dim=1)
    det = stacked.detach()
    pairs = _pair_stage(
        det[:, 0], det[:, 1], det[:, 2], finite, cfg,
        ang=det[:, 7] if cfg.oriented else None,
        ratio=det[:, 8] if cfg.oriented else None,
    )
    out = {k: v.to(torch.int32) for k, v in pairs.items()}
    out["src"] = src
    out["planes"] = stacked
    return out
