"""Sort-based tile binning: per-tile runs in canonical compositing order.

Counterpart of `splat_renderer_tpu/render/binning.py`, in a layout suited
to the GPU.  The canonical compositing order is ascending (depth, input
index): bit-equal depths are common on symmetric scenes, so the
input-index tie-break is part of the semantics.

1. Each record expands into up to `tiles_per_splat_cap` (tile, record)
   pairs, padded to N*cap with the sentinel tile `num_tiles` for inactive
   slots.
2. One `torch.sort` orders the pairs by an int64 key with the tile in its
   high 32 bits.  The low bits are either the record's rank, for records
   already in canonical order (unique, so any sort is deterministic), or
   its 32-bit depth key, for records in input order (`bin_packed_words`):
   a stable sort of record-major pairs then breaks depth ties by input
   index, so every tile's run is in canonical order without a record sort.
3. Per-tile counts come from `bincount`, offsets from `cumsum`: so on the
   CPU, and on any device for `bin_planes_diff` and `bin_splats`.  On CUDA
   tensors `bin_packed_words` runs the hand-written binner instead
   (`ops/bin_words.py`, csrc/bin_words.cu): it expands only the live pairs,
   record-major, sorts those stably by the same key, and reads the tile
   ranges off the sorted keys, with no histogram; its offsets, counts,
   live pairs and record planes are the plain path's bit for bit.  The
   tail past the live pairs holds the sentinel tile on both paths; its
   pair_rank is the sorted-out slots' records on the plain path and 0 on
   the kernel's.

The blend reads a tile's run [offsets[t], offsets[t+1]) and gathers each
record's words by the pair's record index; nothing reads past
offsets[-1].

Three binners share the pair stage (`_pair_stage`): `bin_packed_words` (the
exact pipeline's quantized words, in input order; on the CPU, through
`bin_packed_words_plain`), `bin_planes_diff` (the
differentiable render's continuous f32 planes, read by
csrc/tile_blend_diff.cu) and `bin_splats` (float records for the plain tile
compositor); the last two sort their records first.  The TPU package's
128-lane window tables (`stream_tables`, `block_*`) are not ported: a CUDA
block walks its tile's run itself.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .._torch_util import div, sqrt_rn
from ..config import RenderConfig
from ..ops.bin_words import bin_words
from ..utils.profiling import count, enabled, span
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
    dkeys: Optional[torch.Tensor] = None,
) -> Binned:
    """Expand records into (tile, record) pairs and sort them.

    Without `dkeys` the records are in canonical order (rank = row).
    Slot-major (cap, n) expansion: slot c * n + rank holds footprint tile c
    of record `rank`, or the sentinel tile `num_tiles`.  One sort of the
    int64 key `(tile << 32) | rank` orders the N*cap slots; its indices are
    each sorted pair's slot (`pair_slot`), which the differentiable blend
    uses to put per-pair gradients back at their record.

    With `dkeys` (N,) the records are in input order (`bin_packed_words`):
    record-major (n, cap) expansion, slot i * cap + c for record i, and one
    stable sort of `(tile << 32) | dkey`.  Stability keeps equal keys in
    slot order, which is input order (a record has at most one pair per
    tile), so each tile's run is in (depth key, input index) order: the
    canonical order, reached without a record sort.  pair_rank is then
    the input index.

    Returns offsets, counts, pair_tile, pair_rank (int64) and pair_slot
    (int64).
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
    if dkeys is None:
        rank = torch.arange(n, device=device)[None, :]
        keys, pair_slot = torch.sort(((tile << 32) | rank).reshape(-1))
        pair_rank = keys & 0xFFFFFFFF
    else:
        keys, pair_slot = torch.sort(((tile.t() << 32) | dkeys[:, None]).reshape(-1),
                                     stable=True)
        pair_rank = pair_slot // cap
    pair_tile = keys >> 32

    counts = torch.bincount(pair_tile, minlength=num_tiles + 1)[:num_tiles]
    offsets = torch.zeros(num_tiles + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(counts, 0)
    if enabled():
        count("pairs", offsets[-1])
    return {
        "offsets": offsets,
        "counts": counts,
        "pair_tile": pair_tile,
        "pair_rank": pair_rank,
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


def _compact_nearest(k: int, dkeys: torch.Tensor, *words: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The k records first in canonical order, in input order: dkeys and
    each word plane gathered at their input indices."""
    n = dkeys.shape[0]
    if k < 1 or n >= 1 << 31:
        raise ValueError(f"compact_to={k} of {n} records: need 1 <= compact_to and "
                         "fewer than 2**31 records (the key holds a 31-bit index)")
    iota = torch.arange(n, device=dkeys.device)
    key = (dkeys << 31) | iota  # unique: exactly k keys are <= the k-th smallest
    thresh = torch.topk(key, k, largest=False, sorted=False).values.max()
    keep = key <= thresh
    slot = torch.where(keep, torch.cumsum(keep, 0) - 1, k)  # the dropped share trash slot k
    idx = torch.zeros(k + 1, dtype=torch.int64, device=dkeys.device).scatter_(0, slot, iota)[:k]
    return (dkeys[idx],) + tuple(w[idx] for w in words)


def _word_geometry(w_pos: torch.Tensor, w_ro: torch.Tensor, cfg: RenderConfig):
    """cx, cy, radius (px) and, for oriented profiles, angle and ratio
    (else None) of packed words: grid-exact float32."""
    inv_ps, po = 1.0 / cfg.pos_scale, cfg.pos_offset
    f = lambda x: x.to(torch.float32)  # noqa: E731
    cx = f(w_pos & 0xFFFF) * inv_ps - po
    cy = f(w_pos >> 16) * inv_ps - po
    r = f(w_ro & 0xFFFF) * inv_ps
    if not cfg.oriented:
        return cx, cy, r, None, None
    ang = f((w_ro >> 16) & 0xFF) * INV_ANGLE_SCALE - math.pi
    ratio = f(w_ro >> 24) * INV_RATIO_SCALE
    return cx, cy, r, ang, ratio


def footprint_rows(
    dkeys: torch.Tensor, w_pos: torch.Tensor, w_ro: torch.Tensor, cfg: RenderConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ty0, h) int64: the first tile row and the row count of each
    record's footprint, as `bin_packed_words` expands it on cfg's frame
    (h = 0: the record has no pairs)."""
    cx, cy, r, ang, ratio = _word_geometry(w_pos, w_ro, cfg)
    _, ty0, _, h = _footprint_cols(cx, cy, r, dkeys < _INF_KEY, cfg, ang=ang, ratio=ratio)
    return ty0, h


@span("bin")
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

    The records stay in input order: the pairs are keyed by
    `(tile << 32) | depth key` and sorted stably from record-major slots,
    so each tile's run is in (depth key, input index) order, the canonical
    order, with no sort of the records themselves.

    Returns:
      offsets (T+1,) int32: tile t's run is pairs [offsets[t], offsets[t+1])
      counts (T,) int32: exact pairs per tile
      pair_rank (N*cap,) int32: input index of each pair's record, sorted
          by (tile, depth key, input index); past offsets[-1] the tail is
          unspecified but in [0, N) (the plain path: the records of the
          sorted-out sentinel slots; the kernel: 0)
      pair_tile (N*cap,) int32: tile of each pair; the tail holds the
          sentinel tile num_tiles on both paths
      rec_pos, rec_ro, rec_rgb (N,) int32: the input words (bit patterns of
          the u32 words), indexed by pair_rank
      rec_depth (N,) int32, only with_depth (the G-buffer stream): the bit
          pattern of each record's float depth, `dk & 0x7FFFFFFF`, the
          inverse of `packing.depth_bits` for the positive depths
          projection emits (culled records read +inf and have no pairs).
          Depth is one more plane indexed by pair_rank: no sort payload,
          as the TPU package's pair stream needs.

    The turbo profile's two orderings (`turbo_render_config`) are accepted
    and change nothing:
      - cfg.fast_math: the JAX package coarsens the rank by up to 4 low
        bits where (tile, rank) does not fit its u32 sort key, letting
        records of one 2^k-rank band composite in any order.  This key is
        int64 and always fits, so the exact order stands: it is one of the
        orders the flag allows.
      - cfg.depth_key_order: the JAX package keys pairs by the depth key's
        high bits to skip its record sort.  This binner never sorts
        records and keys the whole depth key, so it is already the exact
        profile's order and image.

    compact_to: keep only the `compact_to` nearest records, the first
    ones in canonical (depth key, input index) order, and drop the rest
    before the pair stage, so every pair-scale buffer has compact_to * cap
    slots (the depth-band renderer, `parallel/band.py`, sheds its routing
    sentinels this way; the caller counts its valid records and flags an
    overflow).  A capacity of at least N changes nothing.  The kept set is
    found without sorting the records: the k-th smallest 63-bit key
    `dk << 31 | index` (a radix select, `torch.topk`) is a threshold, and a
    prefix sum scatters the records at or below it to their slots in input
    order.  Nothing of this waits for the host.  The rec_* planes (and
    rec_depth) then hold the kept records, in input order, and pair_rank
    indexes them.

    Which path runs: on CUDA tensors the hand-written binner
    (`ops/bin_words.py`, counted in `ops/build.py`'s `launches`); it reads
    P, the live pairs, back to the host once, to size its sort.  On CPU tensors the plain path
    `bin_packed_words_plain`, whose `bincount` reads back as well.  Both
    count `pairs` (offsets[-1]) while tracing is on.

    class_caps (class-partitioned expansion) raises NotImplementedError.
    """
    if class_caps is not None:
        raise NotImplementedError("class_caps is not ported")
    if compact_to is not None and int(compact_to) < dkeys.shape[0]:
        dkeys, w_pos, w_ro, w_rgb = _compact_nearest(int(compact_to), dkeys, w_pos, w_ro, w_rgb)
    if dkeys.device.type == "cpu":
        return bin_packed_words_plain(dkeys, w_pos, w_ro, w_rgb, cfg, with_depth=with_depth)
    out = bin_words(dkeys.contiguous(), w_pos.contiguous(), w_ro.contiguous(),
                    w_rgb.contiguous(), cfg, with_depth=with_depth)
    if enabled():
        count("pairs", out["offsets"][-1])
    return out


def bin_packed_words_plain(
    dkeys: torch.Tensor,
    w_pos: torch.Tensor,
    w_ro: torch.Tensor,
    w_rgb: torch.Tensor,
    cfg: RenderConfig,
    with_depth: bool = False,
) -> Binned:
    """`bin_packed_words`' plain path, on any device (the CPU's, and the
    twin the kernel is held to on the card): `_pair_stage` over the
    record-major slots, after any `compact_to`."""
    cx, cy, r, ang, ratio = _word_geometry(w_pos, w_ro, cfg)
    pairs = _pair_stage(cx, cy, r, dkeys < _INF_KEY, cfg, ang=ang, ratio=ratio, dkeys=dkeys)
    out = {
        "offsets": pairs["offsets"].to(torch.int32),
        "counts": pairs["counts"].to(torch.int32),
        "pair_rank": pairs["pair_rank"].to(torch.int32),
        "pair_tile": pairs["pair_tile"].to(torch.int32),
        "rec_pos": as_int32_bits(w_pos),
        "rec_ro": as_int32_bits(w_ro),
        "rec_rgb": as_int32_bits(w_rgb),
    }
    if with_depth:
        out["rec_depth"] = (dkeys & 0x7FFFFFFF).to(torch.int32)
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
