"""Per-tile front-to-back compositing: the CUDA kernels' wrapper and their
plain PyTorch twin.

`blend_tiles` composites the runs of `render/binning.bin_packed_words`.  For
CUDA tensors it launches a hand-written Hopper kernel of
`csrc/tile_blend.cu` or raises; it never falls back.  For CPU tensors it
runs `blend_tiles_plain`, the same function in plain PyTorch.

Two schedules compute the same outputs bit for bit:

- `"tile"`: one CTA per tile (`tile_blend_kernel`), which replaces the JAX
  package's Pallas kernels `ops/tile_blend.py::_make_tile_kernel` and
  `_make_kernel`;
- `"tile_xp"`: a persistent grid over the nonempty tiles, heaviest first,
  that keeps the next chunk's records (the next tile's first included) in
  flight under the current chunk's compute (`tile_blend_xp_kernel`), which
  replaces `_make_tile_kernel_xp`.

Both kernels cull per warp: a warp covers an 8x4 pixel block and walks only
the records whose support can reach it.  `cull_live_plain` is that test in
plain PyTorch, `warp_pixels` the kernels' pixel-to-lane mapping; the tests
hold them against the twin's alphas, nothing on the card's path calls them.

`with_depth=True` (the G-buffer stream, `bin_packed_words(with_depth=True)`)
adds a third output: the premultiplied depth sum under the colour's weights.

The launch counter `launches` of `ops/build.py` counts them under the
kernel's key, one of `KERNELS`.

While the recorder of `utils/profiling.py` is on, the program counter
`blend_walked` adds the run positions each tile's walk took before every
pixel of the tile had stopped (or the run was over): on the card the
per-tile kernel adds them into a device scalar, one atomic a CTA, with no
read-back (its warps stop at the end of a 32-record group, so it reads up
to 31 positions a nonempty tile above the twin); the twin counts them at
its exact stop; the persistent schedule counts nothing.  Off, no buffer is
made and the kernel is handed none.

Returns (tile_color (T, tp, 3), tile_alpha (T, tp)) float32, plus tile_depth
(T, tp) with depth; tiles with no records come out as zeros.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from ..config import RenderConfig
from ..utils.profiling import count, enabled, span
from .._torch_util import maximum, minimum
from ..render.blend import segmented_exclusive_product, splat_alpha_planes
from ..render.packing import (
    INV_ANGLE_SCALE,
    INV_COLOR_SCALE,
    INV_RATIO_SCALE,
    U32_MASK,
    unpack_words,
)
from .build import Entry, check_tensor

MAX_TILE_PIXELS = 1024  # one thread per pixel, one CTA per tile
CULL_SLACK = 1.001  # csrc/warp_cull.cuh kCullSlack: the oriented culling bound's widening

_INT32_INPUTS = ("offsets", "pair_rank", "rec_pos", "rec_ro", "rec_rgb")
SCHEDULES = ("tile", "tile_xp")
# the launch counter's keys of this module's kernel: schedule and form
KERNELS = ("tile_blend", "tile_blend_depth", "tile_blend_xp", "tile_blend_xp_depth")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FORWARD = Entry("tile_blend", "tile_blend_forward",
                 [_P] * 11 + [_I] * 6 + [_F] * 10 + [_P, _P])
_LAUNCH_INFO = Entry("tile_blend", "tile_blend_launch_info", [_I] * 6 + [_P])


def _shape_code(cfg: RenderConfig) -> int:
    """0 Gaussian, 1 opaque ellipse, 2 opaque quad (csrc Shape enum)."""
    if not cfg.opaque:
        return 0
    return 2 if cfg.quad else 1


def launch_info(cfg: RenderConfig, schedule: str = "tile", with_depth: bool = False) -> dict:
    """What the kernel of (cfg's profile, schedule, with_depth) gets on the
    current CUDA device at cfg's tile shape: registers per thread, resident
    CTAs per SM (the occupancy query's answer), SMs, dynamic shared memory
    bytes, and the persistent schedule's full grid."""
    out = (ctypes.c_int * 4)()
    _LAUNCH_INFO(int(cfg.oriented), _shape_code(cfg), int(with_depth), int(schedule == "tile_xp"),
                 cfg.tile_w, cfg.tile_h, out)
    regs, per_sm, sms, smem = out
    return dict(registers=regs, ctas_per_sm=per_sm, sms=sms, smem_bytes=smem,
                xp_grid=per_sm * sms)


def nonempty_tiles(counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tile_list (T,) int32, n_list (1,) int32): the tiles by record count,
    heaviest first (ties in tile order), so the tiles with records come
    first, and their number; both on the device and made without a host
    synchronisation (one stable sort)."""
    tile_list = torch.sort(counts, descending=True, stable=True).indices.to(torch.int32)
    n_list = (counts > 0).sum(dtype=torch.int32).reshape(1)
    return tile_list, n_list


def warp_pixels(cfg: RenderConfig) -> torch.Tensor:
    """(warps, 32) int64: the tile-local pixel index (row-major, y * tile_w
    + x) of every lane, as the kernels map them (csrc/warp_cull.cuh
    `tile_pixel`): an 8x4
    block per warp where tile_w is a multiple of 8 and tile_h of 4, else 32
    consecutive pixels, lanes past the last pixel shadowing it."""
    tw, th = cfg.tile_w, cfg.tile_h
    tid = torch.arange((tw * th + 31) // 32 * 32)
    warp, lane = tid // 32, tid % 32
    if tw % 8 == 0 and th % 4 == 0:
        lx = (warp % (tw // 8)) * 8 + lane % 8
        ly = (warp // (tw // 8)) * 4 + lane // 8
        pix = ly * tw + lx
    else:
        pix = torch.clamp(tid, max=tw * th - 1)
    return pix.reshape(-1, 32)


def warp_rects(cfg: RenderConfig) -> torch.Tensor:
    """(warps, 4) float32: each warp's rectangle of tile-local pixel centres
    (x0, x1, y0, y1)."""
    pix = warp_pixels(cfg)
    x = (pix % cfg.tile_w).to(torch.float32) + 0.5
    y = (pix // cfg.tile_w).to(torch.float32) + 0.5
    return torch.stack([x.amin(1), x.amax(1), y.amin(1), y.amax(1)], dim=1)


def cull_live_plain(
    cx: torch.Tensor,
    cy: torch.Tensor,
    cut2: torch.Tensor,
    rr: torch.Tensor,
    x0: torch.Tensor,
    x1: torch.Tensor,
    y0: torch.Tensor,
    y1: torch.Tensor,
    oriented: bool,
    quad: bool = False,
) -> torch.Tensor:
    """The kernels' warp-level culling test (csrc/warp_cull.cuh `cull_bound`
    and `cull_live`, which both blend sources include) in plain PyTorch
    (float32, the same operations in the same order): False where a record with centre
    (cx, cy) and staged cutoff `cut2` (`staged_cut2`; rr = max(ratio, 1e-3),
    read only when oriented) can give no pixel centre of [x0, x1] x [y0, y1]
    (screen coordinates) a nonzero alpha.  Isotropic: the nearest point's
    squared distance against the cutoff, exact.  Oriented: against
    cut2 / min(1, rr)^2, widened by CULL_SLACK (twice that for the quad)."""
    dxn = maximum(torch.maximum(x0 - cx, cx - x1), 0.0)
    dyn = maximum(torch.maximum(y0 - cy, cy - y1), 0.0)
    if oriented:
        rrm = minimum(rr, 1.0)
        bound = (cut2 / (rrm * rrm)) * CULL_SLACK
        if quad:
            bound = bound * 2.0
        return dxn * dxn + dyn * dyn <= bound
    if quad:
        return (dxn * dxn <= cut2) & (dyn * dyn <= cut2)
    return dxn * dxn + dyn * dyn <= cut2


def staged_cut2(radius: torch.Tensor, opacity: torch.Tensor, ratio: torch.Tensor,
                cfg: RenderConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cut2, rr) as the kernels stage them from unpacked words (csrc
    `decode_store`): margin^2 scale^2 (Gaussian) or scale^2 (opaque), and -1
    for a record whose alpha is 0 everywhere (below min_screen_radius, or
    opacity 0)."""
    rr = maximum(ratio, 1e-3) if cfg.oriented else torch.ones_like(ratio)
    scale = radius * rr if cfg.oriented else radius
    scale2 = scale * scale
    cut2 = scale2 if cfg.opaque else (cfg.bounds_margin * cfg.bounds_margin) * scale2
    dead = ~(radius >= cfg.min_screen_radius) | ~(opacity > 0.0)
    return torch.where(dead, -1.0, cut2), rr


@span("blend")
def blend_tiles(
    binned: Dict[str, torch.Tensor],
    cfg: RenderConfig,
    eps: Optional[float] = None,
    schedule: str = "tile",
    with_depth: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Composite every tile's depth-ordered run.

    eps: transmittance floor of the early exit (None = cfg.
    transmittance_eps; 0 turns it off).  A pixel stops once its
    transmittance is <= eps.
    schedule: "tile" or "tile_xp" (module docstring); the outputs are equal
    bit for bit.  On the CPU both run the plain twin.
    with_depth: also return tile_depth; `binned` must carry "rec_depth".
    """
    if schedule not in SCHEDULES:
        # a mistyped schedule must never silently time the wrong kernel
        raise ValueError(f"unknown blend schedule {schedule!r}; expected one of {SCHEDULES}")
    eps = cfg.transmittance_eps if eps is None else float(eps)
    offsets = binned["offsets"]
    if with_depth and "rec_depth" not in binned:
        raise ValueError("with_depth needs bin_packed_words(with_depth=True)")
    if offsets.device.type == "cpu":
        return blend_tiles_plain(binned, cfg, eps, with_depth=with_depth)
    if offsets.device.type != "cuda":
        raise ValueError(f"no tile-blend kernel for device {offsets.device}")

    tp, num_tiles = cfg.tile_pixels, cfg.num_tiles
    if tp > MAX_TILE_PIXELS:
        raise ValueError(
            f"tile {cfg.tile_w}x{cfg.tile_h} has {tp} pixels; the kernel runs "
            f"one thread per pixel, at most {MAX_TILE_PIXELS}"
        )
    device = offsets.device
    for name in _INT32_INPUTS + (("rec_depth",) if with_depth else ()):
        check_tensor(f"binned[{name!r}]", binned[name], torch.int32, device,
                     shape=(num_tiles + 1,) if name == "offsets" else None)

    xp = schedule == "tile_xp"
    # the persistent kernel never visits an empty tile: its outputs start as
    # zeros; the per-tile kernel writes every tile
    alloc = torch.zeros if xp else torch.empty
    tile_color = alloc((num_tiles, tp, 3), dtype=torch.float32, device=device)
    tile_alpha = alloc((num_tiles, tp), dtype=torch.float32, device=device)
    tile_depth = alloc((num_tiles, tp), dtype=torch.float32, device=device) if with_depth else None
    tile_list, n_list = nonempty_tiles(binned["counts"]) if xp else (None, None)
    walked = None if xp or not enabled() else torch.zeros((), dtype=torch.int64, device=device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _FORWARD.launch(
        device,
        offsets.data_ptr(), binned["pair_rank"].data_ptr(),
        binned["rec_pos"].data_ptr(), binned["rec_ro"].data_ptr(),
        binned["rec_rgb"].data_ptr(),
        binned["rec_depth"].data_ptr() if with_depth else None,
        tile_color.data_ptr(), tile_alpha.data_ptr(), ptr(tile_depth),
        ptr(tile_list), ptr(n_list),
        num_tiles, cfg.tiles_x, cfg.tile_w, cfg.tile_h,
        int(cfg.oriented), _shape_code(cfg),
        1.0 / cfg.pos_scale, cfg.pos_offset, cfg.min_screen_radius,
        cfg.bounds_margin * cfg.bounds_margin,
        -0.5 / (cfg.sigma * cfg.sigma), eps,
        INV_COLOR_SCALE, INV_ANGLE_SCALE, INV_RATIO_SCALE, math.pi, ptr(walked),
        count=("tile_blend_xp" if xp else "tile_blend") + ("_depth" if with_depth else ""),
    )
    if walked is not None:
        count("blend_walked", walked)
    if with_depth:
        return tile_color, tile_alpha, tile_depth
    return tile_color, tile_alpha


def blend_tiles_plain(
    binned: Dict[str, torch.Tensor],
    cfg: RenderConfig,
    eps: Optional[float] = None,
    pair_chunk: int = 1024,
    with_depth: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The kernels' function in plain PyTorch, on any device (the twin of
    both schedules: they compute one function).

    Mirrors the JAX package's `render/compositor.py::render_tiles`: the
    tile-sorted pair stream is scanned in chunks; per chunk every pair's
    alpha is evaluated over its tile's pixels, the within-chunk
    transmittance is a segmented exclusive product, and colour and
    transmittance fold into per-tile accumulators.  Early exit is per pixel
    at chunk granularity: a pixel whose transmittance is <= eps at a chunk's
    start takes no contribution from it.  with_depth also folds each
    record's depth (`rec_depth`, read as float32) under the colour's
    weights and returns it third.  While the recorder is on it counts
    `blend_walked`: each tile's run positions up to the first after which
    every pixel's transmittance is <= eps, or the whole run.
    """
    eps = cfg.transmittance_eps if eps is None else float(eps)
    offsets = binned["offsets"]
    device = offsets.device
    num_tiles, tp, tw = cfg.num_tiles, cfg.tile_pixels, cfg.tile_w
    n_pairs = int(offsets[-1])

    u32 = lambda w: w.to(torch.int64) & U32_MASK
    cx, cy, r, op, cr, cg, cb, ang, ratio = unpack_words(
        u32(binned["rec_pos"]), u32(binned["rec_ro"]), u32(binned["rec_rgb"]), cfg
    )
    rgb = torch.stack([cr, cg, cb], dim=-1)
    lane = torch.arange(tp, device=device)
    lx = (lane % tw).to(torch.float32) + 0.5
    ly = (lane // tw).to(torch.float32) + 0.5

    if with_depth:
        rec_d = binned["rec_depth"].view(torch.float32)
        # culled records read +inf and have no pairs; keep 0 * inf out anyway
        rec_d = torch.where(torch.isfinite(rec_d), rec_d, 0.0)
        depth = torch.zeros((num_tiles, tp), dtype=torch.float32, device=device)
    color = torch.zeros((num_tiles, tp, 3), dtype=torch.float32, device=device)
    trans = torch.ones((num_tiles, tp), dtype=torch.float32, device=device)
    counting = enabled()
    if counting:  # each tile's first run position after which its pixels have all stopped
        stop = torch.full((num_tiles,), n_pairs, dtype=torch.int64, device=device)
    for lo in range(0, n_pairs, pair_chunk):
        hi = min(lo + pair_chunk, n_pairs)
        tiles = binned["pair_tile"][lo:hi].to(torch.int64)
        ranks = binned["pair_rank"][lo:hi].to(torch.int64)
        pxc = ((tiles % cfg.tiles_x).to(torch.float32) * tw)[:, None] + lx[None, :]
        pyc = ((tiles // cfg.tiles_x).to(torch.float32) * cfg.tile_h)[:, None] + ly[None, :]
        col = lambda v: v[ranks][:, None]
        a = splat_alpha_planes(
            col(cx), col(cy), col(r), col(op), col(ang), col(ratio),
            pxc, pyc, cfg,
        )  # (c, tp)
        carry = trans[tiles]  # (c, tp)
        a = torch.where(carry > eps, a, 0.0)
        same = tiles[1:] == tiles[:-1]
        starts = torch.cat([same.new_ones(1), ~same])
        q = 1.0 - a
        t_local = segmented_exclusive_product(q, starts)
        weight = a * t_local * carry
        color.index_add_(0, tiles, weight[:, :, None] * rgb[ranks][:, None, :])
        if with_depth:
            depth.index_add_(0, tiles, weight * rec_d[ranks][:, None])
        if counting:
            done = ((carry * (t_local * q)) <= eps).all(1)
            at = torch.arange(lo, hi, device=device)
            stop.scatter_reduce_(0, tiles, torch.where(done, at, n_pairs), "amin")
        # a tile's run inside a chunk is one segment: fold its product at
        # the segment's last pair
        ends = torch.cat([~same, same.new_ones(1)])
        trans[tiles[ends]] *= (t_local * q)[ends]
    if counting:
        starts, ends = offsets[:-1].to(torch.int64), offsets[1:].to(torch.int64)
        walked = (torch.minimum(stop + 1, ends) - starts).sum()
        # at eps >= 1 no pixel is alive before the first record, as in the kernel
        count("blend_walked", walked if 1.0 > eps else torch.zeros_like(walked))
    if with_depth:
        return color, 1.0 - trans, depth
    return color, 1.0 - trans
