"""Per-tile front-to-back compositing: the CUDA kernel's wrapper and its
plain PyTorch twin.

`blend_tiles` composites the runs of `render/binning.bin_packed_words`.  For
CUDA tensors it launches the hand-written Hopper kernel
`csrc/tile_blend.cu` (which replaces the JAX package's Pallas kernels
`ops/tile_blend.py::_make_tile_kernel` and `_make_kernel`) or raises; it
never falls back.  For CPU tensors it runs `blend_tiles_plain`, the same
function in plain PyTorch.  `blend_tiles.launches` counts kernel launches.

Both return (tile_color (T, tp, 3), tile_alpha (T, tp)) float32; tiles with
no records come out as colour 0 and alpha 0.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..config import RenderConfig
from ..render.binning import Binned
from ..render.blend import segmented_exclusive_product, splat_alpha_planes
from ..render.packing import (
    INV_ANGLE_SCALE,
    INV_COLOR_SCALE,
    INV_RATIO_SCALE,
    U32_MASK,
    unpack_words,
)

MAX_TILE_PIXELS = 1024  # one thread per pixel, one CTA per tile

_INT32_INPUTS = ("offsets", "pair_rank", "rec_pos", "rec_ro", "rec_rgb")


def _shape_code(cfg: RenderConfig) -> int:
    """0 Gaussian, 1 opaque ellipse, 2 opaque quad (csrc Shape enum)."""
    if not cfg.opaque:
        return 0
    return 2 if cfg.quad else 1


def _kernel_fn():
    from .build import load_library

    lib = load_library("tile_blend")
    fn = lib.tile_blend_forward
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.c_float] * 10 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def blend_tiles(
    binned: Binned, cfg: RenderConfig, eps: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composite every tile's depth-ordered run.

    eps: transmittance floor of the early exit (None = cfg.
    transmittance_eps; 0 turns it off).  A pixel stops once its
    transmittance is <= eps.
    """
    eps = cfg.transmittance_eps if eps is None else float(eps)
    offsets = binned["offsets"]
    if offsets.device.type == "cpu":
        return blend_tiles_plain(binned, cfg, eps)
    if offsets.device.type != "cuda":
        raise ValueError(f"no tile-blend kernel for device {offsets.device}")

    tp, num_tiles = cfg.tile_pixels, cfg.num_tiles
    if tp > MAX_TILE_PIXELS:
        raise ValueError(
            f"tile {cfg.tile_w}x{cfg.tile_h} has {tp} pixels; the kernel runs "
            f"one thread per pixel, at most {MAX_TILE_PIXELS}"
        )
    for name in _INT32_INPUTS:
        t = binned[name]
        if t.device != offsets.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(
                f"binned[{name!r}] must be a contiguous int32 tensor on "
                f"{offsets.device}, got {t.dtype} on {t.device}"
            )
    if offsets.shape != (num_tiles + 1,):
        raise ValueError(f"offsets has shape {tuple(offsets.shape)}, "
                         f"expected ({num_tiles + 1},)")

    device = offsets.device
    tile_color = torch.empty((num_tiles, tp, 3), dtype=torch.float32, device=device)
    tile_alpha = torch.empty((num_tiles, tp), dtype=torch.float32, device=device)
    fn = _kernel_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            offsets.data_ptr(), binned["pair_rank"].data_ptr(),
            binned["rec_pos"].data_ptr(), binned["rec_ro"].data_ptr(),
            binned["rec_rgb"].data_ptr(),
            tile_color.data_ptr(), tile_alpha.data_ptr(),
            num_tiles, cfg.tiles_x, cfg.tile_w, cfg.tile_h,
            int(cfg.oriented), _shape_code(cfg),
            1.0 / cfg.pos_scale, cfg.pos_offset, cfg.min_screen_radius,
            cfg.bounds_margin * cfg.bounds_margin,
            -0.5 / (cfg.sigma * cfg.sigma), eps,
            INV_COLOR_SCALE, INV_ANGLE_SCALE, INV_RATIO_SCALE, math.pi,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"tile_blend_forward launch failed: CUDA error {err}")
    blend_tiles.launches += 1
    return tile_color, tile_alpha


blend_tiles.launches = 0


def blend_tiles_plain(
    binned: Binned,
    cfg: RenderConfig,
    eps: Optional[float] = None,
    pair_chunk: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, on any device.

    Mirrors the JAX package's `render/compositor.py::render_tiles`: the
    tile-sorted pair stream is scanned in chunks; per chunk every pair's
    alpha is evaluated over its tile's pixels, the within-chunk
    transmittance is a segmented exclusive product, and colour and
    transmittance fold into per-tile accumulators.  Early exit is per pixel
    at chunk granularity: a pixel whose transmittance is <= eps at a chunk's
    start takes no contribution from it.
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

    color = torch.zeros((num_tiles, tp, 3), dtype=torch.float32, device=device)
    trans = torch.ones((num_tiles, tp), dtype=torch.float32, device=device)
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
        # a tile's run inside a chunk is one segment: fold its product at
        # the segment's last pair
        ends = torch.cat([~same, same.new_ones(1)])
        trans[tiles[ends]] *= (t_local * q)[ends]
    return color, 1.0 - trans
