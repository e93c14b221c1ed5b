"""Per-tile compositing of float records, and tile blocks -> image planes.

Counterpart of `splat_renderer_tpu/render/compositor.py`.  `render_tiles` is
the plain, differentiable tile compositor over (N, 10) float records: the
differentiable render's "tiles" method.  The
exact pipeline's quantized-word compositor is the CUDA kernel
csrc/tile_blend.cu, whose plain twin is `ops/tile_blend.py::
blend_tiles_plain`.

`render_tiles` and the diff kernels' twin (`ops/tile_blend_diff.py::
blend_binned_plain`) walk the pair stream alike but stay two references.
`render_tiles` is the JAX package's "tiles" method: every profile (the
opaque and quad coverage too), over `bin_splats` and `blend.
splat_alpha_planes`, the carry in log space.  It shares neither binner nor
alpha code with the kernels, so the gradient tests that lean on it would
catch a fault in `bin_planes_diff` or in the kernels' alpha.  The twin runs
the kernels' own op sequence on their own stream, so it isolates the
kernels.
"""

from __future__ import annotations

import torch

from .._torch_util import minimum
from ..config import RenderConfig
from ..utils.profiling import span
from .binning import Binned
from .blend import (
    composite_over_background,
    segmented_exclusive_product,
    splat_alpha_planes,
)


@span("image")
def tiles_to_image(
    tile_color: torch.Tensor,  # (num_tiles, tile_pixels, 3)
    tile_alpha: torch.Tensor,  # (num_tiles, tile_pixels)
    cfg: RenderConfig,
) -> torch.Tensor:
    """Assemble per-tile pixel blocks into the (H, W, 3) image (cropping the
    partial tiles at the right/bottom edges) over the background."""
    tw, th = cfg.tile_w, cfg.tile_h
    img = composite_over_background(tile_color, tile_alpha, cfg)
    img = img.reshape(cfg.tiles_y, cfg.tiles_x, th, tw, 3)
    img = img.permute(0, 2, 1, 3, 4).reshape(cfg.tiles_y * th, cfg.tiles_x * tw, 3)
    return img[: cfg.height, : cfg.width]


def tiles_to_plane(tile_vals: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """Assemble per-tile (T, tile_pixels) scalar planes into (H, W)."""
    tw, th = cfg.tile_w, cfg.tile_h
    img = tile_vals.reshape(cfg.tiles_y, cfg.tiles_x, th, tw)
    img = img.permute(0, 2, 1, 3).reshape(cfg.tiles_y * th, cfg.tiles_x * tw)
    return img[: cfg.height, : cfg.width]


_PAIR_CHUNK = 1024  # pairs per step of the walk over the pair stream


def render_tiles(
    splat_data_sorted: torch.Tensor,  # (N, 10) records in canonical order
    binned: Binned,  # binning.bin_splats of the same records
    cfg: RenderConfig,
    return_aux: bool = False,
):
    """Composite the binned records, differentiably; returns the (H, W, 3)
    image.  The JAX package's `render_tiles(differentiable=True)`.

    The tile-sorted pair stream is walked in chunks of pairs.  Per chunk,
    every pair's alpha is evaluated over its tile's pixels and clamped at
    1 - 1e-7, the within-chunk transmittance is a segmented exclusive
    product, colour folds into the per-tile accumulator with `index_add`,
    and the transmittance carry is kept in log space so that its fold is a
    sum too, as the JAX package does.

    return_aux=True also accumulates the alpha-weighted depth sum under the
    colour's blend weights and returns (image, depth_acc (H, W),
    alpha (H, W)), the G-buffer channels (depth_acc is premultiplied).
    """
    num_tiles, tp, tw = cfg.num_tiles, cfg.tile_pixels, cfg.tile_w
    device = splat_data_sorted.device
    n_pairs = int(binned["offsets"][-1])
    lane = torch.arange(tp, device=device)
    lx = (lane % tw).to(torch.float32) + 0.5
    ly = (lane // tw).to(torch.float32) + 0.5

    f32 = dict(dtype=torch.float32, device=device)
    color = torch.zeros((num_tiles, tp, 3), **f32)
    log_trans = torch.zeros((num_tiles, tp), **f32)
    depth = torch.zeros((num_tiles, tp), **f32)
    for lo in range(0, n_pairs, _PAIR_CHUNK):
        hi = min(lo + _PAIR_CHUNK, n_pairs)
        tiles = binned["pair_tile"][lo:hi]
        # index_select: a serial backward (see ops/tile_blend_diff.py)
        data = splat_data_sorted.index_select(0, binned["pair_splat"][lo:hi])  # (c, 10)
        pxc = ((tiles % cfg.tiles_x).to(torch.float32) * tw)[:, None] + lx[None, :]
        pyc = ((tiles // cfg.tiles_x).to(torch.float32) * cfg.tile_h)[:, None] + ly[None, :]
        a = splat_alpha_planes(
            data[:, 0:1], data[:, 1:2], data[:, 2:3], data[:, 3:4],
            data[:, 8:9], data[:, 9:10], pxc, pyc, cfg,
        )  # (c, tp)
        a = minimum(a, 1.0 - 1e-7)  # keeps log1p finite
        same = tiles[1:] == tiles[:-1]
        starts = torch.cat([same.new_ones(1), ~same])
        t_local = segmented_exclusive_product(1.0 - a, starts)
        weight = a * t_local * torch.exp(log_trans).index_select(0, tiles)
        color = color.index_add(0, tiles, weight[:, :, None] * data[:, None, 4:7])
        if return_aux:
            depth = depth.index_add(0, tiles, weight * data[:, 7:8])
        log_trans = log_trans.index_add(0, tiles, torch.log1p(-a))
    alpha = 1.0 - torch.exp(log_trans)
    img = tiles_to_image(color, alpha, cfg)
    if return_aux:
        return img, tiles_to_plane(depth, cfg), tiles_to_plane(alpha, cfg)
    return img
