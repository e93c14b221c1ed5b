"""Per-tile pixel blocks -> image planes.

Counterpart of `splat_renderer_tpu/render/compositor.py::tiles_to_image` and
`tiles_to_plane`.  The plain tile compositor of the JAX module
(`render_tiles`) lives on here as the CUDA kernel's plain twin,
`ops/tile_blend.py::blend_tiles_plain`.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from .blend import composite_over_background


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
