"""Multi-view rendering: one splat set from V cameras, the datagen front end.

Counterpart of `splat_renderer_tpu/render/multiview.py`.  The JAX package
maps the views with `lax.map` inside one compiled program; PyTorch runs
eagerly, so the views are a Python loop whose outputs are stacked on the
device.  A view saturates the card on its own, so nothing is lost by
rendering them in turn.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..camera import CameraArrays
from ..config import RenderConfig
from ..points.properties import Splats
from .pipeline import render_gbuffer, render_splats
from .sh import apply_sh


def view_count(cameras: CameraArrays) -> int:
    """V of a camera dict whose tensors carry a leading view axis."""
    return int(cameras["view_proj"].shape[0])


def camera_at(cameras: CameraArrays, v: int) -> CameraArrays:
    """View v of a stacked camera dict."""
    return {k: t[v] for k, t in cameras.items()}


def quantize_u8(img: torch.Tensor) -> torch.Tensor:
    """float [0, 1] -> uint8 on the device: round(clip(x, 0, 1) * 255), the
    JAX package's `as_uint8` rule (round half to even)."""
    return torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)


def render_views(
    splats: Splats,
    cameras: CameraArrays,  # tensors with a leading view axis V
    rcfg: RenderConfig,
    compositor: str = "auto",
    flat: bool = False,
    as_uint8: bool = False,
    sh=None,
    *,
    device,
) -> torch.Tensor:
    """Render one splat set from V cameras; returns (V, H, W, 3), or
    (V, H, W*3) with `flat=True`: flat interleaved raster rows, the layout
    the viewer ships and `utils.image.unflatten_rows` undoes on the host.
    as_uint8 quantizes on the device (datagen: a quarter of the host
    transfer and no host-side conversion).  `sh` (render/sh.py) lights each
    view along its own camera ray: view-dependent colour is per view by
    definition."""
    out = []
    for v in range(view_count(cameras)):
        camera = camera_at(cameras, v)
        s = apply_sh(splats, sh, camera["cam_pos"]) if sh is not None else splats
        img = render_splats(s, camera, rcfg, compositor, device=device)
        if as_uint8:
            img = quantize_u8(img)
        if flat:
            img = img.reshape(rcfg.height, rcfg.width * 3)
        out.append(img)
    return torch.stack(out)


def render_views_gbuffer(
    splats: Splats,
    cameras: CameraArrays,  # tensors with a leading view axis V
    rcfg: RenderConfig,
    sh=None,
    method: str = "auto",
    *,
    device,
) -> Dict[str, torch.Tensor]:
    """Multi-view G-buffer: {"rgb" (V, H, W, 3), "depth" (V, H, W),
    "alpha" (V, H, W)}: `render_views`' twin over `render_gbuffer`.  Depth
    is the alpha-normalized expected splat camera distance (0 where nothing
    was hit), alpha the composited coverage; both under the same over-blend
    weights as the colour, so the three channels are consistent per pixel.
    `sh` lights each view along its own camera ray, as in `render_views`;
    `method` goes to `render_gbuffer`."""
    views = []
    for v in range(view_count(cameras)):
        camera = camera_at(cameras, v)
        s = apply_sh(splats, sh, camera["cam_pos"]) if sh is not None else splats
        views.append(render_gbuffer(s, camera, rcfg, method, device=device))
    return {k: torch.stack([g[k] for g in views]) for k in ("rgb", "depth", "alpha")}
