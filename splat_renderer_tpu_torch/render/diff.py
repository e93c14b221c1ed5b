"""Differentiable rendering: gradients from pixels back to the splat fields.

Counterpart of `splat_renderer_tpu/render/diff.py`.  The differentiable
render works on the CONTINUOUS screen record (`projector.shade_planes`):
the exact pipeline's projection, lighting, ellipse and blend math without
the fixed-point grid snap, whose rounding has no gradient.  Discrete
structure (the depth order, tile assignment, the support cutoff) comes from
the forward values; gradients flow through the continuous factors.

Three methods:
- "oracle": every splat against every pixel (render/oracle.py), the dense
  reference gradient for small fits;
- "tiles": canonical sort, `bin_splats`, and the plain tile compositor
  (`compositor.render_tiles`), differentiated by autograd;
- "kernel": the training path, `ops/tile_blend_diff.blend_planes`: the
  CUDA forward and backward kernels on CUDA tensors (their plain twin on
  CPU tensors).  Gaussian profiles only: the opaque hard-coverage profile
  has zero gradient almost everywhere.

Every clip here is jnp's (`_torch_util.clip`), whose gradient splits in
half at a bound: `base_opacity` is 1.0, so a modeled splat's opacity sits
exactly on the bound of its clip to [0, 1].
"""

from __future__ import annotations

from typing import Dict

import torch

from .._torch_util import clip, maximum
from ..camera import CameraArrays
from ..config import RenderConfig
from ..points.properties import Splats
from ..utils.profiling import span
from .binning import bin_splats, canonical_sort_data
from .compositor import render_tiles, tiles_to_image, tiles_to_plane
from .oracle import render_oracle
from .projector import shade_planes

METHODS = ("oracle", "tiles", "kernel")


def _clip01(v: torch.Tensor) -> torch.Tensor:
    return clip(v, 0.0, 1.0)


def splat_screen_records_diff(
    splats: Splats,
    view_proj: torch.Tensor,  # (4, 4)
    cam_pos: torch.Tensor,  # (3,)
    cfg: RenderConfig,
) -> torch.Tensor:
    """The (N, 10) render record [cx, cy, radius, opacity, r, g, b, depth,
    angle, ratio] from continuous values: opacity and colour clipped to
    [0, 1], no grid snap."""
    c = shade_planes(splats, view_proj, cam_pos, cfg)
    return torch.stack(
        [
            c["cx"], c["cy"], c["radius"], _clip01(c["opacity"]),
            _clip01(c["r"]), _clip01(c["g"]), _clip01(c["b"]),
            c["depth"], c["angle"], c["ratio"],
        ],
        dim=-1,
    )


def _kernel_tiles(splats: Splats, camera: CameraArrays, cfg: RenderConfig, caller: str):
    if cfg.opaque:
        raise ValueError(
            f"{caller}(method='kernel'): the opaque hard-coverage profile has "
            "zero gradient almost everywhere; use a Gaussian profile "
            "(isotropic or oriented)"
        )
    from ..ops.tile_blend_diff import blend_planes

    c = shade_planes(splats, camera["view_proj"], camera["cam_pos"], cfg)
    return blend_planes(
        cfg, c["cx"], c["cy"], c["radius"], _clip01(c["opacity"]),
        _clip01(c["r"]), _clip01(c["g"]), _clip01(c["b"]),
        c["angle"], c["ratio"], c["depth"],
    )


def _tiles_records(splats: Splats, camera: CameraArrays, cfg: RenderConfig):
    records = splat_screen_records_diff(splats, camera["view_proj"], camera["cam_pos"], cfg)
    data = canonical_sort_data(records)
    # binning reads forward values only: tile ids and runs are structure
    return data, bin_splats(data.detach(), cfg)


@span("fit/render")
def render_diff(
    splats: Splats,
    camera: CameraArrays,
    cfg: RenderConfig,
    method: str = "oracle",
) -> torch.Tensor:
    """Differentiable splat render -> (H, W, 3) image.

    Under autograd, gradients reach splats' px/py/pz/radius/cr/cg/cb/
    opacity/nx/ny/nz (normals through the lighting and, for oriented
    profiles, the ellipse)."""
    if method == "kernel":
        tile_color, tile_alpha, _ = _kernel_tiles(splats, camera, cfg, "render_diff")
        return tiles_to_image(tile_color, tile_alpha, cfg)
    if method == "oracle":
        records = splat_screen_records_diff(
            splats, camera["view_proj"], camera["cam_pos"], cfg)
        return render_oracle(records, cfg)
    if method == "tiles":
        data, binned = _tiles_records(splats, camera, cfg)
        return render_tiles(data, binned, cfg)
    raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")


@span("fit/render")
def render_diff_gbuffer(
    splats: Splats,
    camera: CameraArrays,
    cfg: RenderConfig,
    alpha_eps: float = 1e-6,
    method: str = "tiles",
) -> Dict[str, torch.Tensor]:
    """Differentiable G-buffer {"rgb" (H, W, 3), "depth" (H, W), "alpha"
    (H, W)}: depth is the expected depth, the alpha-weighted depth sum
    normalised by alpha (0 where alpha <= alpha_eps).

    method "kernel" accumulates the depth sum in the kernels as a fourth
    premultiplied channel, forward and backward (Gaussian profiles only);
    "tiles" runs the plain compositor with return_aux (any profile)."""
    if method == "kernel":
        tile_color, tile_alpha, tile_depth = _kernel_tiles(
            splats, camera, cfg, "render_diff_gbuffer")
        img = tiles_to_image(tile_color, tile_alpha, cfg)
        alpha = tiles_to_plane(tile_alpha, cfg)
        depth_acc = tiles_to_plane(tile_depth, cfg)
    elif method == "tiles":
        data, binned = _tiles_records(splats, camera, cfg)
        img, depth_acc, alpha = render_tiles(data, binned, cfg, return_aux=True)
    else:
        raise ValueError(f"unknown method {method!r}; expected 'kernel' or 'tiles'")
    depth = torch.where(
        alpha > alpha_eps, depth_acc / maximum(alpha, alpha_eps), 0.0
    )
    return {"rgb": img, "depth": depth, "alpha": alpha}
