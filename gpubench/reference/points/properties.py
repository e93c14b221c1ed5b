"""Splat property derivation: positions + curvature -> renderable splats.

Counterpart of `splat_renderer_tpu/points/properties.py`.  A `Splats` set is
a plain dict of (N,) float32 planes, one per scalar field:

    {"px","py","pz","radius","cr","cg","cb","opacity","nx","ny","nz"}

The radius is `base_radius * curvature scale`, so curvature shrinks splats
near edges.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import RenderConfig

Splats = Dict[str, torch.Tensor]


def derive_splats(
    positions: torch.Tensor,  # (N, 3)
    normals: torch.Tensor,  # (N, 3)
    scales: torch.Tensor,  # (N,)
    cfg: RenderConfig = RenderConfig(),
) -> Splats:
    """Build the splat planes: colour from the normal (cfg.color_mode),
    opacity cfg.base_opacity, radius cfg.base_radius * scale."""
    radius = cfg.base_radius * scales
    nx, ny, nz = normals[:, 0], normals[:, 1], normals[:, 2]
    if cfg.color_mode == "normal_signed":
        color = (nx * 0.5 + 0.5, ny * 0.5 + 0.5, nz * 0.5 + 0.5)
    else:
        color = (torch.abs(nx) * 0.8 + 0.2, torch.abs(ny) * 0.8 + 0.2,
                 torch.abs(nz) * 0.8 + 0.2)
    opacity = torch.full_like(radius, cfg.base_opacity)
    return {
        "px": positions[:, 0],
        "py": positions[:, 1],
        "pz": positions[:, 2],
        "radius": radius,
        "cr": color[0],
        "cg": color[1],
        "cb": color[2],
        "opacity": opacity,
        "nx": nx,
        "ny": ny,
        "nz": nz,
    }


def splats_from_aos(
    positions: torch.Tensor,  # (N, 3)
    radius: torch.Tensor,  # (N,)
    color: torch.Tensor,  # (N, 3)
    opacity: torch.Tensor,  # (N,)
    normals: torch.Tensor,  # (N, 3)
) -> Splats:
    """Assemble a plane Splats dict from array-of-structs fields."""
    return {
        "px": positions[:, 0], "py": positions[:, 1], "pz": positions[:, 2],
        "radius": radius,
        "cr": color[:, 0], "cg": color[:, 1], "cb": color[:, 2],
        "opacity": opacity,
        "nx": normals[:, 0], "ny": normals[:, 1], "nz": normals[:, 2],
    }


def default_splats(positions: torch.Tensor, cfg: RenderConfig = RenderConfig()) -> Splats:
    """Default properties for positions without curvature data: radius
    0.04, white, opacity 0.7, +y normals."""
    n = positions.shape[0]
    kw = dict(dtype=positions.dtype, device=positions.device)
    one = torch.ones(n, **kw)
    zero = torch.zeros(n, **kw)
    return {
        "px": positions[:, 0],
        "py": positions[:, 1],
        "pz": positions[:, 2],
        "radius": torch.full((n,), 0.04, **kw),
        "cr": one, "cg": one, "cb": one,
        "opacity": torch.full((n,), 0.7, **kw),
        "nx": zero, "ny": one, "nz": zero,
    }
