"""Splat property derivation: positions + curvature -> renderable splats.

Counterpart of `splat_renderer_tpu/points/properties.py`.  A `Splats` set is
a plain dict of (N,) float32 planes, one per scalar field:

    {"px","py","pz","radius","cr","cg","cb","opacity","nx","ny","nz"}

The radius is `base_radius * curvature scale`, so curvature shrinks splats
near edges.

A 3D Gaussian with a full covariance (Kerbl et al. 2023) carries seven
more planes, `COV3D_PLANES`: its three scales (standard deviations, world
units) and its rotation quaternion (w first, any length).  Its covariance
is R(q) diag(s)^2 R(q)^T; `RenderConfig(oriented=True, ellipse="cov3d")`
projects it (render/projector.py).  `gaussian_splats` builds such a set.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .._torch_util import maximum, sqrt_rn
from ..config import RenderConfig

Splats = Dict[str, torch.Tensor]

# a covariance splat's planes beside the eleven: scales, then the quaternion
COV3D_PLANES = ("sx", "sy", "sz", "qw", "qx", "qy", "qz")


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


def quat_rotation(qw: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor,
                  qz: torch.Tensor) -> List[List[torch.Tensor]]:
    """R(q) of the normalised quaternion as nine (N,) planes, R[i][j] the
    world component i of local axis j (3DGS's `build_rotation`); a
    quaternion of length under 1e-8 is divided by 1e-8."""
    qn = maximum(sqrt_rn(qw * qw + qx * qx + qy * qy + qz * qz), 1e-8)
    w, x, y, z = qw / qn, qx / qn, qy / qn, qz / qn
    return [
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y)],
        [2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x)],
        [2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y)],
    ]


def gaussian_splats(
    positions: torch.Tensor,  # (N, 3)
    scales: torch.Tensor,  # (N, 3) standard deviations, world units
    rotations: torch.Tensor,  # (N, 4) quaternions, w first, any length
    color: torch.Tensor,  # (N, 3)
    opacity: torch.Tensor,  # (N,)
) -> Splats:
    """Full-covariance 3D Gaussians as a plane dict: the eleven planes and
    `COV3D_PLANES`.  The radius plane is 2 max(s), the support radius in
    the system's convention (sigma = 0.5: the Gaussian's largest standard
    deviation), which the projector's culling and its 6-offset validity
    read; the normal is the axis of the smallest scale, which lighting
    reads.  Render with `RenderConfig(oriented=True, ellipse="cov3d")`."""
    q = [rotations[:, k].contiguous() for k in range(4)]
    s = [scales[:, k].contiguous() for k in range(3)]
    rot = quat_rotation(*q)
    flat = torch.argmin(scales, dim=1)
    normal = [torch.stack(rot[i], 1).gather(1, flat[:, None])[:, 0] for i in range(3)]
    return {
        "px": positions[:, 0].contiguous(),
        "py": positions[:, 1].contiguous(),
        "pz": positions[:, 2].contiguous(),
        "radius": 2.0 * torch.amax(scales, dim=1),
        "cr": color[:, 0].contiguous(),
        "cg": color[:, 1].contiguous(),
        "cb": color[:, 2].contiguous(),
        "opacity": opacity,
        "nx": normal[0], "ny": normal[1], "nz": normal[2],
        **dict(zip(COV3D_PLANES, s + q)),
    }
