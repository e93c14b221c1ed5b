"""Curvature probe: per-point surface normal + curvature-adaptive scale.

Counterpart of `splat_renderer_tpu/points/curvature.py`: the SDF normal is
sampled at six axial offsets around each settled point, the mean angular
variation is mapped to a splat scale (flat -> 1.0, edge -> min scale).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import PointConfig
from ..sdf.scene import Params, SDFScene

_EPS = 1e-8


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=_EPS)


def _smoothstep(e0: float, e1: float, x: torch.Tensor) -> torch.Tensor:
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def curvature_probe(
    scene: SDFScene,
    params: Params,
    pts: torch.Tensor,
    cfg: PointConfig = PointConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (normals (N, 3), scales (N,)): 7 scene-SDF evaluations per
    point (centre + 6 taps) as one (7, N, 3) batch."""
    r = cfg.probe_radius
    offsets = torch.tensor(
        [
            [0.0, 0.0, 0.0],
            [r, 0.0, 0.0],
            [-r, 0.0, 0.0],
            [0.0, r, 0.0],
            [0.0, -r, 0.0],
            [0.0, 0.0, r],
            [0.0, 0.0, -r],
        ],
        dtype=pts.dtype,
        device=pts.device,
    )  # (7, 3)
    probe = pts[None, :, :] + offsets[:, None, :]  # (7, N, 3)
    _, grads = scene.sdf(probe, params)  # (7, N, 3)
    normals = _normalize(grads)
    center_n = normals[0]  # (N, 3)
    # angular difference = 1 - dot
    variation = 1.0 - torch.sum(normals[1:] * center_n[None], dim=-1)  # (6, N)
    avg_variation = torch.mean(variation, dim=0)
    # flat -> 1, edgy -> 0
    flatness = 1.0 - _smoothstep(0.0, cfg.curvature_range, avg_variation)
    scale = cfg.curvature_min_scale + (1.0 - cfg.curvature_min_scale) * flatness
    return center_n, scale
