"""Newton-style projection of seed points onto the implicit surface.

Counterpart of `splat_renderer_tpu/points/projection.py`; the `lax.scan`
becomes a Python loop of `steps` iterations.
"""

from __future__ import annotations

import torch

from ..sdf.scene import Params, SDFScene

_EPS = 1e-4


def project_step(scene: SDFScene, params: Params, pts: torch.Tensor) -> torch.Tensor:
    """One projection step: p <- p - normalize(grad) * dist.  Points with
    degenerate gradients stay put."""
    dist, grad = scene.sdf(pts, params)
    glen = torch.linalg.vector_norm(grad, dim=-1)
    step = grad / torch.clamp(glen, min=_EPS)[..., None] * dist[..., None]
    return torch.where((glen > _EPS)[..., None], pts - step, pts)


def project_to_surface(
    scene: SDFScene, params: Params, pts: torch.Tensor, steps: int = 5
) -> torch.Tensor:
    """Run `steps` projection iterations."""
    for _ in range(steps):
        pts = project_step(scene, params, pts)
    return pts
