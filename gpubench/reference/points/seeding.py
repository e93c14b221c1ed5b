"""Surface-point seeding on the scene's bounding box.

Counterpart of `splat_renderer_tpu/points/seeding.py`.  Draws come from an
explicit `torch.Generator` on the device where the points are made; they
cannot reproduce `jax.random`'s bits, so parity with the JAX package is
statistical (tests/test_torch_points.py).
"""

from __future__ import annotations

import torch

from ..config import PointConfig
from ..sdf.scene import Params, SDFScene


def point_count(scene: SDFScene, cfg: PointConfig = PointConfig()) -> int:
    """Point budget: points_per_primitive x sqrt(surface area) per
    primitive, clamped to [min_points, max_points].  Uses the primitives'
    current parameter values."""
    prims = scene.primitives()
    if not prims:
        return 50_000
    total = sum(
        int(cfg.points_per_primitive * (p.surface_area() ** 0.5)) for p in prims
    )
    return max(cfg.min_points, min(total, cfg.max_points))


def seed_points(
    generator: torch.Generator,
    aabb_lo: torch.Tensor,
    aabb_hi: torch.Tensor,
    n: int,
) -> torch.Tensor:
    """Sample n points on the AABB surface, the face chosen in proportion
    to its area.  Returns (n, 3) float32 on the generator's device."""
    d = aabb_hi - aabb_lo  # (3,)
    dx, dy, dz = d[0], d[1], d[2]
    # face order: -X +X -Y +Y -Z +Z
    face_areas = torch.stack([dy * dz, dy * dz, dx * dz, dx * dz, dx * dy, dx * dy])
    # area-proportional face choice by CDF inversion
    cdf = torch.cumsum(face_areas, 0) / torch.sum(face_areas)  # (6,)
    device = generator.device
    uf = torch.rand(n, generator=generator, device=device)
    face = torch.zeros(n, dtype=torch.int64, device=device)
    for kf in range(5):
        face = face + (uf > cdf[kf]).to(torch.int64)
    uv = torch.rand((n, 2), generator=generator, device=device)  # in-face coords

    u, v = uv[:, 0], uv[:, 1]
    axis = face >> 1  # 0: x-faces, 1: y-faces, 2: z-faces
    hi = (face & 1).to(torch.float32)
    unit_x = torch.where(axis == 0, hi, u)
    unit_y = torch.where(axis == 1, hi, torch.where(axis == 0, u, v))
    unit_z = torch.where(axis == 2, hi, v)
    unit = torch.stack([unit_x, unit_y, unit_z], dim=-1)  # (n, 3)
    return aabb_lo + unit * d


def seed_scene_points(
    generator: torch.Generator,
    scene: SDFScene,
    params: Params,
    n: int,
    cfg: PointConfig = PointConfig(),
) -> torch.Tensor:
    """Seed on the scene's global AABB grown by cfg.aabb_scale."""
    lo, hi = scene.seeding_aabb(params, generator.device, cfg.aabb_scale)
    return seed_points(generator, lo, hi, n)
