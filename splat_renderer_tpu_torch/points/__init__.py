from .curvature import curvature_probe
from .projection import project_step, project_to_surface
from .properties import (
    COV3D_PLANES,
    Splats,
    default_splats,
    derive_splats,
    gaussian_splats,
    splats_from_aos,
)
from .seeding import point_count, seed_points, seed_scene_points

__all__ = [
    "COV3D_PLANES",
    "Splats",
    "curvature_probe",
    "default_splats",
    "derive_splats",
    "gaussian_splats",
    "point_count",
    "project_step",
    "project_to_surface",
    "seed_points",
    "seed_scene_points",
    "splats_from_aos",
]
