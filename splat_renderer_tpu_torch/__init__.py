"""splat_renderer_tpu_torch: the splat engine in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

The port of `splat_renderer_tpu` (JAX/Pallas), which stays in the repository
as its reference; module names match the JAX package's so each counterpart
is easy to find.  This package imports torch and never jax.

- `sdf`:    CSG scene graph of SDF primitives with analytic gradients, and
            mesh export (`extract_mesh`, `save_obj`).
- `points`: surface-point seeding, projection onto the surface, curvature
            probe, splat property derivation.
- `render`: projection to packed record words, canonical-order tile
            binning, the exact sequential oracle, the frame pipeline
            (`render_frame`, `Engine`, `SplatEngine` for static scenes), the
            G-buffer, multi-view and sequence rendering, the differentiable
            render (`render_diff`, `render_diff_gbuffer`) and SH appearance.
- `ops`:    the CUDA kernels (csrc/tile_blend.cu, the exact tile blend per
            tile and with cross-tile prefetch, with and without depth;
            csrc/tile_blend_diff.cu, the differentiable blend's forward
            and backward; csrc/probe_rate.cu, the arithmetic-rate probe;
            csrc/project_words.cu, the projector in one launch), their
            wrappers and plain PyTorch twins.
- `parallel`: multi-device rendering over torch.distributed (one process
            a GPU): tile bands x view-DP (`multichip_frame_fn`), depth
            bands with an all_to_all (`band_frame_fn`), view-DP records.
- `fit`:    inverse rendering: `fit_splats` (Adam), `density_control`,
            `fit_camera`, and `fit_splats_dp` (views over the ranks).
- `data`:   datasets on disk -> cameras and targets for fitting.
- `viewer`: the HTTP viewer and the offline turntable.
- `utils`:  SSIM and the training losses; splat and checkpoint files; 3DGS
            `.ply` files; PNG files; logging and profiling.
- `apps`:   the command-line front ends (`python -m
            splat_renderer_tpu_torch.apps.demo|fit_demo|datagen`).
- `convert`: state carried across from the JAX package as numpy.
"""

from . import sdf
from .camera import (Camera, OrbitCameraController, camera_tensors,
                     orbit_camera_arrays, orbit_ring)
from .config import (PointConfig, RenderConfig, surface_render_config,
                     turbo_render_config)
from .data import (backproject_gbuffer, load_dataset, load_transforms,
                   stack_views)
from .render.multiview import render_views, render_views_gbuffer
from .render.pipeline import (
    Engine,
    SplatEngine,
    model_points,
    render_frame,
    render_gbuffer,
    render_splats,
)
from .render.sequence import render_sequence
from .sdf import (
    Box,
    Capsule,
    Cylinder,
    Ellipsoid,
    RoundBox,
    SDFScene,
    Sphere,
    Torus,
    intersection,
    smooth_intersection,
    smooth_subtraction,
    smooth_union,
    subtraction,
    union,
)

__all__ = [
    "Box",
    "Camera",
    "Capsule",
    "Cylinder",
    "Ellipsoid",
    "Engine",
    "OrbitCameraController",
    "PointConfig",
    "RenderConfig",
    "RoundBox",
    "SDFScene",
    "Sphere",
    "SplatEngine",
    "Torus",
    "backproject_gbuffer",
    "camera_tensors",
    "intersection",
    "load_dataset",
    "load_transforms",
    "model_points",
    "orbit_camera_arrays",
    "orbit_ring",
    "render_frame",
    "render_gbuffer",
    "render_sequence",
    "render_splats",
    "render_views",
    "render_views_gbuffer",
    "sdf",
    "smooth_intersection",
    "smooth_subtraction",
    "smooth_union",
    "stack_views",
    "subtraction",
    "surface_render_config",
    "turbo_render_config",
    "union",
]
