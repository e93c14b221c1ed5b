"""End-to-end frame functions: scene -> points -> splats -> image.

Counterpart of `splat_renderer_tpu/render/pipeline.py`.  PyTorch runs
eagerly, so there is no compiled frame program to cache: `Engine` keys its
per-structure state (the point budget and the rebuild notice) on the
scene's structure hash, and parameter animation is a fresh
`scene.params(device)` per frame.

Every entry point takes an explicit `device` and checks that the tensors it
is given live there; nothing picks a device by default.
"""

from __future__ import annotations

import logging
import math
from collections import OrderedDict
from typing import Optional

import torch

from .._torch_util import check_device
from ..camera import CameraArrays
from ..config import PointConfig, RenderConfig
from ..points import (
    curvature_probe,
    derive_splats,
    point_count,
    project_to_surface,
    seed_scene_points,
)
from ..points.properties import Splats
from ..sdf.primitives import Box, Sphere
from ..sdf.scene import Params, SDFScene, smooth_union
from .binning import bin_packed_words
from .compositor import tiles_to_image
from .oracle import render_oracle
from .projector import splat_screen_records, splat_screen_words

logger = logging.getLogger("splat_renderer_tpu_torch")


def surface_splats(
    scene: SDFScene,
    params: Params,
    pts: torch.Tensor,
    pcfg: PointConfig,
    rcfg: RenderConfig,
) -> Splats:
    """Seed points -> k-step projection -> curvature -> splats."""
    pts = project_to_surface(scene, params, pts, pcfg.descent_steps)
    normals, scales = curvature_probe(scene, params, pts, pcfg)
    return derive_splats(pts, normals, scales, rcfg)


def model_points(
    scene: SDFScene,
    params: Params,
    generator: torch.Generator,
    n: int,
    pcfg: PointConfig,
    rcfg: RenderConfig,
    *,
    device,
) -> Splats:
    """The modeler stage: seed n points on `device` from `generator`, then
    `surface_splats`."""
    for prim_id, p in params.items():
        check_device(device, **{f"params[{prim_id!r}][{k!r}]": v for k, v in p.items()})
    if generator.device.type != torch.device(device).type:
        raise ValueError(f"generator is on {generator.device}, expected {device}")
    pts = seed_scene_points(generator, scene, params, n, pcfg)
    return surface_splats(scene, params, pts, pcfg, rcfg)


def render_splats(
    splats: Splats,
    camera: CameraArrays,
    rcfg: RenderConfig,
    compositor: str = "auto",
    blend_eps: Optional[float] = None,
    *,
    device,
) -> torch.Tensor:
    """Splat chain: project -> bin -> composite -> (H, W, 3) image.

    compositor:
      - "auto": the packed-word path; its tile blend is the CUDA kernel for
        CUDA tensors and the plain twin for CPU tensors
      - "oracle": the exact sequential compositor (fidelity ground truth)
    blend_eps: transmittance floor of the blend's early exit (None =
    rcfg.transmittance_eps; 0 turns it off, for exact comparisons).
    """
    check_device(device, view_proj=camera["view_proj"], cam_pos=camera["cam_pos"],
                 **{f"splats[{k!r}]": v for k, v in splats.items()})
    vp, cp = camera["view_proj"], camera["cam_pos"]
    if compositor == "auto":
        from ..ops.tile_blend import blend_tiles

        words = splat_screen_words(splats, vp, cp, rcfg)
        binned = bin_packed_words(
            words["dk"], words["w_pos"], words["w_ro"], words["w_rgb"], rcfg
        )
        tile_color, tile_alpha = blend_tiles(binned, rcfg, blend_eps)
        return tiles_to_image(tile_color, tile_alpha, rcfg)
    if compositor == "oracle":
        return render_oracle(splat_screen_records(splats, vp, cp, rcfg), rcfg)
    raise ValueError(f"unknown compositor {compositor!r}; expected 'auto' or 'oracle'")


def render_frame(
    scene: SDFScene,
    params: Params,
    camera: CameraArrays,
    generator: torch.Generator,
    n: int,
    pcfg: PointConfig,
    rcfg: RenderConfig,
    *,
    device,
) -> torch.Tensor:
    """Full frame: modeler + splat chain (the kernel path, default eps)."""
    splats = model_points(scene, params, generator, n, pcfg, rcfg, device=device)
    return render_splats(splats, camera, rcfg, device=device)


class Engine:
    """Frame renderer with per-structure state keyed on the scene's
    structure hash.

    Usage:
        eng = Engine(scene, pcfg, rcfg, device="cuda")
        img = eng.frame(camera_tensors(cam.arrays(), "cuda"), generator)
        scene["sphere1"].position[0] = 0.3   # animate freely
        img = eng.frame(...)                 # same structure: same state
        scene.set_root(new_tree)             # structure change
        img = eng.frame(...)                 # new per-structure state

    The state is the point budget: fixed per structure when the structure
    is first seen (as the JAX Engine fixes it in its compiled program), so
    animating a primitive's size does not change n.  At most CACHE_SIZE
    structures keep state; the oldest is evicted first.
    """

    CACHE_SIZE = 8

    def __init__(
        self,
        scene: SDFScene,
        pcfg: PointConfig = PointConfig(),
        rcfg: RenderConfig = RenderConfig(),
        n: Optional[int] = None,
        *,
        device,
    ):
        self.scene = scene
        self.pcfg = pcfg
        self.rcfg = rcfg
        self.device = torch.device(device)
        self._n = n
        self._n_by_structure: "OrderedDict[str, int]" = OrderedDict()

    @property
    def n(self) -> int:
        """Points per frame for the current structure."""
        h = self.scene.structure_hash()
        n = self._n_by_structure.get(h)
        if n is None:
            logger.info("new frame state for scene structure %s", h)
            n = self._n if self._n is not None else point_count(self.scene, self.pcfg)
            while len(self._n_by_structure) >= self.CACHE_SIZE:
                self._n_by_structure.popitem(last=False)
            self._n_by_structure[h] = n
        return n

    def frame(self, camera: CameraArrays, generator: torch.Generator) -> torch.Tensor:
        """Render one (H, W, 3) frame at the scene's current parameters."""
        return render_frame(
            self.scene, self.scene.params(self.device), camera, generator, self.n,
            self.pcfg, self.rcfg, device=self.device,
        )


def demo_scene() -> SDFScene:
    """The demo scene of demo.py and bench.py: a sphere smooth-unioned with
    a box and a second sphere."""
    s1 = Sphere(id="sphere1", position=(0, 0, 0), radius=0.5)
    b1 = Box(id="box1", position=(0.6, 0, 0), size=(0.3, 0.3, 0.3))
    s2 = Sphere(id="sphere2", position=(0, 0.6, 0), radius=0.25)
    return SDFScene(smooth_union(0.1, smooth_union(0.15, s1, b1), s2))


def animate_demo(scene: SDFScene, t: float) -> None:
    """The demo's parameter animation at time t (demo.py `animate`)."""
    s1, s2 = scene["sphere1"], scene["sphere2"]
    s1.position[0] = math.sin(t) * 0.3
    s1.position[1] = math.cos(t * 0.7) * 0.2
    s2.radius = 0.25 + 0.1 * math.sin(t * 2)
