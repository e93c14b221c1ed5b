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

import math
import statistics
from collections import OrderedDict
from typing import Dict, Optional

import torch

from .._torch_util import check_device
from ..camera import CameraArrays
from ..config import PointConfig, RenderConfig
from ..ops.sdf_model import descend, probe
from ..points import (
    curvature_probe,
    derive_splats,
    point_count,
    project_to_surface,
    seed_scene_points,
)
from ..points.properties import Splats
from ..sdf.primitives import Box, Sphere
from ..sdf.program import STACK_LIMIT, Program, pack_params, program_for
from ..sdf.scene import Params, SDFScene, smooth_union
from ..utils.log import log_rebuild
from ..utils.profiling import enabled, recording, span
from .binning import bin_packed_words, bin_splats, canonical_sort_data
from .compositor import render_tiles, tiles_to_image, tiles_to_plane
from .oracle import render_oracle
from .projector import count_cov3d, splat_screen_records, splat_screen_words
from .sh import apply_sh


def modeler_program(scene: SDFScene, device) -> Optional[Program]:
    """The scene's program for the modeler's kernels (`ops/sdf_model.py`)
    on a CUDA `device`; None on the CPU, which takes the plain functions.
    Raises ValueError on a CUDA device for a tree the kernels cannot
    evaluate (`sdf/program.py`).  Reads no device value."""
    if torch.device(device).type != "cuda":
        return None
    program = program_for(scene)
    if program is None:
        raise ValueError(
            "the modeler's kernels cannot evaluate this scene: it is empty, or has a node "
            "class sdf/program.py does not name, an operation short of two children or a "
            f"tree needing a stack deeper than {STACK_LIMIT}")
    return program


def _kernel_splats(program: Program, block: torch.Tensor, pcfg: PointConfig,
                   rcfg: RenderConfig, **start) -> Splats:
    with span("model/descent"):
        out = descend(program, block, pcfg, **start)
    with span("model/curvature"):
        return probe(program, block, out, pcfg, rcfg)


def _plain_splats(scene: SDFScene, params: Params, pts: torch.Tensor, pcfg: PointConfig,
                  rcfg: RenderConfig) -> Splats:
    with span("model/descent"):
        pts = project_to_surface(scene, params, pts, pcfg.descent_steps)
    with span("model/curvature"):
        normals, scales = curvature_probe(scene, params, pts, pcfg)
    with span("model/derive"):
        return derive_splats(pts, normals, scales, rcfg)


def surface_splats(
    scene: SDFScene,
    params: Params,
    pts: torch.Tensor,
    pcfg: PointConfig,
    rcfg: RenderConfig,
) -> Splats:
    """Seed points -> k-step projection -> curvature -> splats: on CUDA two
    launches of the modeler's kernels (the spans `model/descent` and
    `model/curvature`), on the CPU the plain functions (and
    `model/derive`)."""
    program = modeler_program(scene, pts.device)
    if program is None:
        return _plain_splats(scene, params, pts, pcfg, rcfg)
    return _kernel_splats(program, pack_params(program, params), pcfg, rcfg, pts=pts)


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
    project, probe and derive the splats as `surface_splats` does.  On
    CUDA the seeding keeps the plain path's draws and the descent kernel
    maps them, so the splats are the plain path's bit for bit."""
    for prim_id, p in params.items():
        check_device(device, **{f"params[{prim_id!r}][{k!r}]": v for k, v in p.items()})
    if generator.device.type != torch.device(device).type:
        raise ValueError(f"generator is on {generator.device}, expected {device}")
    with span("model"):
        program = modeler_program(scene, device)
        if program is None:
            with span("model/seed"):
                pts = seed_scene_points(generator, scene, params, n, pcfg)
            return _plain_splats(scene, params, pts, pcfg, rcfg)
        with span("model/seed"):
            # seed_points' draws, in its order; the kernel maps them
            uf = torch.rand(n, generator=generator, device=generator.device)
            uv = torch.rand((n, 2), generator=generator, device=generator.device)
            block = pack_params(program, params)
        return _kernel_splats(program, block, pcfg, rcfg, uniforms=(uf, uv))


# blend_kernel names of the JAX package -> the port's blend schedules
_BLEND_SCHEDULES = {"tile": "tile", "flat": "tile", "tile_xp": "tile_xp"}


def _blend_schedule(blend_kernel: str) -> str:
    try:
        return _BLEND_SCHEDULES[blend_kernel]
    except KeyError:
        raise ValueError(
            f"unknown blend kernel {blend_kernel!r}; expected 'tile', 'flat' or 'tile_xp'"
        ) from None


def _check_inputs(device, splats: Splats, camera: CameraArrays) -> None:
    check_device(device, view_proj=camera["view_proj"], cam_pos=camera["cam_pos"],
                 **{f"splats[{k!r}]": v for k, v in splats.items()})


def _words_and_bins(splats: Splats, camera: CameraArrays, rcfg: RenderConfig,
                    with_depth: bool = False):
    words = splat_screen_words(splats, camera["view_proj"], camera["cam_pos"], rcfg)
    if enabled() and rcfg.oriented and rcfg.ellipse == "cov3d":
        count_cov3d(words, rcfg)
    return bin_packed_words(
        words["dk"], words["w_pos"], words["w_ro"], words["w_rgb"], rcfg,
        with_depth=with_depth,
    )


def render_splats(
    splats: Splats,
    camera: CameraArrays,
    rcfg: RenderConfig,
    compositor: str = "auto",
    blend_eps: Optional[float] = None,
    blend_kernel: str = "tile",
    *,
    device,
) -> torch.Tensor:
    """Splat chain: project -> bin -> composite -> (H, W, 3) image.

    compositor:
      - "auto": the packed-word path; its tile blend is a CUDA kernel for
        CUDA tensors and the plain twin for CPU tensors
      - "oracle": the exact sequential compositor (fidelity ground truth)
    blend_eps: transmittance floor of the blend's early exit (None =
    rcfg.transmittance_eps; 0 turns it off, for exact comparisons).
    blend_kernel: "tile" = one CTA per tile; "tile_xp" = the persistent
    kernel with cross-tile prefetch; "flat" (the JAX package's
    grid-per-window schedule) maps to the one-CTA-per-tile kernel, the
    port's only counterpart of it.  All give the same image bit for bit.
    """
    _check_inputs(device, splats, camera)
    schedule = _blend_schedule(blend_kernel)
    if compositor == "auto":
        from ..ops.tile_blend import blend_tiles

        binned = _words_and_bins(splats, camera, rcfg)
        tile_color, tile_alpha = blend_tiles(binned, rcfg, blend_eps, schedule=schedule)
        return tiles_to_image(tile_color, tile_alpha, rcfg)
    if compositor == "oracle":
        return render_oracle(
            splat_screen_records(splats, camera["view_proj"], camera["cam_pos"], rcfg), rcfg)
    raise ValueError(f"unknown compositor {compositor!r}; expected 'auto' or 'oracle'")


def _normalized_depth(depth_acc: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Premultiplied depth sum -> expected depth, 0 where nothing was hit."""
    return torch.where(alpha > 1e-6, depth_acc / torch.clamp(alpha, min=1e-6), 0.0)


def render_gbuffer(
    splats: Splats,
    camera: CameraArrays,
    rcfg: RenderConfig,
    method: str = "auto",
    eps: Optional[float] = None,
    *,
    device,
) -> Dict[str, torch.Tensor]:
    """Render the G-buffer: {"rgb" (H, W, 3), "depth" (H, W), "alpha" (H, W)}.

    The datagen channels beside colour: `alpha` is the composited coverage
    1 - transmittance, `depth` the alpha-normalized expected splat depth
    sum(w_i d_i) / alpha (each record's camera distance under the colour's
    over-blend weights; 0 where nothing was hit).

    method:
      - "auto" / "kernel" (the JAX package's "pallas"): the packed-word path
        with the depth-carrying stream (`bin_packed_words(with_depth=True)`);
        its blend is the CUDA kernel's depth instantiation for CUDA tensors
        and the plain twin for CPU tensors
      - "tiles": the plain tile compositor over float records
        (`compositor.render_tiles(return_aux=True)`), the readable
        reference the kernel path is held against
    eps: transmittance floor of the kernel path's early exit (None =
    rcfg.transmittance_eps; 0 turns it off).
    """
    _check_inputs(device, splats, camera)
    if method in ("auto", "kernel"):
        from ..ops.tile_blend import blend_tiles

        binned = _words_and_bins(splats, camera, rcfg, with_depth=True)
        tile_color, tile_alpha, tile_depth = blend_tiles(binned, rcfg, eps, with_depth=True)
        alpha = tiles_to_plane(tile_alpha, rcfg)
        return {
            "rgb": tiles_to_image(tile_color, tile_alpha, rcfg),
            "depth": _normalized_depth(tiles_to_plane(tile_depth, rcfg), alpha),
            "alpha": alpha,
        }
    if method == "tiles":
        data = canonical_sort_data(
            splat_screen_records(splats, camera["view_proj"], camera["cam_pos"], rcfg))
        img, depth_acc, alpha = render_tiles(data, bin_splats(data, rcfg), rcfg,
                                             return_aux=True)
        return {"rgb": img, "depth": _normalized_depth(depth_acc, alpha), "alpha": alpha}
    raise ValueError(f"unknown method {method!r}; expected 'auto', 'kernel' or 'tiles'")


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
        blend_kernel: str = "tile",
        *,
        device,
    ):
        _blend_schedule(blend_kernel)  # a mistyped name fails here, not per frame
        self.scene = scene
        self.pcfg = pcfg
        self.rcfg = rcfg
        self.blend_kernel = blend_kernel
        self.device = torch.device(device)
        self._n = n
        self._n_by_structure: "OrderedDict[str, int]" = OrderedDict()

    @property
    def n(self) -> int:
        """Points per frame for the current structure."""
        h = self.scene.structure_hash()
        n = self._n_by_structure.get(h)
        if n is None:
            log_rebuild(h)
            n = self._n if self._n is not None else point_count(self.scene, self.pcfg)
            while len(self._n_by_structure) >= self.CACHE_SIZE:
                self._n_by_structure.popitem(last=False)
            self._n_by_structure[h] = n
        return n

    def _frame_splats(self, camera: CameraArrays, generator: torch.Generator) -> Splats:
        """The splats a frame at this camera would render (SplatEngine
        overrides)."""
        return model_points(
            self.scene, self.scene.params(self.device), generator, self.n,
            self.pcfg, self.rcfg, device=self.device,
        )

    def frame(self, camera: CameraArrays, generator: torch.Generator) -> torch.Tensor:
        """Render one (H, W, 3) frame at the scene's current parameters."""
        with span("frame"):
            return render_splats(
                self._frame_splats(camera, generator), camera, self.rcfg,
                blend_kernel=self.blend_kernel, device=self.device,
            )

    def stage_profile(self, camera: CameraArrays, generator: torch.Generator,
                      iters: int = 3) -> Dict[str, float]:
        """Per-stage times of a frame at this camera in ms, by CUDA events:
        the median of `iters` frames after one warm-up frame, read off the
        frames' spans (`utils.profiling.recording`).  Keys: "splats_ms"
        (the modeler, or SH lighting for a static set; 0 for a static set
        without SH), "project_ms", "bin_ms", "blend_ms", "image_ms".  Used
        by the viewer's HUD.  {} for an engine that is not on a CUDA
        device: only the card's own clock times its stages."""
        if self.device.type != "cuda":
            return {}
        with recording() as rec:
            for _ in range(iters + 1):
                self.frame(camera, generator)
                torch.cuda.synchronize(self.device)

        def median_ms(name: str) -> float:
            ms = rec.device_ms(name)[1:]
            return statistics.median(ms) if ms else 0.0

        spans = {"splats_ms": "model" if self.scene is not None else "sh",
                 "project_ms": "project", "bin_ms": "bin", "blend_ms": "blend",
                 "image_ms": "image"}
        return {k: median_ms(name) for k, name in spans.items()}


class SplatEngine(Engine):
    """Engine for a static splat set: a pre-trained 3DGS scene
    (`utils/ply.load_ply`), a fitted scene, or any hand-built plane dict,
    with optional view-dependent SH colour (`render/sh.py`).

    The same `frame(camera, generator)` surface as Engine minus the
    per-frame SDF modeling; `sh`, when given, lights every frame along the
    camera ray before projection.  The generator is not used: a static set
    draws no random numbers.

    Usage:
        splats, sh = load_ply("garden.ply", with_sh=True, device="cuda")
        eng = SplatEngine(splats, rcfg, sh=sh, device="cuda")
        serve(eng)          # orbit a pre-trained scene
    """

    def __init__(
        self,
        splats: Splats,
        rcfg: RenderConfig = RenderConfig(),
        sh=None,
        blend_kernel: str = "tile",
        *,
        device,
    ):
        _blend_schedule(blend_kernel)
        self.device = torch.device(device)
        check_device(self.device, **{f"splats[{k!r}]": v for k, v in splats.items()})
        if sh is not None:
            check_device(self.device, **{f"sh[{k!r}]": v for k, v in sh.items()})
        self.splats = splats
        self.sh = sh
        self.rcfg = rcfg
        self.blend_kernel = blend_kernel
        self.scene = None
        self.pcfg = None

    @property
    def n(self) -> int:
        return int(self.splats["px"].shape[0])

    def _frame_splats(self, camera: CameraArrays,
                      generator: Optional[torch.Generator] = None) -> Splats:
        if self.sh is not None:
            return apply_sh(self.splats, self.sh, camera["cam_pos"])
        return self.splats

    def frame(self, camera: CameraArrays,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Render one (H, W, 3) frame of the static set at `camera`."""
        return super().frame(camera, generator)


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
