"""Central configuration: the point and render knobs as frozen dataclasses.

Field-for-field copy of `splat_renderer_tpu/config.py` (pure Python; it is
copied rather than imported because importing anything from the JAX package
runs its `__init__`, which imports jax).  Defaults, derived properties and the
`turbo_`/`surface_render_config` presets are held equal to the JAX package's
by tests/test_torch_config.py.

The turbo profile's pair orderings `fast_math` and `depth_key_order` are
exact in the port (`render/binning.py::bin_packed_words` says why).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class PointConfig:
    """Surface-point generation and refinement knobs.

    - points_per_primitive / min/max_points: the point budget (point_count)
    - aabb_scale: the seeding margin around the scene's bounding box
    - descent_steps: projection iterations onto the surface
    - probe_radius / curvature mapping: the curvature probe
    """

    points_per_primitive: int = 30_000
    min_points: int = 10_000
    max_points: int = 200_000
    aabb_scale: float = 1.5
    descent_steps: int = 5
    probe_radius: float = 0.02
    # scale = lerp(curvature_min_scale, 1.0, 1 - smoothstep(0, curvature_range, var))
    curvature_min_scale: float = 0.01
    curvature_range: float = 0.5


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Splat rasterization knobs (tile pipeline + compositors)."""

    width: int = 1920
    height: int = 1080
    tile_size: int = 16  # tile WIDTH in px
    # Tile HEIGHT in px; 0 = square tiles (tile_size).
    tile_height: int = 0
    # Gaussian falloff of the per-pixel compositor
    sigma: float = 0.5
    # Support cutoff: the Gaussian is cut at bounds_margin * radius
    bounds_margin: float = 1.5
    # Splats smaller than this many pixels are dropped
    min_screen_radius: float = 0.5
    # World-space splat radius, multiplied by the curvature scale
    base_radius: float = 0.04
    base_opacity: float = 1.0
    background: Tuple[float, float, float] = (0.05, 0.05, 0.1)
    # Lambert lighting folded into each splat's colour
    light_dir: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    light_ambient: float = 0.85
    light_diffuse: float = 0.15
    # Max screen tiles one splat may overlap; larger footprints are shrunk
    # toward the centre tile, and the projector caps radii to fit (r_cap).
    tiles_per_splat_cap: int = 16
    # Transmittance floor for early termination (alpha >= 0.99 exit).
    transmittance_eps: float = 0.01
    # Opaque z-buffer mode: hard ellipse coverage, nearest splat wins.
    opaque: bool = False
    # Surface-oriented splats: screen ellipses foreshortened by the normal.
    oriented: bool = False
    # Square-quad coverage for the opaque mode (only with opaque=True).
    quad: bool = False
    # Screen-ellipse model for oriented splats: "foreshorten", "ewa" or
    # "cov3d" (full-covariance 3D Gaussians, points.COV3D_PLANES).
    ellipse: str = "foreshorten"
    # The turbo profile's pair orderings: approximate in the JAX package,
    # exact here (render/binning.py::bin_packed_words).
    fast_math: bool = False
    depth_key_order: bool = False
    # Anti-aliasing dilation (px^2) added to every Gaussian splat's screen
    # covariance, with opacity scaled so the splat's mass is conserved.
    aa_dilation: float = 0.0
    # Splat base colour from the surface normal: "normal_abs" or
    # "normal_signed".
    color_mode: str = "normal_abs"
    # Chunk of splats blended per scan step in the plain compositors.
    blend_chunk: int = 32

    @property
    def tile_w(self) -> int:
        """Tile width in px (alias of tile_size; see tile_height)."""
        return self.tile_size

    @property
    def tile_h(self) -> int:
        """Tile height in px (tile_height, or square when 0)."""
        return self.tile_height if self.tile_height else self.tile_size

    @property
    def r_cap(self) -> float:
        """Screen-radius cap: the largest radius whose padded bounds box
        (side 2*bounds_margin*r) spans at most floor(sqrt(tiles_per_splat_
        cap)) tiles per axis, governed by the smaller tile extent."""
        k = max(int(self.tiles_per_splat_cap ** 0.5), 2)
        return (k - 1) * min(self.tile_w, self.tile_h) / (2.0 * self.bounds_margin)

    @property
    def pos_offset(self) -> float:
        """Origin shift of the u16 fixed-point screen grid (px)."""
        return 256.0

    @property
    def pos_scale(self) -> float:
        """Subpixel scale of the u16 fixed-point screen grid (1/scale px):
        the largest power of two up to 32 whose u16 range covers
        [-pos_offset, max(width, height) + pos_offset] px."""
        span = max(self.width, self.height) + 2.0 * self.pos_offset
        scale = 32.0
        while scale > 1.0 and span * scale > 65535.0:
            scale /= 2.0
        if span * scale > 65535.0:
            raise ValueError(
                f"frame {self.width}x{self.height} exceeds the u16 screen "
                "grid even at 1 px resolution (max ~65023 px per axis)"
            )
        return scale

    @property
    def tiles_x(self) -> int:
        return _cdiv(self.width, self.tile_w)

    @property
    def tiles_y(self) -> int:
        return _cdiv(self.height, self.tile_h)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def tile_pixels(self) -> int:
        return self.tile_w * self.tile_h

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def turbo_render_config(width: int = 1920, height: int = 1080, **kw) -> RenderConfig:
    """Throughput-first preset: fast_math, depth_key_order and
    bounds_margin 1.3.  The port's binner is exact whatever the two
    orderings say (`render/binning.py::bin_packed_words`), so the image
    differs from the exact profile's only by the Gaussian cut at 1.3 r
    instead of 1.5 r."""
    defaults = dict(width=width, height=height, fast_math=True,
                    bounds_margin=1.3, depth_key_order=True)
    defaults.update(kw)
    return RenderConfig(**defaults)


def surface_render_config(width: int = 1920, height: int = 1080, **kw) -> RenderConfig:
    """Opaque surface-oriented splats with signed-normal colouring and
    0.3/0.7 ambient/diffuse lighting; base_radius 0.025."""
    defaults = dict(
        width=width,
        height=height,
        opaque=True,
        oriented=True,
        color_mode="normal_signed",
        light_ambient=0.3,
        light_diffuse=0.7,
        base_radius=0.025,
        base_opacity=1.0,
    )
    defaults.update(kw)
    return RenderConfig(**defaults)
