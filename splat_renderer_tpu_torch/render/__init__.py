from .binning import (
    bin_packed_words,
    bin_planes_diff,
    bin_splats,
    canonical_order,
    canonical_sort_data,
    diff_fields,
)
from .blend import (
    composite_over_background,
    ellipse_cos_sin,
    over_merge,
    segmented_exclusive_product,
    splat_alpha_planes,
)
from .compositor import render_tiles, tiles_to_image, tiles_to_plane
from .diff import render_diff, render_diff_gbuffer, splat_screen_records_diff
from .oracle import pixel_grid, render_oracle
from .packing import depth_bits, unpack_words
from .multiview import render_views, render_views_gbuffer
from .pipeline import (
    Engine,
    SplatEngine,
    animate_demo,
    demo_scene,
    model_points,
    render_frame,
    render_gbuffer,
    render_splats,
    surface_splats,
)
from .sequence import render_sequence
from .sh import apply_sh, sh_basis_planes, sh_degree
from .projector import (
    project_planes,
    screen_planes,
    shade_planes,
    splat_screen_records,
    splat_screen_words,
)

__all__ = [
    "Engine",
    "SplatEngine",
    "animate_demo",
    "apply_sh",
    "bin_packed_words",
    "bin_planes_diff",
    "bin_splats",
    "canonical_order",
    "canonical_sort_data",
    "composite_over_background",
    "demo_scene",
    "depth_bits",
    "diff_fields",
    "ellipse_cos_sin",
    "model_points",
    "over_merge",
    "pixel_grid",
    "project_planes",
    "render_diff",
    "render_diff_gbuffer",
    "render_frame",
    "render_gbuffer",
    "render_oracle",
    "render_sequence",
    "render_splats",
    "render_tiles",
    "render_views",
    "render_views_gbuffer",
    "screen_planes",
    "segmented_exclusive_product",
    "sh_basis_planes",
    "sh_degree",
    "shade_planes",
    "splat_alpha_planes",
    "splat_screen_records",
    "splat_screen_records_diff",
    "splat_screen_words",
    "surface_splats",
    "tiles_to_image",
    "tiles_to_plane",
    "unpack_words",
]
