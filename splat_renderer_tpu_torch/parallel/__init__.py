"""Multi-device rendering over torch.distributed (counterpart of
`splat_renderer_tpu/parallel`): view-DP x tile-band SP (`sharding`) and
depth-band splat parallelism (`band`)."""

from .band import band_frame_fn, depth_band
from .sharding import (
    gather_views,
    make_mesh,
    multichip_frame_fn,
    rank_generator,
    render_band,
    render_views_data_parallel,
)

__all__ = [
    "band_frame_fn",
    "depth_band",
    "gather_views",
    "make_mesh",
    "multichip_frame_fn",
    "rank_generator",
    "render_band",
    "render_views_data_parallel",
]
