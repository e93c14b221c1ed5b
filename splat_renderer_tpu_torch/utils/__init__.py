"""Host-side helpers: `ssim` (the 3DGS training loss and the host-side
quality scoreboard), `snapshot` (splat sets and training-state pytrees in
.npz), `ply` (3DGS `.ply` scenes), `image` (PNG files and uint8
quantization), `log` (the package logger) and `profiling` (the recorder's
spans and counters, and `torch.profiler` traces)."""
from .image import to_uint8, write_png
from .log import log_point_budget, log_rebuild, logger
from .ply import load_ply, save_ply
from .profiling import count, span, trace
from .snapshot import load_pytree, load_splats, save_pytree, save_splats

__all__ = [
    "count",
    "load_ply",
    "load_pytree",
    "load_splats",
    "log_point_budget",
    "log_rebuild",
    "logger",
    "save_ply",
    "save_pytree",
    "save_splats",
    "span",
    "to_uint8",
    "trace",
    "write_png",
]
