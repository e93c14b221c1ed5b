"""The projector's CUDA kernel: splats to packed record words in one launch.

`project_words` launches `csrc/project_words.cu` on CUDA tensors and
returns what `render/projector.py::splat_screen_words_plain` returns,
bit for bit: {"dk", "w_pos", "w_ro", "w_rgb"} as int64 tensors holding u32
values and "depth" as float32; `launches["project_words"]` (`ops/build.py`)
counts its launches.
`render/projector.py::splat_screen_words` calls it for CUDA tensors; CPU
tensors take the plain path.  The kernel replaces no TPU kernel (the JAX package's projector
is plain jnp that XLA fuses): it replaces the plain path's ~300 launches a
call.

The planes may be strided views (the modeler's columns of (N, 3) tensors):
the kernel reads each at its own element stride, so nothing is copied.
Nothing here reads back from the device: the camera stays where it is and
the light direction is made once per (light_dir, device) on the device
(`light_direction`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch

from .._torch_util import sqrt_rn
from ..config import RenderConfig
from ..points.properties import COV3D_PLANES
from ..render.packing import ANGLE_SCALE, COLOR_SCALE, POS_MAX, RATIO_SCALE
from .build import Entry, check_tensor

# the kernel's plane order (csrc Plane enum): every model reads the first
# eleven, "cov3d" the seven of COV3D_PLANES after them as well
PLANES = ("px", "py", "pz", "radius", "cr", "cg", "cb", "opacity", "nx", "ny", "nz")
ALL_PLANES = PLANES + COV3D_PLANES
ELLIPSES = ("isotropic", "foreshorten", "ewa", "cov3d")  # csrc Ellipse enum


_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_FORWARD = Entry("project_words", "project_words_forward",
                 [_P] * 2 + [_P, _LL, _LL] + [_P, _LL] + [_P] * 2 + [_P] * 5
                 + [_LL, ctypes.c_int, ctypes.c_int] + [_P])


def ellipse_model(cfg: RenderConfig) -> str:
    """The plain path's branch of cfg: "ewa", "cov3d", "foreshorten" (any
    other ellipse of an oriented config) or "isotropic".  This and
    `dilates` repeat `shade_planes`' conditions; a CPU test holds them to
    the branch `shade_planes` takes."""
    if not cfg.oriented:
        return "isotropic"
    return cfg.ellipse if cfg.ellipse in ("ewa", "cov3d") else "foreshorten"


def dilates(cfg: RenderConfig) -> bool:
    """Whether the plain path applies the anti-aliasing dilation."""
    return cfg.aa_dilation > 0.0 and not cfg.opaque


@functools.lru_cache(maxsize=None)
def light_direction(light_dir: Tuple[float, float, float], device: torch.device) -> torch.Tensor:
    """The normalised light direction (3,) float32 on `device`, made by the
    plain path's own operations (`shade_planes`), once per (light_dir,
    device); callers only read it."""
    light = torch.tensor(light_dir, dtype=torch.float32, device=device)
    return light / sqrt_rn(torch.sum(light * light))


@functools.lru_cache(maxsize=None)
def _scalars(cfg: RenderConfig) -> ctypes.Array:
    """cfg's Python scalars of the plain path as float32 (csrc Scalars)."""
    return (ctypes.c_float * 16)(
        0.5 * cfg.width, 0.5 * cfg.height, cfg.r_cap,
        cfg.pos_scale, cfg.pos_offset, POS_MAX, COLOR_SCALE,
        math.pi, ANGLE_SCALE, 1.0 / RATIO_SCALE, RATIO_SCALE,
        cfg.light_ambient, cfg.light_diffuse, cfg.sigma * cfg.sigma, cfg.aa_dilation,
        cfg.sigma,
    )


def project_words(
    splats: Dict[str, torch.Tensor],
    view_proj: torch.Tensor,  # (4, 4)
    cam_pos: torch.Tensor,  # (3,)
    cfg: RenderConfig,
) -> Dict[str, torch.Tensor]:
    """One kernel launch: splats -> {"dk", "w_pos", "w_ro", "w_rgb",
    "depth"}, equal bit for bit to `splat_screen_words_plain` on the same
    CUDA device.  Every plane, the camera and the outputs live on the
    planes' device; raises ValueError on anything else."""
    px = splats["px"]
    device = px.device
    if px.dim() != 1:
        raise ValueError(f"splats['px'] must be 1-d, got shape {tuple(px.shape)}")
    n = px.shape[0]
    model = ellipse_model(cfg)
    names = ALL_PLANES if model == "cov3d" else PLANES
    missing = [k for k in names if k not in splats]
    if missing:
        raise ValueError(f"ellipse model {model!r} needs the splat planes {missing}")
    # the kernel reads every input at its own strides
    for name in names:
        check_tensor(f"splats[{name!r}]", splats[name], torch.float32, device, (n,),
                     contiguous=False)
    check_tensor("view_proj", view_proj, torch.float32, device, (4, 4), contiguous=False)
    check_tensor("cam_pos", cam_pos, torch.float32, device, (3,), contiguous=False)
    if device.type != "cuda":
        raise ValueError(f"no projector kernel for device {device}")

    light = light_direction(tuple(cfg.light_dir), device)
    # planes a model does not read go in as null pointers
    planes = (ctypes.c_void_p * len(ALL_PLANES))(
        *(splats[k].data_ptr() if k in names else None for k in ALL_PLANES))
    strides = (ctypes.c_longlong * len(ALL_PLANES))(
        *(splats[k].stride(0) if k in names else 0 for k in ALL_PLANES))
    words = {k: torch.empty(n, dtype=torch.int64, device=device)
             for k in ("dk", "w_pos", "w_ro", "w_rgb")}
    depth = torch.empty(n, dtype=torch.float32, device=device)
    _FORWARD.launch(
        device,
        planes, strides, view_proj.data_ptr(), view_proj.stride(0), view_proj.stride(1),
        cam_pos.data_ptr(), cam_pos.stride(0), light.data_ptr(), _scalars(cfg),
        words["dk"].data_ptr(), words["w_pos"].data_ptr(), words["w_ro"].data_ptr(),
        words["w_rgb"].data_ptr(), depth.data_ptr(), n,
        ELLIPSES.index(model), int(dilates(cfg)),
        count="project_words",
    )
    words["depth"] = depth
    return words
