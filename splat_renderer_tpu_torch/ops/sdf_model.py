"""The modeler's CUDA kernels (M1): a frame's splats in two launches.

`descend` launches `csrc/sdf_model.cu`'s descent (D): it seeds the points
from the generator's uniforms on the scene's grown bounding box, as
`points/seeding.py::seed_scene_points` maps them, or starts from the
points it is handed, and runs `points/projection.py::project_to_surface`'s
steps; it returns a fresh (11, N) float32 tensor whose rows px, py, pz
hold the settled points.  `probe` launches the curvature probe (C) over
that tensor: `points/curvature.py::curvature_probe` and
`points/properties.py::derive_splats`, the other 8 rows, returned as
`derive_splats`' plane dict.  Both read the scene as a `sdf/program.py`
Program and its packed parameter block, and equal the plain path bit for
bit on the same CUDA device; `launches["sdf_descent"]` and
`launches["sdf_probe"]` (`ops/build.py`) count them.  `render/pipeline.py`
calls them for CUDA tensors; the CPU takes the plain path.  They replace no
TPU kernel (the JAX modeler is plain jnp that XLA fuses): they replace the
plain path's ~680 launches a frame.  Nothing here reads back from the
device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import PointConfig, RenderConfig
from ..sdf.program import Program
from .build import Entry, check_tensor

# the output's rows, derive_splats' keys in order (csrc Row enum)
PLANES = ("px", "py", "pz", "radius", "cr", "cg", "cb", "opacity", "nx", "ny", "nz")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_DESCENT = Entry("sdf_model", "sdf_descent",
                 [_P, _I, _I, _P, _P, _P, _P, _LL, _LL, ctypes.c_float, _I, _P, _LL, _P])
_PROBE = Entry("sdf_model", "sdf_probe", [_P, _I, _P, _P, _I, _P, _LL, _P])


def program_words(program: Program, device: torch.device) -> torch.Tensor:
    """The program's int32 words on `device`: copied there once, then kept
    with the program."""
    words = program.on_device.get(device)
    if words is None:
        words = torch.tensor(program.words(), dtype=torch.int32, device=device)
        program.on_device[device] = words
    return words


@functools.lru_cache(maxsize=64)
def _probe_scalars(n: int, probe_radius: float, curvature_range: float, min_scale: float,
                   base_radius: float, base_opacity: float) -> ctypes.Array:
    f32 = np.float32
    values = (f32(probe_radius), f32(n) / f32(6 * n) if n else f32(0.0),
              f32(1.0) / f32(curvature_range - 0.0), f32(min_scale), f32(1.0 - min_scale),
              f32(base_radius), f32(base_opacity))
    return (ctypes.c_float * len(values))(*(float(v) for v in values))


def probe_scalars(n: int, pcfg: PointConfig, rcfg: RenderConfig) -> ctypes.Array:
    """The plain path's Python scalars as the card rounds them, in csrc
    ProbeConsts order: the probe radius, torch.mean's factor over the six
    taps' rows (float(N) / float(6 N), as torch computes it), the
    reciprocal of the smoothstep's width (a Python-scalar divisor on CUDA
    is a multiply by its float32 reciprocal), the curvature floor and its
    complement, the base radius and opacity."""
    return _probe_scalars(n, pcfg.probe_radius, pcfg.curvature_range,
                          pcfg.curvature_min_scale, rcfg.base_radius, rcfg.base_opacity)


def _check_block(program: Program, block: torch.Tensor) -> torch.device:
    check_tensor("params block", block, torch.float32, block.device, (program.size,))
    return block.device


def _check_launch(device: torch.device, *tensors: torch.Tensor) -> None:
    """The last checks before a launch: the kernels carry no gradient and
    run only on CUDA."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError("the modeler's kernels carry no gradient: a parameter or point "
                         "requires one")
    if device.type != "cuda":
        raise ValueError(f"no modeler kernel for device {device}")


def descend(
    program: Program,
    block: torch.Tensor,
    pcfg: PointConfig,
    *,
    uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    pts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One launch of D: a fresh (11, N) float32 tensor on the block's
    device, rows px, py, pz the points after `pcfg.descent_steps` steps.
    The start is `uniforms` = (uf (N,), uv (N, 2)), the draws
    `seed_points` makes, mapped onto the scene's box grown by
    `pcfg.aabb_scale`, or else `pts` (N, 3), read at its strides.  Raises
    ValueError on inputs the kernel does not take: another dtype, shape or
    device than these, a CPU device, or a tensor that requires a gradient
    (with grad mode on)."""
    device = _check_block(program, block)
    if (uniforms is None) == (pts is None):
        raise ValueError("descend takes either uniforms or pts")
    if uniforms is not None:
        uf, uv = uniforms
        n = uf.shape[0] if uf.dim() == 1 else -1
        check_tensor("uf", uf, torch.float32, device, (max(n, 0),))
        check_tensor("uv", uv, torch.float32, device, (n, 2))
        start = (uf.data_ptr(), uv.data_ptr(), None, 0, 0)
    else:
        n = pts.shape[0] if pts.dim() == 2 else -1
        check_tensor("pts", pts, torch.float32, device, (max(n, 0), 3), contiguous=False)
        start = (None, None, pts.data_ptr(), pts.stride(0), pts.stride(1))
    _check_launch(device, block, *(uniforms or (pts,)))
    words = program_words(program, device)
    out = torch.empty((len(PLANES), n), dtype=torch.float32, device=device)
    _DESCENT.launch(
        device, words.data_ptr(), len(program.code), len(program.bounds), block.data_ptr(),
        *start, float(np.float32(pcfg.aabb_scale * 0.5)), pcfg.descent_steps,
        out.data_ptr(), n, count="sdf_descent",
    )
    return out


def probe(program: Program, block: torch.Tensor, out: torch.Tensor, pcfg: PointConfig,
          rcfg: RenderConfig) -> Dict[str, torch.Tensor]:
    """One launch of C over `descend`'s tensor: its other 8 rows written,
    and all 11 returned as `derive_splats`' plane dict (rows of `out`)."""
    device = _check_block(program, block)
    n = out.shape[1] if out.dim() == 2 else -1
    check_tensor("out", out, torch.float32, device, (len(PLANES), max(n, 0)))
    _check_launch(device, block, out)
    _PROBE.launch(
        device, program_words(program, device).data_ptr(), len(program.code),
        block.data_ptr(), probe_scalars(n, pcfg, rcfg),
        int(rcfg.color_mode == "normal_signed"), out.data_ptr(), n, count="sdf_probe",
    )
    return dict(zip(PLANES, out.unbind(0)))
