"""State carried across from the JAX package, as numpy, onto a device.

The two packages share no code at run time; a caller that wants both to
work on the same state converts the JAX side's arrays with `numpy.asarray`
and hands them to these functions.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .camera import camera_tensors
from .points.properties import Splats
from .sdf.scene import Params


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=device)


def splats_from_numpy(planes: Mapping[str, np.ndarray], device) -> Splats:
    """A Splats dict of (N,) planes (e.g. the JAX package's `Splats`)."""
    return {k: _f32(v, device) for k, v in planes.items()}


def params_from_numpy(params: Mapping[str, Mapping[str, np.ndarray]], device) -> Params:
    """Scene parameters keyed by primitive/operation id (the JAX
    package's `SDFScene.params()`)."""
    return {pid: {k: _f32(v, device) for k, v in p.items()} for pid, p in params.items()}


# a camera frame uniform {view_proj, cam_pos, time}
camera_from_numpy = camera_tensors


def points_from_numpy(points: np.ndarray, device) -> torch.Tensor:
    """(N, 3) points (e.g. points seeded by the JAX package)."""
    return _f32(points, device)
