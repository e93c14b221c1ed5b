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


def sh_from_numpy(sh: Mapping[str, np.ndarray], device):
    """SH coefficients {"r"|"g"|"b": (n_rest, N)} (render/sh.py)."""
    return {c: _f32(sh[c], device) for c in ("r", "g", "b")}


def theta_from_checkpoint(path: str, device):
    """The fitted fields ("theta") of a `fit_splats` checkpoint written by
    either package (utils/snapshot.save_pytree: both key a leaf by its path,
    e.g. `['theta']['cr']`), as a dict of tensors on `device`."""
    from .utils.snapshot import checkpoint_file

    prefix = "['theta']"
    with np.load(checkpoint_file(path)) as z:
        return {
            k[len(prefix) + 2:-2]: _f32(z[k], device)
            for k in z.files if k.startswith(prefix + "['")
        }
