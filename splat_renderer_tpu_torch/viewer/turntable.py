"""Offline viewer: render an orbiting turntable sequence to PNG files.

Counterpart of `splat_renderer_tpu/viewer/turntable.py`: a frame function
plus an image sink.  This drives an engine across an orbit and writes a PNG
sequence; frame i is fetched and encoded only after frame i+1 has been
enqueued, so on a CUDA engine the device renders while the host encodes.
"""

from __future__ import annotations

import math
import os
from typing import Callable, List, Optional

import torch

from ..camera import Camera, camera_tensors
from ..render.pipeline import Engine
from ..utils.image import write_png


def render_turntable(
    engine: Engine,
    out_dir: str,
    n_frames: int = 60,
    distance: float = 3.0,
    elevation: float = 0.5,
    animate: Optional[Callable[[float], None]] = None,
    seed: int = 0,
) -> List[str]:
    """Render n_frames around a full orbit; returns the written paths.

    `animate(t)` is called before each frame with t = frame index / 30:
    mutate scene primitives there.  Frame i draws its points from a
    generator on the engine's device seeded with `seed + i`.
    """
    os.makedirs(out_dir, exist_ok=True)
    cam = Camera(
        distance=distance,
        elevation=elevation,
        aspect=engine.rcfg.width / engine.rcfg.height,
    )
    paths = []
    pending = None  # (path, device image): overlap render and host transfer
    for i in range(n_frames):
        t = i / 30.0
        if animate is not None:
            animate(t)
        cam.azimuth = 2.0 * math.pi * i / n_frames
        camera = camera_tensors(cam.arrays(t), engine.device)
        img = engine.frame(
            camera, torch.Generator(device=engine.device).manual_seed(seed + i))
        if pending is not None:
            write_png(pending[0], pending[1])
        pending = (os.path.join(out_dir, f"frame_{i:04d}.png"), img)
        paths.append(pending[0])
    if pending is not None:
        write_png(pending[0], pending[1])
    return paths
