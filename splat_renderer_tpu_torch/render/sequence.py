"""Frame sequences: a whole animation rendered into one device tensor.

Counterpart of `splat_renderer_tpu/render/sequence.py`, whose frames run
inside one `lax.scan`.  PyTorch runs eagerly, so the frames are a Python
loop; the images are quantized and stacked on the device, and the host
fetches the stack once.

Per-frame scene parameters arrive stacked (animate on the host, stack
once); cameras as stacked tensors (`camera.orbit_ring` or any (F, ...)
stack).  Output is (F, H, W*3) uint8 by default: flat interleaved raster
rows, which `utils.image.unflatten_rows` turns into (..., H, W, 3).

Random numbers.  `jax.random.fold_in(key, i)` cannot be reproduced in
PyTorch.  The port's rule: frame i seeds its points from a generator of its
own, on the caller's generator's device, seeded with
`generator.initial_seed() + i`.  The caller's generator is not advanced, so
the same generator gives the same sequence again, and frame i does not
depend on how many frames came before it.
"""

from __future__ import annotations

import torch

from ..camera import CameraArrays
from ..config import PointConfig, RenderConfig
from ..sdf.scene import Params, SDFScene
from .multiview import camera_at, quantize_u8, view_count
from .pipeline import model_points, render_splats


def frame_generator(generator: torch.Generator, i: int) -> torch.Generator:
    """Frame i's generator under the module's seeding rule."""
    return torch.Generator(device=generator.device).manual_seed(generator.initial_seed() + i)


def render_sequence(
    scene: SDFScene,
    params_stack: Params,  # {id: {name: tensor with a leading frame axis F}}
    cameras: CameraArrays,  # tensors with a leading frame axis F
    generator: torch.Generator,
    n: int,
    pcfg: PointConfig,
    rcfg: RenderConfig,
    compositor: str = "auto",
    as_uint8: bool = True,
    flat: bool = True,
    *,
    device,
) -> torch.Tensor:
    """Render F animated frames; returns (F, H, W*3) when `flat`, else
    (F, H, W, 3); uint8 when `as_uint8`, else float32.

    Each frame re-models the scene (seed -> descent -> curvature) with its
    own parameters and its own generator (module docstring), then renders.
    """
    frames = []
    for i in range(view_count(cameras)):
        params = {pid: {k: v[i] for k, v in p.items()} for pid, p in params_stack.items()}
        splats = model_points(scene, params, frame_generator(generator, i), n, pcfg, rcfg,
                              device=device)
        img = render_splats(splats, camera_at(cameras, i), rcfg, compositor, device=device)
        if as_uint8:
            img = quantize_u8(img)
        if flat:
            img = img.reshape(rcfg.height, rcfg.width * 3)
        frames.append(img)
    return torch.stack(frames)
