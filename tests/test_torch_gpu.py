"""The tile-blend CUDA kernel on the card, against its plain PyTorch twin.

Marked `gpu`: every test skips where torch sees no CUDA device.  The file
imports no jax, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import splat_renderer_tpu_torch as tpt
from splat_renderer_tpu_torch.camera import camera_tensors
from splat_renderer_tpu_torch.convert import splats_from_numpy
from splat_renderer_tpu_torch.ops.tile_blend import blend_tiles, blend_tiles_plain
from splat_renderer_tpu_torch.render.binning import bin_packed_words
from splat_renderer_tpu_torch.render.projector import splat_screen_words

pytestmark = pytest.mark.gpu

PROFILES = {
    "isotropic": {},
    "oriented": dict(oriented=True),
    "ewa": dict(oriented=True, ellipse="ewa"),
    "opaque": dict(opaque=True, oriented=True),
    "quad": dict(opaque=True, oriented=True, quad=True),
}
TILES = {"16x16": dict(tile_size=16), "32x16": dict(tile_size=32, tile_height=16)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tile-blend kernel runs only on the card")
    return torch.device("cuda")


def _binned(device, cfg, seed=0, n=4000):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n, 3))
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    planes = {
        "px": pos[:, 0], "py": pos[:, 1], "pz": pos[:, 2],
        "radius": rng.uniform(0.005, 0.08, n), "cr": rng.uniform(0, 1, n),
        "cg": rng.uniform(0, 1, n), "cb": rng.uniform(0, 1, n),
        "opacity": rng.uniform(0.2, 1.0, n),
        "nx": nrm[:, 0], "ny": nrm[:, 1], "nz": nrm[:, 2],
    }
    spl = splats_from_numpy(planes, device)
    cam = camera_tensors(tpt.Camera(aspect=cfg.width / cfg.height).arrays(), device)
    w = splat_screen_words(spl, cam["view_proj"], cam["cam_pos"], cfg)
    return bin_packed_words(w["dk"], w["w_pos"], w["w_ro"], w["w_rgb"], cfg)


@pytest.mark.parametrize("tiles", sorted(TILES))
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_kernel_matches_twin(cuda, profile, tiles):
    cfg = tpt.RenderConfig(width=200, height=120, tiles_per_splat_cap=8,
                           **PROFILES[profile], **TILES[tiles])
    binned = _binned(cuda, cfg)
    before = blend_tiles.launches
    kc, ka = blend_tiles(binned, cfg, eps=0.0)
    assert blend_tiles.launches == before + 1
    pc, pa = blend_tiles_plain(binned, cfg, eps=0.0)
    torch.cuda.synchronize()
    assert float((kc - pc).abs().max()) <= 2e-5
    assert float((ka - pa).abs().max()) <= 2e-5
    ec, ea = blend_tiles(binned, cfg, eps=0.01)
    torch.cuda.synchronize()
    assert float((ec - kc).abs().max()) <= 0.0101
    assert float((ea - ka).abs().max()) <= 0.0101


def test_kernel_rejects_what_it_cannot_run(cuda):
    cfg = tpt.RenderConfig(width=128, height=64, tile_size=64, tile_height=32)
    binned = _binned(cuda, cfg, n=100)
    with pytest.raises(ValueError, match="one thread per pixel"):
        blend_tiles(binned, cfg)
    cfg = tpt.RenderConfig(width=64, height=64)
    binned = _binned(cuda, cfg, n=100)
    binned["pair_rank"] = binned["pair_rank"].to(torch.int64)
    with pytest.raises(ValueError, match="int32"):
        blend_tiles(binned, cfg)
