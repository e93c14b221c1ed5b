"""The port's CUDA kernels on the card, against their plain PyTorch twins.

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


def _binned(device, cfg, seed=0, n=4000, with_depth=False):
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
    return bin_packed_words(w["dk"], w["w_pos"], w["w_ro"], w["w_rgb"], cfg,
                            with_depth=with_depth)


@pytest.mark.parametrize("tiles", sorted(TILES))
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_depth_kernel_matches_twin(cuda, profile, tiles):
    """The depth-carrying kernel: colour and alpha within 2e-5 of the twin,
    the premultiplied depth within 2e-5 of the stream's depth range."""
    cfg = tpt.RenderConfig(width=200, height=120, tiles_per_splat_cap=8,
                           **PROFILES[profile], **TILES[tiles])
    binned = _binned(cuda, cfg, with_depth=True)
    before = blend_tiles.launches_by_kernel["tile_blend_depth"]
    kc, ka, kd = blend_tiles(binned, cfg, eps=0.0, with_depth=True)
    assert blend_tiles.launches_by_kernel["tile_blend_depth"] == before + 1
    pc, pa, pd = blend_tiles_plain(binned, cfg, eps=0.0, with_depth=True)
    torch.cuda.synchronize()
    d = binned["rec_depth"].view(torch.float32)
    d_range = float(d[torch.isfinite(d)].max())
    assert float((kc - pc).abs().max()) <= 2e-5
    assert float((ka - pa).abs().max()) <= 2e-5
    assert float((kd - pd).abs().max()) <= 2e-5 * d_range
    assert float(kd.max()) > 0
    # the depth instantiation leaves colour and alpha as they were
    c0, a0 = blend_tiles(binned, cfg, eps=0.0)
    assert torch.equal(c0, kc) and torch.equal(a0, ka)


@pytest.mark.parametrize("tiles", sorted(TILES))
@pytest.mark.parametrize("profile", ["isotropic", "oriented", "quad"])
def test_prefetch_kernel_equals_per_tile_kernel(cuda, profile, tiles):
    """The persistent cross-tile-prefetch schedule gives the per-tile
    kernel's outputs bit for bit, at eps 0 and 0.01, with and without depth;
    a tile with several chunks and empty tiles are both on the stream."""
    cfg = tpt.RenderConfig(width=200, height=120, tiles_per_splat_cap=8,
                           **PROFILES[profile], **TILES[tiles])
    binned = _binned(cuda, cfg, n=40000, with_depth=True)
    assert int(binned["counts"].max()) > cfg.tile_pixels  # a run of several chunks
    for eps in (0.0, 0.01):
        for with_depth in (False, True):
            name = "tile_blend_xp" + ("_depth" if with_depth else "")
            before = blend_tiles.launches_by_kernel[name]
            a = blend_tiles(binned, cfg, eps=eps, with_depth=with_depth)
            b = blend_tiles(binned, cfg, eps=eps, schedule="tile_xp", with_depth=with_depth)
            assert blend_tiles.launches_by_kernel[name] == before + 1
            torch.cuda.synchronize()
            for x, y in zip(a, b):
                assert torch.equal(x, y), (eps, with_depth)


def test_prefetch_kernel_skips_empty_tiles(cuda):
    """Few splats on a large viewport: most tiles are empty and come out as
    zeros from the persistent kernel, as from the per-tile kernel."""
    cfg = tpt.RenderConfig(width=640, height=360, tiles_per_splat_cap=8)
    binned = _binned(cuda, cfg, n=40, with_depth=True)
    assert int((binned["counts"] == 0).sum()) > cfg.num_tiles // 2
    a = blend_tiles(binned, cfg, eps=0.0, with_depth=True)
    b = blend_tiles(binned, cfg, eps=0.0, schedule="tile_xp", with_depth=True)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rate_probe_matches_twin(cuda, dtype):
    """The probe's chain against the mul-then-add loop.  Multiplying by 0.5
    is exact, so each round rounds once in both: float32 must be equal bit
    for bit; bfloat16 is held to one bfloat16 ulp at the chain's fixed point
    2.0 (2**-6), in case PyTorch's bfloat16 add rounds otherwise."""
    from splat_renderer_tpu_torch.ops.probe_rate import PANEL, probe_rate, probe_rate_plain

    x = torch.rand(PANEL, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    for repeats in (0, 1, 5, 256):
        before = probe_rate.launches
        got = probe_rate(x, dtype, repeats=repeats, steps=3)
        assert probe_rate.launches == before + 1
        want = probe_rate_plain(x, dtype, repeats=repeats, steps=1)
        torch.cuda.synchronize()
        if dtype == "f32":
            assert torch.equal(got, want), repeats
        else:
            assert float((got - want).abs().max()) <= 2.0 ** -6, repeats
    with pytest.raises(ValueError, match="dtype"):
        probe_rate(x, "fp8")


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


# ---- the differentiable blend: forward (K4) and backward (K5) kernels ----

DIFF_PROFILES = {"isotropic": ({}, 1e-4), "oriented": (dict(oriented=True), 1e-3)}


def _random_planes(device, cfg, n, seed=0):
    """Random continuous record planes over (and just beyond) the viewport,
    with some bit-equal depths, some culled records and opacities at 1."""
    from splat_renderer_tpu_torch.ops.tile_blend_diff import _PLANE_NAMES

    rng = np.random.default_rng(seed)
    depth = rng.uniform(1.0, 10.0, n)
    depth[n // 2: n // 2 + 20] = depth[:20]
    depth[-10:] = np.inf
    opacity = rng.uniform(0.3, 1.2, n)
    cols = [
        rng.uniform(-10, cfg.width + 10, n), rng.uniform(-10, cfg.height + 10, n),
        rng.uniform(0.3, 6.0, n), np.minimum(opacity, 1.0),
        rng.uniform(0, 1, n), rng.uniform(0, 1, n), rng.uniform(0, 1, n),
        rng.uniform(-np.pi, np.pi, n), rng.uniform(0.05, 1.0, n), depth,
    ]
    return [torch.tensor(c, dtype=torch.float32, device=device).requires_grad_(True)
            for c in cols], _PLANE_NAMES


def _blend_and_grads(fn, cfg, planes, cots):
    outs = fn(cfg, *planes)
    loss = sum((o * c).sum() for o, c in zip(outs, cots))
    # the twin never reads angle and ratio for isotropic profiles
    grads = torch.autograd.grad(loss, planes, allow_unused=True, materialize_grads=True)
    return [o.detach() for o in outs], grads


@pytest.mark.parametrize("tiles", sorted(TILES))
@pytest.mark.parametrize("profile", sorted(DIFF_PROFILES))
def test_diff_kernels_match_twin(cuda, profile, tiles):
    from splat_renderer_tpu_torch.ops.tile_blend_diff import (
        blend_planes, blend_planes_plain, diff_backward, diff_forward,
    )

    prof, grad_tol = DIFF_PROFILES[profile]
    cfg = tpt.RenderConfig(width=200, height=120, tiles_per_splat_cap=8, **prof, **TILES[tiles])
    planes, names = _random_planes(cuda, cfg, 3000)
    g = torch.Generator(device=cuda).manual_seed(1)
    shapes = [(cfg.num_tiles, cfg.tile_pixels, 3), (cfg.num_tiles, cfg.tile_pixels),
              (cfg.num_tiles, cfg.tile_pixels)]
    cots = [torch.rand(s, generator=g, device=cuda) - 0.5 for s in shapes]
    f0, b0 = diff_forward.launches, diff_backward.launches
    k_out, k_grads = _blend_and_grads(blend_planes, cfg, planes, cots)
    assert (diff_forward.launches, diff_backward.launches) == (f0 + 1, b0 + 1)
    p_out, p_grads = _blend_and_grads(blend_planes_plain, cfg, planes, cots)
    torch.cuda.synchronize()
    for k, p in zip(k_out, p_out):
        assert float((k - p).abs().max()) <= 2e-5
    for name, kg, pg in zip(names, k_grads, p_grads):
        if not cfg.oriented and name in ("angle", "ratio"):
            assert float(kg.abs().max()) == 0.0
            continue
        scale = float(pg.abs().max()) + 1e-12
        assert float((kg - pg).abs().max()) / scale < grad_tol, name
    # the backward is deterministic: a second run gives the same bits
    _, k_grads2 = _blend_and_grads(blend_planes, cfg, planes, cots)
    torch.cuda.synchronize()
    for a, b in zip(k_grads, k_grads2):
        assert torch.equal(a, b)


def test_diff_kernels_reject_what_they_cannot_run(cuda):
    from splat_renderer_tpu_torch.ops.tile_blend_diff import blend_planes

    cfg = tpt.RenderConfig(width=64, height=64, tile_size=12)
    planes, _ = _random_planes(cuda, cfg, 100)
    with pytest.raises(ValueError, match="multiple of 32"):
        blend_planes(cfg, *planes)
