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
from splat_renderer_tpu_torch.ops.build import launches
from splat_renderer_tpu_torch.ops.tile_blend import KERNELS, blend_tiles, blend_tiles_plain
from splat_renderer_tpu_torch.render.binning import bin_packed_words, canonical_order
from splat_renderer_tpu_torch.render.projector import splat_screen_words
from splat_renderer_tpu_torch.utils import profiling

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


def k1_launches() -> int:
    """K1's launches, all schedules and forms."""
    return sum(launches[k] for k in KERNELS)


def _binned(device, cfg, seed=0, n=4000, with_depth=False, presort=False,
            radius=(0.005, 0.08), opacity=(0.2, 1.0)):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n, 3))
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    planes = {
        "px": pos[:, 0], "py": pos[:, 1], "pz": pos[:, 2],
        "radius": rng.uniform(*radius, n), "cr": rng.uniform(0, 1, n),
        "cg": rng.uniform(0, 1, n), "cb": rng.uniform(0, 1, n),
        "opacity": rng.uniform(*opacity, n),
        "nx": nrm[:, 0], "ny": nrm[:, 1], "nz": nrm[:, 2],
    }
    spl = splats_from_numpy(planes, device)
    cam = camera_tensors(tpt.Camera(aspect=cfg.width / cfg.height).arrays(), device)
    w = splat_screen_words(spl, cam["view_proj"], cam["cam_pos"], cfg)
    words = [w[k] for k in ("dk", "w_pos", "w_ro", "w_rgb")]
    if presort:  # the records in canonical order before binning
        order = canonical_order(w["dk"])
        words = [x[order] for x in words]
    return bin_packed_words(*words, cfg, with_depth=with_depth)


@pytest.mark.parametrize("tiles", sorted(TILES))
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_depth_kernel_matches_twin(cuda, profile, tiles):
    """The depth-carrying kernel: colour and alpha within 2e-5 of the twin,
    the premultiplied depth within 2e-5 of the stream's depth range."""
    cfg = tpt.RenderConfig(width=200, height=120, tiles_per_splat_cap=8,
                           **PROFILES[profile], **TILES[tiles])
    binned = _binned(cuda, cfg, with_depth=True)
    before = launches["tile_blend_depth"]
    kc, ka, kd = blend_tiles(binned, cfg, eps=0.0, with_depth=True)
    assert launches["tile_blend_depth"] == before + 1
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
            before = launches[name]
            a = blend_tiles(binned, cfg, eps=eps, with_depth=with_depth)
            b = blend_tiles(binned, cfg, eps=eps, schedule="tile_xp", with_depth=with_depth)
            assert launches[name] == before + 1
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
    """The probe's interleaved chains against the mul-then-add loop, on its
    panel and on a ragged one whose last block is partly empty.
    Multiplying by 0.5 is exact, so each round rounds once in both: the
    results are equal bit for bit in float32 and in bfloat16."""
    from splat_renderer_tpu_torch.ops.probe_rate import PANEL, probe_rate, probe_rate_plain

    g = torch.Generator(device=cuda).manual_seed(0)
    for shape in (PANEL, (2, 1001)):
        x = torch.rand(shape, generator=g, device=cuda)
        for repeats in (0, 1, 5, 256):
            before = launches["probe_rate"]
            got = probe_rate(x, dtype, repeats=repeats, steps=3)
            assert launches["probe_rate"] == before + 1
            want = probe_rate_plain(x, dtype, repeats=repeats, steps=1)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (shape, repeats)
    with pytest.raises(ValueError, match="dtype"):
        probe_rate(x, "fp8")


@pytest.mark.parametrize("tiles", sorted(TILES))
@pytest.mark.parametrize("with_depth", [False, True], ids=["rgb", "depth"])
def test_kernels_on_a_depth_key_order_stream(cuda, with_depth, tiles):
    """The turbo profile's depth-keyed stream (records in input order,
    pairs carrying input indices): K1 and its depth form within 2e-5 of
    the twin on it, and equal bit for bit to their output on the stream of
    the same records sorted into canonical order before binning."""
    cfg = tpt.RenderConfig(width=200, height=120, tiles_per_splat_cap=8, **TILES[tiles])
    dko = _binned(cuda, cfg.replace(depth_key_order=True), with_depth=with_depth)
    exact = _binned(cuda, cfg, with_depth=with_depth, presort=True)
    assert not torch.equal(dko["pair_rank"], exact["pair_rank"])
    kernel = "tile_blend_depth" if with_depth else "tile_blend"
    before = launches[kernel]
    got = blend_tiles(dko, cfg, eps=0.0, with_depth=with_depth)
    assert launches[kernel] == before + 1
    twin = blend_tiles_plain(dko, cfg, eps=0.0, with_depth=with_depth)
    want = blend_tiles(exact, cfg, eps=0.0, with_depth=with_depth)
    torch.cuda.synchronize()
    for g, t, w in zip(got, twin, want):
        assert float((g - t).abs().max()) <= 2e-5 * max(1.0, float(t.abs().max()))
        assert torch.equal(g, w)


@pytest.mark.parametrize("tiles", sorted(TILES))
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_kernel_matches_twin(cuda, profile, tiles):
    cfg = tpt.RenderConfig(width=200, height=120, tiles_per_splat_cap=8,
                           **PROFILES[profile], **TILES[tiles])
    binned = _binned(cuda, cfg)
    before = k1_launches()
    kc, ka = blend_tiles(binned, cfg, eps=0.0)
    assert k1_launches() == before + 1
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


WALK_TILES = {"16x16": dict(tile_size=16), "32x32": dict(tile_size=32)}


@pytest.mark.parametrize("with_depth", [False, True], ids=["rgb", "depth"])
@pytest.mark.parametrize("tiles", sorted(WALK_TILES))
@pytest.mark.parametrize("profile", ["quad", "opaque"])
def test_walk_counter_leaves_the_image_and_counts_the_walk(cuda, profile, tiles, with_depth):
    """K1 with the walk counter on (the recorder on) writes the same bits as
    with it off; its `blend_walked` lies between the twin's (the exact stop,
    on the same stream on the card) and the twin's plus 31 a nonempty tile
    (its warps stop at the end of a 32-record group); the persistent
    schedule counts nothing.  Opaque splats at opacity 1, dense enough that
    most tiles stop early; the image within 2e-5 of the twin's."""
    cfg = tpt.RenderConfig(width=200, height=120, tiles_per_splat_cap=16,
                           **PROFILES[profile], **WALK_TILES[tiles])
    binned = _binned(cuda, cfg, n=20000, with_depth=with_depth, radius=(0.02, 0.1),
                     opacity=(1.0, 1.0))
    off = blend_tiles(binned, cfg, with_depth=with_depth)
    with profiling.recording() as rec:
        on = blend_tiles(binned, cfg, with_depth=with_depth)
        blend_tiles(binned, cfg, schedule="tile_xp", with_depth=with_depth)
    with profiling.recording() as twin_rec:
        plain = blend_tiles_plain(binned, cfg, with_depth=with_depth)
    torch.cuda.synchronize()
    for x, y in zip(on, off):
        assert torch.equal(x, y)
    for x, y in zip(on[:2], plain[:2]):
        assert float((x - y).abs().max()) <= 2e-5
    k1, twin = rec.counter("blend_walked"), twin_rec.counter("blend_walked")
    nonempty = int((binned["counts"] > 0).sum())
    assert twin <= k1 <= twin + 31 * nonempty
    assert twin < 0.7 * int(binned["offsets"][-1])


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
    from splat_renderer_tpu_torch.ops.tile_blend_diff import blend_planes, blend_planes_plain

    prof, grad_tol = DIFF_PROFILES[profile]
    cfg = tpt.RenderConfig(width=200, height=120, tiles_per_splat_cap=8, **prof, **TILES[tiles])
    planes, names = _random_planes(cuda, cfg, 3000)
    g = torch.Generator(device=cuda).manual_seed(1)
    shapes = [(cfg.num_tiles, cfg.tile_pixels, 3), (cfg.num_tiles, cfg.tile_pixels),
              (cfg.num_tiles, cfg.tile_pixels)]
    cots = [torch.rand(s, generator=g, device=cuda) - 0.5 for s in shapes]
    keys = ("tile_blend_diff_forward", "tile_blend_diff_backward")
    before = [launches[k] for k in keys]
    k_out, k_grads = _blend_and_grads(blend_planes, cfg, planes, cots)
    assert [launches[k] - b for k, b in zip(keys, before)] == [1, 1]
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


# ---- the redesigned kernels' edges: chunk boundaries, one heavy tile, the queue ----

def _one_tile_binned(device, cfg, n=1500):
    """Every splat projects into one tile: its run holds more than two
    chunks of a 512-thread block, every other tile is empty."""
    rng = np.random.default_rng(3)
    pos = rng.uniform(-1, 1, (n, 3)) * 0.004 + np.array([0.03, -0.03, 0.0])
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    planes = {
        "px": pos[:, 0], "py": pos[:, 1], "pz": pos[:, 2],
        "radius": rng.uniform(0.012, 0.02, n), "cr": rng.uniform(0, 1, n),
        "cg": rng.uniform(0, 1, n), "cb": rng.uniform(0, 1, n),
        "opacity": rng.uniform(0.05, 0.3, n),
        "nx": nrm[:, 0], "ny": nrm[:, 1], "nz": nrm[:, 2],
    }
    spl = splats_from_numpy(planes, device)
    cam = camera_tensors(tpt.Camera(aspect=cfg.width / cfg.height).arrays(), device)
    w = splat_screen_words(spl, cam["view_proj"], cam["cam_pos"], cfg)
    return bin_packed_words(w["dk"], w["w_pos"], w["w_ro"], w["w_rgb"], cfg, with_depth=True)


@pytest.mark.parametrize("tiles", sorted(TILES))
@pytest.mark.parametrize("profile", ["isotropic", "oriented"])
def test_one_heavy_tile_among_empty_ones(cuda, profile, tiles):
    cfg = tpt.RenderConfig(width=200, height=120, tiles_per_splat_cap=8,
                           **PROFILES[profile], **TILES[tiles])
    binned = _one_tile_binned(cuda, cfg)
    counts = binned["counts"]
    assert int((counts > 0).sum()) == 1 and int(counts.max()) > 2 * cfg.tile_pixels
    plain = blend_tiles_plain(binned, cfg, eps=0.0, with_depth=True)
    for eps in (0.0, 0.01):
        k1 = blend_tiles(binned, cfg, eps=eps, with_depth=True)
        k3 = blend_tiles(binned, cfg, eps=eps, schedule="tile_xp", with_depth=True)
        torch.cuda.synchronize()
        for x, y in zip(k1, k3):
            assert torch.equal(x, y), eps
        tol = 2e-5 if eps == 0.0 else 0.0101
        assert float((k1[0] - plain[0]).abs().max()) <= tol
        assert float((k1[1] - plain[1]).abs().max()) <= tol
    empty = counts == 0
    assert float(k1[0][empty].abs().max()) == 0.0 and float(k1[1][empty].abs().max()) == 0.0


def test_tile_queue_visits_every_nonempty_tile_once(cuda):
    from splat_renderer_tpu_torch.ops.tile_blend import nonempty_tiles

    cfg = tpt.RenderConfig(width=640, height=360, tiles_per_splat_cap=8)
    counts = _binned(cuda, cfg, n=3000)["counts"]
    tile_list, n_list = nonempty_tiles(counts)
    n = int(n_list)
    assert n == int((counts > 0).sum()) and 0 < n < cfg.num_tiles
    listed = tile_list[:n].long()
    assert torch.equal(torch.sort(listed).values, torch.nonzero(counts > 0).flatten())
    by_count = counts[listed]
    assert bool((by_count[:-1] >= by_count[1:]).all())  # heaviest first


def _grid_planes(device, blocks, seed=0):
    """Planes whose records sit well inside chosen 16x16 tiles: `blocks` is
    a list of (count, tile x origin, tile y origin)."""
    from splat_renderer_tpu_torch.ops.tile_blend_diff import _PLANE_NAMES

    rng = np.random.default_rng(seed)

    def block(n, x0, y0):
        return [rng.uniform(x0 + 5, x0 + 11, n), rng.uniform(y0 + 5, y0 + 11, n),
                rng.uniform(0.5, 1.2, n), np.minimum(rng.uniform(0.3, 1.3, n), 1.0),
                rng.uniform(0, 1, n), rng.uniform(0, 1, n), rng.uniform(0, 1, n),
                rng.uniform(-3, 3, n), rng.uniform(0.2, 1, n), rng.uniform(1, 10, n)]

    cols = [np.concatenate(c) for c in zip(*(block(*b) for b in blocks))]
    return [torch.tensor(c, dtype=torch.float32, device=device).requires_grad_(True)
            for c in cols], _PLANE_NAMES


@pytest.mark.parametrize("profile", sorted(DIFF_PROFILES))
def test_backward_at_chunk_edges(cuda, profile):
    """Runs of exactly two chunks, one record, one more than a chunk, and
    empty tiles: gradients within the gate of the twin's, bit-equal on rerun."""
    from splat_renderer_tpu_torch.ops.tile_blend_diff import (
        blend_planes, blend_planes_plain, bwd_chunk,
    )
    from splat_renderer_tpu_torch.render.binning import bin_planes_diff

    prof, grad_tol = DIFF_PROFILES[profile]
    cfg = tpt.RenderConfig(width=64, height=48, tiles_per_splat_cap=4, **prof)
    bc = bwd_chunk(cfg)
    planes, names = _grid_planes(cuda, [(2 * bc, 0, 0), (1, 16, 0), (bc + 1, 32, 16)])
    counts = bin_planes_diff({k: p.detach() for k, p in zip(names, planes)}, cfg)["counts"]
    assert counts.tolist() == [2 * bc, 1, 0, 0, 0, 0, bc + 1, 0, 0, 0, 0, 0]
    g = torch.Generator(device=cuda).manual_seed(2)
    shapes = [(cfg.num_tiles, cfg.tile_pixels, 3), (cfg.num_tiles, cfg.tile_pixels),
              (cfg.num_tiles, cfg.tile_pixels)]
    cots = [torch.rand(s, generator=g, device=cuda) - 0.5 for s in shapes]
    k_out, k_grads = _blend_and_grads(blend_planes, cfg, planes, cots)
    p_out, p_grads = _blend_and_grads(blend_planes_plain, cfg, planes, cots)
    _, k_grads2 = _blend_and_grads(blend_planes, cfg, planes, cots)
    torch.cuda.synchronize()
    for k, p in zip(k_out, p_out):
        assert float((k - p).abs().max()) <= 2e-5
    for name, kg, pg, kg2 in zip(names, k_grads, p_grads, k_grads2):
        assert torch.equal(kg, kg2), name
        if not cfg.oriented and name in ("angle", "ratio"):
            continue
        scale = float(pg.abs().max()) + 1e-12
        assert float((kg - pg).abs().max()) / scale < grad_tol, name


def test_backward_rerun_is_bit_equal(cuda):
    """The backward kernel alone, twice on one stream with many multi-chunk
    tiles: the same bits; and it refuses residuals of another shape than
    the stream's."""
    from splat_renderer_tpu_torch.ops.tile_blend_diff import diff_backward, diff_forward
    from splat_renderer_tpu_torch.render.binning import bin_planes_diff

    cfg = tpt.RenderConfig(width=200, height=120, tiles_per_splat_cap=8)
    planes, names = _random_planes(cuda, cfg, 6000)
    binned = bin_planes_diff({k: p.detach() for k, p in zip(names, planes)}, cfg)
    assert int(binned["counts"].max()) > 64
    g = torch.Generator(device=cuda).manual_seed(5)
    shapes = [(cfg.num_tiles, cfg.tile_pixels, 3), (cfg.num_tiles, cfg.tile_pixels),
              (cfg.num_tiles, cfg.tile_pixels)]
    cots = [torch.rand(s, generator=g, device=cuda) - 0.5 for s in shapes]
    *outs, t_start = diff_forward(binned, cfg, residuals=True)
    plain = diff_forward(binned, cfg)
    with pytest.raises(ValueError, match="residuals"):
        diff_backward(binned, cfg, cots, t_start[:-1])
    a = diff_backward(binned, cfg, cots, t_start)
    b = diff_backward(binned, cfg, cots, t_start)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0
    for x, y in zip(outs, plain):  # the residual output leaves the forward's as they were
        assert torch.equal(x, y)


ODD_TILES = {
    "32x32": dict(tile_size=32),                  # 1024-thread blocks: the smaller batches
    "12x12": dict(tile_size=12),                  # no 8x4 blocks: row-major warps, a padded block
    "24x8": dict(tile_size=24, tile_height=8),    # three 8x4 blocks a row
}


@pytest.mark.parametrize("tiles", sorted(ODD_TILES))
@pytest.mark.parametrize("profile", ["isotropic", "oriented", "quad"])
def test_blend_kernels_on_uncommon_tile_shapes(cuda, profile, tiles):
    """Both schedules, with depth, against the twin on the tile shapes that
    take the kernels' other paths."""
    cfg = tpt.RenderConfig(width=200, height=120, tiles_per_splat_cap=8,
                           **PROFILES[profile], **ODD_TILES[tiles])
    binned = _binned(cuda, cfg, n=20000, with_depth=True)
    plain = blend_tiles_plain(binned, cfg, eps=0.0, with_depth=True)
    d = binned["rec_depth"].view(torch.float32)
    d_range = float(d[torch.isfinite(d)].max())
    for eps in (0.0, 0.01):
        k1 = blend_tiles(binned, cfg, eps=eps, with_depth=True)
        k3 = blend_tiles(binned, cfg, eps=eps, schedule="tile_xp", with_depth=True)
        torch.cuda.synchronize()
        for x, y in zip(k1, k3):
            assert torch.equal(x, y), eps
        tol = 2e-5 if eps == 0.0 else 0.0101
        assert float((k1[0] - plain[0]).abs().max()) <= tol
        assert float((k1[1] - plain[1]).abs().max()) <= tol
        if eps == 0.0:
            assert float((k1[2] - plain[2]).abs().max()) <= 2e-5 * d_range
    c0, a0 = blend_tiles(binned, cfg, eps=0.0)
    assert torch.equal(c0, blend_tiles(binned, cfg, eps=0.0, with_depth=True)[0])
    assert float(a0.max()) > 0


@pytest.mark.parametrize("tiles", ["32x32", "16x6"])
@pytest.mark.parametrize("profile", sorted(DIFF_PROFILES))
def test_diff_kernels_on_uncommon_tile_shapes(cuda, profile, tiles):
    """1024-pixel tiles (8-record backward chunks, one record per adjoint
    batch) and a tile without 8x4 blocks (row-major warps)."""
    from splat_renderer_tpu_torch.ops.tile_blend_diff import (
        blend_planes, blend_planes_plain, bwd_chunk,
    )

    prof, grad_tol = DIFF_PROFILES[profile]
    shape = dict(tile_size=32) if tiles == "32x32" else dict(tile_size=16, tile_height=6)
    cfg = tpt.RenderConfig(width=192, height=96, tiles_per_splat_cap=8, **prof, **shape)
    assert bwd_chunk(cfg) == (8 if tiles == "32x32" else 32)
    planes, names = _random_planes(cuda, cfg, 3000)
    g = torch.Generator(device=cuda).manual_seed(4)
    shapes = [(cfg.num_tiles, cfg.tile_pixels, 3), (cfg.num_tiles, cfg.tile_pixels),
              (cfg.num_tiles, cfg.tile_pixels)]
    cots = [torch.rand(s, generator=g, device=cuda) - 0.5 for s in shapes]
    k_out, k_grads = _blend_and_grads(blend_planes, cfg, planes, cots)
    p_out, p_grads = _blend_and_grads(blend_planes_plain, cfg, planes, cots)
    _, k_grads2 = _blend_and_grads(blend_planes, cfg, planes, cots)
    torch.cuda.synchronize()
    for k, p in zip(k_out, p_out):
        assert float((k - p).abs().max()) <= 2e-5
    for name, kg, pg, kg2 in zip(names, k_grads, p_grads, k_grads2):
        assert torch.equal(kg, kg2), name
        if not cfg.oriented and name in ("angle", "ratio"):
            continue
        scale = float(pg.abs().max()) + 1e-12
        assert float((kg - pg).abs().max()) / scale < grad_tol, name


# ---- the forward kernel's residual, its exact-zero stop and deep tiles ----

RESIDUAL_TILES = {
    "16x16": dict(tile_size=16),                  # 32-record chunks
    "32x16": dict(tile_size=32, tile_height=16),  # 16-record chunks
    "32x32": dict(tile_size=32),                  # 8-record chunks, 1024-thread blocks
    "16x6": dict(tile_size=16, tile_height=6),    # row-major warps
}


def _deep_planes(device, cfg, n=3000, n_deep=600, seed=0):
    """`_random_planes` and a pile of wide opacity-1 records over the square
    [24, 56]^2: the pixels under it end at T exactly 0, so warps leave."""
    from splat_renderer_tpu_torch.ops.tile_blend_diff import _PLANE_NAMES

    planes, _ = _random_planes(device, cfg, n, seed)
    rng = np.random.default_rng(seed + 100)
    deep = [rng.uniform(24, 56, n_deep), rng.uniform(24, 56, n_deep),
            rng.uniform(8.0, 14.0, n_deep), np.ones(n_deep), rng.uniform(0, 1, n_deep),
            rng.uniform(0, 1, n_deep), rng.uniform(0, 1, n_deep),
            rng.uniform(-np.pi, np.pi, n_deep), rng.uniform(0.5, 1.0, n_deep),
            rng.uniform(1, 10, n_deep)]
    return [torch.cat([p.detach(), torch.tensor(d, dtype=torch.float32, device=device)])
            .requires_grad_(True) for p, d in zip(planes, deep)], _PLANE_NAMES


@pytest.mark.parametrize("tiles", sorted(RESIDUAL_TILES))
@pytest.mark.parametrize("profile", sorted(DIFF_PROFILES))
def test_forward_residual_matches_its_mirror(cuda, profile, tiles):
    """K4's chunk-start T against `diff_residuals_plain` within 2e-5 in every
    row a tile uses; once all 32 pixels of a warp are at 0 (the warp left),
    every later row of that warp is exactly 0, written, not left over."""
    from splat_renderer_tpu_torch.ops.tile_blend import warp_pixels
    from splat_renderer_tpu_torch.ops.tile_blend_diff import (
        bwd_chunk, diff_fold_plain, diff_forward, residual_row0, residual_rows,
        residual_rows_used,
    )
    from splat_renderer_tpu_torch.render.binning import bin_planes_diff

    prof, _ = DIFF_PROFILES[profile]
    cfg = tpt.RenderConfig(width=192, height=96, tiles_per_splat_cap=16, **prof,
                           **RESIDUAL_TILES[tiles])
    bc = bwd_chunk(cfg)
    planes, names = _deep_planes(cuda, cfg)
    binned = bin_planes_diff({k: p.detach() for k, p in zip(names, planes)}, cfg)
    # the caching allocator hands the freed block to the residual: a row the
    # kernel does not write stays NaN
    junk = torch.full((residual_rows(binned, cfg, bc), cfg.tile_pixels), float("nan"),
                      device=cuda)
    del junk
    *outs, t_start = diff_forward(binned, cfg, residuals=True)
    *p_outs, p_start = diff_fold_plain(binned, cfg, bc)
    torch.cuda.synchronize()
    used = residual_rows_used(binned, bc)
    assert bool(torch.isfinite(t_start[used]).all())
    assert float((t_start[used] - p_start[used]).abs().max()) <= 2e-5
    for k, p in zip(outs, p_outs):
        assert float((k - p).abs().max()) <= 2e-5
    lanes = warp_pixels(cfg).to(cuda)
    row0 = residual_row0(binned, bc).tolist()
    left = 0
    for t, cnt in enumerate(binned["counts"].tolist()):
        if cnt == 0:
            continue
        block = t_start[row0[t]:row0[t] + (cnt + bc - 1) // bc][:, lanes]  # (chunks, warps, 32)
        gone = (block == 0.0).all(-1).int()  # (chunks, warps)
        assert bool((gone[1:] >= gone[:-1]).all()), t  # a warp that left stays gone
        left += int(gone.amax(0).sum())
    assert left > 0  # some warps did leave


def _deep_tile_planes(device, n=400):
    """One 16x16 tile under n opacity-1 records wide enough to reach all of
    it: every pixel's T underflows to exactly 0."""
    from splat_renderer_tpu_torch.ops.tile_blend_diff import _PLANE_NAMES

    rng = np.random.default_rng(5)
    cols = [rng.uniform(0, 16, n), rng.uniform(0, 16, n), rng.uniform(8.0, 16.0, n),
            np.ones(n), rng.uniform(0, 1, n), rng.uniform(0, 1, n), rng.uniform(0, 1, n),
            rng.uniform(-np.pi, np.pi, n), rng.uniform(0.5, 1.0, n), rng.uniform(1, 9, n)]
    return [torch.tensor(c, dtype=torch.float32, device=device).requires_grad_(True)
            for c in cols], _PLANE_NAMES


@pytest.mark.parametrize("profile", sorted(DIFF_PROFILES))
def test_deep_tile_kernels_match_twin(cuda, profile):
    """Where every pixel stops at T == 0: K4 against the twin within 2e-5,
    K5's gradients within the gates, two backward runs bit-equal."""
    from splat_renderer_tpu_torch.ops.tile_blend_diff import (
        blend_planes, blend_planes_plain, diff_forward,
    )
    from splat_renderer_tpu_torch.render.binning import bin_planes_diff

    prof, grad_tol = DIFF_PROFILES[profile]
    cfg = tpt.RenderConfig(width=16, height=16, **prof)
    planes, names = _deep_tile_planes(cuda)
    binned = bin_planes_diff({k: p.detach() for k, p in zip(names, planes)}, cfg)
    *_, t_start = diff_forward(binned, cfg, residuals=True)
    assert binned["counts"].tolist() == [400]
    assert bool((t_start[400 // 32] == 0.0).all())  # every pixel stopped before the last chunk
    g = torch.Generator(device=cuda).manual_seed(6)
    shapes = [(1, 256, 3), (1, 256), (1, 256)]
    cots = [torch.rand(s, generator=g, device=cuda) - 0.5 for s in shapes]
    k_out, k_grads = _blend_and_grads(blend_planes, cfg, planes, cots)
    p_out, p_grads = _blend_and_grads(blend_planes_plain, cfg, planes, cots)
    _, k_grads2 = _blend_and_grads(blend_planes, cfg, planes, cots)
    torch.cuda.synchronize()
    for k, p in zip(k_out, p_out):
        assert float((k - p).abs().max()) <= 2e-5
    for name, kg, pg, kg2 in zip(names, k_grads, p_grads, k_grads2):
        assert torch.equal(kg, kg2), name
        if not cfg.oriented and name in ("angle", "ratio"):
            continue
        scale = float(pg.abs().max()) + 1e-12
        assert float((kg - pg).abs().max()) / scale < grad_tol, name


@pytest.mark.parametrize("profile", ["isotropic", "oriented"])
@pytest.mark.parametrize("shape", [(256, 128), (64, 1600)], ids=["landscape", "portrait"])
def test_tile_bands_bit_equal_to_the_frame(cuda, shape, profile):
    """`parallel.render_band`'s bands of sp 2 and 4, stacked, equal the
    frame K1 blends, bit for bit: the kernel blends each tile from its run
    alone, and a band's runs are the frame's (footprints cut by the band's
    edges and shrunk by the tile cap included; the portrait's bands sit on
    a grid twice as fine as the frame's)."""
    from splat_renderer_tpu_torch.parallel import render_band
    from splat_renderer_tpu_torch.render.compositor import tiles_to_image

    width, height = shape
    cfg = tpt.RenderConfig(width=width, height=height, tiles_per_splat_cap=4,
                           **PROFILES[profile])
    rng = np.random.default_rng(9)
    n = 6000
    pos = rng.uniform(-1, 1, (n, 3))
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    planes = {"px": pos[:, 0], "py": pos[:, 1], "pz": pos[:, 2],
              "radius": rng.uniform(0.005, 0.12, n), "cr": rng.uniform(0, 1, n),
              "cg": rng.uniform(0, 1, n), "cb": rng.uniform(0, 1, n),
              "opacity": rng.uniform(0.2, 1.0, n),
              "nx": nrm[:, 0], "ny": nrm[:, 1], "nz": nrm[:, 2]}
    spl = splats_from_numpy(planes, cuda)
    cam = camera_tensors(tpt.Camera(aspect=width / height).arrays(), cuda)
    w = splat_screen_words(spl, cam["view_proj"], cam["cam_pos"], cfg)
    words = [w[k] for k in ("dk", "w_pos", "w_ro", "w_rgb")]
    frame = tiles_to_image(*blend_tiles(bin_packed_words(*words, cfg), cfg), cfg)
    for sp in (2, 4):
        bands = torch.cat([render_band(w, b, cfg, sp) for b in range(sp)])
        assert torch.equal(bands[:height], frame), sp
