"""The turbo binner profiles of the PyTorch port (`fast_math`,
`depth_key_order`, `turbo_render_config`) against the JAX package, on
`tests/test_render.py::TestTurboProfile`'s scene: 96x96, 3000 splats that
the JAX modeler made, injected into both packages.

The port's pair key is an int64 `(tile << 32) | depth key`, sorted stably
over records in input order, so it bins in the exact (depth key, input
index) order whatever the flags say: `fast_math` and `depth_key_order`
alone each give the exact frame bit for bit.  The turbo preset's image
differs from the exact one only by its bounds_margin of 1.3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splat_renderer_tpu as spt
from splat_renderer_tpu.ops.tile_blend import render_tiles_pallas
from splat_renderer_tpu.render.binning import bin_packed_words as j_bin_packed_words
from splat_renderer_tpu.render.pipeline import model_points as j_model_points
from splat_renderer_tpu.render.pipeline import render_splats as j_render_splats
from splat_renderer_tpu.render.projector import splat_screen_words as j_words
from splat_renderer_tpu.utils.ssim import ssim as j_ssim
import splat_renderer_tpu_torch as tpt
from splat_renderer_tpu_torch.convert import camera_from_numpy, splats_from_numpy
from splat_renderer_tpu_torch.render.binning import bin_packed_words, canonical_order
from splat_renderer_tpu_torch.render.pipeline import render_splats

SIZE, N = 96, 3000
KW = dict(base_radius=0.04, tiles_per_splat_cap=9)


@pytest.fixture(scope="module")
def scene_splats():
    scene = spt.SDFScene(
        spt.smooth_union(0.1, spt.Sphere(id="a", radius=0.5),
                         spt.Box(id="b", position=(0.6, 0, 0), size=(0.3, 0.3, 0.3))))
    exact = spt.RenderConfig(width=SIZE, height=SIZE, **KW)
    jspl = jax.jit(lambda p, k: j_model_points(scene, p, k, N, spt.PointConfig(), exact))(
        scene.params(), jax.random.PRNGKey(0))
    arrays = spt.Camera(aspect=1.0).arrays()
    jcam = {k: jnp.asarray(v) for k, v in arrays.items()}
    tspl = splats_from_numpy({k: np.asarray(v) for k, v in jspl.items()}, "cpu")
    return jspl, jcam, tspl, camera_from_numpy(arrays, "cpu")


def _port(tspl, tcam, cfg, **kw):
    return render_splats(tspl, tcam, cfg, device="cpu", **kw)


def test_turbo_frame_quality_and_own_oracle(scene_splats):
    jspl, jcam, tspl, tcam = scene_splats
    turbo = tpt.turbo_render_config(SIZE, SIZE, **KW)
    assert turbo.fast_math and turbo.depth_key_order and turbo.bounds_margin == 1.3
    want = j_render_splats(jspl, jcam, spt.RenderConfig(width=SIZE, height=SIZE, **KW),
                           "tiles")
    img = _port(tspl, tcam, turbo)
    assert img.shape == (SIZE, SIZE, 3) and bool(torch.isfinite(img).all())
    assert float(j_ssim(jnp.asarray(img.numpy()), want)) > 0.985
    # with the early exit off the packed-word path composites every
    # record, as the sequential oracle does at the same (turbo) config
    exact_blend = _port(tspl, tcam, turbo, blend_eps=0.0).numpy()
    oracle = _port(tspl, tcam, turbo, compositor="oracle").numpy()
    np.testing.assert_allclose(exact_blend, oracle, atol=3e-5, rtol=0)


@pytest.mark.parametrize("flag", ["fast_math", "depth_key_order"])
def test_each_turbo_flag_alone_is_the_exact_frame(scene_splats, flag):
    _, _, tspl, tcam = scene_splats
    exact = tpt.RenderConfig(width=SIZE, height=SIZE, **KW)
    assert torch.equal(_port(tspl, tcam, exact.replace(**{flag: True})),
                       _port(tspl, tcam, exact))


def test_fast_math_frame_matches_jax_fast_math_kernel(scene_splats):
    jspl, jcam, tspl, tcam = scene_splats
    jc = spt.RenderConfig(width=SIZE, height=SIZE, fast_math=True, **KW)
    w = j_words(jspl, jcam["view_proj"], jcam["cam_pos"], jc)
    binned = j_bin_packed_words(w["dk"], w["w_pos"], w["w_ro"], w["w_rgb"], jc, 1024)
    want = np.asarray(render_tiles_pallas(None, binned, jc, block=1024, eps=0.0,
                                          interpret=True, kernel="tile"))
    got = _port(tspl, tcam, tpt.RenderConfig(width=SIZE, height=SIZE, fast_math=True, **KW),
                blend_eps=0.0).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("tiles", [dict(), dict(tile_size=32, tile_height=16)])
def test_depth_key_order_runs_equal_the_exact_runs(tiles):
    """Per tile, the depth-keyed pair sort over records in input order
    yields the records of a stream binned after a record sort, in the same
    order, also where depth keys tie (400 records share 40 keys here): the
    stable sort breaks ties by input index, as the record sort does.  The
    depth_key_order flag changes no output."""
    g = np.random.default_rng(3)
    n = 400
    cfg = tpt.RenderConfig(width=64, height=48, tiles_per_splat_cap=4, **tiles)
    fx = lambda px: np.round((px + cfg.pos_offset) * cfg.pos_scale).astype(np.int64)
    cx, cy = fx(g.uniform(0, 64, n)), fx(g.uniform(0, 48, n))
    r = fx(g.uniform(2.0, 9.0, n) - cfg.pos_offset)
    dk = (0x80000000 | g.integers(0, 40, n) << 16).astype(np.int64)
    dk[g.random(n) < 0.05] = 0xFF800000  # culled records: no pairs
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    words = (t(dk), t(cx | cy << 16), t(r), t(g.integers(0, 1 << 31, n)))
    got = bin_packed_words(*words, cfg)
    flagged = bin_packed_words(*words, cfg.replace(depth_key_order=True))
    for k, v in got.items():
        assert torch.equal(flagged[k], v), k
    order = canonical_order(words[0])
    assert not torch.equal(order, torch.arange(n))
    ex = bin_packed_words(*(w[order] for w in words), cfg)
    assert torch.equal(got["offsets"], ex["offsets"])
    live = int(ex["offsets"][-1])
    assert live > n  # footprints span several tiles
    assert torch.equal(got["pair_rank"][:live].long(), order[ex["pair_rank"][:live].long()])
    for k in ("rec_pos", "rec_ro", "rec_rgb"):
        assert torch.equal(got[k][got["pair_rank"][:live].long()],
                           ex[k][ex["pair_rank"][:live].long()])
