"""The PyTorch port's whole slice (modeler -> words -> bins -> tile blend ->
image) and its Engine, against the JAX package on the same state."""

import jax
import numpy as np
import pytest
import torch

import splat_renderer_tpu as spt
from splat_renderer_tpu.points import seed_scene_points as j_seed
from splat_renderer_tpu.render.pipeline import (
    model_points as j_model_points,
    render_frame as j_render_frame,
    render_splats as j_render_splats,
)
import splat_renderer_tpu_torch as tpt
from splat_renderer_tpu_torch.camera import camera_tensors
from splat_renderer_tpu_torch.convert import (
    camera_from_numpy,
    params_from_numpy,
    points_from_numpy,
    splats_from_numpy,
)
from splat_renderer_tpu_torch.render.pipeline import (
    Engine,
    animate_demo,
    demo_scene,
    model_points,
    render_frame,
    render_splats,
    surface_splats,
)

W, H = 64, 48
CONFIGS = {
    "default": dict(base_radius=0.05, tiles_per_splat_cap=8),
    "surface": dict(base_radius=0.05, tiles_per_splat_cap=8, opaque=True,
                    oriented=True, color_mode="normal_signed", light_ambient=0.3,
                    light_diffuse=0.7),
    "32x16": dict(base_radius=0.04, tiles_per_splat_cap=4, tile_size=32,
                  tile_height=16),
}


def _scene(mod):
    s1 = mod.Sphere(id="sphere1", position=(0, 0, 0), radius=0.5)
    b1 = mod.Box(id="box1", position=(0.6, 0, 0), size=(0.3, 0.3, 0.3))
    s2 = mod.Sphere(id="sphere2", position=(0, 0.6, 0), radius=0.25)
    scene = mod.SDFScene(mod.smooth_union(0.1, mod.smooth_union(0.15, s1, b1), s2))
    for i, op in enumerate(scene.operations()):  # pin per-package op ids
        op.id = f"op{i}"
    return scene


def _cams():
    arrays = spt.Camera(aspect=W / H, azimuth=0.7, elevation=0.3).arrays()
    return {k: jax.numpy.asarray(v) for k, v in arrays.items()}, camera_from_numpy(arrays, "cpu")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_slice_from_jax_splats_matches_jax_oracle(name):
    kw = dict(width=W, height=H, **CONFIGS[name])
    jc, tc = spt.RenderConfig(**kw), tpt.RenderConfig(**kw)
    scene = _scene(spt)
    # both packages render these same splats, so JAX may model them jitted
    jspl = jax.jit(lambda p, k: j_model_points(scene, p, k, 1500, spt.PointConfig(), jc))(
        scene.params(), jax.random.PRNGKey(0))
    jcam, tcam = _cams()
    want = np.asarray(j_render_splats(jspl, jcam, jc, "oracle"))
    tspl = splats_from_numpy({k: np.asarray(v) for k, v in jspl.items()}, "cpu")
    got = render_splats(tspl, tcam, tc, blend_eps=0.0, device="cpu").numpy()
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    # the port's own oracle agrees too
    own = render_splats(tspl, tcam, tc, "oracle", device="cpu").numpy()
    np.testing.assert_allclose(own, want, atol=2e-5, rtol=0)


def test_slice_from_jax_seeds_matches_jax_frame():
    """Modeler and splat chain in both packages from the same JAX seeds.
    Float ulps in the modeler can move a record by one grid step, so the
    image is held by its mean (1e-4); the max is reported, not gated."""
    kw = dict(width=W, height=H, **CONFIGS["default"])
    jc, tc = spt.RenderConfig(**kw), tpt.RenderConfig(**kw)
    pcfg_j, pcfg_t = spt.PointConfig(), tpt.PointConfig()
    scene = _scene(spt)
    key = jax.random.PRNGKey(5)
    jcam, tcam = _cams()
    want = np.asarray(j_render_frame(scene, scene.params(), jcam, key, 1500,
                                     pcfg_j, jc, compositor="tiles"))
    seeds = np.asarray(j_seed(key, scene, scene.params(), 1500, pcfg_j))
    tscene = _scene(tpt)
    tparams = params_from_numpy(scene.params(), "cpu")
    spl = surface_splats(tscene, tparams, points_from_numpy(seeds, "cpu"), pcfg_t, tc)
    got = render_splats(spl, tcam, tc, blend_eps=0.0, device="cpu").numpy()
    diff = np.abs(got - want)
    print(f"seeded slice: mean-abs {diff.mean():.3g}, max-abs {diff.max():.3g}")
    assert diff.mean() <= 1e-4


def _engine_setup():
    scene = demo_scene()
    rcfg = tpt.RenderConfig(width=W, height=H, base_radius=0.05, tiles_per_splat_cap=8)
    cam = camera_tensors(tpt.Camera(aspect=W / H).arrays(), "cpu")
    return scene, rcfg, cam


def test_engine_frame_equals_render_frame():
    scene, rcfg, cam = _engine_setup()
    eng = Engine(scene, tpt.PointConfig(), rcfg, n=1200, device="cpu")
    img = eng.frame(cam, torch.Generator().manual_seed(3))
    ref = render_frame(scene, scene.params("cpu"), cam, torch.Generator().manual_seed(3),
                       1200, tpt.PointConfig(), rcfg, device="cpu")
    np.testing.assert_array_equal(img.numpy(), ref.numpy())
    assert img.shape == (H, W, 3)


def test_engine_animation_keeps_structure_state():
    scene, rcfg, cam = _engine_setup()
    eng = Engine(scene, tpt.PointConfig(), rcfg, device="cpu")
    h, n = scene.structure_hash(), eng.n
    first = eng.frame(cam, torch.Generator().manual_seed(0))
    animate_demo(scene, 1.3)
    second = eng.frame(cam, torch.Generator().manual_seed(0))
    assert scene.structure_hash() == h
    assert float((first - second).abs().max()) > 0.05  # the image moved
    assert len(eng._n_by_structure) == 1 and eng.n == n  # budget fixed per structure
    scene.set_root(tpt.Sphere(id="solo", radius=0.4))
    eng.frame(cam, torch.Generator().manual_seed(0))
    assert len(eng._n_by_structure) == 2 and scene.structure_hash() != h


def test_entry_points_check_devices():
    scene, rcfg, cam = _engine_setup()
    g = torch.Generator().manual_seed(0)
    spl = model_points(scene, scene.params("cpu"), g, 200, tpt.PointConfig(), rcfg,
                       device="cpu")
    with pytest.raises(ValueError, match="expected"):
        render_splats(spl, cam, rcfg, device="meta")
    with pytest.raises(ValueError, match="expected"):
        model_points(scene, scene.params("cpu"), g, 200, tpt.PointConfig(), rcfg,
                     device="meta")
    with pytest.raises(ValueError, match="compositor"):
        render_splats(spl, cam, rcfg, compositor="tiles", device="cpu")
    with pytest.raises(TypeError):
        Engine(scene, tpt.PointConfig(), rcfg)  # no default device
