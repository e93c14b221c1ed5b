"""The PyTorch port's modeler (seeding, projection, curvature, splat
properties) against the JAX package's.  Seeding draws from different
generators, so it is held statistically; every later stage gets the points
JAX seeded and is held within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splat_renderer_tpu as spt
from splat_renderer_tpu.points import (
    curvature_probe as j_curvature,
    derive_splats as j_derive,
    point_count as j_point_count,
    project_to_surface as j_project,
    seed_scene_points as j_seed,
)
import splat_renderer_tpu_torch as tpt
from splat_renderer_tpu_torch.convert import params_from_numpy, points_from_numpy
from splat_renderer_tpu_torch.points import (
    curvature_probe,
    derive_splats,
    point_count,
    project_to_surface,
    seed_points,
    seed_scene_points,
)

ATOL = 1e-5


def _scene(mod):
    s1 = mod.Sphere(id="sphere1", position=(0, 0, 0), radius=0.5)
    b1 = mod.Box(id="box1", position=(0.6, 0, 0), size=(0.3, 0.3, 0.3))
    s2 = mod.Sphere(id="sphere2", position=(0, 0.6, 0), radius=0.25)
    scene = mod.SDFScene(mod.smooth_union(0.1, mod.smooth_union(0.15, s1, b1), s2))
    # operation ids come from per-package counters; pin them so parameters
    # converted from one package address the other's operations
    for i, op in enumerate(scene.operations()):
        op.id = f"op{i}"
    return scene


@pytest.fixture(scope="module")
def jax_state():
    scene = _scene(spt)
    params = scene.params()
    pts = j_seed(jax.random.PRNGKey(3), scene, params, 3000, spt.PointConfig())
    return scene, params, np.asarray(pts)


def test_point_count_matches():
    for pc in (tpt.PointConfig(), tpt.PointConfig(points_per_primitive=100,
                                                  min_points=10, max_points=10**6)):
        jp = spt.PointConfig(**{k: getattr(pc, k) for k in pc.__dataclass_fields__})
        assert point_count(_scene(tpt), pc) == j_point_count(_scene(spt), jp)


def test_seeding_is_area_proportional_on_the_box_surface():
    lo = torch.tensor([-1.0, -0.5, -0.25])
    hi = torch.tensor([1.0, 0.5, 0.75])
    n = 40_000
    g = torch.Generator().manual_seed(0)
    pts = seed_points(g, lo, hi, n)
    assert pts.shape == (n, 3) and pts.dtype == torch.float32
    on_lo = (pts - lo).abs() < 1e-6
    on_hi = (pts - hi).abs() < 1e-6
    inside = (pts >= lo - 1e-6).all(1) & (pts <= hi + 1e-6).all(1)
    assert bool(inside.all()) and bool((on_lo | on_hi).any(1).all())
    d = (hi - lo).numpy().astype(np.float64)
    area = np.array([d[1] * d[2], d[0] * d[2], d[0] * d[1]])
    share = np.repeat(area / (2 * area.sum()), 2)  # -X +X -Y +Y -Z +Z
    counts = np.array([int(on_lo[:, a].sum()) if s == 0 else int(on_hi[:, a].sum())
                       for a in range(3) for s in (0, 1)])
    sigma = np.sqrt(share * (1 - share) / n)
    assert np.all(np.abs(counts / n - share) <= 3 * sigma), (counts / n, share)


def test_seed_scene_points_uses_the_grown_aabb(jax_state):
    scene, params, jpts = jax_state
    ts = _scene(tpt)
    g = torch.Generator().manual_seed(1)
    pts = seed_scene_points(g, ts, ts.params("cpu"), 3000, tpt.PointConfig())
    lo, hi = scene.seeding_aabb(params, 1.5)
    for a in (pts.numpy(), jpts):  # both packages seed the same box
        np.testing.assert_allclose(a.min(0), np.asarray(lo), atol=0.05)
        np.testing.assert_allclose(a.max(0), np.asarray(hi), atol=0.05)


@pytest.mark.parametrize("steps", [1, 5])
def test_projection_matches_jax_on_jax_seeds(jax_state, steps):
    scene, params, jpts = jax_state
    want = np.asarray(j_project(scene, params, jnp.asarray(jpts), steps))
    got = project_to_surface(_scene(tpt), params_from_numpy(params, "cpu"),
                             points_from_numpy(jpts, "cpu"), steps)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("color_mode", ["normal_abs", "normal_signed"])
def test_curvature_and_splats_match_jax(jax_state, color_mode):
    scene, params, jpts = jax_state
    pcfg = spt.PointConfig()
    settled = j_project(scene, params, jnp.asarray(jpts), pcfg.descent_steps)
    jn, js = j_curvature(scene, params, settled, pcfg)
    jspl = j_derive(settled, jn, js, spt.RenderConfig(color_mode=color_mode))

    tparams = params_from_numpy(params, "cpu")
    tsettled = points_from_numpy(np.asarray(settled), "cpu")
    tn, tsc = curvature_probe(_scene(tpt), tparams, tsettled, tpt.PointConfig())
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(js), atol=ATOL, rtol=0)
    tspl = derive_splats(tsettled, tn, tsc, tpt.RenderConfig(color_mode=color_mode))
    assert sorted(tspl) == sorted(jspl)
    for k in jspl:
        np.testing.assert_allclose(tspl[k].numpy(), np.asarray(jspl[k]),
                                   atol=ATOL, rtol=0, err_msg=k)
