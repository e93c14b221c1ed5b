"""The PyTorch port's SDF primitives, CSG ops and scene against the JAX
package's: the same numpy points through both, distance and gradient within
1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splat_renderer_tpu.sdf as jsdf
import splat_renderer_tpu_torch.sdf as tsdf

ATOL = 1e-6


def _points(seed, n=2000, scale=1.2):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    # axis-aligned and degenerate points exercise the select branches
    pts[:8] = 0.0
    pts[8:16, 0] = 0.0
    pts[16:24, 1:] = 0.0
    return pts


def _close(j, t):
    np.testing.assert_allclose(np.asarray(j[0]), t[0].numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.asarray(j[1]), t[1].numpy(), atol=ATOL, rtol=0)


_PRIMS = {
    "sphere": ("sdg_sphere", (np.float32(0.5),)),
    "box": ("sdg_box", (np.array([0.3, 0.5, 0.2], np.float32),)),
    "torus": ("sdg_torus", (np.float32(0.5), np.float32(0.2))),
    "capsule": ("sdg_capsule", (np.float32(1.0), np.float32(0.3))),
    "cylinder": ("sdg_cylinder", (np.float32(0.8), np.float32(0.4))),
    "ellipsoid": ("sdg_ellipsoid", (np.array([0.5, 0.3, 0.4], np.float32),)),
    "round_box": ("sdg_round_box", (np.array([0.5, 0.4, 0.3], np.float32),
                                    np.float32(0.1))),
}


@pytest.mark.parametrize("name", sorted(_PRIMS))
def test_primitive_matches_jax(name):
    fn, args = _PRIMS[name]
    p = _points(1)
    j = getattr(jsdf, fn)(jnp.asarray(p), *(jnp.asarray(a) for a in args))
    t = getattr(tsdf, fn)(torch.from_numpy(p), *(torch.from_numpy(np.asarray(a)) for a in args))
    _close(j, t)


_OPS = ["op_union", "op_intersection", "op_subtraction", "op_smooth_union",
        "op_smooth_intersection", "op_smooth_subtraction"]


@pytest.mark.parametrize("op", _OPS)
def test_op_matches_jax(op):
    p = _points(2)
    ja = jsdf.sdg_sphere(jnp.asarray(p), jnp.float32(0.5))
    jb = jsdf.sdg_box(jnp.asarray(p - 0.3), jnp.asarray([0.3, 0.3, 0.3], jnp.float32))
    ta = tsdf.sdg_sphere(torch.from_numpy(p), torch.tensor(0.5))
    tb = tsdf.sdg_box(torch.from_numpy(p - 0.3), torch.tensor([0.3, 0.3, 0.3]))
    extra = (0.15,) if "smooth" in op else ()
    j = getattr(jsdf, op)(ja, jb, *(jnp.float32(k) for k in extra))
    t = getattr(tsdf, op)(ta, tb, *(torch.tensor(k) for k in extra))
    _close(j, t)


def _scene(mod):
    return mod.SDFScene(
        mod.smooth_union(
            0.1,
            mod.subtraction(
                mod.union(mod.Sphere(id="s", radius=0.5),
                          mod.Torus(id="t", position=(0.2, 0.1, 0.0))),
                mod.Capsule(id="c", position=(0.0, 0.3, 0.2)),
            ),
            mod.smooth_intersection(
                0.05,
                mod.Cylinder(id="y", position=(0.5, 0, 0)),
                mod.smooth_subtraction(
                    0.08,
                    mod.Ellipsoid(id="e", position=(0.4, 0.1, 0)),
                    mod.RoundBox(id="r", position=(0.6, 0, 0.1), size=(0.2, 0.2, 0.2)),
                ),
            ),
        )
    )


def test_scene_sdf_params_hash_and_bounds_match():
    js, ts = _scene(jsdf), _scene(tsdf)
    assert js.structure_hash() == ts.structure_hash()
    jp, tp = js.params(), ts.params("cpu")
    for prim in js.primitives():
        for k, v in jp[prim.id].items():
            np.testing.assert_array_equal(np.asarray(v), tp[prim.id][k].numpy())
    p = _points(3)
    jd, jg = js.sdf(jnp.asarray(p), jp)
    td, tg = ts.sdf(torch.from_numpy(p), tp)
    _close((jd, jg), (td, tg))
    jlo, jhi = js.seeding_aabb(jp, 1.5)
    tlo, thi = ts.seeding_aabb(tp, "cpu", 1.5)
    np.testing.assert_allclose(np.asarray(jlo), tlo.numpy(), atol=ATOL)
    np.testing.assert_allclose(np.asarray(jhi), thi.numpy(), atol=ATOL)
    # (7, N, 3) batches evaluate like flat ones
    td7, _ = ts.sdf(torch.from_numpy(p).reshape(10, 200, 3), tp)
    np.testing.assert_array_equal(td7.reshape(-1).numpy(), td.numpy())


def test_scene_params_follow_animation():
    ts = _scene(tsdf)
    before = ts.params("cpu")["s"]["center"].clone()
    h = ts.structure_hash()
    ts["s"].position[0] = 0.25
    after = ts.params("cpu")["s"]["center"]
    assert after[0] == pytest.approx(0.25) and before[0] == 0.0
    assert ts.structure_hash() == h
