"""Mesh export of the PyTorch port (`sdf/mesh.py`, surface nets) on the CPU:
`tests/test_mesh.py`'s invariants (geometry on the zero set, watertight
2-manifolds with the right Euler characteristic, outward winding, normals
along the SDF gradient, the OBJ round trip, animation), and the port's mesh
against the JAX package's `extract_mesh` on the same scene."""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splat_renderer_tpu as spt
from splat_renderer_tpu.sdf import mesh as j_mesh
import splat_renderer_tpu_torch as tpt
from splat_renderer_tpu_torch.sdf import extract_mesh, save_obj
from splat_renderer_tpu_torch.sdf import mesh as t_mesh


def _edge_counts(faces):
    c = Counter()
    for t in faces:
        for a, b in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            c[(min(a, b), max(a, b))] += 1
    return c


def _checks(scene, resolution):
    params = scene.params("cpu")
    m = extract_mesh(scene, params, resolution=resolution)
    V, F, N = m["vertices"], m["faces"], m["normals"]
    assert V.shape[1] == 3 and F.shape[1] == 3 and N.shape == V.shape
    assert F.min() >= 0 and F.max() < len(V)
    d = scene.sdf(torch.from_numpy(V), params)[0].numpy()
    edges = _edge_counts(F)
    chi = len(V) - len(edges) + len(F)
    return m, d, edges, chi


def test_sphere_geometry_topology_orientation():
    scene = tpt.SDFScene(tpt.Sphere(id="s", radius=0.5))
    m, d, edges, chi = _checks(scene, 32)
    V, F, N = m["vertices"], m["faces"], m["normals"]
    assert np.abs(d).max() < 1e-4
    assert np.abs(np.linalg.norm(V, axis=1) - 0.5).max() < 1e-4
    assert chi == 2
    assert set(edges.values()) == {2}
    dots = np.sum(V * N, axis=1) / np.maximum(np.linalg.norm(V, axis=1), 1e-9)
    assert dots.min() > 0.99
    fn = np.cross(V[F[:, 1]] - V[F[:, 0]], V[F[:, 2]] - V[F[:, 0]])
    assert (np.sum(fn * V[F].mean(axis=1), axis=1) > 0).all()


def test_torus_genus_and_csg():
    torus = tpt.SDFScene(tpt.Torus(id="t", major_radius=0.5, minor_radius=0.18))
    _, d, edges, chi = _checks(torus, 40)
    assert np.abs(d).max() < 1e-4
    assert chi == 0
    assert set(edges.values()) == {2}
    # the demo scene's shape: one closed genus-0 surface; smooth-union
    # fields are bounds, so 8 Newton steps land within 1e-3
    csg = tpt.SDFScene(tpt.smooth_union(
        0.15, tpt.Sphere(id="s1", radius=0.5),
        tpt.Box(id="b1", position=(0.6, 0, 0), size=(0.3, 0.3, 0.3))))
    _, d, edges, chi = _checks(csg, 40)
    assert np.abs(d).max() < 1e-3
    assert chi == 2
    assert set(edges.values()) == {2}


def test_normals_empty_scene_and_refinement():
    scene = tpt.SDFScene(tpt.Torus(id="t", major_radius=0.5, minor_radius=0.2))
    params = scene.params("cpu")
    m = extract_mesh(scene, params, resolution=32)
    g = scene.sdf(torch.from_numpy(m["vertices"]), params)[1].numpy()
    g /= np.maximum(np.linalg.norm(g, axis=1, keepdims=True), 1e-9)
    assert np.sum(g * m["normals"], axis=1).min() > 0.999

    empty = tpt.SDFScene()
    m = extract_mesh(empty, empty.params("cpu"), resolution=8)
    assert m["vertices"].shape == (0, 3) and m["faces"].shape == (0, 3)

    sphere = tpt.SDFScene(tpt.Sphere(id="s", radius=0.5))
    params = sphere.params("cpu")
    bounds = (np.float32([-0.8] * 3), np.float32([0.8] * 3))
    coarse = extract_mesh(sphere, params, resolution=12, bounds=bounds)
    fine = extract_mesh(sphere, params, resolution=24, bounds=bounds)
    assert len(fine["vertices"]) > 2.5 * len(coarse["vertices"])
    for m in (coarse, fine):
        d = sphere.sdf(torch.from_numpy(m["vertices"]), params)[0].numpy()
        assert np.abs(d).max() < 1e-4
    with pytest.raises(ValueError, match="resolution"):
        extract_mesh(sphere, params, resolution=1)


def test_save_obj_roundtrip_and_bytes_equal_jax(tmp_path):
    scene = tpt.SDFScene(tpt.Sphere(id="s", radius=0.4))
    m = extract_mesh(scene, scene.params("cpu"), resolution=16)
    path = str(tmp_path / "m.obj")
    save_obj(path, m)
    v, n, f = [], [], []
    for line in open(path):
        t = line.split()
        if t and t[0] == "v":
            v.append([float(x) for x in t[1:4]])
        elif t and t[0] == "vn":
            n.append([float(x) for x in t[1:4]])
        elif t and t[0] == "f":
            f.append([int(x.split("/")[0]) - 1 for x in t[1:4]])
    assert np.allclose(np.float32(v), m["vertices"], atol=1e-5)
    assert np.allclose(np.float32(n), m["normals"], atol=1e-5)
    assert np.array_equal(np.int32(f), m["faces"])
    # the JAX package writes the same bytes for the same arrays, with and
    # without normals
    for mesh in (m, {"vertices": m["vertices"], "faces": m["faces"]}):
        j_path = str(tmp_path / "j.obj")
        j_mesh.save_obj(j_path, mesh)
        save_obj(path, mesh)
        assert open(path, "rb").read() == open(j_path, "rb").read()


def test_animation_no_structure_change():
    scene = tpt.SDFScene(tpt.Sphere(id="s", radius=0.3))
    m1 = extract_mesh(scene, scene.params("cpu"), resolution=20)
    h = scene.structure_hash()
    scene["s"].radius = 0.45
    m2 = extract_mesh(scene, scene.params("cpu"), resolution=20)
    assert scene.structure_hash() == h
    assert np.linalg.norm(m1["vertices"], axis=1).mean() == pytest.approx(0.3, abs=1e-3)
    assert np.linalg.norm(m2["vertices"], axis=1).mean() == pytest.approx(0.45, abs=1e-3)


@pytest.mark.parametrize("shape", ["demo", "torus"])
def test_mesh_matches_jax(shape):
    """The port's mesh against JAX's `extract_mesh` at resolution 24.

    The two packages' distances agree to about 1e-6, so a grid sample
    within 1e-6 of zero could take the other sign and change the topology
    legitimately.  The faces and vertices are compared where the two sign
    grids match, which these scenes' grids do everywhere (checked first);
    vertices within 1e-5 (Newton refinement from the same start)."""
    res = 24
    if shape == "demo":
        def build(mod):
            return mod.SDFScene(mod.smooth_union(
                0.1, mod.smooth_union(0.15, mod.Sphere(id="sphere1", radius=0.5),
                                      mod.Box(id="box1", position=(0.6, 0, 0),
                                              size=(0.3, 0.3, 0.3))),
                mod.Sphere(id="sphere2", position=(0, 0.6, 0), radius=0.25)))
    else:
        def build(mod):
            return mod.SDFScene(mod.Torus(id="t", major_radius=0.5, minor_radius=0.18))
    j_scene, t_scene = build(spt), build(tpt)
    for i, (a, b) in enumerate(zip(j_scene.operations(), t_scene.operations())):
        a.id = b.id = f"op{i}"  # pin the ops' generated ids in both packages
    j_params, t_params = j_scene.params(), t_scene.params("cpu")
    lo_j, hi_j = (np.asarray(x, np.float32) for x in j_scene.aabb(j_params))
    lo_t, hi_t = (x.numpy() for x in t_scene.aabb(t_params, "cpu"))
    np.testing.assert_array_equal(lo_t, lo_j)
    np.testing.assert_array_equal(hi_t, hi_j)
    pad = 0.08 * float(np.linalg.norm(hi_j - lo_j) + 1e-6)
    lo, spacing = lo_j - pad, (hi_j - lo_j + 2 * pad) / res
    d_j = j_mesh._grid_distances(j_scene, j_params, lo, spacing, res)
    d_t = t_mesh._grid_distances(t_scene, t_params, lo, spacing, res, torch.device("cpu"))
    np.testing.assert_allclose(d_t, d_j, atol=2e-6, rtol=0)
    assert np.array_equal(d_t < 0, d_j < 0), "sign grids differ: compare only where they match"

    want = j_mesh.extract_mesh(j_scene, j_params, resolution=res)
    got = extract_mesh(t_scene, t_params, resolution=res)
    assert len(got["faces"]) > 100
    np.testing.assert_array_equal(got["faces"], want["faces"])
    np.testing.assert_allclose(got["vertices"], want["vertices"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["normals"], want["normals"], atol=1e-5, rtol=0)
    assert float(np.abs(np.asarray(j_scene.distance(jnp.asarray(got["vertices"]),
                                                    j_params))).max()) < 1e-3
