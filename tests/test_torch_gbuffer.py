"""The PyTorch port's G-buffer path against the JAX package's, on the same
numpy splats and camera: the depth plane of the packed-word binner bit-equal
to the JAX pair stream's depth column, `render_gbuffer` within the JAX
tests' own gates (rgb and alpha 2e-5, depth 1e-3) of JAX's kernel path (run
in interpret mode) and of its scan path, and the blend wrapper's schedules
equal on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splat_renderer_tpu as spt
from splat_renderer_tpu.render.binning import bin_packed_words as j_bin_packed_words
from splat_renderer_tpu.render.pipeline import (
    model_points as j_model_points,
    render_gbuffer as j_render_gbuffer,
)
from splat_renderer_tpu.render.projector import splat_screen_words as j_words
import splat_renderer_tpu_torch as tpt
from splat_renderer_tpu_torch.convert import camera_from_numpy, splats_from_numpy
from splat_renderer_tpu_torch.ops.tile_blend import blend_tiles, blend_tiles_plain
from splat_renderer_tpu_torch.render.binning import bin_packed_words
from splat_renderer_tpu_torch.render.pipeline import render_gbuffer, render_splats
from splat_renderer_tpu_torch.render.projector import splat_screen_words

W, H = 64, 48
GATES = (("rgb", 2e-5), ("alpha", 2e-5), ("depth", 1e-3))  # tests/test_render.py:339


def _random_splats(seed, n=2000):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n, 3))
    pos[: n // 50] *= 6.0  # a few behind the eye or far off screen
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    planes = {
        "px": pos[:, 0], "py": pos[:, 1], "pz": pos[:, 2],
        "radius": rng.uniform(0.005, 0.09, n),
        "cr": rng.uniform(0, 1, n), "cg": rng.uniform(0, 1, n),
        "cb": rng.uniform(0, 1, n), "opacity": rng.uniform(0.2, 1.0, n),
        "nx": nrm[:, 0], "ny": nrm[:, 1], "nz": nrm[:, 2],
    }
    planes = {k: v.astype(np.float32) for k, v in planes.items()}
    for k in planes:  # bit-equal depth ties
        planes[k][100:150] = planes[k][50:100]
    return planes


def _torch_bins(planes, cam, tc, with_depth=True):
    tcam = camera_from_numpy(cam, "cpu")
    w = splat_screen_words(splats_from_numpy(planes, "cpu"), tcam["view_proj"],
                           tcam["cam_pos"], tc)
    return bin_packed_words(w["dk"], w["w_pos"], w["w_ro"], w["w_rgb"], tc,
                            with_depth=with_depth)


@pytest.mark.parametrize("oriented", [False, True], ids=["two_word", "three_word"])
def test_depth_plane_equals_jax_depth_column(oriented):
    """Per pair, the port's `rec_depth[pair_rank]` is the JAX stream's
    trailing depth section with the key's top bit cleared, as the TPU kernel
    reads it; counts and offsets are equal too."""
    kw = dict(width=W, height=H, tiles_per_splat_cap=8, oriented=oriented)
    jc, tc = spt.RenderConfig(**kw), tpt.RenderConfig(**kw)
    planes = _random_splats(3)
    cam = spt.Camera(aspect=W / H).arrays()

    # the projector runs eagerly (a jitted one may differ by an ulp of depth);
    # the binner's integer outputs are the same jitted
    w = j_words({k: jnp.asarray(v) for k, v in planes.items()},
                jnp.asarray(cam["view_proj"]), jnp.asarray(cam["cam_pos"]), jc)
    jb = jax.jit(lambda dk, wp, wr, wc: j_bin_packed_words(
        dk, wp, wr, wc, jc, 1024, with_depth=True))(
        w["dk"], w["w_pos"], w["w_ro"], w["w_rgb"])
    tb = _torch_bins(planes, cam, tc)
    np.testing.assert_array_equal(tb["counts"].numpy(), np.asarray(jb["counts"]))
    np.testing.assert_array_equal(tb["offsets"].numpy(), np.asarray(jb["offsets"]))
    n_pairs = int(tb["offsets"][-1])
    assert n_pairs > 1000
    pair_w = np.asarray(jb["pair_w"])
    j_depth = pair_w[:, -128:].reshape(-1)[:n_pairs] & np.uint32(0x7FFFFFFF)
    rec_depth = tb["rec_depth"].numpy()
    assert rec_depth.dtype == np.int32 and rec_depth.shape == (planes["px"].size,)
    got = rec_depth[tb["pair_rank"].numpy()[:n_pairs]].view(np.uint32)
    np.testing.assert_array_equal(got, j_depth)
    # read as floats they are the records' depths, in input order
    np.testing.assert_array_equal(rec_depth.view(np.float32), np.asarray(w["depth"]))
    # the other outputs are those of the stream without depth
    plain = _torch_bins(planes, cam, tc, with_depth=False)
    assert "rec_depth" not in plain
    for k, v in plain.items():
        assert torch.equal(v, tb[k]), k


@pytest.fixture(scope="module")
def sphere_splats():
    """300 splats the JAX package models on a sphere (tests/test_render.py's
    G-buffer scene), as numpy, per profile."""
    out = {}
    scene = spt.SDFScene(spt.Sphere(id="a", radius=0.5))
    for oriented in (False, True):
        jc = spt.RenderConfig(width=W, height=H, base_radius=0.06, tiles_per_splat_cap=16,
                              oriented=oriented)
        spl = j_model_points(scene, scene.params(), jax.random.PRNGKey(0), 300,
                             spt.PointConfig(), jc)
        out[oriented] = {k: np.asarray(v) for k, v in spl.items()}
    return out


@pytest.mark.parametrize("oriented", [False, True], ids=["isotropic", "oriented"])
def test_render_gbuffer_matches_jax(sphere_splats, oriented):
    kw = dict(width=W, height=H, base_radius=0.06, tiles_per_splat_cap=16, oriented=oriented)
    jc, tc = spt.RenderConfig(**kw), tpt.RenderConfig(**kw)
    planes = sphere_splats[oriented]
    cam = spt.Camera(aspect=W / H).arrays()
    jspl = {k: jnp.asarray(v) for k, v in planes.items()}
    jcam = {k: jnp.asarray(v) for k, v in cam.items()}
    j_scan = jax.jit(lambda s, c: j_render_gbuffer(s, c, jc, method="tiles"))(jspl, jcam)
    j_kernel = jax.jit(lambda s, c: j_render_gbuffer(
        s, c, jc, method="pallas", eps=0.0, interpret=True))(jspl, jcam)
    tspl, tcam = splats_from_numpy(planes, "cpu"), camera_from_numpy(cam, "cpu")
    got = {
        "kernel": render_gbuffer(tspl, tcam, tc, method="kernel", eps=0.0, device="cpu"),
        "tiles": render_gbuffer(tspl, tcam, tc, method="tiles", device="cpu"),
    }
    assert got["kernel"]["rgb"].shape == (H, W, 3)
    assert got["kernel"]["depth"].shape == got["kernel"]["alpha"].shape == (H, W)
    alpha = got["kernel"]["alpha"].numpy()
    assert alpha.max() > 0.5 and np.all(got["kernel"]["depth"].numpy()[alpha <= 1e-6] == 0.0)
    for name, out in got.items():
        for ref_name, ref in (("jax tiles", j_scan), ("jax pallas", j_kernel)):
            for ch, tol in GATES:
                np.testing.assert_allclose(
                    out[ch].numpy(), np.asarray(ref[ch]), atol=tol, rtol=0,
                    err_msg=f"port {name} vs {ref_name}: channel {ch}")
    # "auto" is the kernel path, and its colour is the ordinary frame's
    auto = render_gbuffer(tspl, tcam, tc, eps=0.0, device="cpu")
    img = render_splats(tspl, tcam, tc, blend_eps=0.0, device="cpu")
    assert torch.equal(auto["rgb"], got["kernel"]["rgb"]) and torch.equal(auto["rgb"], img)
    with pytest.raises(ValueError, match="method"):
        render_gbuffer(tspl, tcam, tc, method="pallas", device="cpu")
    with pytest.raises(ValueError, match="expected"):
        render_gbuffer(tspl, tcam, tc, device="meta")


@pytest.mark.parametrize("eps", [0.0, 0.01])
def test_blend_schedules_and_depth_on_cpu(eps):
    """On the CPU both schedules run the plain twin: "tile_xp" equals "tile"
    exactly, with and without depth; depth leaves colour and alpha alone."""
    tc = tpt.RenderConfig(width=W, height=H, tiles_per_splat_cap=8, tile_size=32,
                          tile_height=16)
    binned = _torch_bins(_random_splats(4, n=800), spt.Camera(aspect=W / H).arrays(), tc)
    for with_depth in (False, True):
        a = blend_tiles(binned, tc, eps, with_depth=with_depth)
        b = blend_tiles(binned, tc, eps, schedule="tile_xp", with_depth=with_depth)
        p = blend_tiles_plain(binned, tc, eps, with_depth=with_depth)
        assert len(a) == (3 if with_depth else 2)
        for x, y, z in zip(a, b, p):
            assert torch.equal(x, y) and torch.equal(x, z)
    c2, a2 = blend_tiles(binned, tc, eps)
    c3, a3, d3 = blend_tiles(binned, tc, eps, with_depth=True)
    assert torch.equal(c2, c3) and torch.equal(a2, a3)
    assert d3.shape == a3.shape and float(d3.max()) > 0
    # depth is a weighted sum of depths under weights that sum to alpha
    d = binned["rec_depth"].view(torch.float32)
    d_hi = float(d[torch.isfinite(d)].max())
    assert float((d3 - a3 * d_hi).max()) <= 1e-4


def test_blend_rejects_unknown_schedule_and_missing_depth():
    tc = tpt.RenderConfig(width=W, height=H)
    cam = spt.Camera(aspect=W / H).arrays()
    binned = _torch_bins(_random_splats(5, n=200), cam, tc, with_depth=False)
    with pytest.raises(ValueError, match="unknown blend schedule"):
        blend_tiles(binned, tc, schedule="flat")
    with pytest.raises(ValueError, match="with_depth"):
        blend_tiles(binned, tc, with_depth=True)
    tspl = splats_from_numpy(_random_splats(5, n=200), "cpu")
    with pytest.raises(ValueError, match="unknown blend kernel"):
        render_splats(tspl, camera_from_numpy(cam, "cpu"), tc, blend_kernel="tiel",
                      device="cpu")
