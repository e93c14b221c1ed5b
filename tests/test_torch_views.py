"""The PyTorch port's multi-view and sequence renderers: equal to the
per-view / per-frame loop over the port's own single-view functions, and
per view within the JAX package's gates of its `render_views` /
`render_views_gbuffer` on JAX-made splats; the camera ring and the orbit
controller equal the JAX package's numpy code."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splat_renderer_tpu as spt
from splat_renderer_tpu.render.multiview import (
    render_views as j_render_views,
    render_views_gbuffer as j_render_views_gbuffer,
)
from splat_renderer_tpu.render.pipeline import model_points as j_model_points
import splat_renderer_tpu_torch as tpt
from splat_renderer_tpu_torch.camera import camera_tensors
from splat_renderer_tpu_torch.convert import sh_from_numpy, splats_from_numpy
from splat_renderer_tpu_torch.render.multiview import (
    camera_at,
    render_views,
    render_views_gbuffer,
)
from splat_renderer_tpu_torch.render.pipeline import (
    animate_demo,
    demo_scene,
    render_frame,
    render_gbuffer,
    render_splats,
)
from splat_renderer_tpu_torch.render.sequence import frame_generator, render_sequence
from splat_renderer_tpu_torch.render.sh import apply_sh
from splat_renderer_tpu_torch.utils.image import unflatten_rows

W, H, V = 64, 48, 3
KW = dict(width=W, height=H, base_radius=0.06, tiles_per_splat_cap=16,
          transmittance_eps=0.0)


@pytest.fixture(scope="module")
def scene_views():
    """JAX-modeled splats (numpy), SH bands, a 3-camera ring, and the JAX
    package's multi-view renders of them (scan compositor, jitted)."""
    jc = spt.RenderConfig(**KW)
    scene = spt.SDFScene(spt.smooth_union(
        0.1, spt.Sphere(id="a", radius=0.5), spt.Box(id="b", position=(0.6, 0, 0),
                                                     size=(0.3, 0.3, 0.3))))
    jspl = j_model_points(scene, scene.params(), jax.random.PRNGKey(1), 500,
                          spt.PointConfig(), jc)
    planes = {k: np.asarray(v) for k, v in jspl.items()}
    rng = np.random.default_rng(3)
    sh = {c: rng.normal(scale=0.1, size=(8, 500)).astype(np.float32) for c in ("r", "g", "b")}
    ring = spt.orbit_ring(V, aspect=W / H, elevation=0.4)
    jcams = {k: jnp.asarray(v) for k, v in ring.items()}
    jsh = {k: jnp.asarray(v) for k, v in sh.items()}
    j_img = jax.jit(lambda s, c, h: j_render_views(s, c, jc, "tiles", sh=h))(jspl, jcams, jsh)
    j_gb = jax.jit(lambda s, c: j_render_views_gbuffer(s, c, jc, method="tiles"))(jspl, jcams)
    return planes, sh, ring, np.asarray(j_img), {k: np.asarray(v) for k, v in j_gb.items()}


def test_orbit_ring_and_controller_equal_jax():
    for kw in (dict(), dict(distance=2.0, elevation=0.1, aspect=16 / 9)):
        j, t = spt.orbit_ring(5, **kw), tpt.orbit_ring(5, **kw)
        assert set(j) == set(t)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    jc, tc = spt.Camera(aspect=1.5), tpt.Camera(aspect=1.5)
    for cam, ctl in ((jc, spt.OrbitCameraController(jc)), (tc, tpt.OrbitCameraController(tc))):
        ctl.drag_rotate(40, -25)
        ctl.drag_pan(12, 7)
        ctl.wheel_zoom(300)
        ctl.drag_rotate(0, 1e4)  # clamps at MAX_ELEVATION
        cam.set_aspect(1.25)
    for k, v in jc.arrays(0.5).items():
        np.testing.assert_array_equal(tc.arrays(0.5)[k], v, err_msg=k)
    assert tc.elevation == tc.MAX_ELEVATION


def test_render_views_equals_loop_and_jax(scene_views):
    planes, sh, ring, j_img, _ = scene_views
    tc = tpt.RenderConfig(**KW)
    spl, tsh = splats_from_numpy(planes, "cpu"), sh_from_numpy(sh, "cpu")
    cams = camera_tensors(ring, "cpu")
    got = render_views(spl, cams, tc, sh=tsh, device="cpu")
    assert got.shape == (V, H, W, 3) and got.dtype == torch.float32
    for v in range(V):
        cam = camera_at(cams, v)
        one = render_splats(apply_sh(spl, tsh, cam["cam_pos"]), cam, tc, device="cpu")
        assert torch.equal(got[v], one)
        np.testing.assert_allclose(got[v].numpy(), j_img[v], atol=2e-5, rtol=0)
    assert float((got[0] - got[1]).abs().max()) > 0.05

    # the output layouts callers carry over: flat rows, uint8 on the device
    flat = render_views(spl, cams, tc, sh=tsh, flat=True, device="cpu")
    assert flat.shape == (V, H, W * 3)
    assert torch.equal(flat.reshape(V, H, W, 3), got)
    u8 = render_views(spl, cams, tc, sh=tsh, flat=True, as_uint8=True, device="cpu")
    assert u8.dtype == torch.uint8 and u8.shape == (V, H, W * 3)
    want_u8 = np.round(np.clip(j_img, 0.0, 1.0) * 255.0)
    assert np.abs(unflatten_rows(u8, W).astype(np.float64) - want_u8).max() <= 1
    np.testing.assert_array_equal(
        unflatten_rows(u8, W), np.round(np.clip(got.numpy(), 0, 1) * 255.0).astype(np.uint8))
    oracle = render_views(spl, cams, tc, "oracle", sh=tsh, device="cpu")
    np.testing.assert_allclose(oracle.numpy(), j_img, atol=2e-5, rtol=0)


def test_render_views_gbuffer_equals_loop_and_jax(scene_views):
    planes, _, ring, _, j_gb = scene_views
    tc = tpt.RenderConfig(**KW)
    spl = splats_from_numpy(planes, "cpu")
    cams = camera_tensors(ring, "cpu")
    for method in ("kernel", "tiles"):
        got = render_views_gbuffer(spl, cams, tc, method=method, device="cpu")
        assert got["rgb"].shape == (V, H, W, 3)
        assert got["depth"].shape == got["alpha"].shape == (V, H, W)
        for v in range(V):
            one = render_gbuffer(spl, camera_at(cams, v), tc, method=method, device="cpu")
            for ch, tol in (("rgb", 2e-5), ("alpha", 2e-5), ("depth", 1e-3)):
                assert torch.equal(got[ch][v], one[ch])
                np.testing.assert_allclose(got[ch][v].numpy(), j_gb[ch][v], atol=tol, rtol=0,
                                           err_msg=f"{method} view {v} channel {ch}")
    # SH lights each view: the colour changes, depth and alpha do not
    rng = np.random.default_rng(4)
    tsh = sh_from_numpy({c: rng.normal(scale=0.3, size=(3, 500)).astype(np.float32)
                         for c in ("r", "g", "b")}, "cpu")
    lit = render_views_gbuffer(spl, cams, tc, sh=tsh, device="cpu")
    base = render_views_gbuffer(spl, cams, tc, device="cpu")
    assert torch.equal(lit["alpha"], base["alpha"]) and torch.equal(lit["depth"], base["depth"])
    assert float((lit["rgb"] - base["rgb"]).abs().max()) > 0.01


def test_render_sequence_equals_per_frame_loop():
    """render_sequence reproduces the per-frame loop exactly: frame i takes
    its own parameters, camera and generator (seed + i), and the caller's
    generator is left as it was."""
    frames = 3
    scene = demo_scene()
    pcfg = tpt.PointConfig(descent_steps=2)
    tc = tpt.RenderConfig(width=W, height=H, base_radius=0.05, tiles_per_splat_cap=8)
    per_frame = []
    for i in range(frames):
        animate_demo(scene, 0.4 * i)
        per_frame.append(scene.params("cpu"))
    stack = {pid: {k: torch.stack([p[pid][k] for p in per_frame]) for k in per_frame[0][pid]}
             for pid in per_frame[0]}
    cams = camera_tensors(tpt.orbit_ring(frames, aspect=W / H), "cpu")
    g = torch.Generator().manual_seed(11)
    state = g.get_state()
    seq = render_sequence(scene, stack, cams, g, 600, pcfg, tc, device="cpu")
    assert seq.shape == (frames, H, W * 3) and seq.dtype == torch.uint8
    assert torch.equal(g.get_state(), state)
    raw = render_sequence(scene, stack, cams, g, 600, pcfg, tc, as_uint8=False, flat=False,
                          device="cpu")
    assert raw.shape == (frames, H, W, 3) and raw.dtype == torch.float32
    for i in range(frames):
        assert frame_generator(g, i).initial_seed() == 11 + i
        one = render_frame(scene, per_frame[i], camera_at(cams, i),
                           torch.Generator().manual_seed(11 + i), 600, pcfg, tc, device="cpu")
        assert torch.equal(raw[i], one)
        want = torch.round(torch.clamp(one, 0, 1) * 255).to(torch.uint8)
        assert torch.equal(seq[i].reshape(H, W, 3), want)
    assert float((raw[0] - raw[2]).abs().max()) > 0.05  # animated
    # the same generator gives the same sequence again
    again = render_sequence(scene, stack, cams, g, 600, pcfg, tc, device="cpu")
    assert torch.equal(seq, again)
