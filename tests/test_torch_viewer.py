"""The PyTorch port's front ends on the CPU engine: uint8 quantization and
PNG files byte-equal to the JAX package's, the viewer's page and frames
over HTTP, the first frame published before the stage profile, a failing
engine surfacing as an error, and the turntable's files."""

import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splat_renderer_tpu.utils import image as j_image
import splat_renderer_tpu_torch as tpt
from splat_renderer_tpu_torch.render.pipeline import Engine, SplatEngine, demo_scene
from splat_renderer_tpu_torch.utils import image as t_image
from splat_renderer_tpu_torch.viewer.serve import _RenderLoop, make_server, pool_half
from splat_renderer_tpu_torch.viewer.turntable import render_turntable


def _float_image(seed=0, h=21, w=34):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-0.2, 1.2, (h, w, 3)).astype(np.float32)
    img[0, 0] = (np.nan, np.inf, -np.inf)
    img[1, :4, 0] = (0.5 / 255, 1.5 / 255, 254.5 / 255, 1.0)
    return img


def test_uint8_quantization_equals_jax():
    img = _float_image()
    want = j_image.to_uint8(img)
    np.testing.assert_array_equal(t_image.to_uint8(img), want)
    np.testing.assert_array_equal(t_image.to_uint8(torch.from_numpy(img)), want)
    rows = t_image.to_uint8_rows(torch.from_numpy(img))
    assert rows.dtype == torch.uint8 and rows.shape == (21, 34 * 3)
    j_rows = np.asarray(j_image.to_uint8_rows(jnp.asarray(img)))
    np.testing.assert_array_equal(rows.numpy(), j_rows)
    np.testing.assert_array_equal(t_image.unflatten_rows(rows, 34),
                                  j_image.unflatten_rows(j_rows, 34))
    stack = torch.stack([rows, rows])
    assert t_image.unflatten_rows(stack, 34).shape == (2, 21, 34, 3)


@pytest.mark.parametrize("kind", ["float_fast", "u8_slow", "gray", "depth16_float", "depth16_u16"])
def test_png_files_equal_jax(tmp_path, kind):
    rng = np.random.default_rng(1)
    tp, jp = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    if kind == "float_fast":
        arr = _float_image(2)
        t_image.write_png(tp, torch.from_numpy(arr))
        j_image.write_png(jp, arr)
        back = j_image.to_uint8(arr)
    elif kind == "u8_slow":
        arr = back = rng.integers(0, 256, (9, 14, 3), dtype=np.uint8)
        t_image.write_png(tp, arr, fast=False)
        j_image.write_png(jp, arr, fast=False)
    elif kind == "gray":
        arr = rng.integers(0, 256, (9, 14), dtype=np.uint8)
        back = np.repeat(arr[:, :, None], 3, axis=2)
        t_image.write_png(tp, arr)
        j_image.write_png(jp, arr)
    elif kind == "depth16_float":
        arr = rng.uniform(-0.1, 1.1, (7, 11)).astype(np.float32)
        t_image.write_png16(tp, torch.from_numpy(arr))
        j_image.write_png16(jp, arr)
        back = np.clip(arr * np.float32(65535.0) + np.float32(0.5), 0, 65535).astype(np.uint16)
    else:
        arr = back = rng.integers(0, 65536, (7, 11), dtype=np.uint16)
        t_image.write_png16(tp, arr)
        j_image.write_png16(jp, arr)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    got = t_image.read_png(tp)
    np.testing.assert_array_equal(got, j_image.read_png(jp))
    np.testing.assert_array_equal(got, back)
    np.testing.assert_array_equal(t_image.load_image(tp), j_image.load_image(jp))
    assert t_image.load_image(tp).shape[2] == 3
    with pytest.raises(ValueError, match="not a PNG"):
        bad = tmp_path / "bad.png"
        bad.write_bytes(b"nope")
        t_image.read_png(str(bad))


def _engine(n=128):
    return Engine(demo_scene(), tpt.PointConfig(descent_steps=1),
                  tpt.RenderConfig(width=32, height=32, base_radius=0.1), n=n, device="cpu")


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30)


def test_page_and_frame_over_http(tmp_path):
    """Drive the actual HTTP surface on an ephemeral port."""
    eng = _engine()
    httpd = make_server(eng, port=0)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        page = _get(port, "/").read()
        assert b"splat_renderer_tpu_torch" in page and b'width="32"' in page
        r = _get(port, "/frame?az=0.5&el=0.5&d=3.0&t=0")
        png = r.read()
        assert r.status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
        headers = {k.lower() for k in r.headers.keys()}
        assert {"x-render-ms", "x-seq", "x-w", "x-h", "x-stage-ms"} <= headers
        p = tmp_path / "f.png"
        p.write_bytes(png)
        full = t_image.read_png(str(p))
        assert full.shape == (32, 32, 3)
        # the served frame is the engine's frame for that camera and seq
        loop = httpd.render_loop
        cam = loop._camera_arrays((0.5, 0.5, 3.0, 0.0, 0.0, 0.0, False))
        want = eng.frame(cam, torch.Generator().manual_seed(int(r.headers["x-seq"])))
        np.testing.assert_array_equal(full, t_image.to_uint8(want))
        # half mode: 2x2-pooled on the device, a quarter of the wire bytes;
        # chained by seq, or latest-wins would serve the full-size frame
        prev = int(r.headers["x-seq"])
        r2 = _get(port, f"/frame?az=0.6&seq={prev}&raw=1&half=1")
        body = r2.read()
        assert int(r2.headers["x-w"]) == 16 and int(r2.headers["x-h"]) == 16
        assert len(body) == 16 * 16 * 3
        assert int(r2.headers["x-seq"]) > prev
        # raw full frame at the moved camera differs from the first
        r3 = _get(port, f"/frame?az=0.6&seq={r2.headers['x-seq']}&raw=1")
        raw = np.frombuffer(r3.read(), np.uint8).reshape(32, 32, 3)
        assert np.abs(raw.astype(int) - full.astype(int)).max() > 10
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/nope")
        assert e.value.code == 404
        assert loop.error is None
        # the CPU engine has no stage profile: the HUD says so
        assert loop.stage_ms in ({}, {"n/a": 0.0})
    finally:
        httpd.shutdown()
        httpd.render_loop.stop()
        httpd.server_close()


def test_pool_half_is_the_block_mean():
    img = torch.arange(5 * 7 * 3, dtype=torch.float32).reshape(5, 7, 3)
    got = pool_half(img)  # odd sizes: cropped to 4 x 6 first
    assert got.shape == (2, 3, 3)
    want = img[:4, :6].reshape(2, 2, 3, 2, 3).mean(dim=(1, 3))
    assert torch.allclose(got, want)


class _SlowProfileEngine:
    rcfg = tpt.RenderConfig(width=16, height=16)
    device = torch.device("cpu")
    profile_s = 3.0

    def __init__(self):
        self.profiled = 0

    def frame(self, camera, generator):
        return torch.zeros((16, 16, 3))

    def stage_profile(self, camera, generator):
        self.profiled += 1
        time.sleep(self.profile_s)
        return {"project_ms": 1.0}


def test_first_frame_published_before_stage_profile():
    """The render loop publishes its first frame before the one-off stage
    profile, which renders several more frames; profile_stages=False skips
    the profile."""
    eng = _SlowProfileEngine()
    loop = _RenderLoop(eng).start()
    try:
        state = (0.5, 0.5, 3.0, 0.0, 0.0, 0.0)
        t0 = time.perf_counter()
        loop.request(state)
        got = loop.latest(0, state, timeout=2.0)
        dt = time.perf_counter() - t0
        assert got is not None, "first frame not published"
        assert dt < eng.profile_s, f"first frame held back {dt:.1f}s: behind the profile"
        assert got[0] == 1 and got[1].shape == (16, 16, 3) and got[1].dtype == np.uint8
    finally:
        loop.stop()
    eng2 = _SlowProfileEngine()
    loop2 = _RenderLoop(eng2, profile_stages=False).start()
    try:
        state = (0.6, 0.5, 3.0, 0.0, 0.0, 0.0)
        loop2.request(state)
        assert loop2.latest(0, state, timeout=2.0) is not None
        time.sleep(0.2)
        assert eng2.profiled == 0
    finally:
        loop2.stop()


def test_failing_engine_surfaces():
    """An exception in the render thread is kept and answered as a 500; it
    is not swallowed, and the request does not hang."""

    class Broken(_SlowProfileEngine):
        def frame(self, camera, generator):
            raise RuntimeError("kernel launch failed")

    httpd = make_server(Broken(), port=0, profile_stages=False)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(httpd.server_address[1], "/frame?az=0.1")
        assert e.value.code == 500 and b"kernel launch failed" in e.value.read()
        assert isinstance(httpd.render_loop.error, RuntimeError)
    finally:
        httpd.shutdown()
        httpd.render_loop.stop()
        httpd.server_close()


def test_animate_gets_the_time_not_the_half_flag():
    seen = []
    eng = _SlowProfileEngine()
    loop = _RenderLoop(eng, animate=seen.append, profile_stages=False).start()
    try:
        state = (0.5, 0.5, 3.0, 0.0, 0.0, 1.25, True)
        loop.request(state)
        got = loop.latest(0, state, timeout=5.0)
        assert got is not None and got[1].shape == (8, 8, 3)
        assert seen == [1.25]
    finally:
        loop.stop()


def test_turntable_writes_the_engines_frames(tmp_path):
    eng = _engine()
    paths = render_turntable(eng, str(tmp_path / "tt"), n_frames=3, seed=4)
    assert [p[-14:] for p in paths] == [f"frame_{i:04d}.png" for i in range(3)]
    imgs = [t_image.read_png(p) for p in paths]
    assert all(im.shape == (32, 32, 3) for im in imgs)
    assert np.abs(imgs[0].astype(int) - imgs[1].astype(int)).max() > 10
    cam = tpt.Camera(distance=3.0, elevation=0.5, aspect=1.0)
    cam.azimuth = 2.0 * np.pi * 1 / 3
    want = eng.frame(tpt.camera_tensors(cam.arrays(1 / 30.0), "cpu"),
                     torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(imgs[1], t_image.to_uint8(want))
    # a static engine turns on the table too
    spl = tpt.model_points(eng.scene, eng.scene.params("cpu"), torch.Generator().manual_seed(0),
                           200, tpt.PointConfig(descent_steps=1), eng.rcfg, device="cpu")
    paths = render_turntable(SplatEngine(spl, eng.rcfg, device="cpu"), str(tmp_path / "st"),
                             n_frames=2)
    assert len(paths) == 2 and t_image.read_png(paths[1]).shape == (32, 32, 3)
