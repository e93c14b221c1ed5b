"""The PyTorch port's dataset loader against the JAX package's: a dataset
in the JAX datagen layout (manifest.json, 8-bit targets, 16-bit depth and
alpha with the per-frame affine), written here with the port's own G-buffer
and PNG writers, loads to the same arrays in both packages; so does a
NeRF-style transforms.json; and the back-projected point cloud is equal."""

import json
import os

import numpy as np
import pytest
import torch

import splat_renderer_tpu as spt
from splat_renderer_tpu import data as j_data
import splat_renderer_tpu_torch as tpt
from splat_renderer_tpu_torch import data as t_data
from splat_renderer_tpu_torch.camera import camera_tensors
from splat_renderer_tpu_torch.render.multiview import render_views_gbuffer
from splat_renderer_tpu_torch.render.pipeline import demo_scene, model_points
from splat_renderer_tpu_torch.utils.image import to_uint8, write_png, write_png16

W = H = 48
VIEWS = 3


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """What `datagen.py --gbuffer --views 3 --steps 2` lays out, rendered by
    the port on the CPU: two steps, so the step filter has work."""
    out = str(tmp_path_factory.mktemp("ds"))
    rcfg = tpt.RenderConfig(width=W, height=H, base_radius=0.08)
    scene = demo_scene()
    manifest = {"frames": [], "width": W, "height": H, "fov_deg": 45.0}
    for step in range(2):
        spl = model_points(scene, scene.params("cpu"), torch.Generator().manual_seed(step),
                           400, tpt.PointConfig(), rcfg, device="cpu")
        ring = tpt.orbit_ring(VIEWS, aspect=W / H, elevation=0.4 + 0.1 * step)
        gb = render_views_gbuffer(spl, camera_tensors(ring, "cpu"), rcfg, device="cpu")
        rgb, depth, alpha = (gb[k].numpy() for k in ("rgb", "depth", "alpha"))
        for v in range(VIEWS):
            name = f"step{step:03d}_view{v:02d}"
            write_png(os.path.join(out, name + ".png"), rgb[v])
            hit = alpha[v] > 1e-6
            dmin, dmax = float(depth[v][hit].min()), float(depth[v][hit].max())
            dn = np.where(hit, (depth[v] - dmin) / max(dmax - dmin, 1e-9), 0.0)
            write_png16(os.path.join(out, name + "_depth.png"), dn)
            write_png16(os.path.join(out, name + "_alpha.png"), alpha[v])
            manifest["frames"].append({
                "file": name + ".png", "step": step, "time": 0.1 * step,
                "view_proj": ring["view_proj"][v].tolist(),
                "cam_pos": ring["cam_pos"][v].tolist(),
                "depth_file": name + "_depth.png", "alpha_file": name + "_alpha.png",
                "depth_min": dmin, "depth_max": dmax,
            })
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return out, rgb, depth, alpha


def _same_dataset(t_ds, j_ds):
    assert set(t_ds) == set(j_ds)
    for k in ("width", "height", "fov_deg", "frames"):
        assert t_ds[k] == j_ds[k]
    for tc, jc in zip(t_ds["cameras"], j_ds["cameras"]):
        for k in ("view_proj", "cam_pos"):
            assert tc[k].dtype == torch.float32
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
    for k in ("images", "depth", "alpha"):
        if j_ds[k] is None:
            assert t_ds[k] is None
            continue
        assert len(t_ds[k]) == len(j_ds[k])
        for a, b in zip(t_ds[k], j_ds[k]):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)


def test_load_dataset_equals_jax(dataset_dir):
    path, rgb, depth, alpha = dataset_dir
    t_ds = t_data.load_dataset(path, gbuffer=True, device="cpu")
    _same_dataset(t_ds, j_data.load_dataset(path, gbuffer=True))
    assert len(t_ds["images"]) == 2 * VIEWS and t_ds["images"][0].shape == (H, W, 3)
    # the step filter, and colour only
    t1 = t_data.load_dataset(path, step=1, device="cpu")
    _same_dataset(t1, j_data.load_dataset(path, step=1))
    assert len(t1["images"]) == VIEWS and t1["depth"] is None
    # what was written comes back: targets to u8 rounding, depth to u16
    # rounding of its affine, alpha to u16 rounding
    for v in range(VIEWS):
        got = t_ds["images"][VIEWS + v].numpy()
        np.testing.assert_array_equal(np.round(got * 255).astype(np.uint8), to_uint8(rgb[v]))
        a = t_ds["alpha"][VIEWS + v].numpy()
        np.testing.assert_allclose(a, alpha[v], atol=1 / 65535)
        d = t_ds["depth"][VIEWS + v].numpy()
        fr = t_ds["frames"][VIEWS + v]
        hit = alpha[v] > 1e-4
        np.testing.assert_allclose(d[hit], depth[v][hit],
                                   atol=(fr["depth_max"] - fr["depth_min"]) / 65535 + 1e-6)
        assert np.all(d[a <= 1e-6] == 0.0)
    cams, targets = t_data.stack_views(t1)
    assert cams["view_proj"].shape == (VIEWS, 4, 4) and cams["cam_pos"].shape == (VIEWS, 3)
    assert targets.shape == (VIEWS, H, W, 3)
    with pytest.raises(ValueError, match="no frames"):
        t_data.load_dataset(path, step=7, device="cpu")
    with pytest.raises(TypeError):
        t_data.load_dataset(path)  # no default device


def test_backproject_gbuffer_equals_jax(dataset_dir):
    path = dataset_dir[0]
    t_ds = t_data.load_dataset(path, step=0, gbuffer=True, device="cpu")
    j_ds = j_data.load_dataset(path, step=0, gbuffer=True)
    for kw in (dict(), dict(n_max=150, seed=3)):
        got = t_data.backproject_gbuffer(t_ds, device="cpu", **kw)
        want = j_data.backproject_gbuffer(j_ds, **kw)
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    n = got["px"].shape[0]
    assert n == 150 and got["opacity"].shape == (n,)
    # the lifted points lie near the scene's surface
    pts = torch.stack([got["px"], got["py"], got["pz"]], dim=1)
    scene = demo_scene()
    dist, _ = scene.sdf(pts, scene.params("cpu"))
    assert float(dist.abs().median()) < 0.05
    with pytest.raises(ValueError, match="gbuffer=True"):
        t_data.backproject_gbuffer(t_data.load_dataset(path, device="cpu"), device="cpu")


def test_load_transforms_equals_jax(tmp_path):
    """A NeRF-style transforms.json: RGBA targets over white, extensionless
    file paths, camera_angle_x intrinsics."""
    import struct
    import zlib

    def write_rgba(p, arr):
        h, w = arr.shape[:2]
        raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))
        chunk = lambda t, d: (struct.pack(">I", len(d)) + t + d  # noqa: E731
                              + struct.pack(">I", zlib.crc32(t + d) & 0xFFFFFFFF))
        open(p, "wb").write(b"\x89PNG\r\n\x1a\n"
                            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
                            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))

    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "train")
    frames = []
    for i in range(2):
        write_rgba(str(tmp_path / "train" / f"r_{i}.png"),
                   rng.integers(0, 256, (10, 12, 4), dtype=np.uint8))
        cam = spt.Camera(azimuth=0.3 + i, elevation=0.4, aspect=12 / 10)
        c2w = np.linalg.inv(cam.view_matrix().astype(np.float64))
        frames.append({"file_path": f"train/r_{i}", "transform_matrix": c2w.tolist()})
    with open(tmp_path / "transforms.json", "w") as f:
        json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    t_ds = t_data.load_dataset(str(tmp_path), device="cpu")
    _same_dataset(t_ds, j_data.load_dataset(str(tmp_path)))
    assert t_ds["depth"] is None and t_ds["alpha"][0].shape == (10, 12)
    np.testing.assert_allclose(t_ds["cameras"][1]["cam_pos"].numpy(),
                               spt.Camera(azimuth=1.3, elevation=0.4).position(), atol=1e-5)
    with pytest.raises(ValueError, match="manifest.json"):
        t_data.load_dataset(str(tmp_path), gbuffer=True, device="cpu")
