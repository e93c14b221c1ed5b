"""The PyTorch port's differentiable render against the JAX package's, on
the same numpy splats: `bin_planes_diff`, `render_diff` (oracle, tiles and
kernel; "kernel" runs the CUDA kernels' plain twin on the CPU) against JAX
"tiles" and `"pallas", interpret=True`, gradients, the G-buffer and SSIM.

Tolerances are the JAX package's own (tests/test_diff.py): images within
3e-6, gradients within max-relative 1e-4 (isotropic) and 1e-3 (oriented),
max-relative meaning max |port - jax| / max |jax| over a field.  The splats
are modeled with base_opacity 1.0, so every opacity sits exactly on the
bound of the render's clip to [0, 1]: the case where `torch.clamp` would
double jnp.clip's gradient.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splat_renderer_tpu as spt
from splat_renderer_tpu.render import render_diff as j_render_diff
from splat_renderer_tpu.render import render_diff_gbuffer as j_render_diff_gbuffer
from splat_renderer_tpu.render.binning import bin_planes_diff as j_bin_planes_diff
from splat_renderer_tpu.render.pipeline import model_points as j_model_points
from splat_renderer_tpu.render.projector import shade_planes as j_shade_planes
from splat_renderer_tpu.utils import ssim as j_ssim
import splat_renderer_tpu_torch as tpt
from splat_renderer_tpu_torch._torch_util import clip
from splat_renderer_tpu_torch.convert import camera_from_numpy, splats_from_numpy
from splat_renderer_tpu_torch.ops.tile_blend_diff import blend_planes, diff_forward
from splat_renderer_tpu_torch.render.binning import bin_planes_diff, diff_fields
from splat_renderer_tpu_torch.render.diff import render_diff, render_diff_gbuffer
from splat_renderer_tpu_torch.utils import ssim as t_ssim

W = H = 64
BASE = dict(width=W, height=H, base_radius=0.08, tiles_per_splat_cap=16)
IMG_TOL = 3e-6
# profile -> (config fields, n, fields fitted, gradient max-relative gate)
PROFILES = {
    "isotropic": ({}, 200, ("px", "py", "pz", "radius", "opacity", "cr", "cg", "cb"), 1e-4),
    "oriented": (dict(oriented=True), 150, ("px", "nx", "ny", "radius", "opacity", "cr"), 1e-3),
}
TARGET = np.full((H, W, 3), 0.4, np.float32)


def _jax_scene():
    return spt.SDFScene(
        spt.union(spt.Sphere(id="a", radius=0.5),
                  spt.Box(id="b", position=(0.5, 0, 0), size=(0.3, 0.3, 0.3)))
    )


def _maxrel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(scope="module", params=sorted(PROFILES))
def case(request):
    """Splats modeled by JAX, both packages' configs and cameras, and the
    JAX references: images by "tiles" and "pallas" (interpret mode) and the
    "pallas" gradients of an MSE loss."""
    prof, n, fields, tol = PROFILES[request.param]
    jc, tc = spt.RenderConfig(**BASE, **prof), tpt.RenderConfig(**BASE, **prof)
    scene = _jax_scene()
    arrays = spt.Camera(azimuth=0.4, elevation=0.3, aspect=1.0).arrays()
    jcam = {k: jnp.asarray(v) for k, v in arrays.items()}
    js = j_model_points(scene, scene.params(), jax.random.PRNGKey(0), n, spt.PointConfig(), jc)
    np_splats = {k: np.asarray(v) for k, v in js.items()}
    assert np.all(np_splats["opacity"] == 1.0)  # on the clip's bound

    def loss(theta):
        img = j_render_diff(dict(js, **theta), jcam, jc, method="pallas", interpret=True)
        return jnp.mean((img - TARGET) ** 2), img

    (_, img_p), grads = jax.value_and_grad(loss, has_aux=True)({k: js[k] for k in fields})
    return dict(
        name=request.param, jc=jc, tc=tc, js=js, jcam=jcam, np_splats=np_splats,
        tcam=camera_from_numpy(arrays, "cpu"), fields=fields, tol=tol,
        img_pallas=np.asarray(img_p),
        img_tiles=np.asarray(j_render_diff(js, jcam, jc, method="tiles")),
        grads={k: np.asarray(v) for k, v in grads.items()},
    )


def test_bin_planes_diff_matches_jax(case):
    """Counts, offsets, per-tile rank order and src bit-equal; the pair
    stream's planes equal, from the same numpy planes."""
    jc, tc = case["jc"], case["tc"]
    planes = {k: np.asarray(v) for k, v in
              j_shade_planes(case["js"], case["jcam"]["view_proj"], case["jcam"]["cam_pos"], jc).items()}
    want = jax.jit(j_bin_planes_diff, static_argnums=(1, 2))(
        {k: jnp.asarray(v) for k, v in planes.items()}, jc, 1024)
    got = bin_planes_diff({k: torch.tensor(v) for k, v in planes.items()}, tc)
    np.testing.assert_array_equal(got["counts"].numpy(), np.asarray(want["counts"]))
    np.testing.assert_array_equal(got["offsets"].numpy(), np.asarray(want["offsets"]))
    np.testing.assert_array_equal(got["src"].numpy(), np.asarray(want["src"]))
    total = int(got["offsets"][-1])
    assert total > 0
    np.testing.assert_array_equal(got["pair_rank"][:total].numpy(),
                                  np.asarray(want["rank_sorted"])[:total].astype(np.int32))
    # the JAX stream keeps the sorted planes in 128-lane sections per field
    nf = len(diff_fields(tc))
    pair_f = np.asarray(want["pair_f"])
    want_planes = np.stack(
        [pair_f[:, 128 * k:128 * (k + 1)].reshape(-1)[:total] for k in range(nf)], axis=1)
    got_planes = got["planes"][got["pair_rank"][:total].long()].numpy()
    np.testing.assert_array_equal(got_planes, want_planes)
    # each pair's slot holds its record: slot % n == rank
    n = got["src"].shape[0]
    np.testing.assert_array_equal((got["pair_slot"][:total] % n).numpy(),
                                  got["pair_rank"][:total].numpy())


@pytest.mark.parametrize("method", ["oracle", "tiles", "kernel"])
def test_render_diff_matches_jax(case, method):
    spl = splats_from_numpy(case["np_splats"], "cpu")
    before = diff_forward.launches
    got = render_diff(spl, case["tcam"], case["tc"], method=method).numpy()
    assert diff_forward.launches == before  # CPU tensors: the twin, no kernel
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, case["img_tiles"], atol=IMG_TOL, rtol=0)
    np.testing.assert_allclose(got, case["img_pallas"], atol=IMG_TOL, rtol=0)


@pytest.mark.parametrize("method", ["oracle", "tiles", "kernel"])
def test_gradients_match_jax_pallas(case, method):
    spl = splats_from_numpy(case["np_splats"], "cpu")
    theta = {k: spl[k].clone().requires_grad_(True) for k in case["fields"]}
    img = render_diff(dict(spl, **theta), case["tcam"], case["tc"], method=method)
    loss = torch.mean((img - torch.from_numpy(TARGET)) ** 2)
    grads = torch.autograd.grad(loss, list(theta.values()))
    for k, g in zip(theta, grads):
        assert torch.isfinite(g).all(), k
        rel = _maxrel(g.numpy(), case["grads"][k])
        assert rel < case["tol"], f"{k}: max-relative {rel:.2e}"
    # the opacity gradient is live (and, by the gate, jnp.clip's half)
    assert float(grads[list(theta).index("opacity")].abs().max()) > 0


def test_clip_gradient_is_jnps():
    x = np.array([0.0, 0.5, 1.0], np.float32)
    want = jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0)))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    clip(t, 0.0, 1.0).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


def test_gbuffer_matches_jax():
    """Channels within 3e-6 of JAX's, for "tiles" and "kernel"; gradients of
    a depth loss through the kernel path within 1e-4 of JAX "pallas"."""
    jc, tc = spt.RenderConfig(**BASE), tpt.RenderConfig(**BASE)
    scene = _jax_scene()
    arrays = spt.Camera(azimuth=0.9, elevation=0.2, aspect=1.0).arrays()
    jcam = {k: jnp.asarray(v) for k, v in arrays.items()}
    js = j_model_points(scene, scene.params(), jax.random.PRNGKey(1), 150, spt.PointConfig(), jc)
    spl = splats_from_numpy({k: np.asarray(v) for k, v in js.items()}, "cpu")
    tcam = camera_from_numpy(arrays, "cpu")
    want = {k: np.asarray(v) for k, v in j_render_diff_gbuffer(js, jcam, jc, method="tiles").items()}
    for method in ("tiles", "kernel"):
        got = render_diff_gbuffer(spl, tcam, tc, method=method)
        for ch in ("rgb", "alpha"):
            np.testing.assert_allclose(got[ch].numpy(), want[ch], atol=IMG_TOL, rtol=0,
                                       err_msg=f"{method} {ch}")
        # depth is in scene units (about 3 here) and divided by alpha: held
        # relative, at 1e-5
        np.testing.assert_allclose(got["depth"].numpy(), want["depth"], atol=0, rtol=1e-5,
                                   err_msg=f"{method} depth")
    fields = ("px", "pz", "radius", "opacity")

    def j_loss(theta):
        gb = j_render_diff_gbuffer(dict(js, **theta), jcam, jc, method="pallas", interpret=True)
        return jnp.mean(jnp.abs(gb["depth"] - 2.5) * (gb["alpha"] > 0.5)) + jnp.mean(gb["rgb"] ** 2)

    jg = jax.grad(j_loss)({k: js[k] for k in fields})
    theta = {k: spl[k].clone().requires_grad_(True) for k in fields}
    gb = render_diff_gbuffer(dict(spl, **theta), tcam, tc, method="kernel")
    loss = torch.mean(torch.abs(gb["depth"] - 2.5) * (gb["alpha"] > 0.5)) + torch.mean(gb["rgb"] ** 2)
    for k, g in zip(fields, torch.autograd.grad(loss, list(theta.values()))):
        rel = _maxrel(g.numpy(), jg[k])
        assert rel < 1e-4, f"{k}: max-relative {rel:.2e}"


def test_ssim_and_losses_match_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (40, 48, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    b[:10] = 0.3  # a flat region: the variance term near zero
    for name in ("l2", "l1", "ssim"):
        jf, tf = j_ssim.image_loss(name), t_ssim.image_loss(name)
        want, jg = jax.value_and_grad(jf)(jnp.asarray(a), jnp.asarray(b))
        ta = torch.from_numpy(a).requires_grad_(True)
        got = tf(ta, torch.from_numpy(b))
        got.backward()
        got = got.detach()
        assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-7), name
        assert _maxrel(ta.grad.numpy(), jg) < 1e-4, name
    got = float(t_ssim.ssim(torch.from_numpy(a[..., 0]), torch.from_numpy(b[..., 0])))
    assert got == pytest.approx(float(j_ssim.ssim(a[..., 0], b[..., 0])), abs=1e-6)
    assert t_ssim.ssim_np(a, b) == j_ssim.ssim_np(a, b)
    assert t_ssim.quality_gate(a, b) == pytest.approx(j_ssim.quality_gate(a, b), abs=0)
    with pytest.raises(AssertionError, match="outside"):
        t_ssim.quality_gate(a + 2.0, b)
    with pytest.raises(ValueError, match="unknown loss"):
        t_ssim.image_loss("l3")


def test_kernel_method_rejects_opaque_and_unknown_methods():
    cfg = tpt.RenderConfig(**BASE, oriented=True, opaque=True)
    spl = splats_from_numpy({k: np.full(4, 0.5, np.float32) for k in
                             ("px", "py", "pz", "radius", "cr", "cg", "cb", "opacity",
                              "nx", "ny", "nz")}, "cpu")
    cam = camera_from_numpy(spt.Camera().arrays(), "cpu")
    with pytest.raises(ValueError, match="opaque"):
        render_diff(spl, cam, cfg, method="kernel")
    with pytest.raises(ValueError, match="opaque"):
        render_diff_gbuffer(spl, cam, cfg, method="kernel")
    with pytest.raises(ValueError, match="unknown method"):
        render_diff(spl, cam, dataclasses.replace(cfg, opaque=False), method="pallas")
    planes = [torch.zeros(4, device="meta") for _ in range(10)]
    with pytest.raises(ValueError, match="no differentiable tile-blend kernel"):
        blend_planes(dataclasses.replace(cfg, opaque=False), *planes)
