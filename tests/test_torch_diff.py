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
from splat_renderer_tpu_torch.ops.build import launches
from splat_renderer_tpu_torch.ops.tile_blend_diff import blend_planes
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
    before = launches["tile_blend_diff_forward"]
    got = render_diff(spl, case["tcam"], case["tc"], method=method).numpy()
    assert launches["tile_blend_diff_forward"] == before  # CPU tensors: the twin, no kernel
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


# ---- the backward kernel's one-pass recurrence, in its plain mirror ----

def _random_stream(prof, n=520, seed=0, width=64, height=48, near_centre=False):
    """A `bin_planes_diff` stream of random continuous planes over (and just
    beyond) a small viewport, a third of the opacities exactly 1, and tile
    cotangents.  near_centre: records 0-5 are opacity-1 splats whose centres
    lie within 1e-4 px of a pixel centre, stacked front to back: the input
    on which a suffix written as `U_total - prefix` over `1 - a` fails."""
    cfg = tpt.RenderConfig(width=width, height=height, tiles_per_splat_cap=16, **prof)
    rng = np.random.default_rng(seed)
    cols = [
        rng.uniform(-6, width + 6, n), rng.uniform(-6, height + 6, n),
        rng.uniform(0.4, 5.0, n), np.minimum(rng.uniform(0.3, 1.4, n), 1.0),
        rng.uniform(0, 1, n), rng.uniform(0, 1, n), rng.uniform(0, 1, n),
        rng.uniform(-np.pi, np.pi, n), rng.uniform(0.05, 1.0, n), rng.uniform(1.0, 10.0, n),
    ]
    if near_centre:
        cols[0][:6] = 20.5 + rng.uniform(-1e-4, 1e-4, 6)
        cols[1][:6] = 17.5 + rng.uniform(-1e-4, 1e-4, 6)
        cols[2][:6] = rng.uniform(2.0, 4.0, 6)
        cols[3][:6] = 1.0
        cols[9][:6] = np.linspace(1.5, 6.0, 6)
    from splat_renderer_tpu_torch.ops.tile_blend_diff import _PLANE_NAMES

    planes = {k: torch.tensor(c, dtype=torch.float32) for k, c in zip(_PLANE_NAMES, cols)}
    binned = bin_planes_diff(planes, cfg)
    g = torch.Generator().manual_seed(seed + 1)
    t, tp = cfg.num_tiles, cfg.tile_pixels
    cots = [torch.rand(s, generator=g) - 0.5 for s in ((t, tp, 3), (t, tp), (t, tp))]
    return cfg, binned, cots


def _autograd_rows(cfg, binned, cots):
    from splat_renderer_tpu_torch.ops.tile_blend_diff import blend_binned_plain

    twin = dict(binned, planes=binned["planes"].detach().clone().requires_grad_(True))
    outs = blend_binned_plain(twin, cfg)
    loss = sum((o * c).sum() for o, c in zip(outs, cots))
    (grad,) = torch.autograd.grad(loss, twin["planes"])
    return grad


@pytest.mark.parametrize("near_centre", [False, True], ids=["random", "opacity1_on_a_pixel_centre"])
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_adjoint_mirror_matches_autograd(profile, near_centre):
    """Chunk-start T from the forward, R and Q back to front: every field's
    gradient within the kernels' gate of the twin's autograd, and the same
    bits whatever the chunk."""
    from splat_renderer_tpu_torch.ops.tile_blend_diff import blend_adjoint_plain

    prof, _, _, tol = PROFILES[profile]
    cfg, binned, cots = _random_stream(prof, near_centre=near_centre)
    assert int(binned["counts"].max()) > 64  # more than two chunks of 32 in a tile
    want = _autograd_rows(cfg, binned, cots)
    got = {c: blend_adjoint_plain(binned, cfg, cots, chunk=c) for c in (32, 16, 7)}
    assert torch.isfinite(got[32]).all()
    for k, name in enumerate(diff_fields(cfg)):
        scale = float(want[:, k].abs().max()) + 1e-12
        rel = float((got[32][:, k] - want[:, k]).abs().max()) / scale
        assert rel < tol, f"{name}: max-relative {rel:.2e}"
    assert float(got[32].abs().max()) > 0
    assert torch.equal(got[32], got[16]) and torch.equal(got[32], got[7])


class _BlendPlanesMirror(torch.autograd.Function):
    """The twin's forward with `blend_adjoint_plain` as its backward."""

    @staticmethod
    def forward(ctx, cfg, chunk, *plane_args):
        from splat_renderer_tpu_torch.ops.tile_blend_diff import _PLANE_NAMES, blend_binned_plain

        binned = bin_planes_diff(dict(zip(_PLANE_NAMES, plane_args)), cfg)
        ctx.cfg, ctx.chunk, ctx.binned = cfg, chunk, binned
        return blend_binned_plain(binned, cfg)

    @staticmethod
    def backward(ctx, g_color, g_alpha, g_depth):
        from splat_renderer_tpu_torch.ops.tile_blend_diff import blend_adjoint_plain

        cfg, binned = ctx.cfg, ctx.binned
        per_rank = blend_adjoint_plain(binned, cfg, (g_color, g_alpha, g_depth), ctx.chunk)
        grads = torch.empty_like(per_rank)
        grads[binned["src"]] = per_rank  # rank order -> input order
        cols = grads.unbind(1)
        zero = torch.zeros_like(cols[0])
        g_ang, g_ratio = (cols[7], cols[8]) if cfg.oriented else (zero, zero)
        return (None, None) + cols[:7] + (g_ang, g_ratio, cols[-1])


@pytest.mark.parametrize("chunk", [32, 7])
def test_adjoint_mirror_matches_jax_pallas(case, chunk, monkeypatch):
    """The whole differentiable render with the mirror as the blend's
    backward, against the JAX package's Pallas gradients."""
    from splat_renderer_tpu_torch.ops import tile_blend_diff as tbd

    monkeypatch.setattr(tbd, "blend_planes",
                        lambda cfg, *planes: _BlendPlanesMirror.apply(cfg, chunk, *planes))
    spl = splats_from_numpy(case["np_splats"], "cpu")
    theta = {k: spl[k].clone().requires_grad_(True) for k in case["fields"]}
    img = render_diff(dict(spl, **theta), case["tcam"], case["tc"], method="kernel")
    np.testing.assert_allclose(img.detach().numpy(), case["img_pallas"], atol=IMG_TOL, rtol=0)
    loss = torch.mean((img - torch.from_numpy(TARGET)) ** 2)
    grads = torch.autograd.grad(loss, list(theta.values()))
    for k, g in zip(theta, grads):
        assert torch.isfinite(g).all(), k
        rel = _maxrel(g.numpy(), case["grads"][k])
        assert rel < case["tol"], f"{k}: max-relative {rel:.2e}"


def test_backward_kernel_refuses_cpu_tensors():
    """The kernels run only on the card: on CPU tensors the wrapper raises
    and launches nothing (the CPU path is `blend_planes`' twin)."""
    from splat_renderer_tpu_torch.ops.tile_blend_diff import diff_backward

    cfg, binned, cots = _random_stream({}, n=20)
    before = launches["tile_blend_diff_backward"]
    with pytest.raises(ValueError, match="no differentiable tile-blend kernel"):
        diff_backward(binned, cfg, cots, torch.zeros((1, cfg.tile_pixels)))
    assert launches["tile_blend_diff_backward"] == before
