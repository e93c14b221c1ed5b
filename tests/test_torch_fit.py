"""The PyTorch port's training path against the JAX package's, on the same
numpy state: `fit_splats` (Adam, multi-view, the kernel method's plain twin
on the CPU), `density_control`, checkpoints, SH appearance, the
differentiable orbit camera and `fit_camera`.

Tolerances, with their reasons:
- the step-1 loss is one forward render: within 1e-6 relative;
- after 10 Adam steps the loss curve is within 1e-4 relative and the fitted
  fields within 1e-4: Adam divides each moment by the root of the second
  moment, so where a gradient is near zero an ulp of rounding in it moves
  the step by up to lr; the two packages round gradients differently
  (sequential vs tree sums);
- density control with jitter 0 is held exactly (pruned, split and cloned
  slots and every field).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splat_renderer_tpu as spt
from splat_renderer_tpu import fit as jfit
from splat_renderer_tpu.camera import orbit_camera_arrays as j_orbit_camera_arrays
from splat_renderer_tpu.render.pipeline import model_points as j_model_points
from splat_renderer_tpu.render.sh import apply_sh as j_apply_sh
import splat_renderer_tpu_torch as tpt
from splat_renderer_tpu_torch import fit as tfit
from splat_renderer_tpu_torch.camera import orbit_camera_arrays
from splat_renderer_tpu_torch.convert import (
    camera_from_numpy,
    sh_from_numpy,
    splats_from_numpy,
    theta_from_checkpoint,
)
from splat_renderer_tpu_torch.render.sh import apply_sh, sh_degree
from splat_renderer_tpu_torch.utils.snapshot import load_splats, save_splats

W = H = 64
BASE = dict(width=W, height=H, base_radius=0.08, tiles_per_splat_cap=16)
N = 200
FIELDS = ("px", "py", "pz", "radius", "opacity", "cr", "cg", "cb")
AZIMUTHS = (0.4, 1.4)


@pytest.fixture(scope="module")
def scene_state():
    jc = spt.RenderConfig(**BASE)
    scene = spt.SDFScene(
        spt.union(spt.Sphere(id="a", radius=0.5),
                  spt.Box(id="b", position=(0.5, 0, 0), size=(0.3, 0.3, 0.3)))
    )
    js = j_model_points(scene, scene.params(), jax.random.PRNGKey(0), N, spt.PointConfig(), jc)
    arrays = [spt.Camera(azimuth=a, elevation=0.3, aspect=1.0).arrays() for a in AZIMUTHS]
    return dict(
        jc=jc, tc=tpt.RenderConfig(**BASE), js=js,
        np_splats={k: np.asarray(v) for k, v in js.items()},
        jcams=[{k: jnp.asarray(v) for k, v in a.items()} for a in arrays],
        tcams=[camera_from_numpy(a, "cpu") for a in arrays],
    )


def test_fit_splats_matches_jax(scene_state, tmp_path):
    """10 Adam steps over 8 fields from grey, half-opaque splats, two views:
    the port against the JAX package's "pallas" fit.  The JAX run writes a
    checkpoint, whose theta the port's converter reads back."""
    st = scene_state
    jt = jfit.render_targets(st["js"], st["jcams"], st["jc"], method="pallas")
    tt = tfit.render_targets(splats_from_numpy(st["np_splats"], "cpu"), st["tcams"], st["tc"])
    for a, b in zip(jt, tt):  # the port's image gate against a Pallas kernel
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5, rtol=0)
    init = {k: np.full(N, 0.5, np.float32) for k in ("cr", "cg", "cb", "opacity")}
    ckpt = str(tmp_path / "jax_fit")
    jf, jl = jfit.fit_splats(
        st["js"], st["jcams"], jt, st["jc"], fields=FIELDS, steps=10, lr=5e-3,
        method="pallas", init={k: jnp.asarray(v) for k, v in init.items()},
        checkpoint_path=ckpt, checkpoint_every=10,
    )
    tf, tl = tfit.fit_splats(
        splats_from_numpy(st["np_splats"], "cpu"), st["tcams"],
        [torch.tensor(np.asarray(t)) for t in jt], st["tc"], fields=FIELDS, steps=10,
        lr=5e-3, init=splats_from_numpy(init, "cpu"),
    )
    jl, tl = np.asarray(jl), tl.numpy()
    assert tl.shape == (10,) and tl[-1] < tl[0]
    assert abs(tl[0] - jl[0]) <= 1e-6 * jl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)
    for k in FIELDS:
        np.testing.assert_allclose(tf[k].numpy(), np.asarray(jf[k]), atol=1e-4, rtol=0, err_msg=k)
    theta = theta_from_checkpoint(ckpt, "cpu")
    assert sorted(theta) == sorted(FIELDS)
    for k in FIELDS:
        np.testing.assert_array_equal(theta[k].numpy(), np.asarray(jf[k]))


@pytest.mark.parametrize("clone_radius", [None, 0.03])
def test_density_control_matches_jax(scene_state, clone_radius):
    rng = np.random.default_rng(3)
    s = dict(scene_state["np_splats"])
    s["opacity"] = rng.uniform(0, 0.02, N).astype(np.float32)
    s["radius"] = np.where(rng.uniform(size=N) < 0.2, 0, s["radius"]).astype(np.float32)
    score = rng.uniform(0, 2e-5, N).astype(np.float32)
    sh = {c: rng.normal(size=(3, N)).astype(np.float32) for c in ("r", "g", "b")}
    jo, jsh, jst = jfit.density_control(
        {k: jnp.asarray(v) for k, v in s.items()}, jnp.asarray(score),
        jax.random.PRNGKey(1), 1e-5, 0.005, jitter=0.0, clone_radius=clone_radius,
        sh={c: jnp.asarray(v) for c, v in sh.items()})
    to, tsh, tst = tfit.density_control(
        splats_from_numpy(s, "cpu"), torch.from_numpy(score), torch.Generator().manual_seed(0),
        1e-5, 0.005, jitter=0.0, clone_radius=clone_radius, sh=sh_from_numpy(sh, "cpu"))
    assert {k: int(v) for k, v in tst.items()} == {k: int(v) for k, v in jst.items()}
    assert int(tst["split"]) > 0 and int(tst["pruned"]) > 0
    for k in jo:
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]), err_msg=k)
    for c in sh:
        np.testing.assert_array_equal(tsh[c].numpy(), np.asarray(jsh[c]), err_msg=c)


def test_fit_checkpoint_resume_is_bitwise(scene_state, tmp_path):
    """An interrupted fit resumed from its checkpoint (density control and
    its random jitter included) equals the uninterrupted run bit for bit."""
    st = scene_state
    spl = splats_from_numpy(st["np_splats"], "cpu")
    targets = tfit.render_targets(spl, st["tcams"][:1], st["tc"])
    # a fifth of the slots start dead: free capacity for the clones
    dead = torch.arange(N) % 5 == 0
    init = {"cr": torch.full((N,), 0.3), "radius": torch.where(dead, 0.0, spl["radius"]),
            "opacity": torch.where(dead, 0.0, spl["opacity"])}
    kw = dict(fields=("px", "py", "pz", "radius", "opacity", "cr"), lr=5e-3, init=init,
              densify_every=2, densify_threshold=1e-9)
    full, full_l = tfit.fit_splats(spl, st["tcams"][:1], targets, st["tc"], steps=6,
                                   generator=torch.Generator().manual_seed(5), **kw)
    ckpt = str(tmp_path / "fit")
    tfit.fit_splats(spl, st["tcams"][:1], targets, st["tc"], steps=1,
                    generator=torch.Generator().manual_seed(5),
                    checkpoint_path=ckpt, checkpoint_every=1, **kw)
    # the density event at step 2 draws its jitter from the restored generator
    resumed, res_l = tfit.fit_splats(spl, st["tcams"][:1], targets, st["tc"], steps=6,
                                     generator=torch.Generator().manual_seed(99),
                                     checkpoint_path=ckpt, resume=True, **kw)
    assert torch.equal(full_l, res_l)
    for k in full:
        assert torch.equal(full[k], resumed[k]), k
    with pytest.raises(ValueError, match="already holds"):
        tfit.fit_splats(spl, st["tcams"][:1], targets, st["tc"], steps=0,
                        checkpoint_path=ckpt, resume=True, **kw)
    path = str(tmp_path / "splats.npz")
    save_splats(path, full)
    loaded = load_splats(path, "cpu")
    for k in loaded:
        assert torch.equal(loaded[k], full[k]), k


def test_fit_with_sh_and_depth_targets(scene_state):
    """fit_sh trains the coefficients; depth supervision goes through the
    G-buffer; both losses fall, and the step-1 loss equals the JAX one."""
    st = scene_state
    rng = np.random.default_rng(6)
    sh = {c: (0.1 * rng.normal(size=(3, N))).astype(np.float32) for c in ("r", "g", "b")}
    jsh = {c: jnp.asarray(v) for c, v in sh.items()}
    jt = jfit.render_targets(st["js"], st["jcams"][:1], st["jc"], method="tiles", sh=jsh)
    jd = [jnp.full((H, W), 2.8)]
    zero_sh = {c: np.zeros((3, N), np.float32) for c in sh}
    _, jl, _ = jfit.fit_splats(
        st["js"], st["jcams"][:1], jt, st["jc"], fields=("pz",), steps=1, lr=1e-2,
        method="tiles", sh={c: jnp.asarray(v) for c, v in zero_sh.items()}, fit_sh=True,
        depth_targets=jd, loss="ssim")
    spl = splats_from_numpy(st["np_splats"], "cpu")
    _, tl, fitted_sh = tfit.fit_splats(
        spl, st["tcams"][:1], [torch.tensor(np.asarray(jt[0]))], st["tc"], fields=("pz",),
        steps=6, lr=1e-2, method="kernel", sh=sh_from_numpy(zero_sh, "cpu"), fit_sh=True,
        depth_targets=[torch.full((H, W), 2.8)], loss="ssim")
    assert float(tl[0]) == pytest.approx(float(jl[0]), rel=1e-5)
    assert float(tl[-1]) < float(tl[0])
    assert sh_degree(fitted_sh) == 1 and float(fitted_sh["r"].abs().max()) > 0


def test_apply_sh_matches_jax(scene_state):
    rng = np.random.default_rng(8)
    sh = {c: (0.2 * rng.normal(size=(15, N))).astype(np.float32) for c in ("r", "g", "b")}
    cam = scene_state["jcams"][0]["cam_pos"]
    for degree in (None, 1, 2):
        want = j_apply_sh(scene_state["js"], {c: jnp.asarray(v) for c, v in sh.items()}, cam,
                          degree=degree)
        got = apply_sh(splats_from_numpy(scene_state["np_splats"], "cpu"),
                       sh_from_numpy(sh, "cpu"), torch.tensor(np.asarray(cam)), degree=degree)
        for k in ("cr", "cg", "cb"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="complete SH band"):
        sh_degree({"r": torch.zeros(4, 2)})


def test_orbit_camera_and_fit_camera_match_jax(scene_state):
    pose = {"azimuth": 0.45, "elevation": 0.35, "distance": 3.1,
            "target": np.array([0.02, -0.01, 0.0], np.float32)}
    want = j_orbit_camera_arrays({k: jnp.asarray(v, jnp.float32) for k, v in pose.items()})
    got = orbit_camera_arrays({k: torch.tensor(v, dtype=torch.float32) for k, v in pose.items()})
    for k in ("view_proj", "cam_pos"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-6, rtol=0)
    st = scene_state
    target = st["jcams"][0]
    jimg = jfit.render_diff(st["js"], target, st["jc"], method="tiles")
    jpose, jl = jfit.fit_camera(st["js"], pose, jimg, st["jc"], steps=3, method="tiles")
    tpose, tl = tfit.fit_camera(splats_from_numpy(st["np_splats"], "cpu"), pose,
                                torch.tensor(np.asarray(jimg)), st["tc"], steps=3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=0)
    for k in pose:
        np.testing.assert_allclose(tpose[k].numpy(), np.asarray(jpose[k]), atol=1e-5, rtol=0)
    assert float(tl[-1]) < float(tl[0])


def test_psnr_matches_jax():
    mse = np.array([1e-3, 0.0, 0.25], np.float32)
    np.testing.assert_allclose(tfit.psnr(torch.from_numpy(mse)).numpy(),
                               np.asarray(jfit.psnr(jnp.asarray(mse))), rtol=1e-6)


def test_fit_rejects_bad_arguments(scene_state):
    st = scene_state
    spl = splats_from_numpy(st["np_splats"], "cpu")
    t = [torch.zeros(H, W, 3)]
    with pytest.raises(ValueError, match="pair up"):
        tfit.fit_splats(spl, st["tcams"], t, st["tc"])
    with pytest.raises(ValueError, match="densify_every"):
        tfit.fit_splats(spl, st["tcams"][:1], t, st["tc"], densify_every=2)
    with pytest.raises(ValueError, match="fit_sh"):
        tfit.fit_splats(spl, st["tcams"][:1], t, st["tc"], fit_sh=True)
