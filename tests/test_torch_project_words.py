"""The projector's CUDA kernel (`ops/project_words.py`, csrc/project_words.cu)
against the plain path `splat_screen_words_plain`.

The `gpu` tests hold the kernel's five outputs bit-equal to the plain path
on the card, and to the plain path on the CPU (the path the JAX parity
tests pin), and skip where torch sees no CUDA device; the rest run on the
CPU: the dispatch, the cached light direction, the branch a config takes
(against the branch `shade_planes` takes) and the wrapper's input checks.
The file imports no jax:

    python -m pytest --noconftest -m gpu tests/test_torch_project_words.py
"""

import numpy as np
import pytest
import torch

import splat_renderer_tpu_torch as tpt
from splat_renderer_tpu_torch._torch_util import sqrt_rn
from splat_renderer_tpu_torch.camera import camera_tensors
from splat_renderer_tpu_torch.convert import splats_from_numpy
from splat_renderer_tpu_torch.ops.build import launches
from splat_renderer_tpu_torch.ops.project_words import (
    ALL_PLANES,
    PLANES,
    dilates,
    ellipse_model,
    light_direction,
    project_words,
)
from splat_renderer_tpu_torch.render.projector import (
    shade_planes,
    splat_screen_words,
    splat_screen_words_plain,
)

W, H = 96, 64
KEYS = ("dk", "w_pos", "w_ro", "w_rgb", "depth")
PROFILES = {
    "isotropic": lambda: tpt.RenderConfig(width=W, height=H, tiles_per_splat_cap=8),
    "foreshorten": lambda: tpt.RenderConfig(width=W, height=H, oriented=True),
    "ewa": lambda: tpt.RenderConfig(width=W, height=H, oriented=True, ellipse="ewa"),
    "aa": lambda: tpt.RenderConfig(width=W, height=H, aa_dilation=0.3),
    "aa_foreshorten": lambda: tpt.RenderConfig(width=W, height=H, oriented=True,
                                               aa_dilation=0.3),
    "aa_ewa": lambda: tpt.RenderConfig(width=W, height=H, oriented=True, ellipse="ewa",
                                       aa_dilation=0.3, sigma=0.6),
    "surface": lambda: tpt.surface_render_config(W, H),
    "cov3d": lambda: tpt.RenderConfig(width=W, height=H, oriented=True, ellipse="cov3d",
                                      tiles_per_splat_cap=8),
    "aa_cov3d": lambda: tpt.RenderConfig(width=W, height=H, oriented=True, ellipse="cov3d",
                                         aa_dilation=0.3, tiles_per_splat_cap=8),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the projector kernel runs only on the card")
    return torch.device("cuda")


def _planes(n, seed=0, edge=False, view_proj=None, cov=False):
    """Numpy splat planes around the origin with unit normals.  edge: half
    of them moved along the camera's w gradient onto w in {0, +-1e-9, 5e-8,
    +-1e-7, 1e-6, 2e-6, -0.5, -3} (on the eye plane, near it, behind the
    camera) and a quarter scaled 40x (far off screen).  cov: a 3D
    Gaussian's planes as well (`COV3D_PLANES`): scales up to half the
    radius, one of them flat (some exactly 0), and quaternions of any
    length (some of length 0)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n, 3))
    pos[: n // 50] *= 6.0
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    if edge:
        vp = np.asarray(view_proj, dtype=np.float64)
        a, d = vp[3, :3], vp[3, 3]
        targets = np.array([0.0, 1e-9, -1e-9, 5e-8, 1e-7, -1e-7, 1e-6, 2e-6, -0.5, -3.0])
        k = n // 2
        t = targets[np.arange(k) % len(targets)]
        pos[:k] += ((t - (pos[:k] @ a + d)) / (a @ a))[:, None] * a[None, :]
        pos[k:k + n // 4] *= 40.0
    planes = {
        "px": pos[:, 0], "py": pos[:, 1], "pz": pos[:, 2],
        "radius": rng.uniform(0.005, 0.06, n), "cr": rng.uniform(0, 1, n),
        "cg": rng.uniform(0, 1, n), "cb": rng.uniform(0, 1, n),
        "opacity": rng.uniform(0.2, 1.0, n),
        "nx": nrm[:, 0], "ny": nrm[:, 1], "nz": nrm[:, 2],
    }
    if cov:
        s = planes["radius"][:, None] * rng.uniform(0.05, 0.5, (n, 3))
        s[np.arange(n), rng.integers(0, 3, n)] *= rng.choice([0.0, 0.1], n)
        q = rng.normal(size=(n, 4)) * rng.uniform(0.1, 3.0, (n, 1))
        q[: n // 100] = 0.0
        planes.update(sx=s[:, 0], sy=s[:, 1], sz=s[:, 2], qw=q[:, 0], qx=q[:, 1], qy=q[:, 2],
                      qz=q[:, 3])
    return {k: v.astype(np.float32) for k, v in planes.items()}


def _profile_planes(cfg, n, **kw):
    """`_planes` with the covariance planes where cfg's model reads them."""
    return _planes(n, cov=ellipse_model(cfg) == "cov3d", **kw)


def _columns(splats):
    """The same splats with position and normal as stride-3 column views of
    (N, 3) tensors, as the modeler makes them."""
    pos = torch.stack([splats["px"], splats["py"], splats["pz"]], 1)
    nrm = torch.stack([splats["nx"], splats["ny"], splats["nz"]], 1)
    out = dict(splats, px=pos[:, 0], py=pos[:, 1], pz=pos[:, 2],
               nx=nrm[:, 0], ny=nrm[:, 1], nz=nrm[:, 2])
    assert out["px"].stride(0) == 3
    return out


def _camera(device):
    return camera_tensors(tpt.Camera(aspect=W / H).arrays(), device)


ANGLE_FIELD = 0xFF << 16  # ang8 in w_ro


def _assert_bit_equal(got, want, angle_step=False):
    """Every output bit-equal.  angle_step: w_ro's angle field may differ by
    one step of its 256-step grid (mod 256), in at most 1 splat in 10,000;
    every other bit stays equal."""
    assert set(got) == set(KEYS) and set(want) == set(KEYS)
    for k in KEYS:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        a, b = got[k].cpu(), want[k].cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if k == "w_ro" and angle_step:
            other = int(((a ^ b) & ~ANGLE_FIELD).ne(0).sum())
            assert other == 0, f"w_ro: {other} of {a.numel()} differ outside the angle"
            step = torch.remainder(((a & ANGLE_FIELD) - (b & ANGLE_FIELD)) >> 16, 256)
            moved = int(step.ne(0).sum())
            assert bool(((step == 0) | (step == 1) | (step == 255)).all()), "angle off by > 1 step"
            assert moved <= a.numel() // 10_000, f"angle moved a step in {moved} of {a.numel()}"
            continue
        differ = int((a != b).sum())
        assert differ == 0, f"{k}: {differ} of {a.numel()} differ"


def _cpu(splats):
    """CPU copies of the planes, contiguous."""
    return {k: v.cpu().contiguous() for k, v in splats.items()}


# ---- CPU ----

@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_cpu_takes_the_plain_path(profile):
    """On the CPU `splat_screen_words` is the plain path bit for bit and
    launches nothing."""
    cfg = PROFILES[profile]()
    spl = _columns(splats_from_numpy(_profile_planes(cfg, 1500, seed=1), "cpu"))
    cam = _camera("cpu")
    before = launches["project_words"]
    got = splat_screen_words(spl, cam["view_proj"], cam["cam_pos"], cfg)
    assert launches["project_words"] == before
    _assert_bit_equal(got, splat_screen_words_plain(spl, cam["view_proj"], cam["cam_pos"], cfg))


@pytest.mark.parametrize("light_dir", [(1.0, 1.0, 1.0), (0.3, -0.7, 0.2), (0.0, 0.0, 2.5)])
def test_light_direction_is_the_plain_paths(light_dir):
    """The cached light direction is `light / sqrt_rn(sum(light * light))`
    bit for bit, made once per (light_dir, device)."""
    light = torch.tensor(light_dir, dtype=torch.float32)
    want = light / sqrt_rn(torch.sum(light * light))
    got = light_direction(light_dir, torch.device("cpu"))
    assert got.dtype == torch.float32 and got.shape == (3,)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert light_direction(light_dir, torch.device("cpu")) is got


def _branch_config(cfg, model, dilate):
    """cfg with its ellipse and dilation settings replaced by the ones that
    name (model, dilate) outright."""
    return cfg.replace(
        oriented=model != "isotropic", ellipse=model if model in ("ewa", "cov3d") else "foreshorten",
        aa_dilation=(cfg.aa_dilation or 0.3) if dilate else 0.0,
        opaque=cfg.opaque and not dilate,
    )


@pytest.mark.parametrize("ellipse", ["foreshorten", "ewa", "elliptic", "cov3d"])
@pytest.mark.parametrize("oriented", [False, True])
def test_kernel_branch_is_the_one_shade_planes_takes(ellipse, oriented):
    """For every ellipse value (any string other than "ewa" and "cov3d" is
    the foreshortened model), oriented or not, with and without the
    dilation and opaque: of the eight branches, `shade_planes` gives the
    config's planes on exactly the one `ellipse_model`/`dilates` choose for
    the kernel."""
    spl = splats_from_numpy(_planes(256, seed=5, cov=True), "cpu")
    cam = _camera("cpu")
    bits = lambda c: {k: v.view(torch.int32) for k, v in c.items()}  # noqa: E731
    shade = lambda cfg: bits(shade_planes(spl, cam["view_proj"], cam["cam_pos"], cfg))  # noqa: E731
    for aa, opaque in ((0.0, False), (0.3, False), (0.3, True), (0.0, True)):
        cfg = tpt.RenderConfig(width=W, height=H, oriented=oriented, ellipse=ellipse,
                               aa_dilation=aa, opaque=opaque)
        want = shade(cfg)
        same = [
            (model, dilate)
            for model in ("isotropic", "foreshorten", "ewa", "cov3d") for dilate in (False, True)
            if all(torch.equal(want[k], v)
                   for k, v in shade(_branch_config(cfg, model, dilate)).items())
        ]
        assert same == [(ellipse_model(cfg), dilates(cfg))], (aa, opaque, same)


def test_every_config_maps_to_a_kernel_branch():
    """The branch and dilation each config takes, as the plain path
    decides them: opaque configs never dilate."""
    rc = tpt.RenderConfig
    assert (ellipse_model(rc()), dilates(rc())) == ("isotropic", False)
    assert ellipse_model(rc(oriented=True)) == "foreshorten"
    assert ellipse_model(rc(oriented=True, ellipse="ewa")) == "ewa"
    assert ellipse_model(rc(ellipse="ewa")) == "isotropic"
    assert ellipse_model(rc(oriented=True, ellipse="cov3d")) == "cov3d"
    assert ellipse_model(rc(ellipse="cov3d")) == "isotropic"
    assert dilates(rc(aa_dilation=0.3)) and not dilates(rc(aa_dilation=0.3, opaque=True))
    surface = tpt.surface_render_config()
    assert (ellipse_model(surface), dilates(surface)) == ("foreshorten", False)


def test_wrapper_rejects_what_it_cannot_take():
    """The wrapper checks dtype, shape, length and device before it looks
    for a kernel; CPU tensors it refuses (they take the plain path)."""
    cfg = PROFILES["isotropic"]()
    spl = splats_from_numpy(_planes(64), "cpu")
    cam = _camera("cpu")
    vp, cp = cam["view_proj"], cam["cam_pos"]
    with pytest.raises(ValueError, match="float32"):
        project_words(dict(spl, radius=spl["radius"].double()), vp, cp, cfg)
    with pytest.raises(ValueError, match=r"shape \(64,\)"):
        project_words(dict(spl, cb=spl["cb"][:63]), vp, cp, cfg)
    with pytest.raises(ValueError, match="1-d"):
        project_words(dict(spl, px=spl["px"][:, None]), vp, cp, cfg)
    with pytest.raises(ValueError, match="view_proj"):
        project_words(spl, vp[:3], cp, cfg)
    with pytest.raises(ValueError, match="cam_pos"):
        project_words(spl, vp, cp.double(), cfg)
    with pytest.raises(ValueError, match="no projector kernel"):
        project_words(spl, vp, cp, cfg)
    assert set(PLANES) == set(spl)
    # the covariance model needs its seven planes beside the eleven
    with pytest.raises(ValueError, match="needs the splat planes"):
        project_words(spl, vp, cp, PROFILES["cov3d"]())
    assert set(ALL_PLANES) - set(PLANES) == {"sx", "sy", "sz", "qw", "qx", "qy", "qz"}


# ---- on the card ----

@pytest.mark.gpu
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_kernel_bit_equal_to_plain(cuda, profile):
    """All five outputs equal the plain path on the card bit for bit, on
    contiguous planes and on stride-3 columns with splats behind the
    camera, at w ~ 0 and far off screen."""
    cfg = PROFILES[profile]()
    cam = _camera(cuda)
    vp, cp = cam["view_proj"], cam["cam_pos"]
    for edge in (False, True):
        spl = splats_from_numpy(
            _profile_planes(cfg, 20_000, seed=3, edge=edge, view_proj=vp.cpu()), cuda)
        if edge:
            spl = _columns(spl)
        want = splat_screen_words_plain(spl, vp, cp, cfg)
        got = splat_screen_words(spl, vp, cp, cfg)
        torch.cuda.synchronize()
        _assert_bit_equal(got, want)
        if edge:  # culled splats are on the path
            assert bool(torch.isinf(got["depth"]).any())


@pytest.mark.gpu
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_kernel_bit_equal_to_plain_on_the_cpu(cuda, profile):
    """All five outputs equal the plain path run on CPU copies of the same
    planes and camera bit for bit: the CPU plain path is the one the JAX
    parity tests pin, so this joins the kernel to the JAX package.  One
    allowance, for the oriented branches only: the card's `atan2f` and the
    CPU's `atan2` differ by an ulp on some inputs, and where
    (angle + pi) * ANGLE_SCALE lies that close to a rounding half, ang8
    moves one step of its 256-step grid (1 to 3 splats in 1M on the card;
    the card's own plain path agrees with the kernel bit for bit)."""
    cfg = PROFILES[profile]()
    cam = _camera(cuda)
    vp, cp = cam["view_proj"], cam["cam_pos"]
    for edge in (False, True):
        spl = splats_from_numpy(
            _profile_planes(cfg, 20_000, seed=6, edge=edge, view_proj=vp.cpu()), cuda)
        if edge:
            spl = _columns(spl)
        got = splat_screen_words(spl, vp, cp, cfg)
        want = splat_screen_words_plain(_cpu(spl), vp.cpu(), cp.cpu(), cfg)
        _assert_bit_equal(got, want, angle_step=ellipse_model(cfg) != "isotropic")


@pytest.mark.gpu
def test_kernel_bit_equal_at_1m_splats(cuda):
    """1M splats at 1080p on the modeler's column layout, one launch."""
    cfg = tpt.RenderConfig(width=1920, height=1080, base_radius=0.008,
                           tiles_per_splat_cap=4, tile_size=32, tile_height=16)
    cam = camera_tensors(tpt.Camera(aspect=1920 / 1080).arrays(), cuda)
    spl = _columns(splats_from_numpy(_planes(1_000_000, seed=4), cuda))
    before = launches["project_words"]
    got = splat_screen_words(spl, cam["view_proj"], cam["cam_pos"], cfg)
    assert launches["project_words"] == before + 1
    want = splat_screen_words_plain(spl, cam["view_proj"], cam["cam_pos"], cfg)
    torch.cuda.synchronize()
    _assert_bit_equal(got, want)
    # and the plain path on the CPU
    _assert_bit_equal(got, splat_screen_words_plain(
        _cpu(spl), cam["view_proj"].cpu(), cam["cam_pos"].cpu(), cfg))


@pytest.mark.gpu
def test_one_launch_per_call(cuda):
    """Each call through the entry point is one launch, and so is a direct
    call to the wrapper: both counted under "project_words"."""
    cfg = PROFILES["ewa"]()
    cam = _camera(cuda)
    spl = splats_from_numpy(_planes(3000), cuda)
    before = launches["project_words"]
    for k in range(1, 4):
        splat_screen_words(spl, cam["view_proj"], cam["cam_pos"], cfg)
        assert launches["project_words"] == before + k
    project_words(spl, cam["view_proj"], cam["cam_pos"], cfg)
    assert launches["project_words"] == before + 4
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda):
    """float64 planes, planes of another length, a camera on the CPU: each
    raises, and nothing is launched."""
    cfg = PROFILES["isotropic"]()
    spl = splats_from_numpy(_planes(500), cuda)
    cam = _camera(cuda)
    vp, cp = cam["view_proj"], cam["cam_pos"]
    before = launches["project_words"]
    with pytest.raises(ValueError, match="float32"):
        splat_screen_words(dict(spl, nx=spl["nx"].double()), vp, cp, cfg)
    with pytest.raises(ValueError, match=r"shape \(500,\)"):
        splat_screen_words(dict(spl, opacity=spl["opacity"][1:]), vp, cp, cfg)
    with pytest.raises(ValueError, match="view_proj"):
        splat_screen_words(spl, vp.cpu(), cp, cfg)
    with pytest.raises(ValueError, match="cam_pos"):
        splat_screen_words(spl, vp, cp.cpu(), cfg)
    assert launches["project_words"] == before
