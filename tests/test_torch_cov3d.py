"""Full-covariance 3D Gaussians (`ellipse="cov3d"`) on the port's plain path.

- Against the benchmark's plain reference (`gpubench/reference/gaussians.py`:
  the published projection as matrix products, then the frozen binning and
  fold), at 2,000 Gaussians, 96x64, 8 orbit views: words, runs and image.
- The disc limit: scales (r/2, r/2, 0) with the rotation taking +z to n give
  the "ewa" model's ellipse of the disc (r, n), within float rounding.
- `gaussian_splats`, the plane checks, and `load_ply(covariance=True)` /
  `save_ply` keeping the file's scales and rotation.

The file imports no jax.
"""

import math

import numpy as np
import pytest
import torch

import splat_renderer_tpu_torch as tpt
from gpubench.drivers.views import pairs_out_of_place
from gpubench.reference import gaussians as ref_gs
from gpubench.reference.camera import Camera as RefCamera
from gpubench.reference.config import RenderConfig as RefRenderConfig
from splat_renderer_tpu_torch.points import COV3D_PLANES, gaussian_splats
from splat_renderer_tpu_torch.render.pipeline import _words_and_bins, render_splats
from splat_renderer_tpu_torch.render.projector import shade_planes, splat_screen_words
from splat_renderer_tpu_torch.utils.ply import load_ply, save_ply

W, H = 96, 64
KW = dict(width=W, height=H, tiles_per_splat_cap=8, transmittance_eps=0.0, oriented=True,
          ellipse="cov3d", aa_dilation=0.3, light_ambient=1.0, light_diffuse=0.0)
WORDS = ("dk", "w_pos", "w_ro", "w_rgb")
# (shift, mask, wraps) of each field of a record word
FIELDS = {"w_pos": ((0, 0xFFFF, 0), (16, 0xFFFF, 0)),
          "w_ro": ((0, 0xFFFF, 0), (16, 0xFF, 256), (24, 0xFF, 0)),
          "w_rgb": ((0, 0xFF, 0), (8, 0xFF, 0), (16, 0xFF, 0), (24, 0xFF, 0))}


def _f32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _gaussians(n=2000, seed=1):
    """n Gaussians in the unit ball: s1 = 0.06 exp(N(0, 0.3)), s2 = s1
    U(0.25, 1), s3 = 0.1 s1; quaternions N(0, 1) of any length; colour and
    opacity uniform."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3))
    pos *= rng.uniform(0.3, 1.0, (n, 1)) / np.linalg.norm(pos, axis=1, keepdims=True)
    s1 = 0.06 * np.exp(rng.normal(0.0, 0.3, n))
    s = np.stack([s1, s1 * rng.uniform(0.25, 1.0, n), 0.1 * s1], 1)
    return gaussian_splats(_f32(pos), _f32(s), _f32(rng.normal(size=(n, 4))),
                           _f32(rng.uniform(0, 1, (n, 3))), _f32(rng.uniform(0.1, 1.0, n)))


def _camera(v, views=8):
    cam = RefCamera(azimuth=2 * math.pi * v / views, elevation=0.5, distance=3.0, aspect=W / H)
    out = {k: _f32(a) for k, a in cam.arrays().items()}
    out["view"], out["proj"] = _f32(cam.view_matrix()), _f32(cam.projection_matrix())
    return out


@pytest.mark.parametrize("view", range(8))
def test_plain_cov3d_against_the_reference(view):
    """Words: at most 1 record in 400 differs, and only by one step of one
    field's grid (the angle's modulo 256): the reference's own arithmetic
    (matrix products, eigenvalues as mid +- sqrt(mid^2 - det), the major
    axis's angle) rounds differently, which moves a value lying within
    rounding of a grid's half step by one step (0 to 2 records in 2,000
    read).  Runs: at most 1 pair position in 200 differs (0 read).  Image:
    within 0.01, a one-step change of one record (an opacity step is
    1/255; 2.1e-3 read) and float rounding (2e-7 read elsewhere)."""
    spl, cfg, cam = _gaussians(), tpt.RenderConfig(**KW), _camera(view)
    got = splat_screen_words(spl, cam["view_proj"], cam["cam_pos"], cfg)
    want, want_bins, want_img, _ = ref_gs.render(spl, cam, RefRenderConfig(**KW))
    differ = torch.zeros_like(got["dk"], dtype=torch.bool)
    for k in WORDS:
        differ |= got[k] != want[k]
    assert int(differ.sum()) <= len(differ) // 400
    assert torch.equal(got["dk"], want["dk"])
    for k, fields in FIELDS.items():
        for shift, mask, wraps in fields:
            d = ((got[k] >> shift) & mask) - ((want[k] >> shift) & mask)
            if wraps:
                d = torch.remainder(d + 1, wraps) - 1
            assert int(d.abs().max()) <= 1, (k, shift)
    assert pairs_out_of_place(_words_and_bins(spl, cam, cfg), want_bins) <= 1 / 200
    img = render_splats(spl, cam, cfg, device="cpu")
    assert float((img - want_img).abs().max()) <= 0.01


@pytest.mark.parametrize("aa", [0.0, 0.3])
def test_the_disc_limit_is_the_ewa_ellipse(aa):
    """A Gaussian with scales (r/2, r/2, 0) and the rotation taking +z to
    n is the disc (r, n): its centre, depth and colour are the "ewa"
    model's bit for bit, its radius within 1e-6 (4e-7 read), its ratio and
    opacity after the low-pass within 1e-4: the "ewa" model's minor axis
    comes from r^2 (a00 - jn0^2), a difference that loses digits when the
    disc is seen near edge-on (4e-5 read at ratio 0.06).  The screen
    ellipse rebuilt from radius, ratio and angle agrees within 1e-3 of the
    major axis squared: the angle, atan2(lam_lo - m00, m01), loses digits
    to cancellation where the minor axis lies near the x axis (2e-4 rad
    read; the record keeps the angle on a 2.5e-2 rad grid)."""
    rng = np.random.default_rng(7)
    n = 3000
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    r = rng.uniform(0.01, 0.08, n)
    # +z to n, half-angle form (n is never -z here)
    q = np.stack([1.0 + nrm[:, 2], -nrm[:, 1], nrm[:, 0], np.zeros(n)], 1)
    disc = {"px": rng.uniform(-0.8, 0.8, n), "py": rng.uniform(-0.8, 0.8, n),
            "pz": rng.uniform(-0.8, 0.8, n), "radius": r, "cr": rng.uniform(0, 1, n),
            "cg": rng.uniform(0, 1, n), "cb": rng.uniform(0, 1, n),
            "opacity": rng.uniform(0.1, 1, n), "nx": nrm[:, 0], "ny": nrm[:, 1],
            "nz": nrm[:, 2]}
    disc = {k: _f32(v) for k, v in disc.items()}
    gauss = dict(disc, sx=disc["radius"] * 0.5, sy=disc["radius"] * 0.5,
                 sz=torch.zeros(n), **{k: _f32(q[:, i]) for i, k in enumerate(COV3D_PLANES[3:])})
    cam = _camera(1)
    base = tpt.RenderConfig(width=W, height=H, oriented=True, aa_dilation=aa,
                            tiles_per_splat_cap=64)
    got = shade_planes(gauss, cam["view_proj"], cam["cam_pos"], base.replace(ellipse="cov3d"))
    want = shade_planes(disc, cam["view_proj"], cam["cam_pos"], base.replace(ellipse="ewa"))
    for k in ("cx", "cy", "depth", "r", "g", "b"):
        assert torch.equal(got[k], want[k]), k

    def cov(p):
        c, s = torch.cos(p["angle"]), torch.sin(p["angle"])
        major2 = p["radius"] ** 2
        minor2 = major2 * p["ratio"] ** 2
        # the angle is the minor axis's direction
        return (minor2 * c * c + major2 * s * s, (minor2 - major2) * c * s,
                minor2 * s * s + major2 * c * c)

    live = want["radius"] > 0
    assert bool(live.any()) and torch.equal(got["radius"] > 0, live)
    assert torch.allclose(got["radius"], want["radius"], rtol=1e-6, atol=0)
    for k in ("ratio", "opacity"):
        assert torch.allclose(got[k], want[k], rtol=1e-4, atol=0), k
    scale = want["radius"][live] ** 2
    for a, b in zip(cov(got), cov(want)):
        assert float(((a - b)[live] / scale).abs().max()) < 1e-3


def test_gaussian_splats_planes():
    """The radius plane is 2 max(s), the normal the unit axis of the
    smallest scale, every plane (N,) float32, contiguous."""
    spl = _gaussians(500, seed=3)
    s = torch.stack([spl["sx"], spl["sy"], spl["sz"]], 1)
    assert torch.equal(spl["radius"], 2.0 * s.amax(1))
    q = torch.stack([spl[k] for k in COV3D_PLANES[3:]], 1)
    rot = ref_gs.rotation(q)  # column 2 is the axis of sz, the smallest here
    nrm = torch.stack([spl["nx"], spl["ny"], spl["nz"]], 1)
    assert torch.allclose(nrm, rot[:, :, 2], atol=1e-6)
    assert torch.allclose(nrm.norm(dim=1), torch.ones(500), atol=1e-6)
    for k, t in spl.items():
        assert t.shape == (500,) and t.dtype == torch.float32 and t.is_contiguous(), k


def test_cov3d_without_its_planes_raises():
    spl = {k: v for k, v in _gaussians(50).items() if k not in COV3D_PLANES}
    cam = _camera(0)
    with pytest.raises(ValueError, match="needs the splat planes"):
        splat_screen_words(spl, cam["view_proj"], cam["cam_pos"], tpt.RenderConfig(**KW))


def test_ply_keeps_the_covariance(tmp_path):
    """`load_ply(covariance=True)` reads the scales and the rotation as the
    file holds them; `save_ply` writes them back, and a second load reads
    the same planes (exp of a log in float32: within a few ulps, 3e-7
    read)."""
    spl = _gaussians(400, seed=4)
    sh = {c: 0.1 * torch.randn((15, 400), generator=torch.Generator().manual_seed(5))
          for c in ("r", "g", "b")}
    path = str(tmp_path / "g.ply")
    save_ply(path, spl, sh)
    got, got_sh = load_ply(path, with_sh=True, covariance=True, device="cpu")
    for k in COV3D_PLANES[3:] + ("px", "py", "pz"):
        assert torch.equal(got[k], spl[k]), k
    for k in COV3D_PLANES[:3] + ("radius",):
        assert torch.allclose(got[k], spl[k], rtol=1e-6, atol=0), k
    # colour through f_dc = (c - 0.5) / C0, opacity through its logit
    for k in ("cr", "cg", "cb", "opacity"):
        assert torch.allclose(got[k], spl[k], atol=1e-6), k
    assert all(torch.equal(got_sh[c], sh[c]) for c in sh)
    # the normal is the flattest axis either way
    for k in ("nx", "ny", "nz"):
        assert torch.allclose(got[k], spl[k], atol=1e-6), k
    path2 = str(tmp_path / "g2.ply")
    save_ply(path2, got, got_sh)
    again = load_ply(path2, with_sh=True, covariance=True, device="cpu")[0]
    for k in COV3D_PLANES:
        assert torch.allclose(again[k], got[k], rtol=1e-6, atol=0), k


def test_ply_default_is_the_disc(tmp_path):
    """Without `covariance` a file's Gaussians load as discs, as before:
    no covariance planes, radius the geometric mean of the two larger
    scales, the same normal."""
    spl = _gaussians(300, seed=6)
    path = str(tmp_path / "g.ply")
    save_ply(path, spl)
    disc = load_ply(path, device="cpu")
    cov = load_ply(path, covariance=True, device="cpu")
    assert not set(COV3D_PLANES) & set(disc)
    s = torch.sort(torch.stack([spl["sx"], spl["sy"], spl["sz"]], 1), dim=1).values
    assert torch.allclose(disc["radius"], torch.sqrt(s[:, 1] * s[:, 2]), rtol=1e-6)
    for k in disc:
        if k != "radius":
            assert torch.equal(disc[k], cov[k]), k


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the projector kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("aa", [0.0, 0.3])
def test_kernel_bit_equal_at_2m_gaussians(cuda, aa):
    """The kernel's "cov3d" instantiations at 2M Gaussians and 1080p, on
    the modeler's stride-3 columns for positions and normals: one launch,
    its five outputs bit-equal to the plain path on the card."""
    from splat_renderer_tpu_torch.ops.build import launches

    cfg = tpt.RenderConfig(**dict(KW, width=1920, height=1080, aa_dilation=aa))
    spl = {k: v.to(cuda) for k, v in _gaussians(2_000_000, seed=9).items()}
    for cols in (("px", "py", "pz"), ("nx", "ny", "nz")):
        stacked = torch.stack([spl[k] for k in cols], 1)
        spl.update({k: stacked[:, j] for j, k in enumerate(cols)})
    cam = {k: v.to(cuda) for k, v in _camera(3).items()}
    before = launches["project_words"]
    got = splat_screen_words(spl, cam["view_proj"], cam["cam_pos"], cfg)
    assert launches["project_words"] == before + 1
    from splat_renderer_tpu_torch.render.projector import splat_screen_words_plain

    want = splat_screen_words_plain(spl, cam["view_proj"], cam["cam_pos"], cfg)
    torch.cuda.synchronize()
    for k in ("dk", "w_pos", "w_ro", "w_rgb", "depth"):
        a, b = got[k], want[k]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert int((a != b).sum()) == 0, k
    assert bool((got["w_ro"] & 0xFFFF).gt(0).any())
