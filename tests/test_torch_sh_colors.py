"""SH lighting's CUDA kernel (`ops/sh_colors.py`, csrc/sh_colors.cu) against
the plain path `apply_sh_plain`.

The `gpu` tests hold the kernel's lit colours bit-equal to the plain path
on the card (every degree, truncated degrees, strided planes, coefficients
and camera, 1M splats), one launch a call, none under autograd, and no
read-back from the device; and skip where torch sees no CUDA device.  The
rest run on the CPU: the dispatch, the float32 scalars the wrapper hands
the kernel and the wrapper's input checks.  The file imports no jax:

    python -m pytest --noconftest -m gpu tests/test_torch_sh_colors.py
"""

import numpy as np
import pytest
import torch

from splat_renderer_tpu_torch.ops import build
from splat_renderer_tpu_torch.ops.build import launches
from splat_renderer_tpu_torch.ops.sh_colors import PLANES, float32s, sh_colors
from splat_renderer_tpu_torch.render import sh as sh_module
from splat_renderer_tpu_torch.render.sh import (
    KERNEL_SCALARS, SH_C1, SH_C2, SH_C3, SQ_LENGTH_FLOOR, apply_sh, apply_sh_plain,
    kernel_takes,
)
from splat_renderer_tpu_torch.utils import profiling

COLOURS = ("cr", "cg", "cb")
# (the coefficients' degree, the `degree=` argument)
CASES = [(1, None), (2, None), (3, None), (3, 1), (3, 2), (2, 1)]
LAYOUTS = ("rows", "columns")
CAM = (0.3, -2.5, 1.7)
REST_ROWS = {1: 3, 2: 8, 3: 15}  # rest coefficients a channel, by degree


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SH kernel runs only on the card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.disable()


@pytest.fixture
def no_library(monkeypatch):
    """Building or loading any kernel library fails the test."""

    def refuse(name):
        raise AssertionError(f"loaded the {name} library")

    monkeypatch.setattr(build, "load_library", refuse)
    monkeypatch.setattr(build, "build", refuse)


def _inputs(n, full, seed=0, layout="rows", device="cpu"):
    """Splat planes, degree-`full` coefficients and a camera position.
    Splat 0 sits on the camera (the squared length is its floor), splat 1
    has a NaN coefficient, base colours and coefficients push some colours
    past both clip bounds.  layout "rows": contiguous planes, the
    coefficients rows of one (3, R, N) tensor, the camera a row of a (V, 3)
    tensor (as `camera_at` gives it); "columns": the planes stride-3
    columns of (N, 3) tensors, the coefficients (R, N) transposes of
    (N, R) slices of an (N, 3, R) tensor, the camera a stride-4 column."""
    rng = np.random.default_rng(seed)
    cam = np.asarray(CAM, np.float32)
    pos = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    pos[0] = cam
    col = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    coeff = rng.normal(0.0, 0.3, (3, REST_ROWS[full], n)).astype(np.float32)
    coeff[0, 0, 1] = np.nan
    opacity = torch.from_numpy(rng.uniform(0.1, 1.0, n).astype(np.float32)).to(device)
    if layout == "rows":
        pos_t, col_t = torch.from_numpy(pos.T.copy()).to(device), torch.from_numpy(col.T.copy())
        planes = [pos_t[0], pos_t[1], pos_t[2], *col_t.to(device)]
        c = torch.from_numpy(coeff).to(device)
        sh = {"r": c[0], "g": c[1], "b": c[2]}
        cams = torch.zeros((4, 3), dtype=torch.float32, device=device)
        cams[2] = torch.from_numpy(cam).to(device)
        cam_pos = cams[2]
    else:
        pos_t, col_t = torch.from_numpy(pos).to(device), torch.from_numpy(col).to(device)
        planes = [pos_t[:, 0], pos_t[:, 1], pos_t[:, 2], col_t[:, 0], col_t[:, 1], col_t[:, 2]]
        c = torch.from_numpy(coeff.transpose(2, 0, 1).copy()).to(device)  # (N, 3, R)
        sh = {ch: c[:, j, :].T for j, ch in enumerate("rgb")}
        cams = torch.zeros((3, 4), dtype=torch.float32, device=device)
        cams[:, 1] = torch.from_numpy(cam).to(device)
        cam_pos = cams[:, 1]
        assert planes[0].stride(0) == 3 and sh["g"].stride() == (1, 3 * REST_ROWS[full])
        assert cam_pos.stride(0) == 4
    splats = dict(zip(PLANES, planes), opacity=opacity)
    return splats, sh, cam_pos


def _assert_bit_equal(got, want, atol=0.0):
    """The lit colours equal bit for bit (NaN where the other has NaN), or
    within `atol`; every other plane passed through untouched."""
    assert set(got) == set(want)
    for k in got:
        if k not in COLOURS:
            assert got[k] is want[k], k
            continue
        a, b = got[k].cpu(), want[k].cpu()
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape, k
        nan = torch.isnan(a)
        assert torch.equal(nan, torch.isnan(b)), f"{k}: NaN elsewhere"
        if atol == 0.0:
            differ = int((a.view(torch.int32) != b.view(torch.int32))[~nan].sum())
            assert differ == 0, f"{k}: {differ} of {a.numel()} differ"
        else:
            gap = float((a - b)[~nan].abs().max())
            assert gap <= atol, f"{k}: largest gap {gap:.3e} over {atol:.1e}"


# ---- CPU ----

@pytest.mark.parametrize("full,degree", CASES + [(3, 0), (None, None)])
def test_cpu_takes_the_plain_path(no_library, full, degree):
    """On the CPU `apply_sh` is the plain path bit for bit, for every
    degree, truncation, degree 0 and `sh=None`, and loads and launches
    nothing."""
    spl, sh, cam = _inputs(700, full or 3, seed=1, layout="columns")
    sh = sh if full else None
    before = launches.copy()
    got = apply_sh(spl, sh, cam, degree)
    assert launches == before
    _assert_bit_equal(got, apply_sh_plain(spl, sh, cam, degree))


def test_cpu_autograd_is_the_plain_path(no_library):
    """Under autograd on the CPU the colours and gradients are the plain
    path's bit for bit."""
    spl, sh, cam = _inputs(300, 3, seed=2)
    sh = {ch: v.clone() for ch, v in sh.items()}
    sh["r"][0, 1] = 0.1  # no NaN on a differentiated path
    weights = [torch.linspace(-1.0, 1.0, 300) * (j + 1) for j in range(3)]

    def grads(fn):
        leaves = {"px": spl["px"].clone().requires_grad_(True),
                  "cg": spl["cg"].clone().requires_grad_(True),
                  "sh_b": sh["b"].clone().requires_grad_(True)}
        out = fn(dict(spl, px=leaves["px"], cg=leaves["cg"]), dict(sh, b=leaves["sh_b"]), cam)
        loss = sum((out[c] * w).sum() for c, w in zip(COLOURS, weights))
        return [out[c].detach() for c in COLOURS], torch.autograd.grad(loss, list(leaves.values()))

    (got, got_g), (want, want_g) = grads(apply_sh), grads(apply_sh_plain)
    for a, b in zip(got + list(got_g), want + list(want_g)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


class _Stand:
    """What `kernel_takes` reads of a tensor: its device and whether it
    requires a gradient."""

    def __init__(self, is_cuda=True, requires_grad=False):
        self.is_cuda, self.requires_grad = is_cuda, requires_grad


# which of the ten inputs (six planes, three coefficient tensors, the
# camera) is changed, and how
DISPATCH = {
    "none": (None, {}),
    "plane_grad": (0, dict(requires_grad=True)),
    "colour_grad": (4, dict(requires_grad=True)),
    "coeff_grad": (7, dict(requires_grad=True)),
    "cam_grad": (9, dict(requires_grad=True)),
    "plane_on_cpu": (2, dict(is_cuda=False)),
    "cam_on_cpu": (9, dict(is_cuda=False)),
}


@pytest.mark.parametrize("grad_mode", [True, False])
@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_kernel_takes_a_call_only_where_no_gradient_can_flow(case, grad_mode):
    """The kernel takes a call when every input is on CUDA and no gradient
    can flow: grad mode is off, or no input requires one."""
    which, change = DISPATCH[case]
    inputs = [_Stand() for _ in range(10)]
    if which is not None:
        inputs[which] = _Stand(**change)
    with torch.set_grad_enabled(grad_mode):
        got = kernel_takes(inputs)
    on_cuda = "cpu" not in case
    assert got == (on_cuda and (case == "none" or not grad_mode))


@pytest.mark.parametrize("full,degree,launched", [
    (3, None, 3), (3, 2, 2), (2, 5, 2), (3, 0, None), (None, None, None),
])
def test_apply_sh_hands_the_kernel_what_it_takes(monkeypatch, full, degree, launched):
    """Where `kernel_takes` says yes, `apply_sh` hands the kernel the
    truncated degree, after asking about the six planes, the three
    coefficient tensors and the camera; degree 0 and `sh=None` take the
    plain path whatever it says."""
    spl, sh, cam = _inputs(50, full or 3)
    sh = sh if full else None
    asked, calls = [], []
    monkeypatch.setattr(sh_module, "kernel_takes", lambda ts: asked.append(ts) or True)
    monkeypatch.setattr(sh_module, "sh_colors",
                        lambda *args: calls.append(args) or "kernel")
    got = apply_sh(spl, sh, cam, degree)
    if launched is None:
        assert calls == [] and got != "kernel"
        _assert_bit_equal(got, apply_sh_plain(spl, sh, cam, degree))
        return
    assert got == "kernel" and len(calls) == 1
    assert calls[0][0] is spl and calls[0][1] is sh and calls[0][2] is cam
    assert calls[0][3] == launched and calls[0][4] is KERNEL_SCALARS
    want = [spl[k] for k in PLANES] + [sh["r"], sh["g"], sh["b"], cam]
    assert len(asked) == 1 and len(asked[0]) == len(want)
    assert all(a is b for a, b in zip(asked[0], want))


def test_constants_are_the_plain_paths_roundings():
    """The 15 float32 scalars the wrapper hands the kernel for `apply_sh`'s
    `KERNEL_SCALARS` are the plain path's Python scalars as PyTorch rounds
    them against a float32 tensor, in the kernel's order: -SH_C1, SH_C1,
    SH_C2, SH_C3, the floor."""
    one = torch.ones(1, dtype=torch.float32)
    want = [float((one * c)[0]) for c in (-SH_C1, SH_C1, *SH_C2, *SH_C3)]
    want.append(float((torch.zeros(1, dtype=torch.float32) + SQ_LENGTH_FLOOR)[0]))
    got = list(float32s(KERNEL_SCALARS))
    assert len(got) == 15
    assert np.array_equal(np.asarray(got, np.float32).view(np.int32),
                          np.asarray(want, np.float32).view(np.int32))
    # the floor stays a normal float32, above zero
    assert got[14] > 0.0 and np.float32(got[14]) >= np.finfo(np.float32).tiny


def test_wrapper_rejects_what_it_cannot_take(no_library):
    """The wrapper checks dtype, shape, rows and device before it looks for
    a kernel; CPU tensors it refuses (they take the plain path)."""
    spl, sh, cam = _inputs(64, 3)
    with pytest.raises(ValueError, match="float32"):
        sh_colors(dict(spl, cg=spl["cg"].double()), sh, cam, 3, KERNEL_SCALARS)
    with pytest.raises(ValueError, match=r"shape \(64,\)"):
        sh_colors(dict(spl, pz=spl["pz"][1:]), sh, cam, 3, KERNEL_SCALARS)
    with pytest.raises(ValueError, match="1-d"):
        sh_colors(dict(spl, px=spl["px"][:, None]), sh, cam, 3, KERNEL_SCALARS)
    with pytest.raises(ValueError, match=r"sh\['b'\].*float32"):
        sh_colors(spl, dict(sh, b=sh["b"].double()), cam, 3, KERNEL_SCALARS)
    with pytest.raises(ValueError, match=r"sh\['g'\].*shape \(15, 64\)"):
        sh_colors(spl, dict(sh, g=sh["g"][:, :63]), cam, 3, KERNEL_SCALARS)
    with pytest.raises(ValueError, match=r"sh\['b'\].*shape \(15, 64\)"):
        sh_colors(spl, dict(sh, b=sh["b"][:8]), cam, 2, KERNEL_SCALARS)
    with pytest.raises(ValueError, match="2-d"):
        sh_colors(spl, dict(sh, r=sh["r"][0]), cam, 3, KERNEL_SCALARS)
    with pytest.raises(ValueError, match="needs 15 coefficient rows"):
        sh_colors(spl, {ch: v[:8] for ch, v in sh.items()}, cam, 3, KERNEL_SCALARS)
    for degree in (0, 4):
        with pytest.raises(ValueError, match="degree 1, 2 or 3"):
            sh_colors(spl, sh, cam, degree, KERNEL_SCALARS)
    with pytest.raises(ValueError, match="cam_pos"):
        sh_colors(spl, sh, torch.zeros(4), 3, KERNEL_SCALARS)
    with pytest.raises(ValueError, match="cam_pos"):
        sh_colors(spl, sh, cam.double(), 3, KERNEL_SCALARS)
    with pytest.raises(ValueError, match="15 scalars, got 14"):
        sh_colors(spl, sh, cam, 3, KERNEL_SCALARS[:14])
    with pytest.raises(ValueError, match="no SH kernel"):
        sh_colors(spl, sh, cam, 3, KERNEL_SCALARS)


# ---- on the card ----

@pytest.mark.gpu
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("full,degree", CASES)
def test_kernel_bit_equal_to_plain(cuda, full, degree, layout):
    """The lit colours equal the plain path on the card bit for bit, for
    every degree and truncation, on contiguous rows and on strided planes,
    coefficients and camera; one launch a call."""
    spl, sh, cam = _inputs(20_000, full, seed=3, layout=layout, device=cuda)
    before = launches["sh_colors"]
    got = apply_sh(spl, sh, cam, degree)
    assert launches["sh_colors"] == before + 1
    want = apply_sh_plain(spl, sh, cam, degree)
    torch.cuda.synchronize()
    _assert_bit_equal(got, want)
    # both clip bounds and the NaN are on the path
    assert bool((got["cr"] == 0.0).any()) and bool((got["cg"] == 1.0).any())
    assert bool(torch.isnan(got["cr"][1]))


@pytest.mark.gpu
def test_kernel_bit_equal_at_1m_splats(cuda):
    """1M splats at degree 3, the coefficients rows of one (3, 15, N) tensor
    and the camera a row of a (V, 3) tensor, as the benchmark and
    `render_views` give them: one launch, bit-equal to the plain path."""
    n = 1_000_000
    gen = torch.Generator(device=cuda).manual_seed(11)
    pos = torch.rand((3, n), generator=gen, device=cuda) * 2.0 - 1.0
    col = torch.rand((3, n), generator=gen, device=cuda)
    spl = dict(zip(PLANES, [*pos, *col]))
    c = torch.randn((3, 15, n), generator=gen, device=cuda) * 0.1
    sh = {"r": c[0], "g": c[1], "b": c[2]}
    cams = torch.tensor([[0.0, 0.0, 3.0], [2.1, 0.4, -2.2]], device=cuda)
    for v in range(2):
        before = launches["sh_colors"]
        got = apply_sh(spl, sh, cams[v])
        assert launches["sh_colors"] == before + 1
        _assert_bit_equal(got, apply_sh_plain(spl, sh, cams[v]))


@pytest.mark.gpu
def test_kernel_against_the_plain_path_on_the_cpu(cuda):
    """Against the plain path on CPU copies: the card's rsqrtf and the
    CPU's rsqrt may be an ulp apart, which moves a colour by float32
    rounding at most (the card's own plain path agrees with the kernel bit
    for bit)."""
    for layout in LAYOUTS:
        spl, sh, cam = _inputs(20_000, 3, seed=6, layout=layout, device=cuda)
        got = apply_sh(spl, sh, cam)
        want = apply_sh_plain({k: v.cpu() for k, v in spl.items()},
                              {k: v.cpu() for k, v in sh.items()}, cam.cpu())
        got = {k: (v if k in COLOURS else want[k]) for k, v in got.items()}
        _assert_bit_equal(got, want, atol=1e-6)


@pytest.mark.gpu
def test_one_launch_per_call(cuda):
    """Each `apply_sh` call is one launch, and so is a direct call to the
    wrapper: both counted under "sh_colors"."""
    spl, sh, cam = _inputs(3000, 3, device=cuda)
    before = launches["sh_colors"]
    for k in range(1, 4):
        apply_sh(spl, sh, cam)
        assert launches["sh_colors"] == before + k
    sh_colors(spl, sh, cam, 2, KERNEL_SCALARS)
    assert launches["sh_colors"] == before + 4
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_autograd_keeps_the_plain_path(cuda):
    """Where a gradient can flow nothing is launched and the colours and
    gradients are the plain path's bit for bit; under no_grad the kernel
    takes the same leaves."""
    spl, sh, cam = _inputs(5000, 3, seed=8, device=cuda)
    sh = {ch: v.clone() for ch, v in sh.items()}
    sh["r"][0, 1] = 0.1  # no NaN on a differentiated path
    weights = [torch.linspace(-1.0, 1.0, 5000, device=cuda) * (j + 1) for j in range(3)]

    def run(fn):
        leaves = [spl["px"].clone().requires_grad_(True), spl["cb"].clone().requires_grad_(True),
                  sh["g"].clone().requires_grad_(True)]
        s, h = dict(spl, px=leaves[0], cb=leaves[1]), dict(sh, g=leaves[2])
        out = fn(s, h, cam)
        loss = sum((out[c] * w).sum() for c, w in zip(COLOURS, weights))
        return [out[c].detach() for c in COLOURS] + list(torch.autograd.grad(loss, leaves)), s, h

    before = launches["sh_colors"]
    got, s, h = run(apply_sh)
    assert launches["sh_colors"] == before
    want, _, _ = run(apply_sh_plain)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    with torch.no_grad():
        lit = apply_sh(s, h, cam)
    assert launches["sh_colors"] == before + 1
    for c, b in zip(COLOURS, want):
        assert torch.equal(lit[c].view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
def test_no_host_read_back(cuda):
    """A call synchronises nothing with the host: CUDA's sync debug mode
    set to "error" lets it through."""
    spl, sh, cam = _inputs(4000, 3, device=cuda)
    want = apply_sh_plain(spl, sh, cam)
    apply_sh(spl, sh, cam)  # the library is built and loaded outside the check
    torch.cuda.synchronize()
    before = launches["sh_colors"]
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = apply_sh(spl, sh, cam)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert launches["sh_colors"] == before + 1
    _assert_bit_equal(got, want)


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda):
    """float64 coefficients or planes on the card raise and launch nothing;
    a camera on the CPU takes the plain path."""
    spl, sh, cam = _inputs(500, 3, device=cuda)
    before = launches["sh_colors"]
    with pytest.raises(ValueError, match="float32"):
        apply_sh(spl, dict(sh, r=sh["r"].double()), cam)
    with pytest.raises(ValueError, match="float32"):
        apply_sh(dict(spl, py=spl["py"].double()), sh, cam)
    got = apply_sh(spl, sh, cam.cpu())
    assert launches["sh_colors"] == before
    _assert_bit_equal(got, apply_sh_plain(spl, sh, cam.cpu()))
