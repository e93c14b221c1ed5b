"""The seam every hand-written kernel goes through (`ops/build.py`): `Entry`,
one C entry point bound at its first call; its launcher and its error; the
one launch counter `launches`; the input check `check_tensor`; and the
wrappers' CPU paths, which load and launch nothing.  All on the CPU, with a
fake entry point where a library would be called; the file imports no jax.
"""

import contextlib
import ctypes
import types
from collections import Counter

import numpy as np
import pytest
import torch

import splat_renderer_tpu_torch as tpt
from splat_renderer_tpu_torch.camera import camera_tensors
from splat_renderer_tpu_torch.convert import splats_from_numpy
from splat_renderer_tpu_torch.ops import build
from splat_renderer_tpu_torch.ops.probe_rate import probe_rate
from splat_renderer_tpu_torch.ops.tile_blend import blend_tiles
from splat_renderer_tpu_torch.ops.tile_blend_diff import blend_planes
from splat_renderer_tpu_torch.render.binning import bin_packed_words
from splat_renderer_tpu_torch.render.pipeline import demo_scene, model_points
from splat_renderer_tpu_torch.render.projector import splat_screen_words
from splat_renderer_tpu_torch.render.sh import apply_sh

STREAM = 0x5EED


class _FakeFn:
    """A ctypes function stand-in: records its calls, returns `err`."""

    def __init__(self, err=0):
        self.err, self.calls = err, []
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


@pytest.fixture
def fake_library(monkeypatch):
    """`load_library` hands out one fake library with one entry point,
    "fake_forward", and counts its loads; the device and its stream are
    stood in for (this build has no CUDA)."""
    lib = types.SimpleNamespace(fake_forward=_FakeFn(), loads=0)

    def load(name):
        assert name == "fake"
        lib.loads += 1
        return lib

    monkeypatch.setattr(build, "load_library", load)
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: STREAM,
                        raising=False)
    monkeypatch.setattr(build, "launches", Counter())
    return lib


def test_entry_binds_once_at_its_first_call(fake_library):
    """Nothing loads when an entry is made; its first call loads the
    library and sets the whole signature and an int return, once; a launch
    appends the stream's handle and counts under the key it is given."""
    sig = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    entry = build.Entry("fake", "fake_forward", sig)
    assert fake_library.loads == 0
    fn = fake_library.fake_forward
    entry.launch(torch.device("cuda", 0), 11, 3, count="fake_kernel")
    entry.launch(torch.device("cuda", 0), 12, 4, count="fake_kernel")
    entry(13, 5, 0)  # a query: as it is, not counted
    assert fake_library.loads == 1
    assert fn.argtypes == sig and fn.restype is ctypes.c_int
    assert fn.calls == [(11, 3, STREAM), (12, 4, STREAM), (13, 5, 0)]
    assert build.launches == {"fake_kernel": 2}


@pytest.mark.parametrize("err", [1, 700])
def test_failed_launch_raises_and_counts_nothing(fake_library, err):
    """A nonzero return raises RuntimeError naming the entry point and the
    CUDA error code, from a launch and from a query; nothing is counted."""
    fake_library.fake_forward.err = err
    entry = build.Entry("fake", "fake_forward", [ctypes.c_int, ctypes.c_void_p])
    with pytest.raises(RuntimeError, match=rf"^fake_forward failed: CUDA error {err}$"):
        entry.launch(torch.device("cuda", 0), 1, count="fake_kernel")
    with pytest.raises(RuntimeError, match=rf"^fake_forward failed: CUDA error {err}$"):
        entry(1, 0)
    assert len(fake_library.fake_forward.calls) == 2
    assert build.launches == {}


CHECKS = {
    "dtype": (torch.zeros(4, dtype=torch.int32), dict(), r"torch\.float32 .* got torch\.int32"),
    "device": (torch.zeros(4, device="meta"), dict(), r"on cpu, got .* on meta"),
    "shape": (torch.zeros(5), dict(shape=(4,)), r"of shape \(4,\), got torch\.float32 \(5,\)"),
    "strided": (torch.zeros(8)[::2], dict(), r"not contiguous"),
}


@pytest.mark.parametrize("case", sorted(CHECKS))
def test_check_tensor_names_the_tensor(case):
    """`check_tensor` raises ValueError whose message starts with the
    tensor's name and says what it wanted and what it got."""
    t, kw, reason = CHECKS[case]
    with pytest.raises(ValueError, match=r"^binned\['offsets'\] must be ") as info:
        build.check_tensor("binned['offsets']", t, torch.float32, torch.device("cpu"), **kw)
    assert info.match(reason)


def test_check_tensor_passes_what_the_kernel_takes():
    """A match passes; with contiguous=False a strided view does too."""
    cpu = torch.device("cpu")
    build.check_tensor("x", torch.zeros(2, 3), torch.float32, cpu, shape=(2, 3))
    build.check_tensor("x", torch.zeros(8)[::2], torch.float32, cpu, shape=(4,), contiguous=False)


def _splats(n=60, seed=0):
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    pos = rng.uniform(-0.8, 0.8, (n, 3))
    planes = dict(px=pos[:, 0], py=pos[:, 1], pz=pos[:, 2], radius=rng.uniform(0.02, 0.1, n),
                  cr=rng.uniform(0, 1, n), cg=rng.uniform(0, 1, n), cb=rng.uniform(0, 1, n),
                  opacity=rng.uniform(0.2, 1.0, n),
                  nx=nrm[:, 0], ny=nrm[:, 1], nz=nrm[:, 2])
    return splats_from_numpy(planes, "cpu")


def _words(cfg):
    cam = camera_tensors(tpt.Camera().arrays(), "cpu")
    w = splat_screen_words(_splats(), cam["view_proj"], cam["cam_pos"], cfg)
    return [w[k] for k in ("dk", "w_pos", "w_ro", "w_rgb")]


def _model(cfg):
    scene = demo_scene()
    return model_points(scene, scene.params("cpu"), torch.Generator().manual_seed(0), 50,
                        tpt.PointConfig(), cfg, device="cpu")


def _blend_planes(cfg):
    rng = np.random.default_rng(1)
    n = 40
    cols = [rng.uniform(0, 32, n), rng.uniform(0, 32, n), rng.uniform(0.5, 4.0, n),
            rng.uniform(0.3, 1.0, n), *rng.uniform(0, 1, (3, n)),
            rng.uniform(-3, 3, n), rng.uniform(0.1, 1.0, n), rng.uniform(1, 5, n)]
    return blend_planes(cfg, *(torch.tensor(c, dtype=torch.float32) for c in cols))


CPU_PATHS = {
    "apply_sh": lambda cfg: apply_sh(_splats(), {c: torch.full((15, 60), 0.1) for c in "rgb"},
                                     torch.tensor([0.0, 0.0, 3.0])),
    "blend_tiles": lambda cfg: blend_tiles(bin_packed_words(*_words(cfg), cfg), cfg),
    "blend_planes": _blend_planes,
    "splat_screen_words": _words,
    "bin_packed_words": lambda cfg: bin_packed_words(*_words(cfg), cfg),
    "probe_rate": lambda cfg: probe_rate(torch.rand(4, 8), repeats=3),
    "model_points": _model,
}


@pytest.mark.parametrize("wrapper", sorted(CPU_PATHS))
def test_cpu_path_loads_and_launches_nothing(wrapper, monkeypatch):
    """Each wrapper on CPU tensors runs its plain twin: no library is
    built or loaded and no launch is counted."""

    def refuse(name):
        raise AssertionError(f"{wrapper} on the CPU loaded {name}")

    monkeypatch.setattr(build, "load_library", refuse)
    monkeypatch.setattr(build, "build", refuse)
    before, loaded = build.launches.copy(), dict(build._libs)
    cfg = tpt.RenderConfig(width=32, height=32, tiles_per_splat_cap=4)
    CPU_PATHS[wrapper](cfg)
    assert build.launches == before
    assert build._libs == loaded
