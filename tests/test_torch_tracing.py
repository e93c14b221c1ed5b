"""The port's recorder (`utils/profiling.py`) on the CPU, at a small frame
and a 96x64 fit: off, a frame or a fit step records nothing and gives the
outputs it gives on; on, the spans of a frame and of a step form the
layer tree, a parent's time covers its children's, the pair counter sums
the binnings' pair counts, `recording()` nests, and `trace()` writes the
spans into its Chrome trace."""

import json
import os

import pytest
import torch

import splat_renderer_tpu_torch as tpt
from splat_renderer_tpu_torch.camera import camera_tensors
from splat_renderer_tpu_torch.fit import fit_splats
from splat_renderer_tpu_torch.render import binning
from splat_renderer_tpu_torch.render.pipeline import Engine, SplatEngine, demo_scene
from splat_renderer_tpu_torch.utils import profiling

W, H = 96, 64
MODEL = {"model/seed", "model/descent", "model/curvature", "model/derive"}
CHAIN = {("project", "frame"), ("bin", "frame"), ("blend", "frame"), ("image", "frame")}
SDF_TREE = ({("frame", None), ("model", "frame")} | {(m, "model") for m in MODEL} | CHAIN)
SH_TREE = {("frame", None), ("sh", "frame")} | CHAIN
STEP_TREE = {("fit/step", None), ("sh", "fit/step"), ("fit/render", "fit/step"),
             ("image", "fit/render"), ("fit/loss", "fit/step"), ("fit/backward", "fit/step"),
             ("fit/adam", "fit/step")}


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with the recorder off and empty."""
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _camera():
    return camera_tensors(tpt.Camera(aspect=W / H).arrays(), "cpu")


def _static_scene(n=400, seed=3):
    g = torch.Generator().manual_seed(seed)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(n, generator=g)  # noqa: E731
    nrm = torch.randn((3, n), generator=g)
    nrm = nrm / torch.linalg.vector_norm(nrm, dim=0)
    splats = {"px": u(-0.6, 0.6), "py": u(-0.6, 0.6), "pz": u(-0.6, 0.6),
              "radius": u(0.03, 0.09), "cr": u(0, 1), "cg": u(0, 1), "cb": u(0, 1),
              "opacity": u(0.3, 1.0), "nx": nrm[0], "ny": nrm[1], "nz": nrm[2]}
    sh = {c: 0.1 * torch.randn((15, n), generator=g) for c in ("r", "g", "b")}
    return splats, sh


def _frame_sdf():
    """A frame of the live modeler's engine (made here, outside any span)."""
    eng = Engine(demo_scene(), tpt.PointConfig(descent_steps=2),
                 tpt.RenderConfig(width=W, height=H), n=600, device="cpu")
    cam = _camera()
    return lambda: eng.frame(cam, torch.Generator().manual_seed(0))


def _frame_static():
    """A frame of a static SH-lit set's engine."""
    splats, sh = _static_scene()
    eng = SplatEngine(splats, tpt.RenderConfig(width=W, height=H), sh=sh, device="cpu")
    cam = _camera()
    return lambda: eng.frame(cam)


def _fit_two_steps():
    """Two L1/D-SSIM fit steps of four fields and the SH rows, from a
    perturbed start, their losses and fitted values as one tensor."""
    splats, sh = _static_scene()
    rcfg = tpt.RenderConfig(width=W, height=H)
    cam = _camera()
    target = SplatEngine(splats, rcfg, sh=sh, device="cpu").frame(cam)
    start = dict(splats, cr=splats["cr"] * 0.9, radius=splats["radius"] * 1.1)

    def run():
        fitted, losses, fitted_sh = fit_splats(
            start, [cam], [target], rcfg, fields=("px", "radius", "cr", "opacity"), steps=2,
            lr=1e-3, method="kernel", loss="ssim", sh=sh, fit_sh=True)
        return torch.cat([losses] + [v.reshape(-1) for v in fitted.values()]
                         + [v.reshape(-1) for v in fitted_sh.values()])

    return run


# what is run: (a maker of the call, its span tree as (name, parent), its root)
RUNS = {"sdf_frame": (_frame_sdf, SDF_TREE, "frame"),
        "static_frame": (_frame_static, SH_TREE, "frame"),
        "fit_steps": (_fit_two_steps, STEP_TREE, "fit/step")}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_off_records_nothing_and_matches_on(run, monkeypatch):
    fn = RUNS[run][0]()

    def refuse(*a, **k):
        raise AssertionError("tracing off made a CUDA event or a profiler range")

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "Event", refuse)
        m.setattr(profiling, "record_function", refuse)
        off = fn()
    assert profiling.report() == {} and profiling.intervals() == []
    assert profiling.counter("pairs") == 0.0
    with profiling.recording():
        on = fn()
    assert profiling.report() == {}  # the recording was its own
    assert torch.equal(off, on)


def test_off_hands_back_one_null_context():
    assert profiling.span("frame") is profiling.span("frame")
    assert not profiling.enabled()


@pytest.mark.parametrize("run", sorted(RUNS))
def test_the_span_tree_is_the_layer_table(run):
    make, tree, root = RUNS[run]
    fn = make()
    with profiling.recording() as rec:
        fn()
    got = {(name, parent) for name, parent, _, _ in rec.intervals()}
    assert got == tree
    calls = rec.report()[root]["calls"]
    assert calls == (2 if root == "fit/step" else 1)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_a_parent_covers_its_children(run):
    fn = RUNS[run][0]()
    with profiling.recording() as rec:
        fn()
    calls = rec.calls
    child_ns = [0] * len(calls)
    for c in calls:
        if c[1] >= 0:
            child_ns[c[1]] += c[3] - c[2]
            parent = calls[c[1]]
            assert parent[2] <= c[2] and c[3] <= parent[3]
    for c, ns in zip(calls, child_ns):
        assert c[3] - c[2] >= ns
    assert all(r["self_ms"] >= 0 for r in rec.report().values())


@pytest.mark.parametrize("run", sorted(RUNS))
def test_pairs_sums_the_binnings(run, monkeypatch):
    made = []
    pair_stage = binning._pair_stage

    def counted(*a, **k):
        out = pair_stage(*a, **k)
        made.append(int(out["offsets"][-1]))
        return out

    make, _, root = RUNS[run]
    fn = make()
    made.clear()
    monkeypatch.setattr(binning, "_pair_stage", counted)
    with profiling.recording() as rec:
        fn()
    assert made and rec.counter("pairs") == sum(made)
    assert rec.counter("pairs", within=root) == sum(made)
    assert rec.counter("pairs", within="other") == 0


def test_recording_nests_and_restores():
    profiling.enable()
    with profiling.span("outer"):
        with profiling.recording() as a:
            with profiling.span("a"):
                with profiling.recording() as b:
                    with profiling.span("b"):
                        pass
                assert profiling.enabled()
            profiling.count("n", torch.tensor(2))
    assert profiling.enabled()
    assert set(a.report()) == {"a"} and set(b.report()) == {"b"}
    assert set(profiling.report()) == {"outer"} and a.counter("n") == 2
    profiling.disable()
    with profiling.recording() as c:
        with profiling.span("c"):
            pass
    assert not profiling.enabled() and set(c.report()) == {"c"}
    assert set(profiling.report()) == {"outer"}


def test_span_decorates():
    @profiling.span("deco")
    def f(x):
        return x + 1

    assert f(1) == 2
    with profiling.recording() as rec:
        assert f(2) == 3
    assert rec.report()["deco"]["calls"] == 1


def test_trace_writes_the_frame_span(tmp_path):
    log_dir = str(tmp_path / "trace")
    frame = _frame_sdf()
    with profiling.trace(log_dir):
        frame()
    assert not profiling.enabled()
    names = {e.get("name") for e in json.load(open(os.path.join(log_dir, profiling.TRACE_FILE)))
             ["traceEvents"]}
    assert {"splat/frame", "splat/model/descent", "splat/blend"} <= names
