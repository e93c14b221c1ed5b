"""The port's recorder (`utils/profiling.py`) on the CPU, at a small frame,
a 96x64 fit and a batch of views of 3D Gaussians: off, a frame, a fit step
or a batch records nothing and gives the outputs it gives on; on, the
spans of a frame, a step and a batch form the layer tree, a parent's time
covers its children's, the pair counter sums the binnings' pair counts,
the `cov3d_splats` counter the Gaussians projected and `cov3d_capped`
those at the radius cap, `blend_walked` each tile's walk as the reference's
fold needs it (and the kernel's wrapper hands the kernel a buffer for it
only while recording), `recording()` nests,
and `trace()` writes the spans into its Chrome trace."""

import json
import os

import pytest
import torch

import splat_renderer_tpu_torch as tpt
from splat_renderer_tpu_torch.camera import camera_tensors, orbit_ring
from splat_renderer_tpu_torch.fit import fit_splats
from splat_renderer_tpu_torch.points import gaussian_splats
from splat_renderer_tpu_torch.render import binning
from splat_renderer_tpu_torch.render.multiview import render_views, render_views_gbuffer
from splat_renderer_tpu_torch.render.pipeline import Engine, SplatEngine, demo_scene
from splat_renderer_tpu_torch.ops.tile_blend import blend_tiles
from splat_renderer_tpu_torch.render.projector import shade_planes, splat_screen_words
from splat_renderer_tpu_torch.utils import profiling

W, H = 96, 64
MODEL = {"model/seed", "model/descent", "model/curvature", "model/derive"}
CHAIN = {("project", "frame"), ("bin", "frame"), ("blend", "frame"), ("image", "frame")}
SDF_TREE = ({("frame", None), ("model", "frame")} | {(m, "model") for m in MODEL} | CHAIN)
SH_TREE = {("frame", None), ("sh", "frame")} | CHAIN
VIEWS_TREE = {("views", None)} | {(name, "views") for name in ("sh", "project", "bin", "blend",
                                                               "image")}
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


def _gaussians(n=400, seed=3):
    """The static scene's splats as anisotropic 3D Gaussians, and its SH."""
    splats, sh = _static_scene(n, seed)
    g = torch.Generator().manual_seed(seed + 1)
    pos = torch.stack([splats["px"], splats["py"], splats["pz"]], 1)
    scales = splats["radius"][:, None] * (0.1 + 0.4 * torch.rand((n, 3), generator=g))
    col = torch.stack([splats["cr"], splats["cg"], splats["cb"]], 1)
    return gaussian_splats(pos, scales, torch.randn((n, 4), generator=g), col,
                           splats["opacity"]), sh


VIEWS_CFG = tpt.RenderConfig(width=W, height=H, oriented=True, ellipse="cov3d", aa_dilation=0.3,
                             tiles_per_splat_cap=8)


def _views_batch():
    """A batch of 3 views of 3D Gaussians, SH lit, as uint8 rows."""
    splats, sh = _gaussians()
    cams = camera_tensors(orbit_ring(3, aspect=W / H), "cpu")
    return lambda: render_views(splats, cams, VIEWS_CFG, flat=True, as_uint8=True, sh=sh,
                                device="cpu")


# what is run: (a maker of the call, its span tree as (name, parent), its root)
RUNS = {"sdf_frame": (_frame_sdf, SDF_TREE, "frame"),
        "static_frame": (_frame_static, SH_TREE, "frame"),
        "fit_steps": (_fit_two_steps, STEP_TREE, "fit/step"),
        "views_batch": (_views_batch, VIEWS_TREE, "views")}


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
    assert profiling.counter("pairs") == 0.0 and profiling.counter("cov3d_splats") == 0.0
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


def test_cov3d_splats_counts_the_gaussians_projected():
    """`cov3d_splats` adds N for each "cov3d" projection, under the root
    span open at the call, and nothing for the other models."""
    splats, sh = _gaussians(n=300)
    cams = camera_tensors(orbit_ring(3, aspect=W / H), "cpu")
    with profiling.recording() as rec:
        render_views(splats, cams, VIEWS_CFG, sh=sh, device="cpu")
        render_views(splats, cams, VIEWS_CFG.replace(ellipse="ewa"), device="cpu")
    assert rec.counter("cov3d_splats") == 3 * 300
    assert rec.counter("cov3d_splats", within="views") == 3 * 300
    assert rec.report()["views"]["calls"] == 2


def test_cov3d_capped_counts_the_records_at_the_cap():
    """`cov3d_live` adds a projection's records with a radius and
    `cov3d_capped` those whose radius sits at r_cap: at least every
    Gaussian whose unclamped radius (the same model under a cap that never
    binds) reaches r_cap, at most those within the grid's half step below
    it.  Half of the Gaussians are made large, so some are capped and
    some are not."""
    splats, sh = _gaussians(n=300)
    big = torch.arange(300) % 2 == 0
    for k in ("sx", "sy", "sz", "radius"):
        splats[k] = torch.where(big, 6.0 * splats[k], splats[k])
    cams = camera_tensors(orbit_ring(3, aspect=W / H), "cpu")
    with profiling.recording() as rec:
        render_views(splats, cams, VIEWS_CFG, sh=sh, device="cpu")
    free = VIEWS_CFG.replace(tiles_per_splat_cap=4096)
    r_cap, half = VIEWS_CFG.r_cap, 0.5 / VIEWS_CFG.pos_scale
    live = at_least = at_most = 0
    for v in range(3):
        vp, pos = cams["view_proj"][v], cams["cam_pos"][v]
        live += int((shade_planes(splats, vp, pos, VIEWS_CFG)["radius"] * VIEWS_CFG.pos_scale
                     >= 0.5).sum())
        r = shade_planes(splats, vp, pos, free)["radius"]
        at_least += int((r >= r_cap).sum())
        at_most += int((r >= r_cap - half).sum())
    assert rec.counter("cov3d_live", within="views") == live
    assert 0 < at_least <= rec.counter("cov3d_capped", within="views") <= at_most < live


def test_the_gbuffer_views_are_a_views_span():
    """`render_views_gbuffer` is one `views` span over its views' G-buffers."""
    splats, sh = _gaussians(n=300)
    cams = camera_tensors(orbit_ring(2, aspect=W / H), "cpu")
    with profiling.recording() as rec:
        out = render_views_gbuffer(splats, cams, VIEWS_CFG, sh=sh, device="cpu")
    assert out["rgb"].shape == (2, H, W, 3)
    assert {(n, p) for n, p, _, _ in rec.intervals() if p is None} == {("views", None)}
    assert rec.report()["project"]["calls"] == 2
    assert rec.counter("cov3d_splats", within="views") == 2 * 300


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


def _dense_binned(cfg, n=4000, seed=0):
    """Binned records of n splats dense enough on the small frame that the
    opaque profiles stop most tiles early; opaque splats at opacity 1."""
    g = torch.Generator().manual_seed(seed)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(n, generator=g)  # noqa: E731
    nrm = torch.randn((3, n), generator=g)
    nrm = nrm / torch.linalg.vector_norm(nrm, dim=0)
    splats = {"px": u(-0.6, 0.6), "py": u(-0.6, 0.6), "pz": u(-0.6, 0.6),
              "radius": u(0.05, 0.15), "cr": u(0, 1), "cg": u(0, 1), "cb": u(0, 1),
              "opacity": torch.ones(n) if cfg.opaque else u(0.2, 1.0),
              "nx": nrm[0], "ny": nrm[1], "nz": nrm[2]}
    cam = _camera()
    w = splat_screen_words(splats, cam["view_proj"], cam["cam_pos"], cfg)
    return binning.bin_packed_words(w["dk"], w["w_pos"], w["w_ro"], w["w_rgb"], cfg)


def _one_tile(binned, t):
    """`binned` with every tile's run but tile t's emptied."""
    off = binned["offsets"].to(torch.int64)
    a, b = int(off[t]), int(off[t + 1])
    offsets = torch.where(torch.arange(off.shape[0]) <= t, 0, b - a).to(binned["offsets"].dtype)
    counts = torch.zeros_like(binned["counts"])
    counts[t] = b - a
    return dict(binned, offsets=offsets, counts=counts, pair_rank=binned["pair_rank"][a:b],
                pair_tile=binned["pair_tile"][a:b])


WALK_PROFILES = {"quad": dict(opaque=True, oriented=True, quad=True),
                 "opaque": dict(opaque=True, oriented=True),
                 "gauss": dict()}


@pytest.mark.parametrize("profile", sorted(WALK_PROFILES))
def test_blend_walked_is_the_reference_folds_walk_tile_by_tile(profile):
    """The twin's `blend_walked`, tile by tile, equals the run positions the
    reference's exact fold reads before every pixel of the tile has stopped
    (`fold_blend`'s "pairs" on the tile's run alone), and the frame's count
    is their sum; the opaque profiles stop most tiles early.  (The Gaussian
    profile's twin rounds its products unlike the fold; no stop moves here.)"""
    import dataclasses

    from gpubench.reference.config import RenderConfig as RefRenderConfig
    from gpubench.reference.frame import fold_blend

    cfg = tpt.RenderConfig(width=W, height=H, tiles_per_splat_cap=16, **WALK_PROFILES[profile])
    rcfg = RefRenderConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    binned = _dense_binned(cfg)
    walks, want = [], []
    for t in range(cfg.num_tiles):
        one = _one_tile(binned, t)
        with profiling.recording() as rec:
            blend_tiles(one, cfg)
        walks.append(rec.counter("blend_walked"))
        want.append(fold_blend(one, rcfg)[2]["pairs"])
    assert walks == want
    with profiling.recording() as rec:
        blend_tiles(binned, cfg)
    assert rec.counter("blend_walked") == sum(want)
    if cfg.opaque:
        assert sum(want) < 0.7 * int(binned["offsets"][-1])


def test_the_kernel_gets_a_walk_buffer_only_while_recording(monkeypatch):
    """On a (fake) CUDA device `blend_tiles` hands K1 a device buffer for
    `blend_walked` only while the recorder is on and only with the per-tile
    schedule, and counts it under the open root span without reading it;
    off, it hands none and records nothing."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    from splat_renderer_tpu_torch.ops import tile_blend

    handed = []

    class Forward:
        def launch(self, device, *args, count=None):
            handed.append((count, args[-1]))

    monkeypatch.setattr(tile_blend, "_FORWARD", Forward())
    monkeypatch.setattr(FakeTensor, "data_ptr", lambda self: 0x1000, raising=False)
    cfg = tpt.RenderConfig(width=W, height=H, opaque=True, oriented=True, quad=True)
    with FakeTensorMode():
        dev = torch.device("cuda", 0)
        binned = {k: torch.zeros(n, dtype=torch.int32, device=dev)
                  for k, n in (("offsets", cfg.num_tiles + 1), ("counts", cfg.num_tiles),
                               ("pair_rank", 8), ("rec_pos", 8), ("rec_ro", 8),
                               ("rec_rgb", 8))}
        tile_blend.blend_tiles(binned, cfg)
        off = set(profiling.report())
        with profiling.recording() as rec:
            with profiling.span("frame"):
                tile_blend.blend_tiles(binned, cfg)
                tile_blend.blend_tiles(binned, cfg, schedule="tile_xp")
            counted = set(rec.counts)
    assert not off
    assert handed == [("tile_blend", None), ("tile_blend", 0x1000), ("tile_blend_xp", None)]
    assert counted == {("blend_walked", "frame")}
