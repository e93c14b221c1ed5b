"""The opaque-quad cell (`surface_1m_1080p`: the upstream app's live surface
mode) run whole on the CPU at the tiny size: sound runs, plain and traced,
are correct and the traced one reads both new metrics; each opaque fault
planted under the timed path fails the check, through a run and through
`surface_control`'s readings, where the program passes; the reference's
opaque-quad coverage, footprint and fold equal the program's plain path
bit for bit on seeded splats."""

import dataclasses
import json
import time

import pytest
import torch

from gpubench import bench, surface_control
from gpubench.reference import frame as ref
from gpubench.reference.config import RenderConfig as RefRenderConfig
from splat_renderer_tpu_torch.utils import profiling

CPU = torch.device("cpu")
CELL = "surface_1m_1080p"
CONFIG = "gpubench/configs/surface_demo_1m_1080p.json"
NEW = {"blend_walked.frame", "quad_blend_roofline.frame"}


@pytest.fixture
def tree(tiny):
    """The tiny tree with the animate mix's camera at distance 1.5, so that
    at 96x64 the quads cover whole tiles and their walks stop early."""
    p = tiny / "gpubench" / "traffic" / "animate.json"
    mix = json.loads(p.read_text())
    mix["camera"]["distance"] = 1.5
    p.write_text(json.dumps(mix))
    yield tiny
    profiling.disable()
    profiling.reset()


def run(tree, trace=False, seconds=0.3):
    return json.loads(bench.run_cell(CELL, 9876543210123, seconds, trace, CPU,
                                     time.perf_counter(), root=tree))


@pytest.mark.parametrize("trace", [False, True], ids=["plain", "traced"])
def test_a_sound_run_is_correct(tree, monkeypatch, trace):
    """Plain: the end-to-end metrics and the four checks.  Traced, with
    K1's quad launches given a device time (the CPU's timeline has none):
    `blend_walked.frame` reads the twin's walk, fewer positions than the
    frame's pairs, and `quad_blend_roofline.frame` a share of its
    roofline; no other kernel's time counts."""
    from gpubench.tracing import Timeline

    asked = []

    def kernel_s(self, substring, n):
        asked.append((substring, n))
        return 1e-3 if substring == "tile_blend_kernel<true, 2," else 0.0

    monkeypatch.setattr(Timeline, "kernel_s", kernel_s)
    line = run(tree, trace=trace)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 4
    assert set(line["checks"]) == {"splats_gap", "words_differ", "order_differ", "image_gap"}
    if not trace:
        assert set(line["metrics"]) == {"setup_s", "frame_ms", "frame_p95_ms"}
        return
    assert set(line["metrics"]) == NEW and ("tile_blend_kernel<true, 2,", 2) in asked
    assert 0.0 < line["metrics"]["blend_walked.frame"]["value"]
    assert 0.0 < line["metrics"]["quad_blend_roofline.frame"]["value"] < 100.0


def test_the_walk_is_less_than_the_pairs(tree):
    """At the tiny size the early stop leaves part of the binned pairs
    unwalked: the reference's fold walks fewer than it bins, and the
    program's counter, summed over the checked frames, equals the fold's."""
    got = surface_control.readings(CELL, 424242424242, CPU, False, root=tree)
    assert all(got["walked"][f] < got["pairs"][f] for f in got["pairs"])
    config, traffic = bench.cell_parts(bench.load_spec(tree), CELL, tree / "gpubench")
    from gpubench.drivers import frames

    st = frames.Setup(config, traffic, 424242424242, CPU)
    with profiling.recording() as rec:
        for fi in got["frames"]:
            st.frame(fi)
    assert rec.counter("blend_walked", within="frame") == sum(got["walked"].values())


@pytest.mark.parametrize("fault", sorted(surface_control.FAULTS))
def test_an_opaque_fault_under_the_timed_path_is_not_correct(tree, fault):
    with surface_control.planted(fault):
        line = run(tree)
    assert not line["correct"] and line["failed"] > 0


def test_every_fault_fails_and_the_program_passes(tree):
    config = json.loads((tree / CONFIG).read_text())
    limits = config["limits"]["frames"]
    got = surface_control.readings(CELL, 424242424242, CPU, True, faults=True, root=tree)
    assert all(got["program"][k] <= v for k, v in limits.items()), got
    for fault in surface_control.FAULTS:
        assert any(got[fault][k] > v for k, v in limits.items()), (fault, got)


def test_reversed_runs_reverses_each_tiles_run():
    binned = {"offsets": torch.tensor([0, 3, 3, 5]), "pair_tile": torch.tensor([0, 0, 0, 2, 2, 3]),
              "pair_rank": torch.tensor([4, 1, 7, 2, 9, 0])}
    out = surface_control.reversed_runs(binned)
    assert out["pair_rank"].tolist() == [7, 1, 4, 9, 2, 0]
    assert binned["pair_rank"].tolist() == [4, 1, 7, 2, 9, 0]


def _seeded_words(cfg, n=3000, seed=5):
    """The program's words of n seeded splats (opacity 1) at the cell's
    render settings cut to 96x64."""
    import splat_renderer_tpu_torch as spt
    from splat_renderer_tpu_torch.camera import camera_tensors
    from splat_renderer_tpu_torch.render.projector import splat_screen_words

    g = torch.Generator().manual_seed(seed)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(n, generator=g)  # noqa: E731
    nrm = torch.randn((3, n), generator=g)
    nrm = nrm / torch.linalg.vector_norm(nrm, dim=0)
    splats = {"px": u(-0.6, 0.6), "py": u(-0.6, 0.6), "pz": u(-0.6, 0.6),
              "radius": u(0.02, 0.12), "cr": u(0, 1), "cg": u(0, 1), "cb": u(0, 1),
              "opacity": torch.ones(n), "nx": nrm[0], "ny": nrm[1], "nz": nrm[2]}
    cam = camera_tensors(spt.Camera(aspect=cfg.width / cfg.height).arrays(), "cpu")
    words = splat_screen_words(splats, cam["view_proj"], cam["cam_pos"], cfg)
    return splats, cam, words


def test_the_reference_quad_path_equals_the_programs_plain_path():
    """On seeded opaque quads at the cell's settings (96x64): the
    reference's coverage (`splat_alpha_planes`), footprint
    (`_footprint_cols`), binning and fold equal the program's plain path
    bit for bit, the fold's image and alpha included."""
    import splat_renderer_tpu_torch as spt
    from gpubench.reference.render import binning as ref_binning
    from gpubench.reference.render import blend as ref_blend
    from gpubench.reference.render.packing import U32_MASK
    from gpubench.reference.render.packing import unpack_words as ref_unpack
    from splat_renderer_tpu_torch.ops.tile_blend import blend_tiles_plain
    from splat_renderer_tpu_torch.render import binning, blend
    from splat_renderer_tpu_torch.render.compositor import tiles_to_image

    render = dict(json.loads((bench.ROOT / CONFIG).read_text())["render"], width=96, height=64)
    cfg = spt.RenderConfig(**render)
    rcfg = RefRenderConfig(**render)
    assert cfg.opaque and cfg.oriented and cfg.quad
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(cfg)
    splats, cam, words = _seeded_words(cfg)
    ref_words, ref_binned = ref.words_and_bins(splats, cam, rcfg)
    for k in words:
        assert torch.equal(words[k], ref_words[k]), k
    w = [words[k] for k in ("dk", "w_pos", "w_ro", "w_rgb")]
    binned = binning.bin_packed_words(*w, cfg)
    for k in ("offsets", "pair_tile", "pair_rank", "rec_pos", "rec_ro", "rec_rgb"):
        assert torch.equal(binned[k].to(torch.int64), ref_binned[k].to(torch.int64)), k

    u32 = lambda x: x.to(torch.int64) & U32_MASK  # noqa: E731
    cx, cy, r, op, _, _, _, ang, ratio = ref_unpack(u32(words["w_pos"]), u32(words["w_ro"]),
                                                    u32(words["w_rgb"]), rcfg)
    depth_valid = r > 0
    got = binning._footprint_cols(cx, cy, r, depth_valid, cfg, ang=ang, ratio=ratio)
    want = ref_binning._footprint_cols(cx, cy, r, depth_valid, rcfg, ang=ang, ratio=ratio)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    py, px = torch.meshgrid(torch.arange(64) + 0.5, torch.arange(96) + 0.5, indexing="ij")
    pix = lambda v: v[:200, None]  # noqa: E731
    a_got = blend.splat_alpha_planes(pix(cx), pix(cy), pix(r), pix(op), pix(ang), pix(ratio),
                                     px.reshape(1, -1), py.reshape(1, -1), cfg)
    a_want = ref_blend.splat_alpha_planes(pix(cx), pix(cy), pix(r), pix(op), pix(ang),
                                          pix(ratio), px.reshape(1, -1), py.reshape(1, -1), rcfg)
    assert torch.equal(a_got, a_want) and 0.0 < float(a_got.mean()) < 1.0

    color, alpha = blend_tiles_plain(binned, cfg)
    ref_color, ref_alpha, counts = ref.fold_blend(ref_binned, rcfg)
    assert torch.equal(color, ref_color) and torch.equal(alpha, ref_alpha)
    assert torch.equal(tiles_to_image(color, alpha, cfg),
                       ref.tiles_to_image(ref_color, ref_alpha, rcfg))
    assert counts["pairs"] < int(binned["offsets"][-1])


def test_the_new_files_load_neither_jax_nor_the_jax_package():
    from gpubench.bench import FORBIDDEN
    from gpubench.tests.test_gpubench_imports import top_level_after

    names = top_level_after(
        "import gpubench.surface_control\n"
        "from gpubench import bench\n"
        "for m in ('blend_walked.frame', 'quad_blend_roofline.frame'): bench.load_reader(m)")
    assert not names & set(FORBIDDEN)
