"""The `views` cell (`views8_2m_1080p`: 8-view batches of full-covariance 3D
Gaussians) run whole on the CPU at the tiny size: sound runs are correct
and a traced run reads every new metric; a run whose timed path is broken
underneath fails, once for each fault (the disc collapse of `load_ply`'s
default mapping, an altered tile, half of the records dropped); the
control (the reference in bfloat16) and the disc collapse put in the
program's place fail at least one limit, the program none; a tree without
the `views` driver, or a program without the covariance model, exits at
once; K1's oriented roofline counts the reference's fold."""

import json
import shutil
import time

import pytest
import torch

from gpubench import bench, views_control
from gpubench.tests.test_gpubench_checks import _alter_one_tile, _drop_half_the_records
from splat_renderer_tpu_torch.utils import profiling

CPU = torch.device("cpu")
CELL = "views8_2m_1080p"
NEW = {"views_host_ms.batch", "project_ms.batch", "cov3d_splats.batch", "pairs.batch",
       "sh_ms.batch", "bin_ms.batch", "blend_ms.batch", "cov3d_capped_share.batch"}


@pytest.fixture
def tree(tiny):
    """The tiny tree with the views mix checking and tracing its first few
    batches."""
    p = tiny / "gpubench" / "traffic" / "views8.json"
    mix = json.loads(p.read_text())
    mix.update(warmup_items=1, check_range=3, trace_items=2)
    p.write_text(json.dumps(mix))
    yield tiny
    profiling.disable()
    profiling.reset()


def run(tree, trace=False, seconds=0.3):
    return json.loads(bench.run_cell(CELL, 9876543210123, seconds, trace, CPU,
                                     time.perf_counter(), root=tree))


def test_a_sound_run_is_correct(tree):
    line = run(tree)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 3
    assert set(line["metrics"]) == {"setup_s", "frame_ms", "frame_p95_ms"}
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == {"colour_gap", "words_differ", "pairs_out_of_place",
                                   "image_gap", "u8_differ"}


def test_a_traced_run_reads_every_new_metric(tree):
    line = run(tree, trace=True)
    assert line["correct"] and {"busy_s", "window_s"} <= set(line["device"])
    assert NEW <= set(line["metrics"])
    n = json.loads((tree / "gpubench/configs/gs3d_aniso_2m_1080p.json").read_text())["n"]
    assert line["metrics"]["cov3d_splats.batch"]["value"] == pytest.approx(8 * n / 1e6)
    assert 0.0 <= line["metrics"]["cov3d_capped_share.batch"]["value"] < 100.0
    # the CPU's timeline holds no device operation: these read nothing here
    assert not ({"project_roofline.batch", "device_idle.batch", "tile_blend_roofline.batch"}
                & set(line["metrics"]))


def test_the_oriented_blend_roofline_reads_the_reference_fold(tree, monkeypatch):
    """With K1's oriented launches given a device time (the CPU's timeline
    has none), `tile_blend_roofline.batch` counts the first 2 views' work by
    the reference's fold and reads a share; no other kernel's time counts."""
    from gpubench.tracing import Timeline

    asked = []

    def kernel_s(self, substring, n):
        asked.append((substring, n))
        return 1e-3 if substring == "tile_blend_kernel<true," else 0.0

    monkeypatch.setattr(Timeline, "kernel_s", kernel_s)
    line = run(tree, trace=True)
    assert ("tile_blend_kernel<true,", 2) in asked
    share = line["metrics"]["tile_blend_roofline.batch"]["value"]
    assert 0.0 < share < 100.0


def _disc_collapse(monkeypatch):
    """The Gaussians collapsed to discs where the projector takes them,
    rendered with the "ewa" disc model: `load_ply`'s default mapping in
    place of the covariance."""
    import splat_renderer_tpu_torch.render.pipeline as pipeline

    orig = pipeline.splat_screen_words

    def collapsed(splats, view_proj, cam_pos, cfg):
        return orig(views_control.disc_collapse(splats), view_proj, cam_pos,
                    cfg.replace(ellipse="ewa"))

    monkeypatch.setattr(pipeline, "splat_screen_words", collapsed)


@pytest.mark.parametrize("fault", ["disc_collapse", "altered_tile", "half_the_records"])
def test_a_broken_view_is_not_correct(tree, monkeypatch, fault):
    if fault == "disc_collapse":
        _disc_collapse(monkeypatch)
    elif fault == "altered_tile":
        _alter_one_tile(monkeypatch, "splat_renderer_tpu_torch.ops.tile_blend", "blend_tiles")
    else:
        _drop_half_the_records(monkeypatch)
    line = run(tree)
    assert not line["correct"] and line["failed"] > 0


def test_the_control_and_the_fault_fail_and_the_program_passes(tree):
    config = json.loads((tree / "gpubench/configs/gs3d_aniso_2m_1080p.json").read_text())
    limits = config["limits"]["views"]
    got = views_control.readings(CELL, 424242424242, CPU, True, faults=True, root=tree)
    assert any(got["control"][k] > v for k, v in limits.items()), got
    assert any(got["disc_collapse"][k] > v for k, v in limits.items()), got
    assert all(got["program"][k] <= v for k, v in limits.items()), got


def test_a_tree_without_the_driver_exits_at_once(tree):
    shutil.rmtree(tree / "gpubench" / "drivers")
    (tree / "gpubench" / "drivers").mkdir()
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="no driver for traffic kind 'views'"):
        run(tree)
    assert time.perf_counter() - t0 < 5.0


def test_pairs_out_of_place_counts_each_pair_once():
    """A pair one side alone binned counts once, a pair the tiles' runs
    order differently once on each side, over both sides' pairs; nothing
    else moves the share, and it reaches 1 where no pair agrees."""
    from gpubench.drivers.views import pairs_out_of_place

    def binned(runs):
        tiles = [t for t, run in enumerate(runs) for _ in run]
        offsets = [0]
        for run in runs:
            offsets.append(offsets[-1] + len(run))
        return {"offsets": torch.tensor(offsets), "pair_tile": torch.tensor(tiles),
                "pair_rank": torch.tensor([r for run in runs for r in run])}

    want = binned([[3, 1, 4], [1, 5, 9, 2], [6]])
    assert pairs_out_of_place(want, want) == 0.0
    assert pairs_out_of_place(binned([[3, 7, 1, 4], [1, 5, 9, 2], [6]]), want) == 1 / 17
    assert pairs_out_of_place(binned([[3, 1, 4], [1, 9, 5, 2], [6]]), want) == 4 / 16
    assert pairs_out_of_place(binned([[4, 1, 3], [2, 9, 5, 1], [6]]), want) == 12 / 16
    assert pairs_out_of_place(binned([[0], [8], [7]]), want) == 1.0


def test_a_program_without_the_covariance_model_exits_at_once(tree, monkeypatch):
    import splat_renderer_tpu_torch.points as points

    monkeypatch.delattr(points, "COV3D_PLANES")
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="no full-covariance 3D Gaussians"):
        run(tree)
    assert time.perf_counter() - t0 < 5.0


def test_the_new_files_load_neither_jax_nor_the_jax_package():
    """The driver, the readings module and the metric readers load no JAX;
    the reference of the Gaussians loads nothing of the program either."""
    from gpubench.bench import FORBIDDEN
    from gpubench.tests.test_gpubench_imports import top_level_after

    names = top_level_after(
        "import gpubench.drivers.views, gpubench.views_control\n"
        "from gpubench import bench\n"
        "for m in bench.load_spec()['per_layer']: bench.load_reader(m['name'])")
    assert not names & set(FORBIDDEN)
    names = top_level_after("import gpubench.reference.gaussians")
    assert not names & ({"splat_renderer_tpu_torch"} | set(FORBIDDEN))
