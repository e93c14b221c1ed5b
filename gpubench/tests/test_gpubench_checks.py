"""The check of `correct`, driven through whole runs of the cells on the
CPU at a tiny size: sound runs pass; a run whose timed path is broken
underneath fails, once for each fault the cell can have; the control
(the reference in bfloat16) fails at least one number of each cell, and
so does a frame cell's planted early stop."""

import json
import time

import pytest
import torch

from gpubench import bench, control

CPU = torch.device("cpu")


def run(tree, workload, trace=False, seconds=0.5):
    return json.loads(bench.run_cell(workload, 9876543210123, seconds, trace, CPU,
                                     time.perf_counter(), root=tree))


@pytest.mark.parametrize("workload", ["sdf_anim", "sh3_orbit", "sh3_fit"])
def test_a_sound_run_is_correct(tiny, workload):
    line = run(tiny, workload)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("workload", ["sdf_anim", "sh3_orbit", "sh3_fit"])
def test_a_traced_run_is_correct(tiny, workload):
    line = run(tiny, workload, trace=True)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert list(line)[-1] == "checks"


def _alter_one_tile(monkeypatch, module, attr):
    """The answer altered where it is produced: one tile's colour off by 0.5."""
    import importlib

    mod = importlib.import_module(module)
    orig = getattr(mod, attr)

    def altered(*a, **k):
        out = orig(*a, **k)
        color = out[0].clone()
        color[color.shape[0] // 2] += 0.5
        return (color,) + tuple(out[1:])

    monkeypatch.setattr(mod, attr, altered)


def _drop_half_the_records(monkeypatch):
    """Half of the batch left out: the second half of the records' opacity
    words zeroed where the projector makes them."""
    import splat_renderer_tpu_torch.render.pipeline as pipeline

    orig = pipeline.splat_screen_words

    def half(*a, **k):
        w = dict(orig(*a, **k))
        n = w["w_rgb"].shape[0]
        w["w_rgb"] = w["w_rgb"].clone()
        w["w_rgb"][n // 2:] &= 0x00FFFFFF
        return w

    monkeypatch.setattr(pipeline, "splat_screen_words", half)


@pytest.mark.parametrize("fault", ["altered_tile", "half_the_records"])
@pytest.mark.parametrize("workload", ["sdf_anim", "sh3_orbit"])
def test_a_broken_frame_is_not_correct(tiny, monkeypatch, workload, fault):
    if fault == "altered_tile":
        _alter_one_tile(monkeypatch, "splat_renderer_tpu_torch.ops.tile_blend", "blend_tiles")
    else:
        _drop_half_the_records(monkeypatch)
    line = run(tiny, workload)
    assert not line["correct"] and line["failed"] > 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "altered_tile"])
def test_a_broken_fit_step_is_not_correct(tiny, monkeypatch, fault):
    import splat_renderer_tpu_torch.fit as fit

    if fault == "state_unchanged":
        orig = fit.adam_update
        monkeypatch.setattr(fit, "adam_update",
                            lambda theta, grads, state, lr, **k: (theta, orig(
                                theta, grads, state, lr, **k)[1]))
    elif fault == "half_the_batch":
        orig_loss = fit.image_loss

        def half_loss(name):
            f = orig_loss(name)
            return lambda img, tgt: f(img[: img.shape[0] // 2], tgt[: tgt.shape[0] // 2])

        monkeypatch.setattr(fit, "image_loss", half_loss)
    else:
        _alter_one_tile(monkeypatch, "splat_renderer_tpu_torch.ops.tile_blend_diff",
                        "blend_planes")
    line = run(tiny, "sh3_fit", seconds=0.3)
    assert not line["correct"]


@pytest.mark.parametrize("workload", ["sdf_anim", "sh3_orbit", "sh3_fit"])
def test_the_control_fails_and_the_program_passes(tiny, workload):
    spec = bench.load_spec(tiny)
    config, traffic = bench.cell_parts(spec, workload, tiny / "gpubench")
    limits = config["limits"]["fit" if traffic["kind"] == "fit" else "frames"]
    got = control.readings(workload, 424242424242, CPU, True, faults=True, root=tiny)
    assert any(got["control"][k] > v for k, v in limits.items()), got
    assert all(got["program"][k] <= v for k, v in limits.items()), got
    if traffic["kind"] == "frames":
        # the planted fault: pixels stopping early, at T <= 0.05
        assert any(got["early_stop"][k] > v for k, v in limits.items()), got


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["sdf_anim", "sh3_fit"])
def test_a_short_run_on_the_card_is_correct(cuda, workload):
    line = json.loads(bench.run_cell(workload, 31337, 2.0, False, cuda, time.perf_counter()))
    assert line["correct"], line
