"""A new configuration, scene, traffic mix, driver, per-layer metric and
cell are new files and new BENCHMARK.json entries: the harness picks them
up by name, with no edit to a file it already has."""

import json
import time

import torch

from gpubench import bench

NEW_SCENE = {
    "about": "a test scene: two spheres, the second's radius pulsing",
    "tree": {"op": "union", "of": [
        {"prim": "Sphere", "id": "a", "position": [-0.3, 0, 0], "radius": 0.4},
        {"prim": "Sphere", "id": "b", "position": [0.4, 0.1, 0], "radius": 0.3}]},
    "animate": [{"id": "b", "attr": "radius", "wave": "sin", "rate": 3, "amp": 0.05,
                 "base": 0.3},
                {"id": "a", "attr": "position", "index": 2, "wave": "cos", "rate": 1,
                 "amp": 0.1}],
}

NEW_DRIVER = '''"""A test driver: the render loop, leaving a mark that it ran."""
from pathlib import Path

from . import frames


def run(**kw):
    out = frames.run(**kw)
    (Path(__file__).parent / "ran.txt").write_text(str(out["attempted"]))
    return out
'''


def _add_cell(tree, name, config, traffic):
    spec = json.loads((tree / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": name, "config": config, "traffic": traffic,
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "sdf_anim" in m["workloads"]:
            m["workloads"].append(name)
    return spec


def _add_config(spec, g, name, **changes):
    cfg = json.loads((g / "configs" / "sdf_demo_1m_1080p.json").read_text())
    cfg.update(name=name, **changes)
    (g / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": name, "source": "a test",
                            "file": f"gpubench/configs/{name}.json", "reduced": ["n"],
                            "why": "a test"})


def test_new_files_are_picked_up_without_edits(tiny):
    g = tiny / "gpubench"
    mix = json.loads((g / "traffic" / "orbit.json").read_text())
    mix["azimuth_step"] = 0.1
    (g / "traffic" / "orbit_fast.json").write_text(json.dumps(mix))
    (g / "metrics" / "frames_traced.frame.py").write_text(
        "def read(run):\n    return len(run.timeline.items)\n")
    spec = _add_cell(tiny, "sdf_small_orbit", "sdf_demo_small", "orbit_fast")
    _add_config(spec, g, "sdf_demo_small", n=2000)
    spec["per_layer"].append({"name": "frames_traced.frame", "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "engine", "moves": "frame_ms",
                              "workloads": ["sdf_small_orbit"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))

    line = json.loads(bench.run_cell("sdf_small_orbit", 5, 0.5, True, torch.device("cpu"),
                                     time.perf_counter(), root=tiny))
    assert line["correct"]
    assert line["metrics"]["frames_traced.frame"]["value"] == mix["trace_frames"]
    assert "model_ms.frame" not in line["metrics"]  # that metric lists other cells
    plain = json.loads(bench.run_cell("sdf_small_orbit", 5, 0.5, False, torch.device("cpu"),
                                      time.perf_counter(), root=tiny))
    assert set(plain["metrics"]) == {"setup_s", "frame_ms", "frame_p95_ms"}


def test_a_new_scene_and_driver_are_picked_up_without_edits(tiny):
    g = tiny / "gpubench"
    (g / "scenes" / "two_spheres.json").write_text(json.dumps(NEW_SCENE))
    (g / "drivers" / "marked_frames.py").write_text(NEW_DRIVER)
    mix = json.loads((g / "traffic" / "animate.json").read_text())
    mix["kind"] = "marked_frames"
    (g / "traffic" / "animate_marked.json").write_text(json.dumps(mix))
    spec = _add_cell(tiny, "spheres_anim", "two_spheres_small", "animate_marked")
    _add_config(spec, g, "two_spheres_small", n=2000, scene="two_spheres")
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))

    line = json.loads(bench.run_cell("spheres_anim", 6, 0.3, False, torch.device("cpu"),
                                     time.perf_counter(), root=tiny))
    assert line["correct"], line
    assert int((g / "drivers" / "ran.txt").read_text()) == line["attempted"]
