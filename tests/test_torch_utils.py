"""The port's host helpers on the CPU: the rebuild notice once per scene
structure (as tests/test_apps.py::TestObservability holds the JAX Engine's),
and `trace` over torch.profiler with the spans as its ranges."""

import io
import json
import logging
import os

import torch

import splat_renderer_tpu_torch as tpt
from splat_renderer_tpu_torch.camera import camera_tensors
from splat_renderer_tpu_torch.render.pipeline import Engine
from splat_renderer_tpu_torch.utils import log_point_budget, logger, span, trace
from splat_renderer_tpu_torch.utils.profiling import RANGE_PREFIX, TRACE_FILE, enabled


def test_rebuild_logged_once_per_structure():
    buf = io.StringIO()
    h = logging.StreamHandler(buf)
    logger.addHandler(h)
    level = logger.level
    logger.setLevel(logging.INFO)
    try:
        scene = tpt.SDFScene(tpt.smooth_union(0.1, tpt.Sphere(id="a", radius=0.5),
                                              tpt.Box(id="b", position=(0.6, 0, 0))))
        eng = Engine(scene, tpt.PointConfig(descent_steps=1),
                     tpt.RenderConfig(width=32, height=32), n=64, device="cpu")
        cam = camera_tensors(tpt.Camera().arrays(), "cpu")
        eng.frame(cam, torch.Generator().manual_seed(0))
        scene["a"].radius = 0.6  # a parameter change keeps the state
        eng.frame(cam, torch.Generator().manual_seed(1))
        assert buf.getvalue().count("new frame state") == 1
        scene.set_root(tpt.union(tpt.Sphere(id="a"), tpt.Torus(id="t")))
        eng.frame(cam, torch.Generator().manual_seed(2))
        assert buf.getvalue().count("new frame state") == 2
        log_point_budget(64, 2)
        assert "point budget: 64 points for 2 primitive(s)" in buf.getvalue()
    finally:
        logger.removeHandler(h)
        logger.setLevel(level)


def test_trace_writes_the_annotated_span(tmp_path):
    log_dir = str(tmp_path / "trace")
    x = torch.arange(64.0)
    with span("splat_test_span"):  # off: no range
        (x * 2).sum()
    with trace(log_dir) as prof:
        assert enabled()
        with span("splat_test_span"):
            (x * 2).sum()
    assert not enabled()
    path = os.path.join(log_dir, TRACE_FILE)
    events = json.load(open(path))["traceEvents"]
    name = RANGE_PREFIX + "splat_test_span"
    assert any(e.get("name") == name for e in events)
    assert [e.count for e in prof.key_averages() if e.key == name] == [1]

