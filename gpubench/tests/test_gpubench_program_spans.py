"""The readers of the program's own spans and counter
(`gpubench/program_spans.py`): every metric they add reads a number in a
traced run of each cell on the CPU, a run without tracing loads no reader
and leaves the program's recorder off, and the idle gaps are filed under
the program's spans after the two clocks are aligned."""

import json
import time

import pytest
import torch

from gpubench import bench, program_spans
from splat_renderer_tpu_torch.utils import profiling

NEW = {"sdf_anim": {"frame_host_ms.frame", "model_descent_ms.frame",
                    "model_curvature_ms.frame", "pairs.frame"},
       "sh3_orbit": {"frame_host_ms.frame", "pairs.frame"},
       "sh3_fit": {"step_host_ms.step", "loss_ms.step", "backward_ms.step", "pairs.step"}}


@pytest.fixture(autouse=True)
def recorder_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _run(tree, workload, trace):
    return json.loads(bench.run_cell(workload, 9876543210123, 0.3, trace, torch.device("cpu"),
                                     time.perf_counter(), root=tree))


def test_the_new_metrics_list_their_cells():
    spec = bench.load_spec()
    for cell, names in NEW.items():
        listed = {m["name"] for m in spec["per_layer"] if cell in m.get("workloads", [])}
        assert names <= listed


@pytest.mark.parametrize("workload", sorted(NEW))
def test_a_traced_run_reads_every_new_metric(tiny, workload, capfd):
    line = _run(tiny, workload, True)
    assert line["correct"]
    for name in NEW[workload]:
        v = line["metrics"][name]["value"]
        assert v is not None and v > 0, name
    assert "idle gaps by program span" in capfd.readouterr().err
    assert not profiling.enabled()  # read once, at the end


def test_an_untraced_run_loads_no_reader(tiny, monkeypatch):
    loaded = []
    monkeypatch.setattr(bench, "load_reader", lambda *a, **k: loaded.append(a))
    line = _run(tiny, "sh3_orbit", False)
    assert line["correct"] and loaded == []
    assert not profiling.enabled() and profiling.report() == {}


def test_clocks_are_aligned_by_the_median_offset():
    # the profiler's clock runs 5e6 us ahead; one item is read 40 us late
    items = [(1.0, 1.01), (1.01, 1.02), (1.02, 1.03)]
    spans = [(a * 1e6 + 5e6, b * 1e6 + 5e6) for a, b in items]
    spans[1] = (spans[1][0] + 40, spans[1][1] + 40)
    assert program_spans.clock_offset_us(items, spans) == pytest.approx(5e6)
    assert program_spans.clock_offset_us([], []) is None


def test_gaps_are_filed_under_the_innermost_program_span():
    off = 1e9  # us
    items = [(0.0, 0.001), (0.001, 0.002)]
    item_spans = [(a * 1e6 + off, b * 1e6 + off) for a, b in items]
    # the device works [0, 300) and [500, 2000) us into the stretch
    device = [(off, off + 300, "k"), (off + 500, off + 2000, "k")]
    intervals = [("fit/step", None, 0.0, 0.001), ("fit/render", "fit/step", 0.0002, 0.0006),
                 ("fit/step", None, 0.001, 0.002), ("late", None, 5.0, 6.0)]
    gaps, idle = program_spans.gaps_by_span(device, items, item_spans, intervals)
    assert dict(gaps) == pytest.approx({"fit/render": 200e-6})
    assert idle == pytest.approx(200e-6)
    assert program_spans.gaps_by_span(device, [], [], intervals) == ([], 0.0)


def test_a_program_without_a_recorder_reads_none(monkeypatch):
    monkeypatch.setattr(program_spans, "recorder", lambda: None)
    monkeypatch.setattr(program_spans, "_last", None)
    program_spans.enable()
    assert program_spans.span_ms(object(), "frame", "host_ms_median") is None
    assert program_spans.pairs_per_call(object(), "frame") is None
