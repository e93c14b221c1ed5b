"""The idle share and the gap causes from a synthetic kernel timeline."""

import pytest

from gpubench import timeline


def test_idle_share_of_overlapping_kernels():
    # window [0, 100); kernels cover [10, 30) u [25, 40) u [60, 70) = 40
    k = [(10, 30), (25, 40), (60, 70), (120, 130)]
    assert timeline.busy(k, 0, 100) == 40
    assert timeline.idle_share(k, 0, 100) == pytest.approx(0.6)
    assert timeline.gaps(k, 0, 100) == [(0, 10), (40, 60), (70, 100)]


def test_kernels_are_clipped_to_the_window():
    assert timeline.busy([(-5, 5), (95, 105)], 0, 100) == 10


def test_gap_causes_name_the_innermost_open_span():
    k = [(0, 10), (20, 30), (50, 60)]
    spans = [(0, 100, "frame"), (8, 18, "bin"), (28, 45, "model"), (55, 58, "blend")]
    out = dict(timeline.gap_causes(k + [(60, 70)], spans, 0, 80))
    assert out == {"bin": 10, "model": 20, "frame": 10}


def test_top_by_name_sums_and_orders():
    got = timeline.top_by_name([("a", 1.0), ("b", 3.0), ("a", 2.5)], k=1)
    assert got == [["a", 3.5]]


def test_idle_share_holds_busy_time_an_item_against_the_unprofiled_item():
    from gpubench.tracing import Timeline, TracedRun

    # 4 profiled items, 8 ms of device work in all (two kernels overlap)
    items = [(0.0, 0.009), (0.009, 0.018), (0.018, 0.027), (0.027, 0.036)]
    device = [(0, 3000, "k1"), (1000, 4000, "k2"), (10000, 14000, "k1"), (20000, 21000, "k3")]
    line = Timeline(items, device, [], [])
    assert line.busy_s() == pytest.approx(0.009)
    assert line.window_s() == pytest.approx(0.036)
    run = TracedRun(None, line, item_s=0.005)
    assert run.idle_percent() == pytest.approx(100 * (1 - 0.009 / 4 / 0.005))
    assert TracedRun(None, Timeline(items, [], [], []), item_s=0.005).idle_percent() is None
