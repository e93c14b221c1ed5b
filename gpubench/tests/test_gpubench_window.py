"""Window arithmetic: a rate over the whole window, a tail over all frames."""

import statistics

import numpy as np
import pytest

from gpubench import window


def test_rate_is_the_whole_window_over_the_items():
    assert window.per_item_ms(10.0, 400) == pytest.approx(25.0)
    with pytest.raises(ValueError):
        window.per_item_ms(10.0, 0)


@pytest.mark.parametrize("n", [1, 2, 19, 20, 21, 1000, 1237])
def test_p95_over_all_frames_matches_numpy(n):
    rng = np.random.default_rng(n)
    xs = list(rng.gamma(4.0, 5.0, n))
    assert window.percentile(xs, 95.0) == pytest.approx(float(np.percentile(xs, 95.0)))


def test_p95_sees_a_rare_stall():
    # 1000 frames, 60 of them stalled: the tail is the stall, the mean is not
    xs = [20.0] * 940 + [40.0] * 60
    assert window.percentile(xs, 95.0) == 40.0
    assert statistics.mean(xs) < 22.0
