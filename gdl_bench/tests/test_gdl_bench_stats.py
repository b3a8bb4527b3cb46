"""The end-to-end arithmetic covers every sample."""

from __future__ import annotations

import numpy as np
import pytest

from gdl_bench import stats


def test_rate_is_work_over_window():
    assert stats.rate(32 * 57, 10.04) == pytest.approx(32 * 57 / 10.04)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


@pytest.mark.parametrize("n", [1, 2, 19, 20, 200, 219])
def test_percentile_matches_numpy(n):
    xs = np.random.default_rng(n).uniform(0.1, 0.2, n)
    assert stats.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))


def test_p95_sees_a_stall():
    """A stall of 10 s in one of 20 requests moves the tail: every sample
    counts."""
    xs = [0.14] * 19 + [10.0]
    assert stats.percentile(xs, 95) > 0.6
    assert stats.percentile([0.14] * 20, 95) == pytest.approx(0.14)
    assert stats.mean(xs) == pytest.approx((0.14 * 19 + 10.0) / 20)
