"""Tail, median, rate and spread arithmetic, over all samples."""

import statistics

import pytest

from stream_bench import stats


def test_percentile_interpolates_between_order_statistics():
    x = list(range(1, 101))            # 1..100
    assert stats.percentile(x, 95) == pytest.approx(95.05)
    assert stats.percentile(x, 50) == pytest.approx(50.5)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 3], 100) == 5
    assert stats.percentile([5, 1, 3], 0) == 1


def test_percentile_uses_every_sample():
    x = [1.0] * 94 + [10.0] * 6        # the 95th percentile sits in the tail
    assert stats.percentile(x, 95) == pytest.approx(10.0)
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_median_rate_spread():
    assert stats.median([4, 1, 3, 2]) == 2.5
    assert stats.rate(500, 40.0) == 12.5
    v = [10, 11, 12, 13, 14, 15]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / 12.5)


def test_trimmed_spread_leaves_out_the_farthest_run():
    v = [17.82, 19.02, 19.17, 17.96, 19.66, 30.0]
    rest = v[:-1]
    q1, _, q3 = statistics.quantiles(rest, n=4)
    assert stats.trimmed_spread(v) == pytest.approx((q3 - q1) / statistics.median(rest))
    # never wider than the spread of all the runs
    w = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    assert stats.trimmed_spread(w) <= stats.spread(w)
