import statistics

import pytest

from pb import stats


def test_p95_nearest_rank():
    assert stats.p95(range(1, 101)) == 95
    assert stats.p95([5.0]) == 5.0
    assert stats.p95([3, 1, 2]) == 3
    assert stats.p95(list(range(1, 21))) == 19
    with pytest.raises(ValueError):
        stats.p95([])


def test_end_to_end_over_every_request():
    lat = [0.010] * 95 + [0.100] * 5
    m = stats.end_to_end(lat, bytes_in=100 * 4_000_000, bytes_out=100 * 2_000_000, window_s=2.0)
    assert m["compress_MBps"] == pytest.approx(200.0)
    assert m["ratio"] == pytest.approx(2.0)
    assert m["latency_p95_ms"] == pytest.approx(10.0)
    lat[-6] = 0.100
    assert stats.end_to_end(lat, 1, 1, 1.0)["latency_p95_ms"] == pytest.approx(100.0)


def test_spread_uses_statistics_quantiles():
    v = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / statistics.median(v))
