"""The arithmetic of the end-to-end metrics, over every request of a
window, and the spread the bounds are set from."""

from __future__ import annotations

import math
import statistics


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value with at
    least 95% of all values at or below it."""
    s = sorted(values)
    if not s:
        raise ValueError("p95 of no values")
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def end_to_end(latencies_s, bytes_in, bytes_out, window_s) -> dict:
    """compress_MBps (10^6 bytes of input a second of the window),
    latency_p95_ms and ratio (all input over all output)."""
    return {"compress_MBps": bytes_in / window_s / 1e6,
            "latency_p95_ms": p95(latencies_s) * 1e3,
            "ratio": bytes_in / bytes_out}


def spread(values) -> float:
    """Distance between the first and third quartile as a share of the
    median, with Python's `statistics.quantiles(values, n=4)`."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
