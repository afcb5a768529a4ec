"""chip_smoke.py's timing helper on the CPU: `sample_ms` on the host
clock, its warm-up call and its samples of several calls each."""

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402


def test_sample_ms_on_the_host_clock():
    calls = []
    times = chip_smoke.sample_ms(lambda: calls.append(1), reps=4, launches=3, device="cpu")
    assert len(times) == 4 and all(t >= 0 for t in times)
    assert len(calls) == 1 + 4 * 3
