"""tpu7z_torch/utils/timing.py on the CPU: `busy_share` on a synthetic
profiler trace (the busy union, the kernels counted, the stages' device
spans and the idle gaps), and `sample_ms` on the host clock."""

import json

import pytest

torch = pytest.importorskip("torch")

from tpu7z_torch.utils import timing  # noqa: E402


def _trace(tmp_path, events):
    (tmp_path / "host.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    return tmp_path


def test_busy_share_on_a_synthetic_trace(tmp_path):
    """Window 1000-2000 us; kernels at 1100-1300 and 1250-1400 (overlapping),
    a copy at 1600-1700, a set from 1950 past the window's end, and a
    kernel before the window: busy 300 + 100 + 50 us, idle gaps of 100,
    200 and 250 us."""
    events = [
        {"name": "encode_blocks", "cat": "user_annotation", "ts": 1000, "dur": 1000},
        {"name": "k0", "cat": "kernel", "ts": 500, "dur": 100},
        {"name": "k1", "cat": "kernel", "ts": 1100, "dur": 200},
        {"name": "k2", "cat": "kernel", "ts": 1250, "dur": 150},
        {"name": "copy", "cat": "gpu_memcpy", "ts": 1600, "dur": 100},
        {"name": "set", "cat": "gpu_memset", "ts": 1950, "dur": 300},
        {"name": "candidates", "cat": "gpu_user_annotation", "ts": 1100, "dur": 300},
        {"name": "cpu op", "cat": "cpu_op", "ts": 1000, "dur": 900},
    ]
    share = timing.busy_share(_trace(tmp_path, events), "encode_blocks")
    assert share["window_ms"] == pytest.approx(1.0)
    assert share["busy_ms"] == pytest.approx(0.45)
    assert share["kernels"] == 2
    assert share["device_spans_ms"] == {"candidates": pytest.approx(0.3)}
    assert share["idle_gaps_ms"] == [pytest.approx((0.7, 0.25)), pytest.approx((0.4, 0.2)),
                                     pytest.approx((0.0, 0.1))]


def test_busy_share_of_an_idle_window(tmp_path):
    events = [{"name": "w", "cat": "user_annotation", "ts": 0, "dur": 400}]
    share = timing.busy_share(_trace(tmp_path, events), "w")
    assert share["busy_ms"] == 0 and share["kernels"] == 0
    assert share["idle_gaps_ms"] == [pytest.approx((0.0, 0.4))]


def test_sample_ms_on_the_host_clock():
    calls = []
    times = timing.sample_ms(lambda: calls.append(1), reps=4, launches=3, device="cpu")
    assert len(times) == 4 and all(t >= 0 for t in times)
    assert len(calls) == 1 + 4 * 3
