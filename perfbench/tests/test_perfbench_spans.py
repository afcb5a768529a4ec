"""The readers of the program's own spans and counters: `entry.copy_in_ms`,
`entry.read_wait_ms`, `entry.host_reads` and `kernels.own_hbm_pct`, on a
synthetic context and in whole runs on the CPU; and the readers that were
there before them, which read the same with or without the program's
spans in the trace."""

import json
import os
import subprocess
import sys

import pytest

from pb import loader, runner, tracing
from test_perfbench_tracing import events

NEW = ("entry.copy_in_ms", "entry.host_reads", "entry.read_wait_ms", "kernels.own_hbm_pct")
RUN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "run.py")
ROOT = os.path.dirname(os.path.dirname(RUN))
H100 = {"kind": "NVIDIA H100 80GB HBM3"}


@pytest.fixture
def program():
    from tpu7z_torch.utils import trace

    trace.detach()
    trace.reset_totals()
    yield trace
    trace.detach()
    trace.reset_totals()


def _read(name, ctx):
    return loader.module("metrics", name).read(ctx)


def annotated():
    """events(), and the program's spans inside the request as the profiler
    records them: the split before the first kernel, a read around the
    `aten::item`, the copy out at the end."""
    spans = [("entry.lz4_device", 1000.5, 99.0), ("entry.split", 1000.5, 8.0),
             ("read.lz4_check_ns", 1036.0, 30.0), ("entry.d2h", 1085.0, 8.0)]
    return events() + [{"name": n, "cat": "user_annotation", "ts": ts, "dur": d, "tid": 7}
                       for n, ts, d in spans]


def context(evs, spans_s, span_requests=4):
    t = tracing.summary([tracing.reduce_request(evs)] * 2)
    t.update(bytes_in=8_000_000, bytes_out=2_000_000, spans_s=spans_s,
             span_requests=span_requests, kernel_names={})
    return t, runner.context([t], 1, H100)


def test_readers_there_before_read_the_same_with_the_program_spans():
    before = [m["name"] for m in loader.benchmark()["per_layer"] if m["name"] not in NEW]
    spans_s = {"deflate.header": 0.3, "lz.match_lengths": 0.06}
    plain, c_plain = context(events(), spans_s)
    traced, c_traced = context(annotated(), spans_s)
    for name in before:
        assert _read(name, c_traced) == _read(name, c_plain), name
    for key in ("window_s", "busy_s", "kernel_s", "class_s", "ops_s"):
        assert traced[key] == plain[key], key
    assert sorted(g for _, g in traced["gaps"]) == sorted(g for _, g in plain["gaps"])


def test_an_idle_gap_is_named_by_the_program_span_the_host_is_in():
    plain = dict(tracing.reduce_request(events())["gaps"])
    labels = dict(tracing.reduce_request(annotated())["gaps"])
    # 1000-1010: no host operation has begun at its middle, 1005, but the
    # program is in its split, a numpy loop the profiler does not see
    evs = [e for e in annotated() if e["name"] != "aten::sort"]
    assert dict(tracing.reduce_request(evs)["gaps"])["entry.split"] == pytest.approx(10e-6)
    assert "request start" in dict(tracing.reduce_request(
        [e for e in events() if e["name"] != "aten::sort"])["gaps"])
    # where a host operation runs inside a span, the operation names it
    assert labels["aten::item"] == plain["aten::item"]


def test_span_readers_on_a_synthetic_context(program):
    spans_s = {"entry.split": 0.2, "entry.h2d": 0.1, "read.lz4_check_ns": 0.06,
               "read.lz4_assemble_total": 0.02, "lz4.candidates": 1.0}
    _, c = context(events(), spans_s, span_requests=4)
    assert _read("entry.copy_in_ms", c) == pytest.approx(75.0)      # 0.3 s over 4 requests
    assert _read("entry.read_wait_ms", c) == pytest.approx(20.0)
    assert _read("entry.host_reads", c) is None and _read("kernels.own_hbm_pct", c) is None
    program.attach(lambda e: None)
    for _ in range(4):
        with program.span("entry.lz4_device"):
            for _ in range(3):
                with program.span("read.lz4_check_ns"):
                    pass
            with program.span("read.lz4_assemble_total"):
                pass
            with program.span("sort.rows", bytes=1_000_000):
                pass
            with program.span("lz4.emit", bytes=340_000):
                pass
    assert _read("entry.host_reads", c) == 4.0
    # 1.34 MB a request over 10 us of own kernels a traced request (one
    # chip at 3.35 TB/s): 4.0%
    assert c["class_ms"]["own"] == pytest.approx(0.010)
    assert _read("kernels.own_hbm_pct", c) == pytest.approx(100 * 1.34e6 / 3.35e12 / 10e-6)


def test_span_readers_read_nothing_without_the_program_spans(program, monkeypatch):
    _, c = context(events(), {"deflate.header": 0.3})
    program.attach(lambda e: None)
    with program.span("entry.gzip", bytes=5):
        with program.span("read.deflate_hist"):
            pass
    assert _read("entry.copy_in_ms", c) is None and _read("entry.read_wait_ms", c) is None
    # a program without counters: the parent's
    monkeypatch.delattr(program, "totals")
    assert _read("entry.host_reads", c) is None and _read("kernels.own_hbm_pct", c) is None
    _, empty = context(events(), {})
    monkeypatch.undo()
    assert all(_read(name, empty) is None for name in NEW)


def test_the_new_metrics_are_listed_with_their_cells():
    bench = loader.benchmark()
    cells = {w["name"] for w in bench["workloads"]}
    new = [m for m in bench["per_layer"] if m["name"] in NEW]
    assert [m["name"] for m in new] == list(NEW)
    assert all(set(m["workloads"]) == cells and m["moves"] == "compress_MBps" for m in new)


def _traced(cell, pool):
    argv = [sys.executable, RUN, "--workload", cell, "--seed", str(2**31 + 9), "--seconds",
            "3", "--trace", "1", "--device", "cpu", "--pool-bytes", str(pool)]
    p = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_traced_lz4_run_reads_four_host_reads_a_request():
    line = _traced("lz4dev.kafka16k", 1 << 21)
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert line["correct"] is True
    assert got["entry.host_reads"] == 4.0
    assert got["entry.copy_in_ms"] > 0 and got["entry.read_wait_ms"] > 0
    assert "kernels.own_hbm_pct" not in got          # no kernel of the port's own on the CPU


def test_a_traced_gzip_run_reads_every_read_site():
    got = {k: v["value"] for k, v in _traced("gzip6.bulk4m", 1 << 21)["metrics"].items()}
    assert got["entry.host_reads"] >= 14 and got["entry.read_wait_ms"] > 0
    assert got["entry.copy_in_ms"] > 0
    assert {"deflate.header_ms", "lz.match_lengths_ms"} <= set(got)

