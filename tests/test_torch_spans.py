"""The port's spans on the CPU: the off path, the detail events, the spans
as `user_annotation` regions of a `torch.profiler` trace, the host reads
and the `bytes` of each kernel launch's span, on the LZ4 device path and
the gzip writer."""

import collections
import json

import numpy as np
import pytest
import torch

from tpu7z_torch.models.deflate import codec
from tpu7z_torch.ops import lz4_cuda, lz4_plane, sort_cuda
from tpu7z_torch.parallel import sharded
from tpu7z_torch.utils import trace

BLOCK = lz4_plane.BLOCK
LZ4_SPANS = ["entry.lz4_device", "entry.split", "entry.h2d", "lz4.candidates", "sort.rows",
             "read.lz4_check_ns", "lz4.match", "lz4.parse", "lz4.geometry", "lz4.emit",
             "entry.assemble", "read.lz4_assemble_total", "entry.d2h", "entry.tobytes",
             "lz4.keys", "lz4.probe"]
# the gzip writer's blocking reads before its result, and how many a call
GZIP_READS = {"read.lz_valid": 1, "read.lz_chain_ends": 1, "read.lz_panel_rows": 1,
              "read.lz_bounds": 1, "read.deflate_takes": 1, "read.deflate_literals": 1,
              "read.deflate_bincount": 2, "read.deflate_hist": 1, "read.deflate_tokens": 1,
              "read.deflate_match_mask": 2, "read.bitstream_total": 1}
GZIP_SPANS = ["entry.gzip", "entry.deflate", "entry.h2d", "deflate.parse", "lz.sort",
              "sort.rows", "lz.match_lengths", "lz.walk", "deflate.header", "deflate.pack",
              "entry.d2h", "entry.tobytes", "gzip.crc32", "read.lz_panel_pass", *GZIP_READS]


@pytest.fixture(autouse=True)
def _detached(monkeypatch):
    monkeypatch.delenv("TPU7Z_TRACE", raising=False)
    trace.detach()
    trace.clear()
    trace.reset_totals()
    yield
    trace.detach()
    trace.clear()
    trace.reset_totals()


@pytest.fixture(scope="module")
def data():
    """Two blocks' worth and a little more: text-like bytes with repeats."""
    rng = np.random.default_rng(7)
    words = [bytes(rng.integers(97, 123, size=rng.integers(2, 9), dtype=np.uint8))
             for _ in range(300)]
    out = b" ".join(words[i] for i in rng.integers(0, 300, size=40000))
    return out[:BLOCK + 5000]


def _events(fn, detail=True):
    seen = []
    trace.attach(seen.append, detail=detail)
    try:
        fn()
    finally:
        trace.detach()
    return seen


def test_off_path_returns_the_shared_noop_and_emits_nothing():
    assert not trace.enabled()
    first = trace.span("lz4.match", bytes=10)
    assert first is trace.span("entry.split") is trace.stage("deflate.parse", "cpu")
    with first as got:
        pass
    assert got is first
    assert trace.records() == [] and trace.totals()["count"] == {}


def test_off_path_reads_the_environment_on_each_call(monkeypatch, capsys):
    monkeypatch.setenv("TPU7Z_TRACE", "1")
    with trace.span("entry.split"):
        pass
    assert "[tpu7z-trace] {'name': 'entry.split'" in capsys.readouterr().err
    monkeypatch.setenv("TPU7Z_TRACE", "")
    assert trace.span("entry.split") is trace.span("entry.h2d")


def test_detail_events_carry_parent_and_request():
    def nested():
        for _ in range(2):
            with trace.span("root.a", size=3):
                with trace.span("child.b", bytes=5):
                    with trace.span("leaf.c"):
                        pass

    plain = _events(nested, detail=False)
    full = _events(nested)
    assert [sorted(e) for e in plain] == [["name", "seconds"], ["bytes", "name", "seconds"],
                                          ["MBps", "name", "seconds", "size"]] * 2
    assert [e["name"] for e in full] == ["leaf.c", "child.b", "root.a"] * 2
    assert [e["parent"] for e in full] == ["child.b", "root.a", None] * 2
    first, second = full[:3], full[3:]
    assert len({e["request"] for e in first}) == 1 and len({e["request"] for e in second}) == 1
    assert first[0]["request"] != second[0]["request"]
    for e, p in zip(full, plain):
        assert {k: v for k, v in e.items() if k not in ("start", "end", "parent", "request")
                }.keys() == p.keys()
        assert e["end"] - e["start"] == pytest.approx(e["seconds"])
    assert full[2]["start"] <= full[1]["start"] <= full[0]["start"] <= full[0]["end"] \
        <= full[1]["end"] <= full[2]["end"]
    assert trace.totals()["requests"] == 4
    assert trace.totals()["count"] == {"root.a": 4, "child.b": 4, "leaf.c": 4}
    assert trace.totals()["bytes"] == {"child.b": 20}


def test_a_failing_span_reports_its_error_to_both():
    plain, detail = [], []
    trace.attach(plain.append)
    trace.attach(detail.append, detail=True)
    with pytest.raises(ValueError):
        with trace.span("entry.split"):
            raise ValueError("bad")
    assert plain[0]["error"] == detail[0]["error"] == "ValueError('bad')"
    # the failed span left the stack of open spans: the next is a root
    with trace.span("entry.h2d"):
        pass
    assert detail[1]["parent"] is None and detail[1]["request"] != detail[0]["request"]


def _annotations(fn, tmp_path):
    with trace.profile(tmp_path, device="cpu"):
        with trace.annotate("test.request"):
            fn()
    (path,) = tmp_path.glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    (req,) = [e for e in events if e.get("name") == "test.request"]
    t0, t1 = req["ts"], req["ts"] + req["dur"]
    return [e["name"] for e in events if e.get("cat") == "user_annotation"
            and e is not req and t0 <= e["ts"] and e["ts"] + e["dur"] <= t1 + 1]


def test_lz4_path_spans_are_annotations_of_the_request(data, tmp_path):
    names = _annotations(lambda: sharded.shard_compress_lz4_device(data, device="cpu"),
                         tmp_path)
    counts = collections.Counter(names)
    assert set(counts) == set(LZ4_SPANS)
    assert counts["read.lz4_check_ns"] == 3 and counts["sort.rows"] == 1
    assert trace.records() == [] and trace.totals()["count"] == {}    # the profiler alone


def test_gzip_spans_are_annotations_of_the_request(data, tmp_path):
    names = _annotations(lambda: codec.gzip_compress(data * 3, device="cpu"), tmp_path)
    assert set(names) == set(GZIP_SPANS)


def test_stage_under_the_profiler_alone_is_an_annotation(tmp_path):
    def staged():
        with trace.stage("deflate.parse", "cpu"):
            pass

    assert _annotations(staged, tmp_path) == ["deflate.parse"]
    assert trace.records() == []


def test_lz4_path_reads_four_times(data):
    for blob in (data, data[:16384], b""):
        ev = _events(lambda: sharded.shard_compress_lz4_device(blob, device="cpu"))
        reads = collections.Counter(e["name"] for e in ev if e["name"].startswith("read."))
        assert reads == {"read.lz4_check_ns": 3, "read.lz4_assemble_total": 1}
        root = [e for e in ev if e["parent"] is None]
        assert [e["name"] for e in root] == ["entry.lz4_device"]
        assert {e["request"] for e in ev} == {root[0]["request"]}


def test_gzip_reads_at_each_site(data):
    ev = _events(lambda: codec.gzip_compress(data * 3, device="cpu"))
    reads = collections.Counter(e["name"] for e in ev if e["name"].startswith("read."))
    passes = reads.pop("read.lz_panel_pass")
    assert reads == GZIP_READS and passes >= 1
    assert [e["name"] for e in ev if e["parent"] is None] == ["entry.gzip"]


def test_lz4_launch_bytes_by_hand(data):
    """Two blocks at W = 0: every plane a kernel reads whole once, every
    plane it writes once."""
    ev = _events(lambda: sharded.shard_compress_lz4_device(data[:BLOCK + 100], device="cpu"))
    got = {e["name"]: e["bytes"] for e in ev if "bytes" in e}
    B, N, G = 2, BLOCK, len(lz4_plane.GEO_NAMES)
    # so8, so4a, so4b and ns read; mlen and moff written
    assert got["lz4.match"] == B * (3 * 4 * N + 4) + B * 2 * 4 * N
    # mlen read; the uint8 is_start written
    assert got["lz4.parse"] == B * 4 * N + B * N
    # mlen, is_start and ns read (moff only at some starts); the planes,
    # core_used and used written
    assert got["lz4.geometry"] == B * (4 * N + N + 4) + B * (G * 4 * N + 4 + 4)
    # used, glen and kept read; out written whole
    assert got["lz4.emit"] == B * (4 + 2 * 4 * N) + B * lz4_plane.OUT_CAP
    # the block read; both tiers' int32 keys written
    assert got["lz4.keys"] == B * N + B * 2 * 4 * N
    # the block, both tiers' sorted keys and ns read; so8, so4a, so4b written
    assert got["lz4.probe"] == B * (N + 2 * 4 * N + 4) + B * 3 * 4 * N
    # one sort of both tiers' 2B rows of int32 keys, begin_bit 16: read 4
    # and write 4, twice, a key
    sorts = [e["bytes"] for e in ev if e["name"] == "sort.rows"]
    assert sorts == [2 * B * N * 16]
    assert lz4_cuda.launch_bytes("lz4_match", B, 16) == got["lz4.match"] + B * N


@pytest.mark.parametrize("dtype,payloads,begin_bit,per_key", [
    (torch.int64, 0, 16, 8 + 4 + 4 + 8),
    (torch.int32, 1, 16, (4 + 4) * 2 + (4 + 4) * 2),
    (torch.int32, 1, 8, (4 + 4) * 3 + (4 + 4) * 3),
    (torch.uint32, 0, 24, 4 + 4),
    (torch.int64, 3, 0, (8 + 4 * 3 + 4 * 3 + 8) + 3 * 8 * 4),
])
def test_sort_rows_bytes_by_hand(dtype, payloads, begin_bit, per_key):
    key = torch.arange(6 * 100, dtype=torch.int64).view(6, 100).flip(1).to(dtype)
    pays = [torch.arange(600, dtype=torch.int32).view(6, 100) for _ in range(payloads)]
    ev = _events(lambda: sort_cuda.sort_rows(key, *pays, begin_bit=begin_bit))
    assert [(e["name"], e["bytes"]) for e in ev] == [("sort.rows", 600 * per_key)]


def test_bytes_of_refused_arguments_are_zero():
    with pytest.raises(ValueError):
        sort_cuda.sort_rows(torch.zeros(4, dtype=torch.int32))
    assert sort_cuda.launch_bytes(torch.zeros(4, dtype=torch.int32), ()) == 0
    assert lz4_cuda._rows(b"x") == 0
    with pytest.raises(ValueError, match="blocks"):
        lz4_cuda.match_lengths(b"x", None, None, None, None)
