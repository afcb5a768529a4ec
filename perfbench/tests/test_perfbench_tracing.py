"""The reduction of a traced request and the per-layer readers, on a
synthetic profiler trace (times in microseconds, as the trace has them)."""

import pytest

from pb import loader, runner, tracing

OWN = "(anonymous namespace)::lz4_match_kernel(unsigned char const*, int const*)"
TORCH = "void at::native::vectorized_elementwise_kernel<4, at::native::AbsFunctor<long>>"
CUB = "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>"
NCCL = "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)"


def events():
    req = {"name": tracing.REQUEST, "cat": "user_annotation", "ts": 1000.0, "dur": 100.0,
           "tid": 7}
    return [
        req,
        {"name": "aten::sort", "cat": "cpu_op", "ts": 1001.0, "dur": 4.0, "tid": 7},
        {"name": "aten::item", "cat": "cpu_op", "ts": 1040.0, "dur": 20.0, "tid": 7},
        {"name": "aten::copy_", "cat": "cpu_op", "ts": 1085.0, "dur": 3.0, "tid": 7},
        {"name": OWN, "cat": "kernel", "ts": 1010.0, "dur": 10.0},
        {"name": TORCH, "cat": "kernel", "ts": 1015.0, "dur": 10.0},      # overlaps OWN
        {"name": CUB, "cat": "kernel", "ts": 1030.0, "dur": 5.0},
        {"name": NCCL, "cat": "kernel", "ts": 1070.0, "dur": 10.0},
        {"name": "Memcpy DtoH (Device -> Pinned)", "cat": "gpu_memcpy", "ts": 1090.0, "dur": 5.0},
        {"name": OWN, "cat": "kernel", "ts": 2000.0, "dur": 50.0},       # another request's
    ]


def test_kernel_classes():
    assert tracing.kernel_class(OWN) == "own"
    assert tracing.kernel_class(TORCH) == "torch"
    assert tracing.kernel_class(CUB) == "torch"
    assert tracing.kernel_class(NCCL) == "nccl"


def test_union_and_gaps():
    busy, gaps = tracing.union([(1, 3), (2, 5), (7, 8), (20, 30)], 0, 10)
    assert busy == 5
    assert gaps == [(0, 1), (5, 2), (8, 2)]


def test_reduce_request():
    r = tracing.reduce_request(events())
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(35e-6)            # 1010-1025, 1030-1035, 1070-1080, 1090-1095
    assert r["kernel_s"] == pytest.approx(30e-6)
    assert r["class_s"] == pytest.approx({"own": 10e-6, "torch": 15e-6, "nccl": 10e-6})
    labels = dict(r["gaps"])
    assert labels["aten::item"] == pytest.approx(35e-6)   # 1035-1070, the host in aten::item
    assert labels["aten::sort"] == pytest.approx(10e-6)       # 1000-1010
    assert labels["after aten::sort"] == pytest.approx(5e-6)  # 1025-1030
    assert tracing.reduce_request([e for e in events() if e["cat"] != "user_annotation"]) is None


HELD = str(loader.HERE / "tests" / "held_cells.json")


def ctx():
    t = tracing.summary([tracing.reduce_request(events())] * 2)
    t.update(bytes_in=2 * 4_000_000, bytes_out=2 * 1_000_000,
             spans_s={"deflate.header": 0.3, "lz.match_lengths": 0.06}, span_requests=3,
             kernel_names={})
    return runner.context([t, t], 1, {"kind": "NVIDIA H100 80GB HBM3"})


def test_readers_on_a_synthetic_trace():
    c = ctx()
    read = {m["name"]: loader.module("metrics", m["name"]).read(c)
            for m in loader.benchmark(HELD)["per_layer"]}
    assert read["kernels.csrc_ms"] == pytest.approx(0.010)
    assert read["encoder.torch_ops_ms"] == pytest.approx(0.015)
    assert read["collective.nccl_ms"] == pytest.approx(0.010)
    assert read["device.idle_pct"] == pytest.approx(65.0)
    # least time (8e6 + 2e6 bytes) / 3.35e12 B/s over 60 us of kernels
    assert read["kernels_roofline"] == pytest.approx(100 * 10e6 / 3.35e12 / 60e-6)
    assert read["deflate.header_ms"] == pytest.approx(100.0)
    assert read["lz.match_lengths_ms"] == pytest.approx(20.0)


def test_readers_return_nothing_where_nothing_is_read():
    t = tracing.summary([])
    t.update(bytes_in=0, bytes_out=0, spans_s={}, span_requests=1, kernel_names={})
    c = runner.context([t], 1, {"kind": "cpu"})
    for m in loader.benchmark(HELD)["per_layer"]:
        assert loader.module("metrics", m["name"]).read(c) is None, m["name"]
