"""The traced run: `torch.profiler` over requests spread across the window,
and the reduction of each traced request to what the metric readers read.

Every request runs inside `record_function(REQUEST)`. The profiler's
schedule keeps one request in every `period`; after each, its trace is
written as JSON into a directory of `$TMPDIR`, read, reduced and deleted,
so the traces never take more than one request's worth of disk.

A request's host window is its annotation. Inside it: the device's busy
intervals (kernels, copies, sets) and their union (the interval
arithmetic of the program's `utils/timing.py:busy_share`, copied), the
kernels' time by class (`kernel_class`), the union of kernel intervals,
and its ten longest idle gaps, each named by the host operation the
request's thread was in at the gap's middle (else the last one it left).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from collections import defaultdict

REQUEST = "perfbench.request"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NAME_CHARS = 160


def kernel_class(name: str) -> str:
    """'nccl' for NCCL's kernels, 'torch' for PyTorch's own (their names
    hold `at::`, or `at_cuda_detail` for the CUB kernels it builds in),
    'own' for every other kernel: the program's."""
    if "nccl" in name.lower():
        return "nccl"
    if "at::" in name or "at_cuda_detail" in name:
        return "torch"
    return "own"


def union(intervals, lo, hi):
    """Total length of the union of (start, end) intervals clipped to
    [lo, hi], and the gaps between them as (start, length)."""
    spans = sorted((max(a, lo), min(b, hi)) for a, b in intervals if a < hi and b > lo)
    busy, end, gaps = 0.0, lo, []
    for a, b in spans + [(hi, hi)]:
        if a > end:
            gaps.append((end, a - end))
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, gaps


def _host_label(host, at):
    """The innermost host operation around time `at`, else 'after' the
    last that ended before it."""
    inner = [e for e in host if e["ts"] <= at <= e["ts"] + e["dur"]]
    if inner:
        return min(inner, key=lambda e: e["dur"])["name"][:NAME_CHARS]
    before = [e for e in host if e["ts"] + e["dur"] < at]
    if before:
        return "after " + max(before, key=lambda e: e["ts"] + e["dur"])["name"][:NAME_CHARS]
    return "request start"


def reduce_request(events, spans=(), t0_host=None) -> dict | None:
    """One traced request's numbers (seconds), or None where the trace
    holds no request annotation. `spans` are the program's spans of the
    request, (name, start, end) on the host clock with the request's start
    at `t0_host`: they name the gaps as the host operations do."""
    reqs = [e for e in events if e.get("name") == REQUEST and e.get("cat") == "user_annotation"]
    if not reqs:
        return None
    req = reqs[0]
    t0, t1 = req["ts"], req["ts"] + req["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    busy, gaps = union([(e["ts"], e["ts"] + e["dur"]) for e in dev], t0, t1)
    kernels = [e for e in dev if e["cat"] == "kernel" and e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    kunion, _ = union([(e["ts"], e["ts"] + e["dur"]) for e in kernels], t0, t1)
    by_class = defaultdict(float)
    by_name = defaultdict(float)
    for e in kernels:
        by_class[kernel_class(e["name"])] += e["dur"] / 1e6
        by_name[e["name"][:NAME_CHARS]] += e["dur"] / 1e6
    for e in dev:
        if e["cat"] != "kernel" and t0 <= e["ts"] < t1:
            by_name[e["name"][:NAME_CHARS]] += e["dur"] / 1e6
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e
            and e.get("tid") == req.get("tid") and e is not req
            and e.get("name") != REQUEST and t0 <= e["ts"] <= t1]
    for name, a, b in spans:
        host.append({"name": name, "ts": t0 + (a - t0_host) * 1e6, "dur": (b - a) * 1e6})
    names = defaultdict(set)
    for e in kernels:
        names[kernel_class(e["name"])].add(e["name"][:NAME_CHARS])
    longest = sorted(gaps, key=lambda ag: -ag[1])[:10]
    named_gaps = [(_host_label(host, a + g / 2), g / 1e6) for a, g in longest]
    return {"window_s": (t1 - t0) / 1e6, "busy_s": busy / 1e6, "kernel_s": kunion / 1e6,
            "class_s": dict(by_class), "ops_s": dict(by_name), "gaps": named_gaps,
            "kernel_names": names}


def warm_profiler(cuda: bool):
    """One short profile of a small operation, exported and read, so that
    the profiler's own start (CUPTI's, on the card) falls into set-up and
    not into the first traced request."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    x = torch.ones(1 << 20, device="cuda" if cuda else "cpu")
    with tempfile.TemporaryDirectory(prefix="perfbench-warm-") as d:
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(REQUEST):
                (x * 2).sum().item()
        path = os.path.join(d, "warm.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            got = reduce_request(json.load(f)["traceEvents"])
    if got is None:
        raise RuntimeError("the profiler's trace holds no request annotation")
    return got


class Tracer:
    """`torch.profiler` for a window of requests: trace one request of
    every `period`, at most `active` of them, each reduced as it comes."""

    def __init__(self, active: int, period: int, cuda: bool):
        import torch

        self.spans = []          # (name, start, end) of the program's spans, host clock
        self.t0 = 0.0            # the current request's start, host clock
        self.requests = []
        self.cycles = 0
        self.kernel_names = defaultdict(set)
        self.dir = tempfile.mkdtemp(prefix="perfbench-trace-")
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        period = max(3, int(period))
        self.prof = torch.profiler.profile(
            activities=activities,
            schedule=torch.profiler.schedule(wait=period - 2, warmup=1, active=1,
                                             repeat=max(1, int(active))),
            on_trace_ready=self._ready)

    def _ready(self, prof):
        self.cycles += 1
        path = os.path.join(self.dir, "request.json")
        prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        got = reduce_request(events, [sp for sp in self.spans if sp[2] >= self.t0], self.t0)
        self.spans.clear()
        if got is not None:
            for cls, names in got.pop("kernel_names").items():
                self.kernel_names[cls] |= names
            self.requests.append(got)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def step(self):
        self.prof.step()

    def __exit__(self, *exc):
        try:
            return self.prof.__exit__(*exc)
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)


def summary(requests) -> dict:
    """Totals over traced requests: seconds by kernel class, busy, window,
    kernel union, the device operations by name and every idle gap."""
    out = {"requests": len(requests), "window_s": 0.0, "busy_s": 0.0, "kernel_s": 0.0,
           "class_s": defaultdict(float), "ops_s": defaultdict(float), "gaps": []}
    for r in requests:
        for k in ("window_s", "busy_s", "kernel_s"):
            out[k] += r[k]
        for k, v in r["class_s"].items():
            out["class_s"][k] += v
        for k, v in r["ops_s"].items():
            out["ops_s"][k] += v
        out["gaps"] += r["gaps"]
    out["class_s"] = dict(out["class_s"])
    out["ops_s"] = dict(out["ops_s"])
    return out


def breakdown(summ: dict, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each as [name, seconds]."""
    ops = sorted(summ["ops_s"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summ["gaps"], key=lambda g: -g[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}
