"""Timing on the card, and the card's idle share from a profiler trace.

`card` names the card and its power limit. `sample_ms` times a call with CUDA events on a CUDA device (the host
clock elsewhere, where a call ends when it returns); `timed` and
`timed_launches` take the median of its samples. `busy_share` reads one
`trace.profile` trace: the host window of an annotated region and the
union of the device's busy intervals inside it. `traced_encode` traces
one `encode_blocks` call, whose stages name themselves in the trace (the
encoder's `lz4.*` spans), and reads that trace.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from ..ops import lz4_cuda as K
from . import trace


def card():
    """(name, power limit) of the first card, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    name, power = out.splitlines()[0].rsplit(",", 1)
    return name.strip(), power.strip()


def sample_ms(fn, reps=5, launches=1, device="cuda"):
    """`reps` samples, in milliseconds, of one call of `fn` after one
    warm-up call; each sample the mean over `launches` calls back to back.
    CUDA events on a CUDA device, the host clock on any other."""
    fn()
    if torch.device(device).type != "cuda":
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            for _ in range(launches):
                fn()
            times.append((time.perf_counter() - t) * 1e3 / launches)
        return times
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return times


def timed(fn, reps=5):
    """Median milliseconds of `fn` on the card, after one warm-up run."""
    return statistics.median(sample_ms(fn, reps))


def timed_launches(fn, launches=10, reps=5):
    """Median milliseconds of one call of `fn` on the card, from events
    around `launches` calls back to back, after one warm-up call."""
    return statistics.median(sample_ms(fn, reps, launches))


def busy_share(trace_dir, window_name):
    """From the one torch.profiler trace in `trace_dir`: the host window of
    the region annotated `window_name`, the union of the device's busy
    intervals (kernels, copies, sets) inside it, the kernels counted, each
    annotated stage's span on the device, and the five longest idle gaps
    as (start from the window's start, length); all times in ms."""
    (path,) = Path(trace_dir).glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    (win,) = [e for e in events if e.get("name") == window_name
              and e.get("cat") == "user_annotation"]
    t0, t1 = win["ts"], win["ts"] + win["dur"]
    spans = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and e["ts"] < t1 and e["ts"] + e["dur"] > t0)
    busy, end, gaps = 0.0, t0, []
    for a, b in spans + [(t1, t1)]:
        if a > end:
            gaps.append(((end - t0) / 1e3, (a - end) / 1e3))
        if b > end:
            busy += b - max(a, end)
            end = b
    kernels = sum(1 for e in events if e.get("cat") == "kernel"
                  and t0 <= e["ts"] < t1)
    stages = {e["name"]: e["dur"] / 1e3 for e in events
              if e.get("cat") == "gpu_user_annotation"}
    return {"window_ms": (t1 - t0) / 1e3, "busy_ms": busy / 1e3, "kernels": kernels,
            "device_spans_ms": stages,
            "idle_gaps_ms": sorted(gaps, key=lambda g: -g[1])[:5]}


def traced_encode(blocks, ns, W, workdir):
    """One `encode_blocks(blocks, ns, W)` on the card under `trace.profile`,
    the whole call annotated "encode_blocks"; each stage is a span of the
    encoder's own (`lz4.candidates`, with `lz4.keys`, `sort.rows` and
    `lz4.probe` inside it, `lz4.match`, `lz4.parse`, `lz4.geometry`,
    `lz4.emit`), so a region of the trace.
    The trace goes to a directory made in `workdir` and removed after.
    Returns ((out, used), `busy_share` of the call with its "idle_share"
    and "segments_allocated", the device memory segments the caching
    allocator had to allocate during the call, host seconds of the
    traced call)."""
    logdir = tempfile.mkdtemp(dir=workdir)
    try:
        torch.cuda.synchronize()
        segments = torch.cuda.memory_stats(blocks.device)["segment.all.allocated"]
        t = time.perf_counter()
        with trace.profile(logdir):
            with trace.annotate("encode_blocks"):
                result = K.encode_blocks(blocks, ns, W)
                torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        segments = torch.cuda.memory_stats(blocks.device)["segment.all.allocated"] - segments
        share = busy_share(logdir, "encode_blocks")
    finally:
        shutil.rmtree(logdir)
    if share["kernels"] == 0:
        raise RuntimeError("the trace of encode_blocks holds no kernel")
    share["idle_share"] = 1 - share["busy_ms"] / share["window_ms"]
    share["segments_allocated"] = segments
    return result, share, seconds
