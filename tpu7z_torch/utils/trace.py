"""Tracing and profiling hooks: the port's counterpart of tpu7z/utils/trace.py.

Host spans, as in tpu7z (the zstd_trace model: callbacks around a region,
no cost until someone attaches or TPU7Z_TRACE is set):

    from tpu7z_torch.utils import trace
    trace.attach(my_callback)            # or TPU7Z_TRACE=1 for stderr
    with trace.span("lz4.compress", size=len(data)):
        ...
    trace.detach()

`stage(name, device)` is a span whose work runs on a device: it
synchronizes the CUDA card at both ends.

and the device profiler, where tpu7z has `tpu_profile`: `profile(logdir)`
records a `torch.profiler` trace of a region (host activity, and the CUDA
card's kernels unless the device named is the CPU) into `logdir` as a
TensorBoard-loadable JSON trace; `annotate(name)` names a region in it.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch

from ..device import resolve_device

_callbacks: list = []
_records: list = []
_keep_records = False


def attach(callback=None, keep_records: bool = False):
    """Register a trace callback: fn(event: dict). With keep_records=True
    events also accumulate in `records()`."""
    global _keep_records
    if callback is not None:
        _callbacks.append(callback)
    _keep_records = _keep_records or keep_records


def detach(callback=None):
    global _keep_records
    if callback is None:
        _callbacks.clear()
        _keep_records = False
    elif callback in _callbacks:
        _callbacks.remove(callback)


def records() -> list:
    return list(_records)


def clear():
    _records.clear()


def enabled() -> bool:
    return bool(_callbacks) or _keep_records or \
        bool(os.environ.get("TPU7Z_TRACE"))


def _emit(event: dict):
    if os.environ.get("TPU7Z_TRACE"):
        print(f"[tpu7z-trace] {event}", file=sys.stderr)
    if _keep_records:
        _records.append(event)
    for cb in _callbacks:
        cb(event)


@contextlib.contextmanager
def span(name: str, **fields):
    """Time a region; emits one event with its duration and, given a
    `size`, its throughput."""
    if not enabled():
        yield
        return
    t0 = time.perf_counter()
    err = None
    try:
        yield
    except BaseException as e:
        err = repr(e)
        raise
    finally:
        dt = time.perf_counter() - t0
        ev = {"name": name, "seconds": dt, **fields}
        if err is not None:
            ev["error"] = err
        size = fields.get("size")
        if size and dt > 0:
            ev["MBps"] = size / dt / 1e6
        _emit(ev)


@contextlib.contextmanager
def stage(name: str, device, **fields):
    """A span around a stage whose work runs on `device`, the CUDA card
    synchronized at both ends so that its host-clock time is the
    stage's; nothing when tracing is off."""
    if not enabled():
        yield
        return
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    with span(name, **fields):
        yield
        if cuda:
            torch.cuda.synchronize(device)


@contextlib.contextmanager
def profile(logdir, device=None):
    """`torch.profiler` over the region: the host, and the CUDA card unless
    `device` names the CPU. On exit the trace is written into `logdir`
    (`tensorboard_trace_handler`). Yields the profiler."""
    from torch.profiler import ProfilerActivity, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=tensorboard_trace_handler(str(logdir))) as prof:
        yield prof


def annotate(name: str):
    """A named region in the profiler's trace (`record_function`)."""
    return torch.profiler.record_function(name)
