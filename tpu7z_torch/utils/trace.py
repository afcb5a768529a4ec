"""Tracing and profiling hooks: the port's counterpart of tpu7z/utils/trace.py.

Host spans, as in tpu7z (the zstd_trace model: callbacks around a region,
no cost until someone attaches or TPU7Z_TRACE is set):

    from tpu7z_torch.utils import trace
    trace.attach(my_callback)            # or TPU7Z_TRACE=1 for stderr
    with trace.span("lz4.compress", size=len(data)):
        ...
    trace.detach()

A span has three ways out, each taken only when it is on:
  - the events of `attach(cb)`, of `keep_records` and of TPU7Z_TRACE,
    which carry tpu7z's keys: the name, `seconds`, the span's own fields
    (`size`, and `bytes` where a span wraps one of the port's kernel
    launches), `error` and `MBps`;
  - `attach(cb, detail=True)`, whose events also carry `start` and `end`
    (`time.perf_counter()`), `parent` (the enclosing span's name, None at
    a root) and `request` (one id for every span under one root span);
  - a recording `torch.profiler`: the span is a `record_function` region,
    a `user_annotation` in the same trace and on the same clock as the
    kernels and copies launched inside it. Nothing synchronizes for it.
With none of them on, `span()` returns one shared no-op context manager.
Each span that emits also adds to the process's counters, `totals()`:
the root spans, and by name the spans and their `bytes` fields.

`stage(name, device)` is a span whose work runs on a device: with a
callback, records or TPU7Z_TRACE on, it synchronizes the CUDA card at
both ends, so that its host-clock time is the stage's.

and the device profiler, where tpu7z has `tpu_profile`: `profile(logdir)`
records a `torch.profiler` trace of a region (host activity, and the CUDA
card's kernels unless the device named is the CPU) into `logdir` as a
TensorBoard-loadable JSON trace; `annotate(name)` names a region in it.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import threading
import time

import torch
import torch.autograd.profiler as _profiler

from ..device import resolve_device

_callbacks: list = []
_detail: list = []          # callbacks attached with detail=True
_records: list = []
_keep_records = False
_open = threading.local()   # .spans: (name, request) of this thread's open spans
_requests = itertools.count(1)
_roots = 0                  # root spans emitted
_counts: dict = {}          # spans emitted, by name
_bytes: dict = {}           # their `bytes` fields summed, by name

# TPU7Z_TRACE is read on each call from os.environ's own store:
# `os.environ.get` of an unset name raises and catches a KeyError inside,
# which costs more than a whole span that is off
_ENV = os.environ._data
_ENV_KEY = os.environ.encodekey("TPU7Z_TRACE")


def _env_on() -> bool:
    """TPU7Z_TRACE set and not empty."""
    return bool(_ENV.get(_ENV_KEY))


def attach(callback=None, keep_records: bool = False, detail: bool = False):
    """Register a trace callback: fn(event: dict). With keep_records=True
    events also accumulate in `records()`. With detail=True the callback's
    events also carry `start`, `end`, `parent` and `request`."""
    global _keep_records
    if callback is not None:
        (_detail if detail else _callbacks).append(callback)
    _keep_records = _keep_records or keep_records


def detach(callback=None):
    global _keep_records
    if callback is None:
        _callbacks.clear()
        _detail.clear()
        _keep_records = False
    else:
        for held in (_callbacks, _detail):
            if callback in held:
                held.remove(callback)


def records() -> list:
    return list(_records)


def clear():
    _records.clear()


def totals() -> dict:
    """What the spans emitted since the process started or the last
    `reset_totals()` add up to: "requests", the root spans (one a call of
    an entry point); "count", the spans by name; "bytes", their `bytes`
    fields summed by name."""
    return {"requests": _roots, "count": dict(_counts), "bytes": dict(_bytes)}


def reset_totals():
    global _roots
    _roots = 0
    _counts.clear()
    _bytes.clear()


def enabled() -> bool:
    """A callback, records or TPU7Z_TRACE on (the profiler is not asked)."""
    return bool(_callbacks or _detail or _keep_records) or _env_on()


def _emit(event: dict, detail: dict):
    if _env_on():
        print(f"[tpu7z-trace] {event}", file=sys.stderr)
    if _keep_records:
        _records.append(event)
    for cb in _callbacks:
        cb(event)
    if _detail:
        full = {**event, **detail}
        for cb in _detail:
            cb(full)


class _Off:
    """What `span` returns when nothing is on."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "fields", "emit", "region", "start", "parent", "request")

    def __init__(self, name, fields, emit):
        self.name, self.fields, self.emit = name, fields, emit
        self.region = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.region = torch.profiler.record_function(self.name)
            self.region.__enter__()
        if self.emit:
            stack = getattr(_open, "spans", None)
            if stack is None:
                stack = _open.spans = []
            if stack:
                self.parent, self.request = stack[-1]
            else:
                self.parent, self.request = None, next(_requests)
            stack.append((self.name, self.request))
            self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        global _roots
        if self.emit:
            end = time.perf_counter()
            _open.spans.pop()
        if self.region is not None:
            self.region.__exit__(exc_type, exc, tb)
        if self.emit:
            name = self.name
            _roots += self.parent is None
            _counts[name] = _counts.get(name, 0) + 1
            moved = self.fields.get("bytes")
            if moved is not None:
                _bytes[name] = _bytes.get(name, 0) + moved
            dt = end - self.start
            ev = {"name": name, "seconds": dt, **self.fields}
            if exc is not None:
                ev["error"] = repr(exc)
            size = self.fields.get("size")
            if size and dt > 0:
                ev["MBps"] = size / dt / 1e6
            _emit(ev, {"start": self.start, "end": end, "parent": self.parent,
                       "request": self.request})
        return False


def span(name: str, **fields):
    """Time a region; emits one event with its duration and, given a
    `size`, its throughput; a `record_function` region under a recording
    profiler; the shared no-op when neither is on."""
    if not (_callbacks or _detail or _keep_records or _profiler._is_profiler_enabled
            or _ENV.get(_ENV_KEY)):
        return _OFF
    return _Span(name, fields, enabled())


def stage(name: str, device, **fields):
    """A span around a stage whose work runs on `device`, the CUDA card
    synchronized at both ends when a callback, records or TPU7Z_TRACE is
    on; under the profiler alone a span, with no synchronize."""
    if not enabled():
        return span(name, **fields)
    return _synchronized(name, device, fields)


@contextlib.contextmanager
def _synchronized(name, device, fields):
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
