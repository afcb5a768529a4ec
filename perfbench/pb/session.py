"""One cell in one process (a rank, where the cell asks for several chips):
set-up, warm-up, the measured window, the traced window and the check.

Every rank runs the same calls in the same order. Rank 0 decides when the
window ends and tells the others through a gloo group of the harness's
own (`side`), which also holds each request between two barriers: a
request starts when every rank is ready and ends when the last rank holds
its bytes. With one rank those steps do nothing.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
import torch.distributed as dist

from . import loader, tracing
from .traffic import Traffic, max_size, size_at

WARM_QUANTILES = 64       # sizes warmed up: this many quantiles of the mix, and its largest


class Session:
    def __init__(self, cell: loader.Cell, device: str, pool: bytes, *, rank: int = 0,
                 world: int = 1, group=None, side=None):
        self.cell = cell
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.rank, self.world, self.group, self.side = rank, world, group, side
        self.pool = pool
        self.entry = loader.module("entries", cell.config["entry"]).Entry(
            cell.config, device, group)
        self.reference = loader.module("reference", cell.config["reference"])
        self.request_s = None

    # -- ranks ---------------------------------------------------------
    def _agree(self, go: bool) -> bool:
        """Rank 0's decision, taken by every rank (a barrier as well)."""
        if self.side is None:
            return go
        flag = torch.tensor([int(go and self.rank == 0)])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.side)
        return bool(flag.item())

    def _barrier(self):
        if self.side is not None:
            dist.barrier(group=self.side)

    def gather(self, obj) -> list:
        """`obj` of every rank, in rank order, on rank 0 (None elsewhere)."""
        if self.side is None:
            return [obj]
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.side)
        return out

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    # -- the program ---------------------------------------------------
    def _caller(self, control: bool):
        if not control:
            return self.entry
        spec = self.cell.config["control"]
        if spec["by"] == "program":
            return lambda data: self.entry(data, **spec["args"])
        return lambda data: self.reference.compress(data, self.device, **spec["args"])

    def warm_up(self, seed: int):
        """Every size the mix draws, at WARM_QUANTILES quantiles and its
        largest, then two requests of indices the window never uses; the
        mean time of a request, the first call's left out (it pays the
        first-call costs), places the traces."""
        traffic = Traffic(self.cell.traffic, seed, self.pool)
        sizes = sorted({size_at(self.cell.traffic, (k + 0.5) / WARM_QUANTILES)
                        for k in range(WARM_QUANTILES)} | {max_size(self.cell.traffic)})
        times = []
        for size in sizes:
            self._agree(True)
            t = time.perf_counter()
            self.entry(traffic.ring[:size])
            self._barrier()
            times.append(time.perf_counter() - t)
        for i in (-1, -2):
            self._agree(True)
            t = time.perf_counter()
            self.entry(traffic.request(i))
            self._barrier()
            times.append(time.perf_counter() - t)
        self._sync()
        self.request_s = float(np.mean(times[1:]))

    def window(self, seed: int, seconds: float, trace: bool = False,
               control: bool = False) -> dict:
        """Requests 0, 1, ... of the seed's traffic in a closed loop until
        one ends `seconds` after the first began. Keeps the outputs of a
        sample of requests drawn from the seed (reservoir sampling) and of
        the longest, for the check."""
        traffic = Traffic(self.cell.traffic, seed, self.pool)
        call = self._caller(control)
        keep = int(self.cell.run["check"]["sample"])
        rng = np.random.default_rng([int(seed) % (1 << 64), 0xC4EC])
        slots, longest = [], (-1, -1, None)
        lat, bytes_in, bytes_out = [], 0, 0
        tracer = spans = None
        if trace:
            from tpu7z_torch.utils import trace as program_trace

            active = int(self.cell.run["trace"]["requests"])
            expect = max(1.0, seconds / max(self.request_s or 1.0, 1e-6))
            tracer = tracing.Tracer(active, expect // active, self.cuda)
            spans = {}

            def on_span(event):
                spans[event["name"]] = spans.get(event["name"], 0.0) + event["seconds"]
                now = time.perf_counter()
                tracer.spans.append((event["name"], now - event["seconds"], now))

            program_trace.attach(on_span)
            tracer.__enter__()
        i, start, end = 0, None, None
        traced_bytes = []
        gc.collect()
        gc.freeze()                 # no collection pauses inside the window
        gc.disable()
        try:
            while self._agree(start is None or end - start < seconds):
                data = traffic.request(i)
                t0 = time.perf_counter()
                if tracer is not None:
                    tracer.t0 = t0
                    tracer.spans.clear()
                if start is None:
                    start = t0
                with torch.profiler.record_function(tracing.REQUEST):
                    out = call(data)
                self._barrier()
                end = time.perf_counter()
                lat.append(end - t0)
                bytes_in += len(data)
                bytes_out += len(out)
                if tracer is not None:
                    seen = len(tracer.requests)
                    tracer.step()
                    if len(tracer.requests) > seen:
                        traced_bytes.append((len(data), len(out)))
                if i < keep:
                    slots.append((i, out))
                else:
                    j = int(rng.integers(0, i + 1))
                    if j < keep:
                        slots[j] = (i, out)
                if len(data) > longest[1]:
                    longest = (i, len(data), out)
                i += 1
        finally:
            gc.enable()
            gc.unfreeze()
            if tracer is not None:
                tracer.__exit__(None, None, None)
                program_trace.detach(on_span)
        kept = dict(slots)
        kept[longest[0]] = longest[2]
        result = {"seed": seed, "requests": i, "latencies": lat, "bytes_in": bytes_in,
                  "bytes_out": bytes_out, "window_s": end - start, "start": start,
                  "kept": kept, "traffic": traffic}
        if tracer is not None:
            summ = tracing.summary(tracer.requests)
            summ["bytes_in"] = sum(b[0] for b in traced_bytes)
            summ["bytes_out"] = sum(b[1] for b in traced_bytes)
            summ["spans_s"] = spans
            summ["span_requests"] = i
            summ["kernel_names"] = {k: sorted(v) for k, v in tracer.kernel_names.items()}
            summ["cycles"] = tracer.cycles
            result["trace"] = summ
        return result

    def peak_bytes(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.device)) if self.cuda else 0

    def check(self, win: dict) -> tuple[dict, int]:
        """The compared numbers summed over the kept requests, from the
        reference's bytes for each request's input, computed here, against
        the program's; and how many kept requests read above 0."""
        if self.cuda:
            torch.cuda.empty_cache()
        items = []
        for i, got in sorted(win["kept"].items()):
            data = win["traffic"].request(i)
            items.append((data, self.reference.compress(data, self.device), got))
        numbers = self.reference.compare(items)
        totals = {name: sum(n[name] for n in numbers) for name in self.cell.config["checks"]}
        return totals, sum(any(n.values()) for n in numbers)


def combine(checks: list[tuple[dict, int]]) -> tuple[dict, int]:
    """Every rank's compared numbers and failed requests, summed."""
    out = {}
    for numbers, _ in checks:
        for k, v in numbers.items():
            out[k] = out.get(k, 0) + v
    return out, sum(f for _, f in checks)
