"""A run of one cell, from set-up to the result line; `run.py` and
`calibrate.py` drive it.

Set-up: the seed's pool is made in a process of its own (`start.pool`) while this
one imports PyTorch, builds (first run in a checkout) or loads the program's
libraries, starts the other ranks and joins their group; then the cell's
sizes are warmed up; each rank is held to cores of its own (`pin`).
`setup_s` runs from the process's start to the first
timed request. After the window: the peak device memory, the traced
numbers and the check, whose reference runs after the program's outputs
are on the host and its caches are freed.
"""

from __future__ import annotations

import json
import os
import sys
import time

from . import imports, loader, ranks, tracing
from .session import Session, combine
from .stats import end_to_end

_T0 = [time.perf_counter()]


def log(msg: str):
    """Progress on standard error, with the seconds since the process's
    start (its `T_START`, once a Runner has it)."""
    print(f"perfbench [{time.perf_counter() - _T0[0]:8.3f} s] {msg}", file=sys.stderr, flush=True)


class Runner:
    def __init__(self, cell: loader.Cell, args, argv: list[str], t_start: float, pool):
        """`pool` is the (executor, future) of `start.pool`, started before
        PyTorch was imported."""
        self.cell, self.args, self.t_start = cell, args, t_start
        self.rank, self.world = args.rank, cell.chips
        _T0[0] = t_start
        ex, fut = pool
        try:
            import torch

            torch.set_num_threads(min(4, os.cpu_count() or 1))
            if self.rank == 0:
                self._build(args.device)
            self.procs = []
            group = side = None
            if self.world > 1:
                if self.rank == 0:
                    args.port = ranks.free_port()
                    self.procs = ranks.spawn(argv, self.world, args.port)
                    ranks.watch(self.procs)
                group, side = ranks.join(self.rank, self.world, args.port, args.device)
            pin(self.rank, self.world)
            if args.device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            device = (f"cuda:{torch.cuda.current_device()}" if args.device == "cuda"
                      else args.device)
            if args.fault:
                from .faults import plant

                plant(args.fault)
            if getattr(args, "trace", 0):
                warm = tracing.warm_profiler(args.device == "cuda")
                log(f"profiler warmed: a request window of {warm['window_s']:.6f} s, "
                    f"device busy {warm['busy_s']:.6f} s")
            log("libraries and group ready")
            pool = fut.result()
            log("pool ready")
            self.session = Session(cell, device, pool, rank=self.rank,
                                   world=self.world, group=group, side=side)
        finally:
            ex.shutdown()
        self.session.warm_up(args.seed)
        log(f"warmed up: {self.session.request_s:.6f} s a request")

    def _build(self, device: str):
        """The program's libraries this configuration loads: built on the
        first run in a checkout (into the program's `_build/`), loaded
        after; kernel sources only where there is a card."""
        from tpu7z_torch.ops import _build

        names = [n for n in self.cell.config["libraries"]
                 if device == "cuda" or (_build.CSRC / f"{n}.cpp").exists()]
        for name in names:
            _build.load(name)

    def measure(self, seed: int, seconds: float, trace: bool, control: bool = False):
        """One window and its check: on rank 0 the result line, whose last
        key holds the compared numbers with their limits; elsewhere None."""
        s = self.session
        win = s.window(seed, seconds, trace=trace, control=control)
        if trace:
            log(f"trace: {win['trace']['cycles']} cycles, {win['trace']['requests']} requests "
                f"reduced of {win['requests']}")
        peaks = s.gather(s.peak_bytes())
        traces = s.gather(win.get("trace"))
        numbers = s.gather(s.check(win))
        if self.rank != 0:
            return None
        peak = max(peaks)
        numbers, failed = combine(numbers)
        checks = {k: {"value": numbers[k], "limit": spec["limit"]}
                  for k, spec in self.cell.config["checks"].items()}
        correct = all(c["value"] <= c["limit"] for c in checks.values())
        device = self._device(peak)
        if trace:
            metrics, breakdown = self._per_layer(traces, device)
        else:
            metrics, breakdown = self._end_to_end(win), None
        line = {"correct": correct, "attempted": win["requests"], "failed": failed,
                "metrics": metrics, "device": device}
        if breakdown is not None:
            line["breakdown"] = breakdown
            line["kernel_names"] = traces[0]["kernel_names"]
        line["checks"] = checks
        return line

    def _device(self, peak: int) -> dict:
        import torch

        if self.args.device != "cuda":
            return {"platform": "cpu", "kind": "cpu", "count": self.world,
                    "memory_peak_bytes": peak}
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(),
                "count": self.world, "memory_peak_bytes": peak}

    def _end_to_end(self, win) -> dict:
        values = end_to_end(win["latencies"], win["bytes_in"], win["bytes_out"],
                            win["window_s"])
        values["setup_s"] = win["start"] - self.t_start
        units = {m["name"]: m["unit"] for m in self.cell.end_to_end}
        return {name: {"value": values[name], "unit": unit} for name, unit in units.items()}

    def _per_layer(self, traces, device):
        ctx = context(traces, self.world, device)
        device["busy_s"] = ctx["busy_s"]
        device["window_s"] = ctx["window_s"]
        metrics = {}
        for m in self.cell.per_layer:
            value = loader.module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        return metrics, tracing.breakdown(traces[0])

    def close(self) -> bool:
        """Leave the process groups, every rank together (a group left to
        the interpreter's exit can abort the process), then wait for the
        other ranks. True when every rank ended with 0."""
        if self.world > 1:
            import torch.distributed as dist

            dist.barrier(group=self.session.side)
            dist.destroy_process_group()
        return ranks.finish(self.procs)


def pin(rank: int, world: int, per_rank: int = 4):
    """Hold this rank's process to cores of its own: `per_rank` of those it
    may use (fewer where they do not go round), rank r the r-th group.
    The host's scheduler then moves no thread of the request loop between
    cores, which set the tails of the host part of a request."""
    if not hasattr(os, "sched_setaffinity"):
        return
    cores = sorted(os.sched_getaffinity(0))
    n = max(1, min(per_rank, len(cores) // world))
    mine = cores[rank * n:(rank + 1) * n]
    if mine:
        os.sched_setaffinity(0, mine)


def context(traces: list[dict], chips: int, device: dict) -> dict:
    """What a per-layer reader reads: totals over the traced requests,
    device times averaged over the ranks, spans per request of the whole
    traced window (rank 0's)."""
    first = traces[0]
    n = first["requests"]
    peaks = json.loads((loader.HERE / "pb" / "peaks.json").read_text())
    classes = {c for t in traces for c in t["class_s"]}

    def mean(key):
        return sum(t[key] for t in traces) / len(traces)

    return {
        "requests": n,
        "chips": chips,
        "class_ms": {c: sum(t["class_s"].get(c, 0.0) for t in traces) / len(traces) / n * 1e3
                     for c in classes} if n else {},
        "kernel_s": mean("kernel_s"),
        "busy_s": mean("busy_s"),
        "window_s": mean("window_s"),
        "bytes_in": first["bytes_in"],
        "bytes_out": first["bytes_out"],
        "peak_bytes_per_s": peaks.get(device["kind"], {}).get("hbm_bytes_per_s"),
        "spans_ms": {k: v / first["span_requests"] * 1e3 for k, v in first["spans_s"].items()},
    }


def report(line: dict, out=sys.stdout, err=sys.stderr) -> int:
    """The compared numbers beside their limits as the last lines on
    standard error, then the result as the last line on standard output;
    nothing is printed, and 3 returned, where a forbidden module is
    loaded."""
    bad = imports.forbidden_loaded()
    if bad:
        print(f"perfbench: forbidden modules loaded in this process: {', '.join(bad)}",
              file=err, flush=True)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=err, flush=True)
    print(json.dumps(line), file=out, flush=True)
    return 0
