"""Progress and error aggregation across ranks: the port's counterpart of
tpu7z/parallel/progress.py.

Each rank contributes (in_bytes, out_bytes, error_flag); the global view
is the sums and the largest error code (0 = ok), so the first-error-wins
rule of the host accumulator becomes a max. `reduce_progress` reduces on
the device and then across the ranks of a process group; `Progress` is
the host accumulator.
"""

from __future__ import annotations

import threading
from typing import Callable

import torch
import torch.distributed as dist

from . import mesh


def reduce_progress(in_sizes, out_sizes, error_flags, group=None):
    """(in total, out total, largest error code) over this rank's entries
    and, with a `group`, every rank's: 0-d int64 tensors on the inputs'
    device. Two collectives: the two sums together, then the max."""
    in_sizes, out_sizes, error_flags = (
        torch.as_tensor(t) for t in (in_sizes, out_sizes, error_flags))
    sums = torch.stack([in_sizes.sum(), out_sizes.sum()]).to(torch.int64)
    error = error_flags.max().to(torch.int64)
    mesh.world(group, sums.device)
    if group is not None:
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(error, op=dist.ReduceOp.MAX, group=group)
    return sums[0], sums[1], error


class Progress:
    """Host-side accumulator: totals plus first-error-wins, optionally
    forwarding the totals to a callback. Worker threads share one (the
    zstd job model), so its updates hold a lock."""

    def __init__(self, callback: Callable[[int, int], None] | None = None):
        self.in_total = 0
        self.out_total = 0
        self.error: BaseException | None = None
        self._cb = callback
        self._lock = threading.Lock()

    def add(self, in_bytes: int, out_bytes: int) -> None:
        with self._lock:
            if self.error is not None:
                return
            self.in_total += in_bytes
            self.out_total += out_bytes
            if self._cb is not None:
                self._cb(self.in_total, self.out_total)

    def set_error(self, exc: BaseException) -> None:
        with self._lock:
            if self.error is None:  # first error wins
                self.error = exc

    def check(self) -> None:
        if self.error is not None:
            raise self.error
