"""What a run starts before it imports PyTorch: its arguments and the
pool. Nothing here imports PyTorch, so the pool's process (spawned, it
imports only this package and numpy) makes the seed's pool while the run's
process imports PyTorch and sets up the card."""

from __future__ import annotations

import argparse
import concurrent.futures
import multiprocessing

from . import corpus, loader, traffic


def add_internal_args(p: argparse.ArgumentParser):
    """The harness's own arguments, left out of its help: `--rank` and
    `--port` for the processes of ranks 1 .. n-1, which rank 0 starts;
    `--device cpu`, `--pool-bytes` (the pool and the mix's sizes scaled to
    it), `--fault` and `--extra-cells` (a file of cells held out of
    `BENCHMARK.json`, `loader.benchmark`) for the tests, which drive runs
    on the CPU."""
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--pool-bytes", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--fault", default="", help=argparse.SUPPRESS)
    p.add_argument("--extra-cells", default="", help=argparse.SUPPRESS)


def cell(name: str, pool_bytes: int = 0, extra: str = "") -> loader.Cell:
    """The cell, its mix scaled to `pool_bytes` where that is given."""
    c = loader.Cell(name, loader.benchmark(extra))
    if pool_bytes:
        c.traffic = traffic.scaled(c.traffic, pool_bytes / c.traffic["pool"]["corpus_bytes"])
    return c


def pool(c: loader.Cell, seed: int):
    """(executor, future of the pool's bytes): the seed's pool made in a
    process of its own."""
    ex = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    return ex, ex.submit(corpus.make_pool, int(c.traffic["pool"]["corpus_bytes"]), seed)
