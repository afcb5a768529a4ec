"""Process-group set-up: the port's counterpart of
tpu7z/parallel/distributed.py.

One process per device: `initialize()` joins this process to a
`torch.distributed` process group (NCCL for the card, one rank a card;
gloo for ranks on the CPU), and `global_mesh()` gives that group, over
which parallel/sharded.py shards its blocks. A single process needs none
of it: with no address given, `initialize()` does nothing.

Several ranks on one host:
    torchrun --nproc-per-node=<cards> prog.py   # NCCL, one rank a card
    run_ranks(fn, n, ..., device="cpu")         # gloo ranks, spawned here
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import BACKEND


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device=None,
               timeout_s: float = 120) -> bool:
    """Join the process group. `coordinator` ("host:port", rank 0's store),
    `num_processes` and `process_id` default from torchrun's MASTER_ADDR
    and MASTER_PORT, WORLD_SIZE and RANK. The backend follows `device`
    (the card unless named): NCCL on the card, after this process takes
    card LOCAL_RANK (default: its rank), or gloo on the CPU. Returns True
    when there is more than one process; with nothing given it is a no-op
    that returns False."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator is None and num_processes is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("initialize: the coordinator's address, the number "
                         "of processes and this process's id are all needed")
    dev = resolve_device(device)
    if dev.type not in BACKEND:
        raise ValueError(f"initialize: no process group for {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id)))
    dist.init_process_group(
        BACKEND[dev.type], init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return num_processes > 1


def global_mesh():
    """The default process group, every rank; None when this process runs
    alone (no process group initialised)."""
    return dist.group.WORLD if dist.is_initialized() else None


def process_info() -> dict:
    """This process's rank and the world's size. `local_devices` counts the
    ranks on this host (torchrun's LOCAL_WORLD_SIZE, else the world: one
    host), `global_devices` the ranks of the world, one device each."""
    if not dist.is_initialized():
        return {"process_id": 0, "process_count": 1, "local_devices": 1,
                "global_devices": 1}
    size = dist.get_world_size()
    return {"process_id": dist.get_rank(), "process_count": size,
            "local_devices": int(os.environ.get("LOCAL_WORLD_SIZE", size)),
            "global_devices": size}


def free_port() -> int:
    """A TCP port on 127.0.0.1 that no one listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(tasks, results, n, rank, port, device, timeout_s):
    """One spawned rank: take (fn, args) from `tasks`, join the group over
    127.0.0.1, run `fn(*args)` and put (rank, True, its result) or (rank,
    False, the traceback) on `results`."""
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(n)
    # the ranks share this host: their connections stay on the loopback,
    # and ranks on the CPU split its cores
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    try:
        fn, args = tasks.get()
        initialize(f"127.0.0.1:{port}", n, rank, device=device,
                   timeout_s=timeout_s)
        try:
            value = fn(*args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    else:
        results.put((rank, True, value))


def run_ranks(fn, n: int, *args, device=None, timeout_s: float = 120) -> list:
    """Run `fn(*args)` in `n` spawned ranks of one process group on this
    host (NCCL on the cards unless `device` names the CPU, which takes
    gloo) and return each rank's result, in rank order. `fn` and its
    arguments must pickle, and the ranks import only what `fn` needs.
    A rank that fails raises here with its traceback; past `timeout_s`
    every rank is killed and TimeoutError raised."""
    if n < 1:
        raise ValueError(f"run_ranks: {n} ranks")
    dev = resolve_device(device)
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(f"run_ranks: {n} ranks need {n} cards, "
                           f"{torch.cuda.device_count()} present")
    ctx = multiprocessing.get_context("spawn")
    # the work goes through a queue, not the processes' arguments: those
    # are written to each child in turn, as it starts
    tasks, results = ctx.Queue(), ctx.Queue()
    for _ in range(n):
        tasks.put((fn, args))
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(tasks, results, n, r, port, str(dev), timeout_s))
             for r in range(n)]
    deadline = time.monotonic() + timeout_s
    done = {}
    try:
        for p in procs:
            p.start()
        while len(done) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_ranks: {n - len(done)} of {n} ranks "
                                   f"gave no result in {timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                # a rank that exits with 0 has put its result first
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_ranks: rank {dead[0]} exited with "
                                       f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{value}")
            done[rank] = value
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=30)
        for q in (tasks, results):
            q.cancel_join_thread()
            q.close()
    return [done[r] for r in range(n)]
