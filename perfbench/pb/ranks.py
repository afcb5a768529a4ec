"""The ranks of a cell on several chips: rank 0 is the process that was
started; it starts ranks 1 .. n-1 as processes of the same command (with
`--rank`), one card each, and waits for them. They join one process group
as `README.md`'s `torchrun` example joins them: through the program's
`parallel.distributed.initialize` (NCCL on the cards, gloo on the CPU),
and the group is the program's `global_mesh()`. The harness keeps a gloo
group of its own for its barriers and results, so that they add no
kernel to the device's trace."""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import threading
import time

TIMEOUT_S = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv: list[str], world: int, port: int) -> list[subprocess.Popen]:
    """Ranks 1 .. world-1, each `argv` with its rank, their standard output
    sent to this process's standard error."""
    procs = []
    for rank in range(1, world):
        env = dict(os.environ, LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        procs.append(subprocess.Popen(
            [sys.executable, *argv, "--rank", str(rank), "--port", str(port)],
            env=env, stdout=sys.stderr.fileno()))
    return procs


def watch(procs: list[subprocess.Popen]):
    """End this process if a rank ends with an error: the others would
    wait for it in their next collective until the timeout."""
    def loop():
        while True:
            for p in procs:
                code = p.poll()
                if code not in (None, 0):
                    print(f"perfbench: rank process {p.args[-3]} exited with {code}",
                          file=sys.stderr, flush=True)
                    for q in procs:
                        if q.poll() is None:
                            q.kill()
                    os._exit(1)
            if all(p.poll() is not None for p in procs):
                return
            time.sleep(0.5)

    threading.Thread(target=loop, daemon=True).start()


def finish(procs: list[subprocess.Popen]) -> bool:
    """Wait for every rank; kill what is left after the timeout. True when
    every rank ended with 0."""
    ok = True
    for p in procs:
        try:
            ok &= p.wait(timeout=TIMEOUT_S) == 0
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            ok = False
    return ok


def join(rank: int, world: int, port: int, device: str):
    """(the program's group, the harness's gloo group) of this rank."""
    import torch.distributed as dist

    from tpu7z_torch.parallel import distributed

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    distributed.initialize(f"127.0.0.1:{port}", world, rank, device=device,
                           timeout_s=TIMEOUT_S)
    side = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return distributed.global_mesh(), side
