"""Entry points of the port, the counterparts of `__graft_entry__`.

`entry()` returns `(fn, args)`, where `fn(*args)` runs
`ops.match.find_matches` over the same sample (four 16 KiB blocks of
words) and returns (selected, mlen, moff); the tensors lie on the CUDA
card unless `device` names another. `dryrun_multichip(n)` runs the
sharded device encoder at `n` ranks and checks its frame.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops import match


def entry(device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta "]
    sample = b"".join(words[i] for i in rng.integers(0, 4, 6000))
    N = 16384
    B = 4
    blocks = np.zeros((B, N), dtype=np.uint8)
    for b in range(B):
        chunk = sample[b * N:(b + 1) * N]
        blocks[b, :len(chunk)] = np.frombuffer(chunk, dtype=np.uint8)
    lengths = np.minimum(
        np.full(B, N, np.int32),
        np.maximum(0, len(sample) - np.arange(B) * N)).astype(np.int32)

    def fn(blocks, lengths):
        return match.find_matches(blocks, lengths)

    return fn, (torch.from_numpy(blocks).to(dev), torch.from_numpy(lengths).to(dev))


def _dryrun_rank(payload: bytes, device: str) -> bytes:
    from .parallel.distributed import global_mesh
    from .parallel.sharded import shard_compress_lz4_device
    return shard_compress_lz4_device(payload, global_mesh(), W=16, device=device)


def dryrun_multichip(n: int, device=None) -> None:
    """The sharded device encoder at `n` ranks, the counterpart of
    `__graft_entry__.dryrun_multichip`: `n` spawned ranks (NCCL, one card
    each, unless `device` names the CPU, which takes gloo) each encode
    their span of 64 KiB blocks at W = 16 and assemble the frame after the
    ordered all-gathers. Raises unless every rank's frame equals the frame
    of one rank alone and the frame decodes to the payload."""
    from .models.lz4 import frame
    from .parallel.distributed import run_ranks
    from .parallel.sharded import shard_compress_lz4_device

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"zstd ", b"tpu "]
    payload = b"".join(words[i] for i in rng.integers(0, 6, 16384 * n))
    frames = run_ranks(_dryrun_rank, n, payload, dev.type, device=dev.type)
    one = shard_compress_lz4_device(payload, W=16, device=dev)
    for rank, got in enumerate(frames):
        if got != one:
            raise AssertionError(f"rank {rank} of {n}: frame differs from the "
                                 f"one-rank frame")
    if frame.decompress(one) != payload:
        raise AssertionError("the frame does not decode to the payload")
