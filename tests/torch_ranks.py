"""Inputs of the port's multi-rank tests, and the work each spawned rank
does on them. The ranks import this module and tpu7z_torch only, never
JAX: the JAX reference runs in the test process itself.

`session()` runs on every rank of a gloo process group on the CPU
(`tpu7z_torch.parallel.distributed.run_ranks`) and returns what each
sharded entry point gave there, by case.
"""

from __future__ import annotations

import numpy as np

BLOCK = 1 << 16
SMALL_BLOCK = 1 << 14


def words(n_words: int, seed: int, vocab: list[bytes]) -> bytes:
    rng = np.random.default_rng(seed)
    return b"".join(vocab[i] for i in rng.integers(0, len(vocab), n_words))


def frame_payloads() -> dict:
    """name -> (payload, W) for shard_compress_lz4_device: the words of
    tests/test_parallel.py's device tests at W = 16 and 0 (4 blocks);
    random bytes over one block with a partial tail (raw blocks; 2 blocks,
    fewer than 4 ranks); an empty input (one block of length 0, fewer
    than 2 ranks)."""
    text = words(40000, 0, [b"alpha ", b"beta ", b"gamma ", b"delta ", b"tpu "])
    rand = np.random.default_rng(3).integers(0, 256, BLOCK + 12345, np.uint8).tobytes()
    return {"words_W16": (text, 16), "words_W0": (text, 0),
            "random_tail_W16": (rand, 16), "empty_W0": (b"", 0)}


def match_sample() -> bytes:
    """The sample of tests/test_parallel.py: 11 blocks of 16 KiB."""
    return words(30000, 7, [b"alpha ", b"beta ", b"gamma ", b"delta "])


def match_blocks():
    """The sample as 12 blocks of 16 KiB (one empty), which divide over 1,
    2 and 4 ranks: (blocks (12, 16384) uint8, lengths (12,) int32)."""
    s = np.frombuffer(match_sample(), np.uint8)
    nb = 12
    blocks = np.zeros(nb * SMALL_BLOCK, np.uint8)
    blocks[:s.size] = s
    lengths = np.clip(s.size - np.arange(nb) * SMALL_BLOCK, 0, SMALL_BLOCK)
    return blocks.reshape(nb, SMALL_BLOCK), lengths.astype(np.int32)


def progress_entries():
    """16 entries of (in_bytes, out_bytes, error code), two of them errors."""
    rng = np.random.default_rng(5)
    errors = np.zeros(16, np.int32)
    errors[[6, 11]] = [3, 7]
    return (rng.integers(0, 1 << 24, 16).astype(np.int32),
            rng.integers(0, 1 << 24, 16).astype(np.int32), errors)


def session() -> dict:
    """Every sharded entry point over the default process group, on the CPU
    with one intra-op thread; run on each rank."""
    import torch
    import torch.distributed as dist

    from tpu7z_torch.parallel import distributed, mesh, progress, sharded

    torch.set_num_threads(1)
    group = distributed.global_mesh()
    size, rank = dist.get_world_size(), dist.get_rank()
    out = {}
    for name, (payload, W) in frame_payloads().items():
        out["frame", name] = sharded.shard_compress_lz4_device(
            payload, group, W=W, device="cpu")
    blocks, lengths = match_blocks()
    out["find_matches"] = sharded.sharded_find_matches(
        blocks, lengths, group, device="cpu")
    out["container"] = sharded.shard_compress_lz4(
        match_sample(), group, block_size=SMALL_BLOCK, device="cpu")
    k = 16 // size
    mine = [torch.from_numpy(a[rank * k:(rank + 1) * k]) for a in progress_entries()]
    out["progress"] = [int(t) for t in progress.reduce_progress(*mine, group)]
    # the first half of the ranks as a group of its own: its members encode
    # over it, the rest are refused by it
    half = mesh.make_mesh(max(1, size // 2))
    payload, W = frame_payloads()["words_W16"]
    try:
        out["half"] = sharded.shard_compress_lz4_device(payload, half, W=W,
                                                        device="cpu")
    except ValueError as exc:
        out["half"] = f"refused: {exc}"
    # a gloo group carries CPU tensors only
    try:
        sharded.shard_compress_lz4_device(b"x", group, device="meta")
    except ValueError as exc:
        out["meta_refused"] = str(exc)
    return out


def fail():
    """A rank's work that raises."""
    raise ValueError("this rank fails on purpose")


def hang(seconds: float):
    """A rank's work that outlasts its deadline."""
    import time
    time.sleep(seconds)
