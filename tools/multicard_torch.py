#!/usr/bin/env python3
"""The port's sharded device encoder at one rank a card, over the cards of
one host.

    python3 tools/multicard_torch.py

For each world size n of 1, 2, 4, ... up to the cards present, spawns n
NCCL ranks (tpu7z_torch.parallel.distributed.run_ranks, one card each).
Every rank makes the 32 MiB corpus, encodes its span of 64 KiB blocks
with `shard_compress_lz4_device(corpus, global_mesh(), W=0)` and returns
a digest of its frame with its times: the whole call on the host clock
between two barriers (median of 5 after a warm-up), and its span through
`encode_blocks` alone (CUDA events, median of 5). Every rank's frame must
equal the frame of one process alone, made here on card 0, which must
decode; then `dryrun_multichip` runs at every card. The cards' names and
power limits are printed beside the times; the last line is one JSON
object of the results. Imports nothing of JAX or tpu7z.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CORPUS_BYTES = 32 << 20


def encode_rank(device: str, size: int, reps: int = 5) -> dict:
    """One rank's work over the default process group: the frame's digest
    and this rank's times."""
    import torch.distributed as dist

    from tpu7z_torch.ops import lz4_cuda
    from tpu7z_torch.parallel import distributed, sharded
    from tpu7z_torch.utils.corpus import make_corpus
    from chip_smoke import timed

    corpus = make_corpus(size)
    group = distributed.global_mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    frame = sharded.shard_compress_lz4_device(corpus, group, device=device)
    calls = []
    for _ in range(reps):
        sync()
        dist.barrier()
        t = time.perf_counter()
        frame = sharded.shard_compress_lz4_device(corpus, group, device=device)
        dist.barrier()
        calls.append(time.perf_counter() - t)
    nb = max(1, -(-len(corpus) // lz4_cuda.BLOCK))
    k = -(-nb // world)
    blocks, ns = sharded.split_blocks(corpus, device, rank * k, k)
    span_ms = (timed(lambda: lz4_cuda.encode_blocks(blocks, ns, 0))
               if device == "cuda" else None)
    return {"rank": rank, "sha256": hashlib.sha256(frame).hexdigest(),
            "bytes": len(frame), "call_s": statistics.median(calls),
            "call_s_all": calls, "span_blocks": k, "span_encode_ms": span_ms,
            "card": torch.cuda.get_device_name() if device == "cuda" else "cpu"}


def main() -> int:
    if not torch.cuda.is_available():
        print("multicard_torch: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from tpu7z_torch.entry import dryrun_multichip
    from tpu7z_torch.models.lz4 import frame as lz4frame
    from tpu7z_torch.ops import _build
    from tpu7z_torch.parallel import distributed, sharded
    from tpu7z_torch.utils.corpus import make_corpus

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    cards = torch.cuda.device_count()
    _build.build()
    corpus = make_corpus(CORPUS_BYTES)
    t = time.perf_counter()
    one = sharded.shard_compress_lz4_device(corpus)
    one_s = time.perf_counter() - t
    if lz4frame.decompress(one) != corpus:
        raise AssertionError("the one-process frame does not decode")
    want = hashlib.sha256(one).hexdigest()
    print(f"one process on card 0: {len(one)} bytes, first call {one_s:.3f} s, decoded",
          flush=True)
    results = {}
    n = 1
    while n <= cards:
        ranks = distributed.run_ranks(encode_rank, n, "cuda", CORPUS_BYTES,
                                      device="cuda", timeout_s=900)
        for r in ranks:
            if r["sha256"] != want:
                raise AssertionError(f"world {n}, rank {r['rank']}: frame differs from "
                                     f"one process's")
        results[n] = ranks
        print(f"world {n}: every rank's frame equals one process's; call "
              f"{[round(r['call_s'], 4) for r in ranks]} s (host clock, median of 5), "
              f"span of {ranks[0]['span_blocks']} blocks through encode_blocks "
              f"{[round(r['span_encode_ms'], 3) for r in ranks]} ms", flush=True)
        n *= 2
    t = time.perf_counter()
    dryrun_multichip(cards)
    print(f"dryrun_multichip({cards}): passed in {time.perf_counter() - t:.1f} s",
          flush=True)
    print(json.dumps({"cards": cards, "smi": smi.splitlines(), "frame_bytes": len(one),
                      "worlds": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
