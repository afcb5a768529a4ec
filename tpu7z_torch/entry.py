"""Entry point of the port: one step of the device match finder.

The counterpart of `__graft_entry__.entry`: `entry()` returns `(fn, args)`,
where `fn(*args)` runs `ops.match.find_matches` over the same sample (four
16 KiB blocks of words) and returns (selected, mlen, moff). The tensors
lie on the CUDA card unless `device` names another.
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
