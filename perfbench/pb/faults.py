"""Faults planted in the program for the tests that must see `correct`
come out false: each replaces one function of the program's timed path
in the process it is planted in (every rank plants it)."""

from __future__ import annotations

import torch


def _stored():
    """The encoder returns its input unchanged: every block stored raw."""
    from tpu7z_torch.ops import lz4_cuda

    real = lz4_cuda.encode_blocks

    def encode_blocks(blocks, ns, W=0, tier_b=True):
        out, used = real(blocks, ns, W, tier_b)
        return out, torch.full_like(used, blocks.shape[1] + 1)

    lz4_cuda.encode_blocks = encode_blocks


def _half_batch():
    """Half of the blocks left out of the frame."""
    from tpu7z_torch.parallel import sharded

    real = sharded.split_blocks

    def split_blocks(data, device, first=0, count=None):
        blocks, ns = real(data, device, first, count)
        keep = max(1, blocks.shape[0] // 2)
        return blocks[:keep].contiguous(), ns[:keep].contiguous()

    sharded.split_blocks = split_blocks


def _no_exchange():
    """The all-gather between ranks left out: each rank assembles its
    own blocks alone."""
    from tpu7z_torch.parallel import sharded

    sharded._all_gather = lambda t, group: t


def _altered_lz4():
    """One byte of the frame altered where it is produced."""
    from tpu7z_torch.parallel import sharded

    real = sharded.assemble

    def assemble(out, used, blocks, ns):
        frame = real(out, used, blocks, ns)
        frame[frame.numel() // 2] ^= 0x5A
        return frame

    sharded.assemble = assemble


def _altered_deflate():
    """One byte of the DEFLATE stream altered where it is produced."""
    from tpu7z_torch.models.deflate import codec

    real = codec.compress

    def compress(data, level=6, block_size=codec.BLOCK, device=None):
        body = bytearray(real(data, level, block_size, device))
        body[len(body) // 2] ^= 0x5A
        return bytes(body)

    codec.compress = compress


FAULTS = {"stored": _stored, "half_batch": _half_batch, "no_exchange": _no_exchange,
          "altered_lz4": _altered_lz4, "altered_deflate": _altered_deflate}


def plant(name: str):
    FAULTS[name]()
