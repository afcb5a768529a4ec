"""LZ4 block compression with the device match finder.

The counterpart of tpu7z/models/lz4/jax_backend.py: match finding and the
greedy parse run on the device (`ops.match.find_matches`, whose sort is the
row-sort kernel on the card); the sequences are emitted on the host by the
vectorised numpy emitter of block.py. Blocks are independent, of any
size the frame takes (up to 4 MiB), and `hashlog` runs 0-31.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from ...ops import match
from ...ops.hashing import xxh32_native
from . import block as blockmod
from .frame import _BD_SIZES, _pick_bd, block_record, frame_header


def pad_blocks(data: bytes, block_size: int):
    """Split into fixed-size zero-padded blocks. Returns (blocks (B,
    block_size) uint8, lengths (B,) int32); empty input gives one block of
    length 0."""
    s = np.frombuffer(data, dtype=np.uint8)
    n = s.size
    nblocks = max(1, -(-n // block_size))
    padded = np.zeros(nblocks * block_size, dtype=np.uint8)
    padded[:n] = s
    blocks = padded.reshape(nblocks, block_size)
    lengths = np.full(nblocks, block_size, dtype=np.int32)
    if n % block_size or n == 0:
        lengths[-1] = n - (nblocks - 1) * block_size
    return blocks, lengths


def emit_block(s: np.ndarray, sel, mlen, moff) -> bytes:
    """The raw LZ4 block of bytes `s` from the match finder's rows for it
    (numpy, at least len(s) long): the selected matches, merged where one
    continues the next, then serialised."""
    n = s.size
    mp = np.nonzero(sel[:n])[0].astype(np.int64)
    ml = mlen[mp].astype(np.int64)
    mo = moff[mp].astype(np.int64)
    mp, ml, mo = blockmod.merge_adjacent_matches(mp, ml, mo)
    return blockmod._emit_sequences(s, mp, ml, mo)


def find_matches_host(blocks: np.ndarray, lengths: np.ndarray,
                      hashlog: int = 16, device=None):
    """`match.find_matches` on `device` (the card unless named) for numpy
    inputs; returns (selected, mlen, moff) as numpy arrays."""
    dev = resolve_device(device)
    out = match.find_matches(torch.from_numpy(np.ascontiguousarray(blocks)).to(dev),
                             torch.from_numpy(np.asarray(lengths, np.int32)).to(dev),
                             hashlog=hashlog)
    return tuple(t.cpu().numpy() for t in out)


def compress_blocks_device(blocks: np.ndarray, lengths: np.ndarray,
                           hashlog: int = 16, device=None) -> list[bytes]:
    """Compress a batch of independent blocks. Returns a list of raw LZ4
    blocks."""
    sel, mlen, moff = find_matches_host(blocks, lengths, hashlog, device)
    return [emit_block(blocks[b, :int(lengths[b])], sel[b], mlen[b], moff[b])
            for b in range(blocks.shape[0])]


def compress_frame_device(data: bytes, block_size: int = 1 << 16,
                          device=None) -> bytes:
    """One .lz4 frame (independent blocks, content size and checksum) with
    device match finding. Runs on the CUDA card unless `device` names
    another."""
    dev = resolve_device(device)
    bsize = min(block_size, _BD_SIZES[_pick_bd(block_size)])
    blocks, lengths = pad_blocks(data, bsize)
    comps = compress_blocks_device(blocks, lengths, device=dev) if data else []
    out = bytearray(frame_header(len(data), block_size))
    for b, comp in enumerate(comps):
        out += block_record(blocks[b, :int(lengths[b])].tobytes(), comp)
    out += (0).to_bytes(4, "little")
    out += xxh32_native(data).to_bytes(4, "little")
    return bytes(out)
