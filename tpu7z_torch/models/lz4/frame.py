"""The .lz4 frames the port writes, and their decoder.

Layout (LZ4 Frame format): magic 0x184D2204 (u32le); FLG 0x60 (version
01, independent blocks, no checksums, no content size); BD 0x40 (64 KiB
blocks); HC = (xxh32(FLG BD) >> 8) & 0xFF; then blocks, each a u32le size
(bit 31 set: stored uncompressed) and its bytes; then a zero u32 EndMark.
"""

from __future__ import annotations

from ...ops.hashing import xxh32
from . import block as lz4block
from .block import CorruptError

MAGIC = 0x184D2204
BLOCK_SIZE = 1 << 16
DESCRIPTOR = bytes([0x60, 0x40])
HEADER = (MAGIC.to_bytes(4, "little") + DESCRIPTOR
          + bytes([(xxh32(DESCRIPTOR) >> 8) & 0xFF]))


def iter_blocks(src: bytes):
    """Yield (stored, payload) for each block of one frame in `src`;
    raises CorruptError on a header or layout this port does not write."""
    if src[:len(HEADER)] != HEADER:
        raise CorruptError("lz4 frame: not a frame of this writer")
    pos = len(HEADER)
    while True:
        if pos + 4 > len(src):
            raise CorruptError("lz4 frame: truncated block header")
        word = int.from_bytes(src[pos:pos + 4], "little")
        pos += 4
        if word == 0:
            break
        size = word & 0x7FFFFFFF
        if size > BLOCK_SIZE or pos + size > len(src):
            raise CorruptError("lz4 frame: bad block size")
        yield bool(word & 0x80000000), src[pos:pos + size]
        pos += size
    if pos != len(src):
        raise CorruptError("lz4 frame: bytes after the EndMark")


def decode_block(stored: bool, payload: bytes) -> bytes:
    if stored:
        return bytes(payload)
    return lz4block.decompress_block(payload, cap_hint=BLOCK_SIZE)


def decompress(src: bytes) -> bytes:
    """Decode one frame written by `parallel.sharded`."""
    return b"".join(decode_block(s, p) for s, p in iter_blocks(src))
