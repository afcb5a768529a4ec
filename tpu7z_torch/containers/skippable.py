"""Skippable-frame container: each compressed frame is preceded by a
12-byte skippable frame (magic 0x184D2A50, size 4) that carries the
frame's length, so a decoder finds the frame boundaries without parsing
them. LZ4 and zstd decoders skip such frames, so the container is also a
plain stream of frames."""

from __future__ import annotations

from ..models.lz4.block import CorruptError

MAGIC = 0x184D2A50


def write_container(frames: list[bytes]) -> bytes:
    out = bytearray()
    for f in frames:
        out += MAGIC.to_bytes(4, "little")
        out += (4).to_bytes(4, "little")
        out += len(f).to_bytes(4, "little")
        out += f
    return bytes(out)


def parse_container(data: bytes):
    """Return [(offset, size)] of payload frames; a bare stream (no
    skippable headers) gives one entry spanning all of it."""
    spans = []
    pos = 0
    n = len(data)
    while pos + 12 <= n:
        magic = int.from_bytes(data[pos:pos + 4], "little")
        size = int.from_bytes(data[pos + 4:pos + 8], "little")
        if magic != MAGIC or size != 4:
            break
        flen = int.from_bytes(data[pos + 8:pos + 12], "little")
        if pos + 12 + flen > n:
            raise CorruptError("skippable container: frame overruns input")
        spans.append((pos + 12, flen))
        pos += 12 + flen
    if not spans or pos != n:
        return [(0, n)]
    return spans
