"""The .lz4 frames the port writes, and their decoder.

Layout (LZ4 Frame format): magic 0x184D2204 (u32le); FLG (version 01 in
bits 7-6, independent blocks in bit 5, content size in bit 3, content
checksum in bit 2); BD (block size code in bits 6-4: 4 = 64 KiB, 5 = 256
KiB, 6 = 1 MiB, 7 = 4 MiB); the content size u64le if flagged; HC =
(xxh32(FLG .. content size) >> 8) & 0xFF; then blocks, each a u32le size
(bit 31 set: stored uncompressed) and its bytes; a zero u32 EndMark; the
content checksum xxh32(content) u32le if flagged.

The port writes two descriptors: FLG 0x60 BD 0x40 (`HEADER`, the device
encoder's frame: no checksums, no content size) and FLG 0x6C (independent
blocks, content size and content checksum) from the device match finder.
Skippable frames (magic 0x184D2A50..5F, a u32le size and that many bytes)
carry the skippable container's sizes; the decoder skips them.
"""

from __future__ import annotations

from ...ops.hashing import xxh32, xxh32_native
from . import block as lz4block
from .block import CorruptError

MAGIC = 0x184D2204
MAGIC_SKIPPABLE_MIN = 0x184D2A50
MAGIC_SKIPPABLE_MAX = 0x184D2A5F
DESCRIPTOR = bytes([0x60, 0x40])
HEADER = (MAGIC.to_bytes(4, "little") + DESCRIPTOR
          + bytes([(xxh32(DESCRIPTOR) >> 8) & 0xFF]))

FLG_VERSION = 0x40
FLG_INDEPENDENT = 1 << 5
FLG_CONTENT_SIZE = 1 << 3
FLG_CONTENT_CHECKSUM = 1 << 2
_FLG_KNOWN = 0xC0 | FLG_INDEPENDENT | FLG_CONTENT_SIZE | FLG_CONTENT_CHECKSUM

_BD_SIZES = {4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}


def _pick_bd(block_size: int) -> int:
    for code in (4, 5, 6, 7):
        if block_size <= _BD_SIZES[code]:
            return code
    return 7


def frame_header(content_size: int, block_size: int) -> bytes:
    """Magic and descriptor of a frame with independent blocks, its
    content size and a content checksum (FLG 0x6C)."""
    desc = bytes([FLG_VERSION | FLG_INDEPENDENT | FLG_CONTENT_SIZE
                  | FLG_CONTENT_CHECKSUM, _pick_bd(block_size) << 4])
    desc += content_size.to_bytes(8, "little")
    return (MAGIC.to_bytes(4, "little") + desc
            + bytes([(xxh32(desc) >> 8) & 0xFF]))


def block_record(raw: bytes, comp: bytes) -> bytes:
    """One block of a frame: its size word and its LZ4 bytes, or its raw
    bytes (bit 31 of the size word set) where those are not shorter."""
    if len(comp) >= len(raw):
        return (len(raw) | 0x80000000).to_bytes(4, "little") + raw
    return len(comp).to_bytes(4, "little") + comp


def _u32(src: bytes, pos: int, what: str) -> int:
    if pos + 4 > len(src):
        raise CorruptError(f"lz4 frame: truncated {what}")
    return int.from_bytes(src[pos:pos + 4], "little")


def _frame(src: bytes, pos: int):
    """Parse the frame whose magic is at `pos`. Returns (content size or
    None, block size, [(stored, payload)], content checksum or None, end)."""
    pos += 4
    if pos + 2 > len(src):
        raise CorruptError("lz4 frame: truncated descriptor")
    flg, bd = src[pos], src[pos + 1]
    if flg & 0xC0 != FLG_VERSION or flg & ~_FLG_KNOWN or bd & 0x8F:
        raise CorruptError(f"lz4 frame: unsupported descriptor {flg:#x} {bd:#x}")
    if not flg & FLG_INDEPENDENT:
        raise CorruptError("lz4 frame: linked blocks are not supported")
    if (bd >> 4) not in _BD_SIZES:
        raise CorruptError(f"lz4 frame: bad block size code {bd >> 4}")
    bsize = _BD_SIZES[bd >> 4]
    dlen = 2 + (8 if flg & FLG_CONTENT_SIZE else 0)
    if pos + dlen + 1 > len(src):
        raise CorruptError("lz4 frame: truncated descriptor")
    desc = src[pos:pos + dlen]
    if (xxh32(desc) >> 8) & 0xFF != src[pos + dlen]:
        raise CorruptError("lz4 frame: header checksum mismatch")
    size = int.from_bytes(desc[2:], "little") if flg & FLG_CONTENT_SIZE else None
    pos += dlen + 1
    blocks = []
    while True:
        word = _u32(src, pos, "block header")
        pos += 4
        if word == 0:
            break
        n = word & 0x7FFFFFFF
        if n > bsize or pos + n > len(src):
            raise CorruptError("lz4 frame: bad block size")
        blocks.append((bool(word & 0x80000000), src[pos:pos + n]))
        pos += n
    checksum = None
    if flg & FLG_CONTENT_CHECKSUM:
        checksum = _u32(src, pos, "content checksum")
        pos += 4
    return size, bsize, blocks, checksum, pos


def _frames(src: bytes):
    """Yield (content size, block size, blocks, checksum) of each .lz4
    frame in `src`, skipping skippable frames; bytes that are no frame
    raise CorruptError."""
    pos = 0
    while pos < len(src):
        magic = _u32(src, pos, "magic")
        if MAGIC_SKIPPABLE_MIN <= magic <= MAGIC_SKIPPABLE_MAX:
            end = pos + 8 + _u32(src, pos + 4, "skippable frame")
            if end > len(src):
                raise CorruptError("lz4 frame: truncated skippable frame")
            pos = end
            continue
        if magic != MAGIC:
            raise CorruptError(f"lz4 frame: bad magic {magic:#x}")
        size, bsize, blocks, checksum, pos = _frame(src, pos)
        yield size, bsize, blocks, checksum


def iter_blocks(src: bytes):
    """Yield (stored, payload) for each block of the frames in `src`."""
    for _, _, blocks, _ in _frames(src):
        yield from blocks


def decode_block(stored: bool, payload: bytes, bsize: int) -> bytes:
    if stored:
        return bytes(payload)
    return lz4block.decompress_block(payload, cap_hint=bsize)


def decompress(src: bytes) -> bytes:
    """Decode the frames in `src` (the port's, or any with independent
    blocks), verifying each content checksum and content size."""
    parts = []
    for size, bsize, blocks, checksum in _frames(src):
        data = b"".join(decode_block(s, p, bsize) for s, p in blocks)
        if checksum is not None and xxh32_native(data) != checksum:
            raise CorruptError("lz4 frame: content checksum mismatch")
        if size is not None and len(data) != size:
            raise CorruptError("lz4 frame: content size mismatch")
        parts.append(data)
    return b"".join(parts)
