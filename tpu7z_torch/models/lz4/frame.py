"""The .lz4 frames the port writes, and their decoder.

Layout (LZ4 Frame format): magic 0x184D2204 (u32le); FLG (version 01 in
bits 7-6, independent blocks in bit 5, block checksums in bit 4, content
size in bit 3, content checksum in bit 2, dictionary ID in bit 0); BD
(block size code in bits 6-4: 4 = 64 KiB, 5 = 256 KiB, 6 = 1 MiB, 7 = 4
MiB); the content size u64le if flagged; HC = (xxh32(FLG .. content
size) >> 8) & 0xFF; then blocks, each a u32le size (bit 31 set: stored
uncompressed), its bytes and, if flagged, their xxh32 u32le; a zero u32
EndMark; the content checksum xxh32(content) u32le if flagged. Where
bit 5 is clear, the blocks are linked: a block's matches may reach into
the last 64 KiB of the content before it.

The device paths write two descriptors: FLG 0x60 BD 0x40 (`HEADER`, the
device encoder's frame: no checksums, no content size) and FLG 0x6C
(independent blocks, content size and content checksum) from the device
match finder; `compress_frame` writes tpu7z's frames with any of their
options: by the host library at accel 1, by the tensor parse otherwise.
Skippable frames (magic 0x184D2A50..5F, a u32le size and that many bytes)
carry the skippable container's sizes; the decoder skips them. The
decoder takes every frame tpu7z's takes: reserved bits are ignored, and
a dictionary ID is refused, as there.
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
FLG_BLOCK_CHECKSUM = 1 << 4
FLG_CONTENT_SIZE = 1 << 3
FLG_CONTENT_CHECKSUM = 1 << 2
FLG_DICT_ID = 1
WINDOW = 1 << 16  # how far back a linked block's matches may reach

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


def _frame(src: bytes, pos: int, verify_checksums: bool):
    """Parse the frame whose magic is at `pos`, verifying its header and
    block checksums if asked. Returns (flags, block size, content size or
    None, [(stored, payload)], content checksum or None, end)."""
    pos += 4
    if pos + 3 > len(src):
        raise CorruptError("lz4 frame: truncated descriptor")
    flg, bd = src[pos], src[pos + 1]
    if flg >> 6 != 1:
        raise CorruptError(f"lz4 frame: unsupported version {flg >> 6}")
    code = (bd >> 4) & 7
    if code not in _BD_SIZES:
        raise CorruptError(f"lz4 frame: bad block size code {code}")
    if flg & FLG_DICT_ID:
        raise CorruptError("lz4 frame: dictionaries not supported")
    bsize = _BD_SIZES[code]
    dlen = 2 + (8 if flg & FLG_CONTENT_SIZE else 0)
    desc = src[pos:pos + dlen]
    pos += dlen
    if pos >= len(src):
        raise CorruptError("lz4 frame: truncated header checksum")
    if verify_checksums and (xxh32(desc) >> 8) & 0xFF != src[pos]:
        raise CorruptError("lz4 frame: header checksum mismatch")
    pos += 1
    blocks = []
    while True:
        word = _u32(src, pos, "block header")
        pos += 4
        if word == 0:
            break
        n = word & 0x7FFFFFFF
        if pos + n > len(src):
            raise CorruptError("lz4 frame: truncated block")
        payload = src[pos:pos + n]
        pos += n
        if flg & FLG_BLOCK_CHECKSUM:
            checksum = _u32(src, pos, "block checksum")
            pos += 4
            if verify_checksums and xxh32_native(payload) != checksum:
                raise CorruptError("lz4 frame: block checksum mismatch")
        blocks.append((bool(word & 0x80000000), payload))
    checksum = None
    if flg & FLG_CONTENT_CHECKSUM:
        checksum = _u32(src, pos, "content checksum")
        pos += 4
    size = int.from_bytes(desc[2:], "little") if flg & FLG_CONTENT_SIZE else None
    return flg, bsize, size, blocks, checksum, pos


def _frames(src: bytes, verify_checksums: bool = True):
    """Yield (flags, block size, content size or None, blocks, content
    checksum or None) of each .lz4 frame in `src`, skipping skippable
    frames; bytes that are no frame raise CorruptError. As in tpu7z, a
    skippable frame whose size runs past the end of `src` ends it."""
    pos = 0
    while pos < len(src):
        magic = _u32(src, pos, "magic")
        if MAGIC_SKIPPABLE_MIN <= magic <= MAGIC_SKIPPABLE_MAX:
            pos += 8 + _u32(src, pos + 4, "skippable frame")
            continue
        if magic != MAGIC:
            raise CorruptError(f"lz4 frame: bad magic {magic:#x}")
        *parsed, pos = _frame(src, pos, verify_checksums)
        yield parsed


def iter_blocks(src: bytes):
    """Yield (stored, payload) for each block of the frames in `src`."""
    for _, _, _, blocks, _ in _frames(src):
        yield from blocks


def _block(bsize: int, stored: bool, payload, window: bytes = b"") -> bytes:
    if stored:
        return bytes(payload)
    return lz4block.decompress_block(payload, cap_hint=bsize, window=window)


def _decode_frame(flg: int, bsize: int, blocks, pmap=map) -> bytes:
    """The content of one frame's blocks: each independent block decodes
    alone into at most `bsize` bytes, through `pmap` (a pool's `map` to
    decode them in parallel); a linked block also sees the last 64 KiB of
    the content before it, so a linked frame decodes in order."""
    if flg & FLG_INDEPENDENT:
        return b"".join(pmap(lambda blk: _block(bsize, *blk), blocks))
    parts, window = [], b""
    for stored, payload in blocks:
        data = _block(bsize, stored, payload, window)
        parts.append(data)
        window = (window + data)[-WINDOW:]
    return b"".join(parts)


def _content(flg, bsize, size, blocks, checksum, verify_checksums, pmap=map) -> bytes:
    data = _decode_frame(flg, bsize, blocks, pmap)
    if verify_checksums and checksum is not None and xxh32_native(data) != checksum:
        raise CorruptError("lz4 frame: content checksum mismatch")
    if size is not None and len(data) != size:
        raise CorruptError("lz4 frame: content size mismatch")
    return data


def decompress(src: bytes, verify_checksums: bool = True) -> bytes:
    """Decode the frames in `src`: independent or linked blocks, with or
    without block checksums, content size and content checksum. The
    checksums (header, block, content) are verified unless
    `verify_checksums` is false; the content size always is."""
    return b"".join(_content(*parsed, verify_checksums)
                    for parsed in _frames(src, verify_checksums))


def compress_frame(data: bytes, block_size: int = 1 << 22,
                   content_checksum: bool = True, content_size: bool = True,
                   block_checksum: bool = False,
                   block_independence: bool = True, accel: int = 1,
                   device=None) -> bytes:
    """One .lz4 frame of `data`, the bytes of tpu7z's `compress_frame`
    (tpu7z/models/lz4/frame.py:43): blocks of `block_size` (4 MiB by
    default), each `compress_block(chunk, accel)`, or, where blocks are
    linked, `compress_block_continuation` behind the last 64 KiB before
    it; a block stored raw where that is not longer. At accel 1 every
    block is the host library's; at another accel, tpu7z's data-parallel
    parse runs on `device` (the card unless it names the CPU)."""
    code = _pick_bd(block_size)
    bsize = min(block_size, _BD_SIZES[code])
    flg = (FLG_VERSION | (FLG_INDEPENDENT if block_independence else 0)
           | (FLG_BLOCK_CHECKSUM if block_checksum else 0)
           | (FLG_CONTENT_SIZE if content_size else 0)
           | (FLG_CONTENT_CHECKSUM if content_checksum else 0))
    desc = bytes([flg, code << 4])
    if content_size:
        desc += len(data).to_bytes(8, "little")
    out = bytearray(MAGIC.to_bytes(4, "little") + desc
                    + bytes([(xxh32(desc) >> 8) & 0xFF]))
    for start in range(0, len(data), bsize):
        chunk = data[start:start + bsize]
        if block_independence or start == 0:
            comp = lz4block.compress_block(chunk, accel=accel, device=device)
        else:
            comp = lz4block.compress_block_continuation(
                chunk, data[max(start - WINDOW, 0):start], device=device)
        record = block_record(chunk, comp)
        out += record
        if block_checksum:
            out += xxh32_native(record[4:]).to_bytes(4, "little")
    out += (0).to_bytes(4, "little")  # EndMark
    if content_checksum:
        out += xxh32_native(data).to_bytes(4, "little")
    return bytes(out)
