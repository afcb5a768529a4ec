"""Span-parallel decode: the MtDec analog, on the host
(tpu7z/parallel/decode.py).

A cheap header walk finds spans that decode independently, a thread pool
decodes them (every native decoder call releases the GIL inside ctypes),
and an indexed join assembles the output in order, so the bytes equal the
serial path's.

Independent spans:
  zstd:  whole frames (skippable ones included), found by walking block
         headers without decoding (Block_Header carries Block_Size;
         RFC 8878 3.1.1.2.2);
  lz4:   the blocks of a block-independent frame (each size-prefixed);
         a linked-block frame decodes serially;
  lzma2: chunk groups that begin with a dictionary reset (the
         C/Lzma2DecMt.c model), found by walking chunk headers.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

from ..models.lz4 import frame as lframe
from ..models.lzma import lzma2 as l2
from ..models.zstd import frame as zframe
from ..utils.errors import CorruptError


def _default_workers(n: int | None) -> int:
    if n and n > 0:
        return n
    return min(8, os.cpu_count() or 1)


# --------------------------------------------------------------- zstd ---

_ZSTD_MAGIC = 0xFD2FB528
_SKIP_MIN, _SKIP_MAX = 0x184D2A50, 0x184D2A5F


def scan_zstd_frames(src: bytes) -> list[tuple[int, int]]:
    """Frame spans [(offset, size)] via header walk, no payload decode."""
    spans = []
    pos = 0
    n = len(src)
    while pos < n:
        if n - pos < 4:
            raise CorruptError("zstd: trailing garbage")
        magic = int.from_bytes(src[pos:pos + 4], "little")
        start = pos
        if _SKIP_MIN <= magic <= _SKIP_MAX:
            if n - pos < 8:
                raise CorruptError("zstd: truncated skippable frame")
            size = int.from_bytes(src[pos + 4:pos + 8], "little")
            pos += 8 + size
        elif magic == _ZSTD_MAGIC:
            pos += 4
            if pos >= n:
                raise CorruptError("zstd: truncated frame header")
            fhd = src[pos]
            pos += 1
            fcs_flag = fhd >> 6
            single = (fhd >> 5) & 1
            cksum = (fhd >> 2) & 1
            did = fhd & 3
            if not single:
                pos += 1  # window descriptor
            pos += (0, 1, 2, 4)[did]
            pos += (1 if single else 0, 2, 4, 8)[fcs_flag] \
                if (fcs_flag or single) else 0
            while True:
                if n - pos < 3:
                    raise CorruptError("zstd: truncated block header")
                bh = int.from_bytes(src[pos:pos + 3], "little")
                pos += 3
                last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
                if btype == 3:
                    raise CorruptError("zstd: reserved block type")
                pos += 1 if btype == 1 else bsize
                if last:
                    break
            if cksum:
                pos += 4
        else:
            raise CorruptError(f"zstd: bad magic {magic:#x}")
        if pos > n:
            raise CorruptError("zstd: frame overruns input")
        spans.append((start, pos - start))
    return spans


def decompress_zstd(src: bytes, threads: int | None = None,
                    verify_checksum: bool = True) -> bytes:
    """Frame-parallel zstd decode; bytes identical to the serial path."""
    spans = scan_zstd_frames(src)
    if len(spans) <= 1:
        return zframe.decompress(src, verify_checksum)
    workers = min(_default_workers(threads), len(spans))

    def one(span):
        off, size = span
        return zframe.decompress(src[off:off + size], verify_checksum)

    if workers <= 1:
        return b"".join(one(s) for s in spans)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return b"".join(pool.map(one, spans))


# ---------------------------------------------------------------- lz4 ---

def decompress_lz4(src: bytes, threads: int | None = None,
                   verify_checksums: bool = True) -> bytes:
    """`frame.decompress` with the blocks of each block-independent frame
    decoded in a thread pool: the same frame walk and the same checks
    (header, block and content checksums, content size); a linked-block
    frame decodes in order."""
    workers = _default_workers(threads)
    frames = lframe._frames(src, verify_checksums)
    if workers <= 1:
        return b"".join(lframe._content(*f, verify_checksums) for f in frames)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return b"".join(lframe._content(*f, verify_checksums, pool.map) for f in frames)


# -------------------------------------------------------------- lzma2 ---

def scan_lzma2_groups(src: bytes) -> list[tuple[int, int]]:
    """Spans of chunk groups separated by dictionary resets.  Each group
    decodes independently (its first chunk resets the dictionary)."""
    groups = []
    pos = 0
    n = len(src)
    start = None
    while pos < n:
        ctrl = src[pos]
        if ctrl == 0:
            pos += 1
            break
        if ctrl < 0x80:
            if ctrl > 2:
                raise CorruptError(f"lzma2: bad control byte {ctrl:#x}")
            if n - pos < 3:
                raise CorruptError("lzma2: truncated chunk header")
            usize = int.from_bytes(src[pos + 1:pos + 3], "big") + 1
            dict_reset = ctrl == 1
            hlen = 3
            clen = usize
        else:
            reset = (ctrl >> 5) & 3
            dict_reset = reset == 3
            if n - pos < 5:
                raise CorruptError("lzma2: truncated chunk header")
            csize = int.from_bytes(src[pos + 3:pos + 5], "big") + 1
            hlen = 5 + (1 if reset >= 2 else 0)
            clen = csize
        if dict_reset and start is not None:
            groups.append((start, pos - start))
            start = pos
        if start is None:
            if not dict_reset:
                raise CorruptError("lzma2: first chunk must reset dict")
            start = pos
        pos += hlen + clen
        if pos > n:
            raise CorruptError("lzma2: chunk overruns input")
    if start is not None:
        groups.append((start, pos - start if pos <= n else n - start))
    return groups


def decompress_lzma2(src: bytes, threads: int | None = None) -> bytes:
    """Group-parallel LZMA2 decode (dict-reset boundaries = spans, the
    C/Lzma2DecMt.c parallel model); serial result bytes guaranteed."""
    groups = scan_lzma2_groups(src)
    if len(groups) <= 1:
        return l2.decompress(src)
    workers = min(_default_workers(threads), len(groups))

    def one(span):
        off, size = span
        # a group plus a synthesized end-of-stream control decodes alone
        return l2.decompress(src[off:off + size] + b"\x00")

    if workers <= 1:
        return b"".join(one(g) for g in groups)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return b"".join(pool.map(one, groups))
