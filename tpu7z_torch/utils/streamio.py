"""Bounded-memory stream extraction.

A copy of tpu7z/utils/streamio.py, on the host: the same bytes, lines and
errors from the same input. Its blocks and frames decode through the
port's host libraries (csrc/lz4_host.cpp, csrc/zstd_dec.cpp), gzip, bzip2
and xz through the standard library, as in tpu7z. One repair: tpu7z's
.lz4 walk skips the header, block and content checksums and the content
size, so a corrupt frame streams out as other bytes without a word; the
port checks each of them as its frame decoder does, with its messages
(ROADMAP.md section 3).

Role analog of the reference's InBuffer/OutBuffer + LimitedSequential
streams (CPP/7zip/Common/InBuffer.h, StreamUtils.cpp): single-stream
formats decode INCREMENTALLY — input is memory-mapped, output is
written unit by unit (lz4 block / zstd frame / gzip member / bzip2
stream / LZMA2 chunk group), so peak RSS is bounded by the largest
unit plus the codec window, not the archive size.

Units per format:
  lz4   — frame blocks (64 KB..4 MB each); block-dependent frames keep
          a window of the last 64 KB only
  zstd  — frames (the zstdmt skippable-frame container makes these
          small); a single giant frame falls back to whole-buffer
  gzip  — members, decoded with a zlib streaming object (true chunking)
  bzip2 — streams, via bz2.BZ2Decompressor chunks
  xz    — stdlib LZMADecompressor chunks
"""

from __future__ import annotations

import mmap
import struct

from .errors import CorruptError


def open_mapped(path: str):
    """Read-only memory map (bounded input RSS; pages fault in/out)."""
    f = open(path, "rb")
    if f.seek(0, 2) == 0:
        f.seek(0)
        return f, b""
    f.seek(0)
    return f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)


def _u32(src, pos: int, what: str) -> int:
    if pos + 4 > len(src):
        raise CorruptError(f"lz4 frame: truncated {what}")
    return struct.unpack_from("<I", src, pos)[0]


def extract_lz4_stream(src, out, progress=None) -> int:
    """Decode a .lz4 frame sequence from `src` (buffer/mmap) into the
    file object `out`, block at a time, each frame's checksums and content
    size verified. Returns bytes written."""
    from ..models.lz4 import block as blockmod
    from ..ops.hashing import XXH32Stream, xxh32, xxh32_native

    def decode_block(blk: bytes, cap: int) -> bytes:
        # the host library within the frame's block maximum; where it
        # refuses, the plain decoder decides, as tpu7z's decodes every
        # block: its error, or the bytes of a block over that maximum
        try:
            return blockmod.decompress_block(blk, cap_hint=cap)
        except CorruptError:
            return blockmod.decompress_block_ref(blk)

    pos = 0
    total = 0
    n = len(src)
    while pos + 4 <= n:
        fstart = pos
        magic, = struct.unpack_from("<I", src, pos)
        if (magic & 0xFFFFFFF0) == 0x184D2A50:  # skippable frame
            if pos + 8 > n:
                raise CorruptError("lz4: truncated skippable frame")
            sz, = struct.unpack_from("<I", src, pos + 4)
            pos += 8 + sz
            continue
        if magic != 0x184D2204:
            raise CorruptError("lz4: bad frame magic")
        pos += 4
        if pos + 2 > n:
            raise CorruptError("lz4: truncated frame descriptor")
        flg = src[pos]
        indep = bool(flg & 0x20)   # block-independence flag
        has_csize = bool(flg & 0x08)
        has_bsum = bool(flg & 0x10)
        has_csum = bool(flg & 0x04)
        block_max = 1 << (8 + 2 * ((src[pos + 1] >> 4) & 7))
        desc = bytes(src[pos:pos + 2 + (8 if has_csize else 0)])
        pos += 2 + (8 if has_csize else 0)
        if pos < n and (xxh32(desc) >> 8) & 0xFF != src[pos]:
            raise CorruptError("lz4 frame: header checksum mismatch")
        pos += 1
        content = XXH32Stream() if has_csum else None
        size = 0
        if not indep:
            # block-dependent frame: decode it whole (bounded by one
            # frame; our own frames and 7zz's MT frames are independent)
            from ..models.lz4 import frame as lz4frame
            dec = lz4frame.decompress(bytes(src[fstart:]))
            out.write(dec)
            total += len(dec)
            if progress is not None:
                progress.add(len(dec))
            return total
        while True:
            if pos + 4 > n:
                raise CorruptError("lz4: truncated block size")
            bsz, = struct.unpack_from("<I", src, pos)
            pos += 4
            if bsz == 0:
                break
            raw = bool(bsz & 0x80000000)
            bsz &= 0x7FFFFFFF
            blk = bytes(src[pos:pos + bsz])
            if len(blk) != bsz:
                raise CorruptError("lz4: truncated block")
            pos += bsz
            if has_bsum:
                if xxh32_native(blk) != _u32(src, pos, "block checksum"):
                    raise CorruptError("lz4 frame: block checksum mismatch")
                pos += 4
            dec = blk if raw else decode_block(blk, block_max)
            if content is not None:
                content.update(dec)
            size += len(dec)
            out.write(dec)
            total += len(dec)
            if progress is not None:
                progress.add(len(dec))
        if has_csum:
            if content.digest() != _u32(src, pos, "content checksum"):
                raise CorruptError("lz4 frame: content checksum mismatch")
            pos += 4
        if has_csize and size != int.from_bytes(desc[2:], "little"):
            raise CorruptError("lz4 frame: content size mismatch")
    return total


def _zstd_frame_size(src, pos: int) -> int:
    """Compressed size of the zstd frame at `pos` (header-only walk of
    the block chain, RFC 8878 frame layout)."""
    start = pos
    n = len(src)
    if pos + 5 > n:
        raise CorruptError("zstd: truncated frame header")
    fhd = src[pos + 4]
    p = pos + 5
    single_segment = bool(fhd & 0x20)
    if not single_segment:
        p += 1  # window descriptor
    p += (0, 1, 2, 4)[fhd & 3]  # dictionary id
    fcs = fhd >> 6
    p += (1 if single_segment else 0, 2, 4, 8)[fcs]
    while True:
        if p + 3 > n:
            raise CorruptError("zstd: truncated block header")
        bh = src[p] | (src[p + 1] << 8) | (src[p + 2] << 16)
        p += 3
        btype = (bh >> 1) & 3
        bsize = bh >> 3
        p += 1 if btype == 1 else bsize
        if bh & 1:
            break
    if fhd & 0x04:
        p += 4  # content checksum
    if p > n:
        raise CorruptError("zstd: truncated frame")
    return p - start


def extract_zstd_stream(src, out, progress=None) -> int:
    """Decode a zstd frame sequence frame-at-a-time via the native
    decoder (skippable frames skipped), bounding memory to the largest
    single frame."""
    from ..models.zstd.native import zstd_decode

    pos = 0
    total = 0
    n = len(src)
    while pos + 4 <= n:
        magic, = struct.unpack_from("<I", src, pos)
        if 0x184D2A50 <= magic <= 0x184D2A5F:
            if pos + 8 > n:
                raise CorruptError("zstd: truncated skippable frame")
            sz, = struct.unpack_from("<I", src, pos + 4)
            pos += 8 + sz
            continue
        if magic != 0xFD2FB528:
            raise CorruptError("zstd: bad frame magic")
        end = _zstd_frame_size(src, pos)
        dec = zstd_decode(bytes(src[pos:pos + end]))
        if dec is None:
            raise CorruptError("zstd: frame decode failed")
        out.write(dec)
        total += len(dec)
        if progress is not None:
            progress.add(len(dec))
        pos += end
    return total


def extract_zlib_family(src, out, kind: str, progress=None) -> int:
    """gzip/bzip2/xz through stdlib streaming decompressors, 1 MiB
    input chunks — true bounded-memory decode."""
    import bz2
    import lzma
    import zlib

    total = 0
    pos = 0
    n = len(src)
    while pos < n:
        if kind == "gzip":
            d = zlib.decompressobj(wbits=31)
        elif kind == "bzip2":
            d = bz2.BZ2Decompressor()
        else:
            d = lzma.LZMADecompressor(format=lzma.FORMAT_XZ)
        while pos < n:
            chunk = bytes(src[pos:pos + (1 << 20)])
            try:
                dec = d.decompress(chunk)
            except Exception as e:
                raise CorruptError(f"{kind}: {e}")
            out.write(dec)
            total += len(dec)
            if progress is not None:
                progress.add(len(dec))
            if getattr(d, "eof", False):
                used = len(chunk) - len(d.unused_data)
                pos += used
                break
            pos += len(chunk)
        else:
            break
        if getattr(d, "eof", False) and not d.unused_data and pos >= n:
            break
    return total


STREAMABLE = {"lz4", "zstd", "gzip", "bzip2", "xz"}


def stream_extract(path: str, atype: str, out, progress=None) -> int:
    """Dispatch: extract `path` (format `atype`) into file object `out`
    with bounded memory. Raises KeyError for non-streamable types."""
    f, m = open_mapped(path)
    try:
        if atype == "lz4":
            return extract_lz4_stream(m, out, progress)
        if atype == "zstd":
            return extract_zstd_stream(m, out, progress)
        if atype in ("gzip", "bzip2", "xz"):
            return extract_zlib_family(m, out, atype, progress)
        raise KeyError(atype)
    finally:
        if m != b"":
            m.close()
        f.close()
