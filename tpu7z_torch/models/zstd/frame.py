"""Zstd frames: the header read and written, the block loop of the plain
decoder, and the entry points `compress` and `decompress`.

Behavioral reference: RFC 8878 section 3.1 (tpu7z/models/zstd/frame.py,
written from the spec). `decompress` decodes through the host library
(csrc/zstd_dec.cpp) and hands what it refuses to `decompress_frame`, the
plain decoder, which decodes it or raises with the precise error, as
tpu7z does. `compress` dispatches as tpu7z's does (`frame.py:267-298`):
`threads` > 1 runs the zstdmt job model (parallel/zstd_jobs.py); any
further keyword, or `use_native=False`, the tensor encoder
(compressor.py, whose parse runs on the card unless `device` names the
CPU); otherwise the host encoder (csrc/zstd_enc.cpp). Both trace their
calls as `zstd.compress` and `zstd.decompress` spans (utils/trace.py).
"""

from __future__ import annotations

import numpy as np

from ...ops.hashing import xxh64_native
from ...utils import trace as _trace
from ...utils.errors import CorruptError, UnsupportedError
from . import literals as lit_mod
from . import native
from . import sequences as seq_mod

MAGIC = 0xFD2FB528
MAGIC_SKIPPABLE_MIN = 0x184D2A50
MAGIC_SKIPPABLE_MAX = 0x184D2A5F

BLOCK_RAW = 0
BLOCK_RLE = 1
BLOCK_COMPRESSED = 2

MAX_BLOCK_SIZE = 128 * 1024


class FrameHeader:
    __slots__ = ("window_size", "content_size", "dict_id", "checksum",
                 "single_segment", "header_size")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


def parse_frame_header(src: bytes) -> FrameHeader:
    if len(src) < 5:
        raise CorruptError("zstd: truncated frame header")
    magic = int.from_bytes(src[:4], "little")
    if magic != MAGIC:
        raise CorruptError(f"zstd: bad magic {magic:#x}")
    fhd = src[4]
    pos = 5
    fcs_flag = fhd >> 6
    single_segment = bool(fhd & (1 << 5))
    if fhd & (1 << 3):
        raise CorruptError("zstd: reserved frame header bit set")
    checksum = bool(fhd & (1 << 2))
    did_flag = fhd & 3

    window_size = None
    if not single_segment:
        if len(src) < pos + 1:
            raise CorruptError("zstd: truncated window descriptor")
        wd = src[pos]
        pos += 1
        exponent = wd >> 3
        mantissa = wd & 7
        base = 1 << (10 + exponent)
        window_size = base + (base // 8) * mantissa
        if window_size > (1 << 31):
            raise UnsupportedError("zstd: window too large")

    did_bytes = (0, 1, 2, 4)[did_flag]
    dict_id = 0
    if did_bytes:
        if len(src) < pos + did_bytes:
            raise CorruptError("zstd: truncated dictionary id")
        dict_id = int.from_bytes(src[pos:pos + did_bytes], "little")
        pos += did_bytes

    fcs_bytes = (1 if single_segment else 0, 2, 4, 8)[fcs_flag]
    content_size = None
    if fcs_bytes:
        if len(src) < pos + fcs_bytes:
            raise CorruptError("zstd: truncated content size")
        content_size = int.from_bytes(src[pos:pos + fcs_bytes], "little")
        if fcs_bytes == 2:
            content_size += 256
        pos += fcs_bytes
    if single_segment:
        window_size = content_size if content_size is not None else 0
    return FrameHeader(window_size=window_size, content_size=content_size,
                       dict_id=dict_id, checksum=checksum,
                       single_segment=single_segment, header_size=pos)


def write_frame_header(content_size: int | None, checksum: bool = True,
                       single_segment: bool | None = None,
                       window_log: int | None = None) -> bytes:
    """Serialize a frame header. With known content_size and small data we
    use single-segment mode (no window descriptor), like the reference
    encoder does for one-shot compression."""
    out = bytearray(MAGIC.to_bytes(4, "little"))
    if single_segment is None:
        single_segment = (content_size is not None
                          and content_size <= (1 << 27) and window_log is None)
    fhd = 0
    if checksum:
        fhd |= 1 << 2
    body = bytearray()
    if single_segment:
        fhd |= 1 << 5
        if content_size is None:
            raise ValueError("single segment requires known content size")
        if content_size < 256:
            fcs_flag, fcs_bytes = 0, 1
        elif content_size <= 0xFFFF + 256:
            fcs_flag, fcs_bytes = 1, 2
        elif content_size <= 0xFFFFFFFF:
            fcs_flag, fcs_bytes = 2, 4
        else:
            fcs_flag, fcs_bytes = 3, 8
        fhd |= fcs_flag << 6
        v = content_size - 256 if fcs_flag == 1 else content_size
        body += v.to_bytes(fcs_bytes, "little")
    else:
        wl = window_log if window_log is not None else 21
        if wl < 10 or wl > 31:
            raise ValueError("window_log out of range")
        body += bytes([(wl - 10) << 3])
        if content_size is not None:
            if content_size < 256:
                # cannot express 1-byte fcs without single-segment; use 2
                fcs_flag, fcs_bytes = (2, 4) if content_size > 0xFFFF + 256 \
                    else (1, 2) if content_size >= 256 else (2, 4)
            elif content_size <= 0xFFFF + 256:
                fcs_flag, fcs_bytes = 1, 2
            elif content_size <= 0xFFFFFFFF:
                fcs_flag, fcs_bytes = 2, 4
            else:
                fcs_flag, fcs_bytes = 3, 8
            fhd |= fcs_flag << 6
            v = content_size - 256 if fcs_flag == 1 else content_size
            body += v.to_bytes(fcs_bytes, "little")
    out.append(fhd)
    out += body
    return bytes(out)


def decompress_frame(src: bytes, verify_checksum: bool = True):
    """Decode one frame at src[0]. Returns (data, consumed)."""
    if len(src) >= 8:
        magic = int.from_bytes(src[:4], "little")
        if MAGIC_SKIPPABLE_MIN <= magic <= MAGIC_SKIPPABLE_MAX:
            size = int.from_bytes(src[4:8], "little")
            return b"", 8 + size
    fh = parse_frame_header(src)
    pos = fh.header_size

    # output buffer: known content size or grow-as-needed
    if fh.content_size is not None:
        cap = fh.content_size
        out = np.empty(max(cap, 1), dtype=np.uint8)
    else:
        cap = None
        out = np.empty(1 << 20, dtype=np.uint8)
    op = 0

    lit_state = lit_mod.LiteralsState()
    seq_tables = seq_mod.SeqTables()
    rep = [1, 4, 8]
    block_cap = min(fh.window_size or MAX_BLOCK_SIZE, MAX_BLOCK_SIZE)

    while True:
        if pos + 3 > len(src):
            raise CorruptError("zstd: truncated block header")
        bh = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16)
        pos += 3
        last = bh & 1
        btype = (bh >> 1) & 3
        bsize = bh >> 3
        if btype == 3:
            raise CorruptError("zstd: reserved block type")
        if btype == BLOCK_RAW:
            if pos + bsize > len(src):
                raise CorruptError("zstd: truncated raw block")
            out, op = _ensure(out, op, bsize, cap)
            out[op:op + bsize] = np.frombuffer(src[pos:pos + bsize],
                                               dtype=np.uint8)
            op += bsize
            pos += bsize
        elif btype == BLOCK_RLE:
            if pos + 1 > len(src):
                raise CorruptError("zstd: truncated RLE block")
            out, op2 = _ensure(out, op, bsize, cap)
            out[op:op + bsize] = src[pos]
            op += bsize
            pos += 1
        else:
            if bsize > block_cap:
                raise CorruptError("zstd: block larger than allowed")
            if pos + bsize > len(src):
                raise CorruptError("zstd: truncated compressed block")
            block = src[pos:pos + bsize]
            pos += bsize
            lits, used = lit_mod.decode(block, lit_state)
            ll, ofv, ml = seq_mod.decode_section(block[used:], seq_tables)
            offsets = seq_mod.resolve_offsets(ll, ofv, rep)
            need = int(ll.sum() + ml.sum()) + (lits.size - int(ll.sum()))
            out, _ = _ensure(out, op, need, cap)
            op = seq_mod.execute(lits, ll, offsets, ml, out, op)
        if last:
            break

    if fh.content_size is not None and op != fh.content_size:
        raise CorruptError(
            f"zstd: decoded {op} bytes, header said {fh.content_size}")
    data = out[:op].tobytes()
    if fh.checksum:
        if pos + 4 > len(src):
            raise CorruptError("zstd: truncated checksum")
        want = int.from_bytes(src[pos:pos + 4], "little")
        pos += 4
        if verify_checksum:
            got = xxh64_native(data) & 0xFFFFFFFF
            if got != want:
                raise CorruptError("zstd: content checksum mismatch")
    return data, pos


def _ensure(out: np.ndarray, op: int, extra: int, cap):
    need = op + extra
    if cap is not None:
        if need > max(cap, 1):
            raise CorruptError("zstd: output exceeds declared content size")
        return out, op
    if need > out.size:
        nb = np.empty(max(need, out.size * 2), dtype=np.uint8)
        nb[:op] = out[:op]
        return nb, op
    return out, op


def decompress(src: bytes, verify_checksum: bool = True,
               use_native: bool = True) -> bytes:
    """Decode a concatenation of zstd frames (skippable ones included):
    by the host library, and by the plain decoder where the library
    refuses the input or `use_native` is false."""
    if _trace.enabled():
        with _trace.span("zstd.decompress", size=len(src)):
            return _decompress_impl(src, verify_checksum, use_native)
    return _decompress_impl(src, verify_checksum, use_native)


def _decompress_impl(src, verify_checksum=True, use_native=True):
    if use_native:
        out = native.zstd_decode(bytes(src), verify_checksum)
        if out is not None:
            return out
    pos = 0
    parts = []
    while pos < len(src):
        if len(src) - pos < 4:
            raise CorruptError("zstd: trailing garbage")
        data, used = decompress_frame(src[pos:], verify_checksum)
        parts.append(data)
        pos += used
    return b"".join(parts)


def compress(data: bytes, level: int = 3, use_native: bool = True,
             threads: int | None = None, **kw) -> bytes:
    """One zstd frame of `data`. `threads` > 1: the zstdmt job model, one
    frame whose bytes do not depend on the worker count; any keyword in
    `kw` (`window_log`, `checksum`, `block_size`, `device`) or
    `use_native=False`: the tensor encoder, `compressor.compress`;
    otherwise the host encoder."""
    if _trace.enabled():
        with _trace.span("zstd.compress", level=level, size=len(data)):
            return _compress_impl(data, level, use_native, threads, **kw)
    return _compress_impl(data, level, use_native, threads, **kw)


def _compress_impl(data, level=3, use_native=True, threads=None, **kw):
    if use_native and not kw:
        if threads and threads > 1:
            from ...parallel import zstd_jobs
            return zstd_jobs.compress_sharded(bytes(data), level=level, workers=threads)
        return native.zstd_encode(bytes(data), level=level)
    # method properties (window_log) and the device have no plumbing in
    # the host encoder, so they force the tensor encoder, and `threads`
    # is not honoured there, as in tpu7z
    from .compressor import compress as _impl
    return _impl(data, level=level, **kw)
