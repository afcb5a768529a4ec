""".xz container (read/write) over LZMA2: tpu7z/containers/xz.py.

Behavioral reference: C/Xz.c, C/XzEnc.c (XzEnc_Encode:1172), C/XzDec.c
and the public xz file-format specification: a stream header (magic,
flags, CRC32), blocks (a header with one LZMA2 filter, the LZMA2 stream,
padding, the check of the block's content: none, CRC32 or CRC64), the
index and the footer. Each block is independent (its own dictionary
reset), which is what a multi-block stream (`block_size`) gives a
parallel encoder or decoder. The LZMA2 streams are the host library's
(models/lzma/lzma2.py), the checks csrc/crc.cpp's.
"""

from __future__ import annotations

from ..models.lzma import lzma2
from ..ops.hashing import crc32_native as _crc32, crc64_native as _crc64
from ..utils.errors import CorruptError, UnsupportedError

MAGIC = b"\xfd7zXZ\x00"
FOOTER_MAGIC = b"YZ"
CHECK_NONE = 0x00
CHECK_CRC32 = 0x01
CHECK_CRC64 = 0x04
FILTER_LZMA2 = 0x21


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(data: bytes, pos: int):
    v = 0
    shift = 0
    while True:
        if pos >= len(data) or shift > 63:
            raise CorruptError("xz: bad varint")
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


def _dict_size_prop(dict_size: int) -> int:
    """Encode dict size per LZMA2 props: (2|(p&1)) << (p//2+11)."""
    for p in range(41):
        if p == 40:
            return 40
        if (2 | (p & 1)) << (p // 2 + 11) >= dict_size:
            return p
    return 40


def _dict_size_of_prop(p: int) -> int:
    if p > 40:
        raise CorruptError("xz: bad lzma2 dict-size prop")
    if p == 40:
        return 0xFFFFFFFF
    return (2 | (p & 1)) << (p // 2 + 11)


def compress(data: bytes, check: int = CHECK_CRC64,
             block_size: int | None = None, preset_chunk: int = 1 << 20
             ) -> bytes:
    """Write a complete .xz stream; block_size enables multi-block
    (parallel-friendly) layout."""
    flags = bytes([0x00, check])
    out = bytearray()
    out += MAGIC + flags + _crc32(flags).to_bytes(4, "little")

    blocks = []
    if block_size is None or len(data) == 0:
        spans = [(0, len(data))]
    else:
        spans = [(s, min(s + block_size, len(data)))
                 for s in range(0, len(data), block_size)]
    index_records = []
    for s, e in spans:
        chunk = data[s:e]
        comp = lzma2.compress(chunk, chunk_size=preset_chunk)
        hdr = bytearray()
        hdr.append(0x00)  # one filter, no size fields
        hdr += _varint(FILTER_LZMA2)
        hdr += _varint(1)
        hdr.append(_dict_size_prop(1 << 24))
        # pad to multiple of 4 (incl. size byte + crc)
        total = 1 + len(hdr) + 4
        pad = (-total) % 4
        hdr += b"\x00" * pad
        size_byte = (1 + len(hdr) + 4) // 4 - 1
        block_hdr = bytes([size_byte]) + bytes(hdr)
        block_hdr += _crc32(block_hdr).to_bytes(4, "little")

        body = bytearray(block_hdr)
        body += comp
        data_pad = (-len(comp)) % 4
        unpadded = len(block_hdr) + len(comp)
        body += b"\x00" * data_pad
        if check == CHECK_CRC32:
            body += _crc32(chunk).to_bytes(4, "little")
            unpadded += 4
        elif check == CHECK_CRC64:
            body += _crc64(chunk).to_bytes(8, "little")
            unpadded += 8
        out += body
        index_records.append((unpadded, len(chunk)))

    # index
    index = bytearray(b"\x00")
    index += _varint(len(index_records))
    for unpadded, usize in index_records:
        index += _varint(unpadded)
        index += _varint(usize)
    pad = (-len(index)) % 4
    index += b"\x00" * pad
    index += _crc32(bytes(index)).to_bytes(4, "little")
    out += index

    # footer
    backward = (len(index) // 4) - 1
    tail = backward.to_bytes(4, "little") + flags
    out += _crc32(tail).to_bytes(4, "little") + tail + FOOTER_MAGIC
    return bytes(out)


def decompress(src: bytes, verify_check: bool = True) -> bytes:
    if len(src) < 32 or src[:6] != MAGIC:
        raise CorruptError("xz: bad stream header")
    flags = src[6:8]
    if int.from_bytes(src[8:12], "little") != _crc32(flags):
        raise CorruptError("xz: header crc mismatch")
    if flags[0] != 0:
        raise CorruptError("xz: bad stream flags")
    check = flags[1]
    pos = 12
    parts = []
    while True:
        if pos >= len(src):
            raise CorruptError("xz: missing index")
        first = src[pos]
        if first == 0x00:
            break  # index indicator
        hdr_size = (first + 1) * 4
        if pos + hdr_size > len(src):
            raise CorruptError("xz: truncated block header")
        hdr = src[pos:pos + hdr_size]
        if int.from_bytes(hdr[-4:], "little") != _crc32(hdr[:-4]):
            raise CorruptError("xz: block header crc mismatch")
        bflags = hdr[1]
        nfilters = (bflags & 3) + 1
        has_csize = bool(bflags & 0x40)
        has_usize = bool(bflags & 0x80)
        if bflags & 0x3C:
            raise CorruptError("xz: reserved block flags")
        hp = 2
        csize = usize = None
        if has_csize:
            csize, hp = _read_varint(hdr, hp)
        if has_usize:
            usize, hp = _read_varint(hdr, hp)
        filters = []
        for _ in range(nfilters):
            fid, hp = _read_varint(hdr, hp)
            psize, hp = _read_varint(hdr, hp)
            props = hdr[hp:hp + psize]
            hp += psize
            filters.append((fid, props))
        pos += hdr_size
        if len(filters) != 1 or filters[0][0] != FILTER_LZMA2:
            raise UnsupportedError("xz: only single LZMA2 filter supported")
        # decode LZMA2 stream in place; find its length by decoding
        chunk, consumed = _decode_lzma2_span(src, pos, usize)
        parts.append(chunk)
        pos += consumed
        pos += (-consumed) % 4  # block padding
        if check == CHECK_CRC32:
            want = int.from_bytes(src[pos:pos + 4], "little")
            if verify_check and _crc32(chunk) != want:
                raise CorruptError("xz: block crc32 mismatch")
            pos += 4
        elif check == CHECK_CRC64:
            want = int.from_bytes(src[pos:pos + 8], "little")
            if verify_check and _crc64(chunk) != want:
                raise CorruptError("xz: block crc64 mismatch")
            pos += 8
        elif check == 0x0A:
            pos += 32  # sha256 (not verified here)
        elif check != CHECK_NONE:
            pos += {0x02: 4, 0x03: 4}.get(check, 0)
    # skip index verification details; verify footer magic
    if src[-2:] != FOOTER_MAGIC:
        raise CorruptError("xz: bad footer magic")
    return b"".join(parts)


def _decode_lzma2_span(src: bytes, pos: int, usize):
    """Decode an LZMA2 chunk sequence starting at pos; returns
    (data, consumed_bytes incl. end marker)."""
    # walk chunk headers to find the end marker (cheap scan), then decode
    p = pos
    while True:
        if p >= len(src):
            raise CorruptError("xz: unterminated lzma2 stream")
        ctrl = src[p]
        if ctrl == 0:
            p += 1
            break
        if ctrl in (1, 2):
            if p + 3 > len(src):
                raise CorruptError("xz: truncated lzma2 chunk")
            sz = ((src[p + 1] << 8) | src[p + 2]) + 1
            p += 3 + sz
        elif ctrl >= 0x80:
            if p + 5 > len(src):
                raise CorruptError("xz: truncated lzma2 chunk")
            csz = ((src[p + 3] << 8) | src[p + 4]) + 1
            reset = (ctrl >> 5) & 3
            p += 5 + (1 if reset >= 2 else 0) + csz
        else:
            raise CorruptError("xz: bad lzma2 control byte")
    span = src[pos:p]
    data = lzma2.decompress(span, usize)
    return data, p - pos
