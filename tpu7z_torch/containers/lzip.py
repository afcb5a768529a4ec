"""lzip (.lz) container, a port of tpu7z/containers/lzip.py: an LZMA
stream in a CRC-checked member format, the same bytes and errors.

Behavioral reference: the reference fork's lzip decode patch
(CPP/7zip/Archive/LzHandler.cpp) and the published lzip format (v1):

  member := magic "LZIP" | version(1) | coded dict size (1) |
            LZMA stream (lc=3 lp=0 pb=2, ends with EOS marker) |
            crc32(data) u32le | data_size u64le | member_size u64le

Coded dict size byte: low 5 bits = base log2; bits 5-7 subtract
wedge * base/16. Multi-member files are concatenations. The stream is
models/lzma's fast-parse encoder (its parse on the card unless `device`
names the CPU, the range coder on the host); the decoder is models/lzma's
host decoder; the CRC is `crc32_native`.
"""

from __future__ import annotations

from ..models.lzma.decoder import LzmaDecoder
from ..models.lzma.encoder import compress_raw
from ..ops.hashing import crc32_native as _crc32
from ..utils.errors import CorruptError

MAGIC = b"LZIP"


def _decode_dict_size(b: int) -> int:
    base = b & 0x1F
    if base < 12 or base > 29:
        raise CorruptError("lzip: invalid dictionary size")
    size = 1 << base
    size -= ((b >> 5) & 7) * (size // 16)
    return size


def _encode_dict_size(size: int) -> int:
    log = max(12, (max(size, 1) - 1).bit_length())
    return min(log, 29)


def compress(data: bytes, device=None) -> bytes:
    """One lzip member encoding `data` (lc=3 lp=0 pb=2 + EOS marker)."""
    data = bytes(data)
    stream, _props = compress_raw(data, end_marker=True, device=device)
    out = bytearray()
    out += MAGIC
    out.append(1)
    out.append(_encode_dict_size(len(data) or 1))
    out += stream
    out += (_crc32(data) & 0xFFFFFFFF).to_bytes(4, "little")
    out += len(data).to_bytes(8, "little")
    member = len(out) + 8
    out += member.to_bytes(8, "little")
    return bytes(out)


def decompress_member(src: bytes):
    """Decode one member at src[0]. Returns (data, consumed)."""
    if len(src) < 6 or src[:4] != MAGIC:
        raise CorruptError("lzip: bad magic")
    if src[4] > 1:
        raise CorruptError(f"lzip: unsupported version {src[4]}")
    _decode_dict_size(src[5])

    dec = LzmaDecoder(3, 0, 2, 1 << 16)
    consumed = dec.decode_chunk(src[6:], None, expect_end_marker=True)
    data = dec.out[: dec.pos].tobytes()
    pos = 6 + consumed
    if pos + 20 > len(src):
        raise CorruptError("lzip: truncated footer")
    crc = int.from_bytes(src[pos:pos + 4], "little")
    dsize = int.from_bytes(src[pos + 4:pos + 12], "little")
    msize = int.from_bytes(src[pos + 12:pos + 20], "little")
    if dsize != len(data):
        raise CorruptError("lzip: data size mismatch")
    if (_crc32(data) & 0xFFFFFFFF) != crc:
        raise CorruptError("lzip: CRC mismatch")
    if msize != pos + 20:
        raise CorruptError("lzip: member size mismatch")
    return data, pos + 20


def decompress(src: bytes) -> bytes:
    """Decode a concatenation of lzip members."""
    src = bytes(src)
    pos = 0
    parts = []
    while pos < len(src):
        data, used = decompress_member(src[pos:])
        parts.append(data)
        pos += used
    return b"".join(parts)
