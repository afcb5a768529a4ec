"""RPM package reader (payload extraction).

A copy of tpu7z/containers/rpm.py, on the host: the same bytes, lines
and errors from the same input.

Behavioral reference: CPP/7zip/Archive/RpmHandler.cpp — 96-byte lead
with magic 0xEDABEEDB (:663-672), signature + main header sections with
magic 0x8EADE801, 16-byte entries, 8-byte alignment of the section
after the signature header (:485-513), payload compressor from tag
RPMTAG_PAYLOADCOMPRESSOR=1125 (:62,:552, default gzip) wrapping a cpio
archive.
"""

from __future__ import annotations

import struct

from ..utils.errors import CorruptError, UnsupportedError

LEAD_SIZE = 96
HEADER_MAGIC = 0x8EADE801
TAG_PAYLOADCOMPRESSOR = 1125


def _read_header(data: bytes, pos: int):
    """Returns (entries {tag: (type, value_bytes)}, end position)."""
    if struct.unpack_from(">I", data, pos)[0] != HEADER_MAGIC:
        raise CorruptError("rpm: bad header magic")
    nentries, dlen = struct.unpack_from(">II", data, pos + 8)
    idx = pos + 16
    store = idx + nentries * 16
    entries = {}
    for i in range(nentries):
        tag, typ, off, _count = struct.unpack_from(">IIII", data,
                                                   idx + i * 16)
        entries[tag] = (typ, store + off)
    end = store + dlen
    if end > len(data):
        raise CorruptError("rpm: truncated header")
    return entries, end


def read_rpm(raw: bytes, *, device=None) -> dict:
    """Returns the files of the embedded cpio payload. A bzip2 payload's
    inverse BWT runs on `device` (the card unless it names the CPU)."""
    if len(raw) < LEAD_SIZE or \
            struct.unpack_from(">I", raw)[0] != 0xEDABEEDB:
        raise CorruptError("rpm: bad lead magic")
    pos = LEAD_SIZE
    # signature header, then align to 8
    _sig, pos = _read_header(raw, pos)
    pos += (-pos) % 8
    entries, pos = _read_header(raw, pos)
    compressor = "gzip"
    if TAG_PAYLOADCOMPRESSOR in entries:
        _typ, off = entries[TAG_PAYLOADCOMPRESSOR]
        end = raw.index(b"\x00", off)
        compressor = raw[off:end].decode("ascii", "replace")
    payload = raw[pos:]
    if compressor == "gzip":
        import zlib
        cpio_data = zlib.decompress(payload, 31)
    elif compressor == "zstd":
        from ..models.zstd import frame
        cpio_data = frame.decompress(payload)
    elif compressor in ("xz", "lzma"):
        from . import xz
        cpio_data = xz.decompress(payload)
    elif compressor == "bzip2":
        from ..models import bzip2
        cpio_data = bzip2.decompress(payload, device=device)
    else:
        raise UnsupportedError(f"rpm: compressor {compressor}")
    from . import cpio
    files = cpio.read_cpio(cpio_data)
    return {k.lstrip("./"): v for k, v in files.items()}
