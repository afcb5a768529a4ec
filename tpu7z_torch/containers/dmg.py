"""DMG (Apple disk image) reader + writer.

A copy of tpu7z/containers/dmg.py, on the host: the same bytes, lines
and errors from the same input.

Behavioral reference: CPP/7zip/Archive/DmgHandler.cpp — 512-byte
"koly" trailer, XML property list with resource-fork "blkx" entries,
each a base64 "mish" block map whose chunks are stored / zlib / bzip2
/ zero-filled.  The writer (superset; the reference is read-only)
emits zlib-compressed UDZO-style images.
"""

from __future__ import annotations

import base64
import bz2
import plistlib
import struct
import zlib

from ..utils.errors import CorruptError, UnsupportedError

_SECTOR = 512

# mish chunk types (DmgHandler.cpp kType_*)
_T_ZERO0 = 0x00000000
_T_RAW = 0x00000001
_T_ZERO2 = 0x00000002
_T_UDCO = 0x80000004   # ADC — unsupported
_T_UDZO = 0x80000005   # zlib
_T_UDBZ = 0x80000006   # bzip2
_T_LZFSE = 0x80000007
_T_COMMENT = 0x7FFFFFFE
_T_END = 0xFFFFFFFF


def is_dmg(raw: bytes) -> bool:
    return len(raw) >= 512 and raw[-512:-508] == b"koly"


def _parse_mish(data: bytes) -> list:
    if data[:4] != b"mish":
        raise CorruptError("dmg: bad mish magic")
    first_sector, = struct.unpack_from(">Q", data, 8)
    nchunks, = struct.unpack_from(">I", data, 200)
    chunks = []
    for k in range(nchunks):
        off = 204 + 40 * k
        if off + 40 > len(data):
            raise CorruptError("dmg: truncated mish chunk table")
        ctype, _c, sec, seccount, coff, clen = struct.unpack_from(
            ">IIQQQQ", data, off)
        chunks.append((ctype, first_sector + sec, seccount, coff,
                       clen))
    return chunks


def read_dmg(raw: bytes) -> dict:
    """Partitions as members named by their blkx names, fully
    materialized (DmgHandler.cpp extraction)."""
    if not is_dmg(raw):
        raise CorruptError("dmg: missing koly trailer")
    k = raw[-512:]
    version, = struct.unpack_from(">I", k, 8)
    data_off, data_len = struct.unpack_from(">QQ", k, 24)
    xml_off, xml_len = struct.unpack_from(">QQ", k, 216)
    if xml_off + xml_len > len(raw):
        raise CorruptError("dmg: XML plist outside file")
    try:
        plist = plistlib.loads(raw[xml_off:xml_off + xml_len])
    except Exception as e:
        raise CorruptError(f"dmg: bad plist: {e}") from None
    blkx = plist.get("resource-fork", {}).get("blkx", [])
    if not blkx:
        raise CorruptError("dmg: no blkx entries")
    files: dict = {}
    for ent in blkx:
        name = ent.get("Name") or ent.get("CFName") or \
            f"part{ent.get('ID', '?')}"
        mish = ent["Data"]
        if isinstance(mish, str):
            mish = base64.b64decode(mish)
        chunks = _parse_mish(mish)
        out = bytearray()
        for ctype, sec, seccount, coff, clen in chunks:
            if ctype in (_T_END, _T_COMMENT):
                continue
            nb = seccount * _SECTOR
            src = raw[data_off + coff:data_off + coff + clen]
            if len(src) != clen:
                raise CorruptError("dmg: chunk outside data fork")
            if ctype in (_T_ZERO0, _T_ZERO2):
                out.extend(b"\0" * nb)
            elif ctype == _T_RAW:
                if clen != nb:
                    raise CorruptError("dmg: raw chunk size mismatch")
                out.extend(src)
            elif ctype == _T_UDZO:
                try:
                    dec = zlib.decompress(src)
                except zlib.error as e:
                    raise CorruptError(f"dmg: zlib chunk: {e}") \
                        from None
                if len(dec) != nb:
                    raise CorruptError("dmg: zlib chunk size mismatch")
                out.extend(dec)
            elif ctype == _T_UDBZ:
                try:
                    dec = bz2.decompress(src)
                except OSError as e:
                    raise CorruptError(f"dmg: bzip2 chunk: {e}") \
                        from None
                if len(dec) != nb:
                    raise CorruptError("dmg: bzip2 chunk size mismatch")
                out.extend(dec)
            else:
                raise UnsupportedError(
                    f"dmg: chunk type {ctype:#x} (ADC/LZFSE) not "
                    "supported")
        files[name] = bytes(out)
    return files


def write_dmg(parts: dict) -> bytes:
    """UDZO-style image: zlib chunks, one blkx entry per member."""
    data = bytearray()
    blkx = []
    for i, (name, content) in enumerate(parts.items()):
        if len(content) % _SECTOR:
            content = content + b"\0" * (_SECTOR -
                                         len(content) % _SECTOR)
        chunks = []
        pos = 0
        chunk_sectors = 2048  # 1 MiB chunks
        while pos < len(content):
            piece = content[pos:pos + chunk_sectors * _SECTOR]
            comp = zlib.compress(piece, 6)
            ctype = _T_UDZO
            if len(comp) >= len(piece):
                comp, ctype = piece, _T_RAW
            chunks.append((ctype, pos // _SECTOR,
                           len(piece) // _SECTOR, len(data),
                           len(comp)))
            data.extend(comp)
            pos += len(piece)
        chunks.append((_T_END, len(content) // _SECTOR, 0, len(data),
                       0))
        mish = bytearray(204)
        mish[0:4] = b"mish"
        struct.pack_into(">I", mish, 4, 1)
        struct.pack_into(">QQ", mish, 8, 0, len(content) // _SECTOR)
        struct.pack_into(">I", mish, 200, len(chunks))
        for ctype, sec, seccount, coff, clen in chunks:
            mish += struct.pack(">IIQQQQ", ctype, 0, sec, seccount,
                                coff, clen)
        blkx.append({"Attributes": "0x0050", "ID": str(i),
                     "Name": name, "Data": bytes(mish)})
    plist = {"resource-fork": {"blkx": blkx}}
    xml = plistlib.dumps(plist)
    xml_off = len(data)
    out = bytes(data) + xml
    koly = bytearray(512)
    koly[0:4] = b"koly"
    struct.pack_into(">II", koly, 4, 4, 512)       # version, hdr size
    struct.pack_into(">QQ", koly, 24, 0, len(data))  # data fork
    struct.pack_into(">QQ", koly, 216, xml_off, len(xml))
    return out + bytes(koly)
