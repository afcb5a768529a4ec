"""cpio container (read: newc/crc, odc, binary; write: newc).

A copy of tpu7z/containers/cpio.py, on the host: the same bytes, lines
and errors from the same input.

Behavioral reference: CPP/7zip/Archive/CpioHandler.cpp — magics
(:30-35: 0x71C7 binary, "070701"/"070702" new ASCII/CRC, "070707"
portable ASCII), header layouts in its Parse paths. The newc header is
110 ASCII bytes: magic(6) + 13 x 8-hex fields, name NUL-terminated,
header+name and data each padded to 4 bytes; archive ends with the
"TRAILER!!!" member.
"""

from __future__ import annotations

import struct

from ..utils.errors import CorruptError

TRAILER = "TRAILER!!!"


def _hex_fields(hdr: bytes):
    return [int(hdr[6 + i * 8:14 + i * 8], 16) for i in range(13)]


def read_cpio(data: bytes) -> dict:
    files: dict = {}
    pos = 0
    while pos + 6 <= len(data):
        magic6 = data[pos:pos + 6]
        if magic6 in (b"070701", b"070702"):
            if pos + 110 > len(data):
                raise CorruptError("cpio: truncated newc header")
            f = _hex_fields(data[pos:pos + 110])
            (_ino, mode, _uid, _gid, _nlink, _mtime, fsize, _dmaj, _dmin,
             _rmaj, _rmin, nsize, _chk) = f
            name = data[pos + 110:pos + 110 + nsize - 1].decode(
                "utf-8", "replace")
            pos += 110 + nsize
            pos += (-pos) % 4
            if name == TRAILER:
                break
            content = bytes(data[pos:pos + fsize])
            if len(content) != fsize:
                raise CorruptError("cpio: truncated member data")
            pos += fsize
            pos += (-pos) % 4
            if (mode & 0o170000) in (0o100000, 0):
                files[name] = content
        elif magic6 == b"070707":  # portable ASCII (odc), octal fields
            if pos + 76 > len(data):
                raise CorruptError("cpio: truncated odc header")
            hdr = data[pos:pos + 76]
            mode = int(hdr[18:24], 8)
            nsize = int(hdr[59:65], 8)
            fsize = int(hdr[65:76], 8)
            name = data[pos + 76:pos + 76 + nsize - 1].decode(
                "utf-8", "replace")
            pos += 76 + nsize
            if name == TRAILER:
                break
            content = bytes(data[pos:pos + fsize])
            pos += fsize
            if (mode & 0o170000) in (0o100000, 0):
                files[name] = content
        elif data[pos:pos + 2] in (b"\xc7\x71", b"\x71\xc7"):
            # old binary, 26-byte header of u16le (or swapped) fields
            le = data[pos] == 0xC7
            fmt = "<13H" if le else ">13H"
            f = struct.unpack_from(fmt, data, pos)
            mode = f[3]
            nsize = f[10]
            fsize = (f[11] << 16) | f[12]
            name = data[pos + 26:pos + 26 + nsize - 1].decode(
                "utf-8", "replace")
            pos += 26 + nsize + (nsize & 1)
            if name == TRAILER:
                break
            content = bytes(data[pos:pos + fsize])
            pos += fsize + (fsize & 1)
            if (mode & 0o170000) in (0o100000, 0):
                files[name] = content
        else:
            raise CorruptError("cpio: bad magic")
    return files


def write_cpio(files: dict) -> bytes:
    out = bytearray()

    def member(name: str, content: bytes, mode: int, nlink: int, ino: int):
        nb = name.encode() + b"\x00"
        fields = (ino, mode, 0, 0, nlink, 0, len(content), 0, 0, 0, 0,
                  len(nb), 0)
        out.extend(b"070701" + b"".join(b"%08X" % v for v in fields))
        out.extend(nb)
        out.extend(bytes((-len(out)) % 4))
        out.extend(content)
        out.extend(bytes((-len(out)) % 4))

    ino = 1
    for name in sorted(files):
        member(name, files[name], 0o100644, 1, ino)
        ino += 1
    member(TRAILER, b"", 0, 1, 0)
    return bytes(out)
