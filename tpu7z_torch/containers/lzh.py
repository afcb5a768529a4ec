"""LZH/LHA container: header levels 0-2 reader + level-0 writer (lh5, or
lh0 where lh5 does not shrink a member).

A copy of tpu7z/containers/lzh.py, on the host: the same bytes and errors
from the same input, with two repairs where tpu7z's gives other bytes
than were written, without a word (ROADMAP.md section 3): `read_lzh`
checks each member's CRC-16, which tpu7z's skips, and reads a level-1
member's data after its extension headers, where tpu7z's reads them as
data; `write_lzh` refuses two names that its `?` for every non-ASCII
character makes one, where tpu7z's writes both and its reader keeps the
later.

Behavioral reference: CPP/7zip/Archive/LzhHandler.cpp — 2-byte start
{headerSize, checksum} for levels 0/1 (:259-305: byte-sum over the
header body), basic part {method 5B, packSize u32, size u32, mtime u32,
attr, level, [namelen name] crc16}, level 1/2 extension chains with
0x01 filename / 0x02 directory records. lh0 is stored; compressed
methods (lh4-lh7 LZSS + dynamic Huffman) are a round-2 decode item.
File CRC is CRC-16/ARC (poly 0xA001).
"""

from __future__ import annotations

import struct

from ..utils.errors import CorruptError, UnsupportedError


def _crc16_table() -> list:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ 0xA001 if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC16 = _crc16_table()


def _crc16(data: bytes) -> int:
    """CRC-16/ARC, a table lookup a byte (tpu7z's loops over the bits)."""
    crc = 0
    table = _CRC16
    for b in data:
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc


def _sum8(data: bytes) -> int:
    return sum(data) & 0xFF


def read_lzh(raw: bytes) -> dict:
    files: dict = {}
    pos = 0
    while pos + 2 <= len(raw):
        b0, b1 = raw[pos], raw[pos + 1]
        if b0 == 0:
            break
        # basic part starts at pos+2
        base = pos + 2
        if base + 21 > len(raw):
            raise CorruptError("lzh: truncated header")
        method = raw[base:base + 5]
        if not (method[:3] == b"-lh" or method[:3] == b"-lz"
                or method[:3] == b"-pm") or method[4:5] != b"-":
            raise CorruptError("lzh: bad method id")
        pack_size, size, _mtime = struct.unpack_from("<III", raw, base + 5)
        level = raw[base + 18]
        p = base + 19
        name = ""
        dirname = ""
        if level > 2:
            raise CorruptError("lzh: bad header level")
        if level < 2:
            header_size = b0
            if b1 != _sum8(raw[base:base + header_size]):
                raise CorruptError("lzh: header checksum mismatch")
            namelen = raw[p]
            p += 1
            name = raw[p:p + namelen].decode("shift_jis", "replace")
            p += namelen
            crc = struct.unpack_from("<H", raw, p)[0]
            p += 2
            hdr_end = base + header_size
        else:
            header_size = b0 | (b1 << 8)
            crc = struct.unpack_from("<H", raw, p)[0]
            p += 2
            hdr_end = pos + header_size
        if level != 0:
            p += 1  # os id
            # extension chain
            next_size = struct.unpack_from("<H", raw, p)[0]
            p += 2
            while next_size:
                if next_size < 3:
                    raise CorruptError("lzh: bad extension size")
                etype = raw[p]
                edata = raw[p + 1:p + next_size - 2]
                if level == 1:
                    pack_size -= next_size
                if etype == 0x01:
                    name = edata.decode("shift_jis", "replace")
                elif etype == 0x02:
                    dirname = edata.replace(b"\xff", b"/").decode(
                        "shift_jis", "replace")
                p += next_size - 2
                next_size = struct.unpack_from("<H", raw, p)[0]
                p += 2
            # a level-1 member's data follows its extension headers, which
            # its pack size counts (tpu7z's reader starts at hdr_end)
            data_start = p
        else:
            data_start = hdr_end
        content = raw[data_start:data_start + pack_size]
        if len(content) != pack_size:
            raise CorruptError("lzh: truncated member data")
        if method == b"-lh0-" or method == b"-lz4-" or method == b"-pm0-":
            if len(content) != size:
                raise CorruptError("lzh: stored size mismatch")
            member = bytes(content)
        elif method in (b"-lh4-", b"-lh5-", b"-lh6-", b"-lh7-"):
            from ..models import lha_huffman
            member = lha_huffman.decode(
                bytes(content), size, method[1:4].decode("ascii"))
        else:
            raise UnsupportedError(
                f"lzh: method {method.decode('ascii', 'replace')}")
        if _crc16(member) != crc:
            raise CorruptError(f"lzh: CRC mismatch for {dirname + name}")
        files[dirname + name] = member
        pos = data_start + pack_size
    return files


def write_lzh(files: dict, method: str = "lh5") -> bytes:
    """Write a level-0 .lzh; method 'lh0' stores, 'lh5' compresses
    (falling back to store when compression does not help)."""
    written: dict = {}
    for name in sorted(files):
        nb = name.encode("ascii", "replace")
        if nb in written:
            raise UnsupportedError(f"lzh: names {written[nb]!r} and {name!r} are both "
                                   f"written as {nb.decode()!r}")
        written[nb] = name
    out = bytearray()
    for name in sorted(files):
        content = files[name]
        use_method = b"-lh0-"
        payload = content
        if method != "lh0" and len(content) > 0:
            from ..models import lha_huffman
            comp = lha_huffman.encode(content, method)
            if len(comp) < len(content):
                use_method = f"-{method}-".encode("ascii")
                payload = comp
        nb = name.encode("ascii", "replace")
        body = bytearray()
        body += use_method
        body += struct.pack("<III", len(payload), len(content), 0)
        body += bytes([0x20, 0])           # attr, level 0
        body += bytes([len(nb)]) + nb
        body += struct.pack("<H", _crc16(content))
        out.append(len(body))
        out.append(_sum8(bytes(body)))
        out += body
        out += payload
    out.append(0)  # terminator
    return bytes(out)
