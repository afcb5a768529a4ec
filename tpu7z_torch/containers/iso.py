"""ISO 9660 container: reader (+ minimal writer used for fixtures).

A copy of tpu7z/containers/iso.py, on the host: the same bytes, lines
and errors from the same input.

Behavioral reference: CPP/7zip/Archive/Iso/ — volume descriptors start
at sector 16 with "CD001" after the type byte (IsoIn.cpp:306,518-559),
primary/supplementary volume descriptors carry the 34-byte root
directory record (IsoIn.cpp:278), directories are walked from extent
records (IsoIn.cpp:335-378). Directory records hold both-endian extent
LBA and data length, a flags byte (bit 1 = directory), and the file
identifier ("NAME;1" version suffix for files). Sector size 2048.
"""

from __future__ import annotations

import struct

from ..utils.errors import CorruptError

SECTOR = 2048
FLAG_DIR = 0x02


def _both16(v: int) -> bytes:
    return struct.pack("<H", v) + struct.pack(">H", v)


def _both32(v: int) -> bytes:
    return struct.pack("<I", v) + struct.pack(">I", v)


def _parse_dir_record(data: bytes, pos: int):
    rlen = data[pos]
    if rlen == 0:
        return None
    extent = struct.unpack_from("<I", data, pos + 2)[0]
    size = struct.unpack_from("<I", data, pos + 10)[0]
    flags = data[pos + 25]
    id_len = data[pos + 32]
    fid = bytes(data[pos + 33:pos + 33 + id_len])
    return rlen, extent, size, flags, fid


def read_iso(raw: bytes) -> dict:
    """Returns {path: content} from the primary volume descriptor."""
    pos = 16 * SECTOR
    pvd = None
    while pos + SECTOR <= len(raw):
        vtype = raw[pos]
        if raw[pos + 1:pos + 6] != b"CD001":
            raise CorruptError("iso: bad volume descriptor signature")
        if vtype == 1 and pvd is None:
            pvd = pos
        if vtype == 255:
            break
        pos += SECTOR
    if pvd is None:
        raise CorruptError("iso: no primary volume descriptor")
    root = _parse_dir_record(raw, pvd + 156)
    if root is None or not (root[3] & FLAG_DIR):
        raise CorruptError("iso: bad root directory record")

    files: dict = {}

    def walk(extent: int, size: int, prefix: str, depth: int):
        if depth > 32:
            raise CorruptError("iso: directory loop")
        base = extent * SECTOR
        offset = 0
        while offset < size:
            # records do not span sector boundaries; a zero length
            # byte means skip to the next sector
            if raw[base + offset] == 0:
                offset = (offset // SECTOR + 1) * SECTOR
                continue
            rec = _parse_dir_record(raw, base + offset)
            rlen, ext, dsize, flags, fid = rec
            offset += rlen
            if fid in (b"\x00", b"\x01"):  # . and ..
                continue
            name = fid.split(b";")[0].decode("utf-8", "replace")
            if name.endswith("."):
                name = name[:-1]
            if flags & FLAG_DIR:
                walk(ext, dsize, f"{prefix}{name}/", depth + 1)
            else:
                files[f"{prefix}{name}"] = bytes(
                    raw[ext * SECTOR:ext * SECTOR + dsize])

    walk(root[1], root[2], "", 0)
    return files


# ---------------------------------------------------------------------------
# Writer (flat root directory; used for fixtures / creation surface)
# ---------------------------------------------------------------------------

def _dir_record(extent: int, size: int, flags: int, fid: bytes) -> bytes:
    rlen = 33 + len(fid)
    if rlen & 1:
        rlen += 1
    rec = bytearray(rlen)
    rec[0] = rlen
    rec[2:10] = _both32(extent)
    rec[10:18] = _both32(size)
    rec[18:25] = bytes([126, 1, 1, 0, 0, 0, 0])  # date: 2026-01-01
    rec[25] = flags
    rec[28:32] = _both16(1)  # volume sequence number
    rec[32] = len(fid)
    rec[33:33 + len(fid)] = fid
    return bytes(rec)


def write_iso(files: dict, volume_id: str = "TPU7Z") -> bytes:
    names = sorted(files)
    # layout: sectors 0-15 system area, 16 PVD, 17 terminator,
    # 18 root directory, 19+ file extents
    root_extent = 18
    file_extent = 19
    extents = {}
    for name in names:
        extents[name] = file_extent
        file_extent += max(1, -(-len(files[name]) // SECTOR))

    root = bytearray()
    root += _dir_record(root_extent, SECTOR, FLAG_DIR, b"\x00")
    root += _dir_record(root_extent, SECTOR, FLAG_DIR, b"\x01")
    for name in names:
        fid = name.upper().encode("ascii", "replace") + b";1"
        root += _dir_record(extents[name], len(files[name]), 0, fid)
    if len(root) > SECTOR:
        raise CorruptError("iso writer: root directory too large")

    total_sectors = file_extent
    out = bytearray(total_sectors * SECTOR)

    pvd = bytearray(SECTOR)
    pvd[0] = 1
    pvd[1:6] = b"CD001"
    pvd[6] = 1  # version
    pvd[8:40] = b" " * 32                       # system id
    pvd[40:72] = volume_id.ljust(32).encode()   # volume id
    pvd[80:88] = _both32(total_sectors)         # volume space size
    pvd[120:124] = _both16(1)                   # volume set size
    pvd[124:128] = _both16(1)                   # volume sequence number
    pvd[128:132] = _both16(SECTOR)              # logical block size
    pvd[132:140] = _both32(0)                   # path table size
    pvd[156:156 + 34] = _dir_record(root_extent, SECTOR, FLAG_DIR,
                                    b"\x00")
    pvd[881] = 1  # file structure version
    out[16 * SECTOR:17 * SECTOR] = pvd

    term = bytearray(SECTOR)
    term[0] = 255
    term[1:6] = b"CD001"
    term[6] = 1
    out[17 * SECTOR:18 * SECTOR] = term

    out[root_extent * SECTOR:root_extent * SECTOR + len(root)] = root
    for name in names:
        start = extents[name] * SECTOR
        out[start:start + len(files[name])] = files[name]
    return bytes(out)
