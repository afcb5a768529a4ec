"""FAT12/16/32 filesystem image reader.

A copy of tpu7z/containers/fat.py, on the host: the same bytes, lines
and errors from the same input.

Behavioral reference: CPP/7zip/Archive/FatHandler.cpp — BPB parse,
FAT chain walk, directory tree enumeration with long-file-name (VFAT)
entries; files are exposed with their full path as members.
"""

from __future__ import annotations

import struct

from ..utils.errors import CorruptError


def is_fat(raw: bytes) -> bool:
    if len(raw) < 512 or raw[510:512] != b"\x55\xaa":
        return False
    bps = struct.unpack_from("<H", raw, 11)[0]
    spc = raw[13]
    return bps in (512, 1024, 2048, 4096) and spc in (
        1, 2, 4, 8, 16, 32, 64, 128)


class _Fat:
    def __init__(self, raw: bytes):
        if len(raw) < 512:
            raise CorruptError("fat: image too small")
        self.raw = raw
        bps, = struct.unpack_from("<H", raw, 11)
        if bps not in (512, 1024, 2048, 4096):
            raise CorruptError("fat: bad bytes-per-sector")
        spc = raw[13]
        if spc not in (1, 2, 4, 8, 16, 32, 64, 128):
            raise CorruptError("fat: bad sectors-per-cluster")
        reserved, = struct.unpack_from("<H", raw, 14)
        nfats = raw[16]
        root_entries, = struct.unpack_from("<H", raw, 17)
        total16, = struct.unpack_from("<H", raw, 19)
        fatsz16, = struct.unpack_from("<H", raw, 22)
        total32, = struct.unpack_from("<I", raw, 32)
        fatsz32, = struct.unpack_from("<I", raw, 36)
        total = total16 or total32
        fatsz = fatsz16 or fatsz32
        if not (reserved and nfats and total and fatsz):
            raise CorruptError("fat: bad BPB geometry")
        self.bps, self.spc = bps, spc
        root_sectors = -(-root_entries * 32 // bps)
        self.fat_off = reserved * bps
        self.root_off = (reserved + nfats * fatsz) * bps
        self.data_off = self.root_off + root_sectors * bps
        self.root_entries = root_entries
        nclusters = (total - reserved - nfats * fatsz
                     - root_sectors) // spc
        self.nclusters = nclusters
        if nclusters < 4085:
            self.kind = 12
        elif nclusters < 65525:
            self.kind = 16
        else:
            self.kind = 32
        self.root_cluster = struct.unpack_from("<I", raw, 44)[0] \
            if self.kind == 32 else 0
        self.fat = raw[self.fat_off:self.fat_off + fatsz * bps]

    def next_cluster(self, c: int) -> int:
        if self.kind == 12:
            off = c + c // 2
            if off + 2 > len(self.fat):
                raise CorruptError("fat: FAT12 entry outside table")
            v, = struct.unpack_from("<H", self.fat, off)
            v = (v >> 4) if c & 1 else (v & 0xFFF)
            return 0x0FFFFFFF if v >= 0xFF8 else v
        if self.kind == 16:
            if 2 * c + 2 > len(self.fat):
                raise CorruptError("fat: FAT16 entry outside table")
            v, = struct.unpack_from("<H", self.fat, 2 * c)
            return 0x0FFFFFFF if v >= 0xFFF8 else v
        if 4 * c + 4 > len(self.fat):
            raise CorruptError("fat: FAT32 entry outside table")
        v = struct.unpack_from("<I", self.fat, 4 * c)[0] & 0x0FFFFFFF
        return 0x0FFFFFFF if v >= 0x0FFFFFF8 else v

    def chain(self, c: int, limit: int) -> bytes:
        out = bytearray()
        cbytes = self.spc * self.bps
        for _ in range(self.nclusters + 2):
            if c < 2 or c - 2 >= self.nclusters:
                break
            off = self.data_off + (c - 2) * cbytes
            out.extend(self.raw[off:off + cbytes])
            if limit >= 0 and len(out) >= limit:
                break
            c = self.next_cluster(c)
            if c >= 0x0FFFFFF7:
                break
        return bytes(out[:limit]) if limit >= 0 else bytes(out)


def _parse_dir(fs: _Fat, data: bytes, prefix: str, files: dict,
               depth: int):
    if depth > 64:
        raise CorruptError("fat: directory tree too deep")
    lfn_parts: list[str] = []
    for off in range(0, len(data) - 31, 32):
        e = data[off:off + 32]
        if e[0] == 0x00:
            break
        if e[0] == 0xE5:
            lfn_parts = []
            continue
        attr = e[11]
        if attr == 0x0F:  # VFAT long-name entry
            seq = e[0] & 0x1F
            chunk = (e[1:11] + e[14:26] + e[28:32]).decode(
                "utf-16-le", "ignore")
            chunk = chunk.split("￿")[0].split("\0")[0]
            while len(lfn_parts) < seq:
                lfn_parts.append("")
            lfn_parts[seq - 1] = chunk
            continue
        if attr & 0x08:  # volume label
            lfn_parts = []
            continue
        base = e[0:8].decode("latin-1").rstrip()
        ext = e[8:11].decode("latin-1").rstrip()
        short = base + ("." + ext if ext else "")
        name = "".join(lfn_parts) or short
        lfn_parts = []
        if name in (".", ".."):
            continue
        cluster = struct.unpack_from("<H", e, 26)[0] | (
            struct.unpack_from("<H", e, 20)[0] << 16)
        size, = struct.unpack_from("<I", e, 28)
        path = prefix + name
        if attr & 0x10:  # directory
            sub = fs.chain(cluster, -1)
            _parse_dir(fs, sub, path + "/", files, depth + 1)
        else:
            files[path] = fs.chain(cluster, size) if size else b""


def read_fat(raw: bytes) -> dict:
    """All files in the image, keyed by full path (FatHandler.cpp)."""
    fs = _Fat(raw)
    files: dict = {}
    if fs.kind == 32:
        root = fs.chain(fs.root_cluster, -1)
    else:
        root = raw[fs.root_off:fs.root_off + fs.root_entries * 32]
    _parse_dir(fs, root, "", files, 0)
    return files


def write_fat16(files: dict, label: bytes = b"TPU7Z") -> bytes:
    """Minimal FAT16 image writer (flat root directory, 4KB clusters) —
    superset of the read-only reference handler, used by tests."""
    bps, spc = 512, 8
    cbytes = bps * spc
    # layout: 1 reserved + 1 FAT copy + root(32 sectors) + data
    blobs = [(n.upper()[:12], d) for n, d in files.items()]
    nclusters = sum(max(1, -(-len(d) // cbytes)) for _, d in blobs) + 2
    nclusters = max(nclusters, 4085 + 16)  # force FAT16 range
    fatsz = -(-(nclusters * 2) // bps)
    root_sectors = 32
    reserved = 1
    total = reserved + fatsz + root_sectors + nclusters * spc
    img = bytearray(total * bps)
    # BPB
    img[0:3] = b"\xeb\x3c\x90"
    img[3:11] = b"TPU7Z   "
    struct.pack_into("<H", img, 11, bps)
    img[13] = spc
    struct.pack_into("<H", img, 14, reserved)
    img[16] = 1  # one FAT
    struct.pack_into("<H", img, 17, root_sectors * bps // 32)
    if total < 0x10000:
        struct.pack_into("<H", img, 19, total)
    else:
        struct.pack_into("<I", img, 32, total)
    img[21] = 0xF8
    struct.pack_into("<H", img, 22, fatsz)
    img[54:62] = b"FAT16   "
    img[510:512] = b"\x55\xaa"
    fat_off = reserved * bps
    root_off = (reserved + fatsz) * bps
    data_off = root_off + root_sectors * bps
    struct.pack_into("<HH", img, fat_off, 0xFFF8, 0xFFFF)
    next_c = 2

    def put_entry(idx, name, cluster, size, attr=0x20):
        if "." in name:
            b, e = name.rsplit(".", 1)
        else:
            b, e = name, ""
        ent = (b[:8].ljust(8).encode("latin-1")
               + e[:3].ljust(3).encode("latin-1"))
        ent += bytes([attr]) + b"\0" * 8
        ent += b"\0\0"  # high cluster
        ent += b"\0\0\0\0"  # time/date
        ent += struct.pack("<H", cluster) + struct.pack("<I", size)
        img[root_off + idx * 32:root_off + idx * 32 + 32] = ent

    put_entry(0, label.decode("latin-1"), 0, 0, attr=0x08)
    for i, (name, data) in enumerate(blobs):
        ncl = max(1, -(-len(data) // cbytes))
        start = next_c
        for k in range(ncl):
            c = next_c + k
            nxt = 0xFFFF if k == ncl - 1 else c + 1
            struct.pack_into("<H", img, fat_off + 2 * c, nxt)
            chunk = data[k * cbytes:(k + 1) * cbytes]
            doff = data_off + (c - 2) * cbytes
            img[doff:doff + len(chunk)] = chunk
        next_c += ncl
        put_entry(1 + i, name, start, len(data))
    return bytes(img)
