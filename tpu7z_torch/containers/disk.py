"""Disk image containers: MBR / GPT partition schemes and VHD images.

A copy of tpu7z/containers/disk.py, on the host: the same bytes, lines
and errors from the same input.

Behavioral references: CPP/7zip/Archive/MbrHandler.cpp (partition table
at 0x1BE, EBR chains for extended partitions), GptHandler.cpp ("EFI
PART" header at LBA 1, CRC-checked entry array), VhdHandler.cpp
("conectix" footer; fixed and dynamic/"cxsparse" BAT layouts).  Each
reader exposes partitions / the virtual disk as extractable members,
like the reference's read-only disk handlers.
"""

from __future__ import annotations

import struct
import zlib

from ..utils.errors import CorruptError

_SECTOR = 512

_MBR_TYPES = {
    0x01: "FAT12", 0x04: "FAT16", 0x05: "Extended", 0x06: "FAT16B",
    0x07: "NTFS", 0x0B: "FAT32", 0x0C: "FAT32-LBA", 0x0E: "FAT16-LBA",
    0x0F: "Extended-LBA", 0x82: "Linux-swap", 0x83: "Linux",
    0x8E: "Linux-LVM", 0xA5: "FreeBSD", 0xEE: "GPT-protective",
    0xEF: "EFI",
}


def is_mbr(raw: bytes) -> bool:
    if len(raw) < _SECTOR or raw[510:512] != b"\x55\xaa":
        return False
    # at least one plausible partition entry
    for k in range(4):
        e = raw[0x1BE + 16 * k:0x1BE + 16 * k + 16]
        status, ptype = e[0], e[4]
        lba, count = struct.unpack_from("<II", e, 8)
        if ptype and status in (0x00, 0x80) and count and \
                (lba + count) * _SECTOR <= len(raw) + (32 << 20):
            return True
    return False


def read_mbr(raw: bytes) -> dict:
    """Partitions as members named '<index>.<type>' (MbrHandler.cpp
    naming by partition kind).  Extended partitions are walked through
    their EBR chain."""
    if len(raw) < _SECTOR or raw[510:512] != b"\x55\xaa":
        raise CorruptError("mbr: missing boot signature")
    files: dict = {}

    def add(idx, ptype, lba, count):
        start = lba * _SECTOR
        size = count * _SECTOR
        if start + size > len(raw):
            raise CorruptError("mbr: partition outside image")
        tname = _MBR_TYPES.get(ptype, f"{ptype:02x}")
        files[f"{idx}.{tname}"] = raw[start:start + size]

    idx = 0
    ext_base = None
    for k in range(4):
        e = raw[0x1BE + 16 * k:0x1BE + 16 * k + 16]
        ptype = e[4]
        if ptype == 0:
            continue
        lba, count = struct.unpack_from("<II", e, 8)
        if ptype in (0x05, 0x0F):
            ext_base = lba
        else:
            add(idx, ptype, lba, count)
        idx += 1
    # EBR chain
    if ext_base is not None:
        ebr_lba = ext_base
        for _ in range(128):  # chain bound
            off = ebr_lba * _SECTOR
            if off + _SECTOR > len(raw):
                raise CorruptError("mbr: EBR outside image")
            sec = raw[off:off + _SECTOR]
            if sec[510:512] != b"\x55\xaa":
                raise CorruptError("mbr: bad EBR signature")
            e0 = sec[0x1BE:0x1BE + 16]
            if e0[4]:
                lba, count = struct.unpack_from("<II", e0, 8)
                add(idx, e0[4], ebr_lba + lba, count)
                idx += 1
            e1 = sec[0x1CE:0x1CE + 16]
            if e1[4] in (0x05, 0x0F):
                nxt = struct.unpack_from("<I", e1, 8)[0]
                ebr_lba = ext_base + nxt
            else:
                break
    return files


def is_gpt(raw: bytes) -> bool:
    return len(raw) >= 2 * _SECTOR and \
        raw[_SECTOR:_SECTOR + 8] == b"EFI PART"


def read_gpt(raw: bytes) -> dict:
    """GPT partitions as members named by their UTF-16 label (or index).

    Header and entry-array CRC32s are enforced (GptHandler.cpp)."""
    if not is_gpt(raw):
        raise CorruptError("gpt: missing EFI PART header")
    hdr = raw[_SECTOR:2 * _SECTOR]
    (hsize, hcrc) = struct.unpack_from("<II", hdr, 12)
    if hsize < 92 or hsize > _SECTOR:
        raise CorruptError("gpt: bad header size")
    calc = zlib.crc32(hdr[:16] + b"\0\0\0\0" + hdr[20:hsize])
    if calc != hcrc:
        raise CorruptError("gpt: header CRC mismatch")
    entries_lba, nentries, esize, ecrc = struct.unpack_from("<QIII",
                                                            hdr, 72)
    if esize < 128 or nentries > 1024:
        raise CorruptError("gpt: bad entry geometry")
    eoff = entries_lba * _SECTOR
    earr = raw[eoff:eoff + nentries * esize]
    if len(earr) != nentries * esize:
        raise CorruptError("gpt: entry array outside image")
    if zlib.crc32(earr) != ecrc:
        raise CorruptError("gpt: entry array CRC mismatch")
    files: dict = {}
    for k in range(nentries):
        e = earr[k * esize:(k + 1) * esize]
        if e[:16] == b"\0" * 16:
            continue
        first, last = struct.unpack_from("<QQ", e, 32)
        name = e[56:56 + 72].decode("utf-16-le").rstrip("\0")
        start = first * _SECTOR
        size = (last - first + 1) * _SECTOR
        if last < first or start + size > len(raw):
            raise CorruptError("gpt: partition outside image")
        files[name or f"part{k}"] = raw[start:start + size]
    return files


# ----------------------------------------------------------------- vhd ---

def is_vhd(raw: bytes) -> bool:
    return (len(raw) >= _SECTOR and
            (raw[-512:-504] == b"conectix" or raw[:8] == b"conectix"))


def _vhd_footer(raw: bytes) -> dict:
    ft = raw[-512:]
    if ft[:8] != b"conectix":
        ft = raw[:512]  # dynamic disks carry a copy up front
        if ft[:8] != b"conectix":
            raise CorruptError("vhd: missing footer cookie")
    csum = struct.unpack_from(">I", ft, 64)[0]
    calc = (~sum(ft[:64] + ft[68:512])) & 0xFFFFFFFF
    if calc != csum:
        raise CorruptError("vhd: footer checksum mismatch")
    data_offset, = struct.unpack_from(">Q", ft, 16)
    cur_size, = struct.unpack_from(">Q", ft, 48)
    dtype, = struct.unpack_from(">I", ft, 60)
    return {"data_offset": data_offset, "size": cur_size, "type": dtype}


def read_vhd(raw: bytes) -> dict:
    """VHD virtual disk content as a single member 'disk.img' (fixed and
    dynamic layouts; VhdHandler.cpp)."""
    ft = _vhd_footer(raw)
    if ft["type"] == 2:  # fixed
        return {"disk.img": raw[:ft["size"]]}
    if ft["type"] != 3:
        raise CorruptError(f"vhd: unsupported disk type {ft['type']}")
    # dynamic: sparse header at data_offset
    dh_off = ft["data_offset"]
    dh = raw[dh_off:dh_off + 1024]
    if dh[:8] != b"cxsparse":
        raise CorruptError("vhd: missing dynamic header cookie")
    table_offset, = struct.unpack_from(">Q", dh, 16)
    max_entries, = struct.unpack_from(">I", dh, 28)
    block_size, = struct.unpack_from(">I", dh, 32)
    if block_size == 0 or block_size % _SECTOR:
        raise CorruptError("vhd: bad block size")
    bitmap_sectors = -(-(block_size // _SECTOR) // (8 * _SECTOR))
    out = bytearray(ft["size"])
    bat = struct.unpack_from(f">{max_entries}I", raw, table_offset)
    for bi, entry in enumerate(bat):
        if entry == 0xFFFFFFFF:
            continue  # unallocated block reads as zeros
        src = (entry + bitmap_sectors) * _SECTOR
        dst = bi * block_size
        take = min(block_size, len(out) - dst)
        if take <= 0:
            break
        if src + take > len(raw):
            raise CorruptError("vhd: block outside image")
        out[dst:dst + take] = raw[src:src + take]
    return {"disk.img": bytes(out)}


def write_vhd_fixed(disk: bytes) -> bytes:
    """Produce a fixed VHD (footer only) — the writer counterpart used
    by tests and the CLI 'a -tvhd' verb."""
    size = len(disk)
    if size % _SECTOR:
        disk = disk + b"\0" * (_SECTOR - size % _SECTOR)
        size = len(disk)
    ft = bytearray(512)
    ft[0:8] = b"conectix"
    struct.pack_into(">I", ft, 8, 2)          # features: reserved bit
    struct.pack_into(">I", ft, 12, 0x00010000)  # version 1.0
    struct.pack_into(">Q", ft, 16, 0xFFFFFFFFFFFFFFFF)  # fixed: no data
    struct.pack_into(">I", ft, 28, 0x74707A37)  # creator 'tpz7'
    struct.pack_into(">Q", ft, 40, size)      # original size
    struct.pack_into(">Q", ft, 48, size)      # current size
    # CHS geometry (simplified cylinder math, ATA spec appendix style)
    sectors = size // _SECTOR
    spt, heads = 17, 4
    cyls = min(0xFFFF, sectors // (spt * heads) or 1)
    struct.pack_into(">HBB", ft, 56, cyls, heads, spt)
    struct.pack_into(">I", ft, 60, 2)         # type: fixed
    csum = (~sum(ft[:64] + ft[68:512])) & 0xFFFFFFFF
    struct.pack_into(">I", ft, 64, csum)
    return disk + bytes(ft)


# --------------------------------------------------------------- qcow2 ---

def is_qcow(raw: bytes) -> bool:
    return raw[:4] == b"QFI\xfb"


def read_qcow(raw: bytes) -> dict:
    """qcow/qcow2 virtual disk as 'disk.img' (QcowHandler.cpp; no
    backing files, no compressed clusters beyond zlib)."""
    if not is_qcow(raw):
        raise CorruptError("qcow: bad magic")
    version, = struct.unpack_from(">I", raw, 4)
    if version not in (2, 3):
        raise CorruptError(f"qcow: unsupported version {version}")
    cluster_bits, = struct.unpack_from(">I", raw, 20)
    size, = struct.unpack_from(">Q", raw, 24)
    crypt, = struct.unpack_from(">I", raw, 32)
    l1_size, = struct.unpack_from(">I", raw, 36)
    l1_off, = struct.unpack_from(">Q", raw, 40)
    if crypt:
        raise CorruptError("qcow: encrypted images not supported")
    if cluster_bits < 9 or cluster_bits > 21:
        raise CorruptError("qcow: bad cluster size")
    csize = 1 << cluster_bits
    l2_entries = csize // 8
    if size > (1 << 40):
        raise CorruptError("qcow: image too large to materialize")
    out = bytearray(size)
    if l1_off + 8 * l1_size > len(raw):
        raise CorruptError("qcow: L1 table outside image")
    for i in range(l1_size):
        l1e, = struct.unpack_from(">Q", raw, l1_off + 8 * i)
        l2_off = l1e & 0x00FFFFFFFFFFFE00
        if l2_off == 0:
            continue
        if l2_off + 8 * l2_entries > len(raw):
            raise CorruptError("qcow: L2 table outside image")
        for j in range(l2_entries):
            l2e, = struct.unpack_from(">Q", raw, l2_off + 8 * j)
            if l2e & (1 << 62):  # compressed cluster
                x = 62 - (cluster_bits - 8)
                host = l2e & ((1 << x) - 1)
                nsect = ((l2e >> x) & ((1 << (cluster_bits - 8)) - 1)) + 1
                blob = raw[host:host + nsect * 512]
                d = zlib.decompressobj(-zlib.MAX_WBITS)
                data = d.decompress(blob, csize)
            else:
                host = l2e & 0x00FFFFFFFFFFFE00
                if host == 0 or (l2e & 1):  # unallocated / all-zero
                    continue
                if host + csize > len(raw):
                    raise CorruptError("qcow: cluster outside image")
                data = raw[host:host + csize]
            dst = (i * l2_entries + j) * csize
            if dst >= size:
                break
            take = min(len(data), size - dst)
            out[dst:dst + take] = data[:take]
    return {"disk.img": bytes(out)}


# ----------------------------------------------------------------- vdi ---

def is_vdi(raw: bytes) -> bool:
    return len(raw) > 68 and raw[64:68] == b"\x7f\x10\xda\xbe"


def read_vdi(raw: bytes) -> dict:
    """VirtualBox VDI as 'disk.img' (VdiHandler.cpp; dynamic + fixed)."""
    if not is_vdi(raw):
        raise CorruptError("vdi: bad signature")
    blocks_off, data_off = struct.unpack_from("<II", raw, 340)
    size, = struct.unpack_from("<Q", raw, 368)
    # cbBlock at 0x178=376, cBlocks at 0x180=384 (VdiHandler.cpp:322-323)
    block_size, = struct.unpack_from("<I", raw, 376)
    nblocks, = struct.unpack_from("<I", raw, 384)
    if block_size == 0 or block_size > (64 << 20):
        raise CorruptError("vdi: bad block size")
    if size > (1 << 40):
        raise CorruptError("vdi: image too large to materialize")
    out = bytearray(size)
    if blocks_off + 4 * nblocks > len(raw):
        raise CorruptError("vdi: block map outside image")
    for bi in range(nblocks):
        ent, = struct.unpack_from("<I", raw, blocks_off + 4 * bi)
        if ent in (0xFFFFFFFF, 0xFFFFFFFE):  # unallocated / zero
            continue
        src = data_off + ent * block_size
        dst = bi * block_size
        if dst >= size:
            break
        take = min(block_size, size - dst)
        if src + take > len(raw):
            raise CorruptError("vdi: block outside image")
        out[dst:dst + take] = raw[src:src + take]
    return {"disk.img": bytes(out)}


# ---------------------------------------------------------------- vmdk ---

def is_vmdk(raw: bytes) -> bool:
    return raw[:4] == b"KDMV"


def read_vmdk(raw: bytes) -> dict:
    """VMDK sparse extent as 'disk.img' (VmdkHandler.cpp; monolithic
    sparse, optional zlib-compressed grains)."""
    if not is_vmdk(raw):
        raise CorruptError("vmdk: bad magic")
    (_ver, flags, capacity, grain_size, _desc_off, _desc_sz,
     gtes_per_gt, _rgd_off, gd_off, _overhead) = struct.unpack_from(
        "<IIQQQQIQQQ", raw, 4)
    compressed = bool(flags & 0x10000)
    if capacity * _SECTOR > (1 << 40):
        raise CorruptError("vmdk: image too large to materialize")
    out = bytearray(capacity * _SECTOR)
    grain_bytes = grain_size * _SECTOR
    ngrains = -(-capacity // grain_size)
    ngt = -(-ngrains // gtes_per_gt)
    gd = struct.unpack_from(f"<{ngt}I", raw, gd_off * _SECTOR)
    for t, gt_sector in enumerate(gd):
        if gt_sector == 0:
            continue
        gt = struct.unpack_from(f"<{gtes_per_gt}I", raw,
                                gt_sector * _SECTOR)
        for g, gte in enumerate(gt):
            if gte in (0, 1):  # unallocated / zero grain
                continue
            gi = t * gtes_per_gt + g
            if gi >= ngrains:
                break
            dst = gi * grain_bytes
            src = gte * _SECTOR
            if compressed:
                # grain marker: u64 lba, u32 size, then deflate data
                dsz, = struct.unpack_from("<I", raw, src + 8)
                blob = raw[src + 12:src + 12 + dsz]
                d = zlib.decompressobj(-zlib.MAX_WBITS)
                data = d.decompress(blob, grain_bytes)
            else:
                if src + grain_bytes > len(raw):
                    raise CorruptError("vmdk: grain outside image")
                data = raw[src:src + grain_bytes]
            take = min(len(data), len(out) - dst)
            out[dst:dst + take] = data[:take]
    return {"disk.img": bytes(out)}


# ---------------------------------------------------------------- vhdx ---

def is_vhdx(raw: bytes) -> bool:
    return raw[:8] == b"vhdxfile"


def read_vhdx(raw: bytes) -> dict:
    """VHDX virtual disk as 'disk.img' (VhdxHandler.cpp; parses the
    region table -> BAT + metadata, payload blocks only)."""
    if not is_vhdx(raw):
        raise CorruptError("vhdx: bad signature")
    # region table at 192KB (two copies; use the first valid)
    bat_off = meta_off = None
    for base in (192 << 10, 256 << 10):
        if raw[base:base + 4] != b"regi":
            continue
        count, = struct.unpack_from("<I", raw, base + 8)
        for k in range(min(count, 2047)):
            e = base + 16 + 32 * k
            guid = raw[e:e + 16]
            off, _len = struct.unpack_from("<QI", raw, e + 16)
            if guid == bytes.fromhex("6677c22d23f600429d64115e9bfd4a08"):
                bat_off = off
            elif guid == bytes.fromhex("06a27c8b90479a4bb8a8ff25f73c5d06"):
                meta_off = off
        if bat_off is not None:
            break
    if bat_off is None or meta_off is None:
        raise CorruptError("vhdx: missing BAT/metadata regions")
    # metadata table: entries of (guid, offset, length)
    if raw[meta_off:meta_off + 8] != b"metadata":
        raise CorruptError("vhdx: bad metadata header")
    mcount, = struct.unpack_from("<H", raw, meta_off + 10)
    block_size = virt_size = lsec = None
    for k in range(min(mcount, 2047)):
        e = meta_off + 32 + 32 * k
        guid = raw[e:e + 16]
        off, length = struct.unpack_from("<II", raw, e + 16)
        p = meta_off + off
        if guid == bytes.fromhex("3767a1ca36fa434db3b633f0aa44e76b"):
            block_size, = struct.unpack_from("<I", raw, p)
        elif guid == bytes.fromhex("2442a52f1bcd7648b2115dbed83bf4b8"):
            virt_size, = struct.unpack_from("<Q", raw, p)
        elif guid == bytes.fromhex("1dbf41816fa90947ba47f233a8faab5f"):
            lsec, = struct.unpack_from("<I", raw, p)
    if not block_size or not virt_size:
        raise CorruptError("vhdx: missing file-parameters/size metadata")
    if virt_size > (1 << 40):
        raise CorruptError("vhdx: image too large to materialize")
    out = bytearray(virt_size)
    chunk_ratio = ((1 << 23) * (lsec or 512)) // block_size
    nblocks = -(-virt_size // block_size)
    bi = 0
    k = 0
    while bi < nblocks:
        ent, = struct.unpack_from("<Q", raw, bat_off + 8 * k)
        k += 1
        # skip sector-bitmap entries interleaved every chunk_ratio
        if chunk_ratio and k % (chunk_ratio + 1) == 0:
            continue
        state = ent & 7
        off = ent & ~0xFFFFF
        if state == 6:  # PAYLOAD_BLOCK_FULLY_PRESENT
            dst = bi * block_size
            take = min(block_size, virt_size - dst)
            if off + take > len(raw):
                raise CorruptError("vhdx: block outside image")
            out[dst:dst + take] = raw[off:off + take]
        bi += 1
    return {"disk.img": bytes(out)}
