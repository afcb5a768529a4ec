"""UDF (ECMA-167 / Universal Disk Format) image reader.

A copy of tpu7z/containers/udf.py, on the host: the same bytes, lines
and errors from the same input.

Behavioral reference: CPP/7zip/Archive/Udf/UdfIn.cpp — anchor volume
descriptor pointer at sector 256, main volume descriptor sequence walk
(partition + logical volume descriptors), file-set descriptor, ICB
file entries with short/long allocation descriptors or embedded data,
and directory enumeration through file identifier descriptors.
"""

from __future__ import annotations

import struct

from ..utils.errors import CorruptError

_SEC = 2048


def is_udf(raw: bytes) -> bool:
    # volume recognition sequence at 32KB: BEA01 .. NSR0x .. TEA01
    for k in range(16, 24):
        off = k * _SEC
        ident = raw[off + 1:off + 6]
        if ident in (b"NSR02", b"NSR03"):
            return True
        if ident not in (b"BEA01", b"TEA01", b"BOOT2", b"CD001",
                         b"CDW02"):
            break
    return False


def _tag(raw: bytes, off: int):
    """Descriptor tag: (tag_id, location). Checksum enforced
    (UdfIn.cpp tag verification)."""
    if off + 16 > len(raw):
        raise CorruptError("udf: tag outside image")
    t = raw[off:off + 16]
    tag_id, = struct.unpack_from("<H", t, 0)
    csum = sum(t[:4]) + sum(t[5:16])
    if t[4] != csum & 0xFF:
        raise CorruptError("udf: tag checksum mismatch")
    loc, = struct.unpack_from("<I", t, 12)
    return tag_id, loc


def _dstring(b: bytes) -> str:
    """OSTA compressed unicode (8 or 16 bit)."""
    if not b:
        return ""
    n = b[-1]
    s = b[:n] if n <= len(b) else b
    if not s:
        return ""
    comp = s[0]
    body = s[1:]
    if comp == 16:
        return body.decode("utf-16-be", "ignore")
    return body.decode("latin-1", "ignore")


class _Udf:
    def __init__(self, raw: bytes):
        self.raw = raw
        if not is_udf(raw):
            raise CorruptError("udf: missing NSR volume recognition")
        # anchor at sector 256 (fall back to last sector)
        anchor = None
        for loc in (256, len(raw) // _SEC - 1):
            try:
                tid, _ = _tag(raw, loc * _SEC)
            except CorruptError:
                continue
            if tid == 2:  # AVDP
                anchor = loc * _SEC
                break
        if anchor is None:
            raise CorruptError("udf: no anchor volume descriptor")
        mvds_len, mvds_loc = struct.unpack_from("<II", raw, anchor + 16)
        self.part_start = None
        self.fsd_loc = None
        fsd_part = 0
        # walk the main volume descriptor sequence
        for k in range(mvds_len // _SEC):
            off = (mvds_loc + k) * _SEC
            try:
                tid, _ = _tag(raw, off)
            except CorruptError:
                break
            if tid == 5:  # partition descriptor
                pstart, plen = struct.unpack_from("<II", raw, off + 188)
                self.part_start = pstart
            elif tid == 6:  # logical volume descriptor
                # logicalVolumeContentsUse: long_ad of the FSD
                fsd_len, fsd_lbn = struct.unpack_from("<II", raw,
                                                      off + 248)
                fsd_part, = struct.unpack_from("<H", raw, off + 256)
                self.fsd_loc = fsd_lbn
            elif tid == 8:  # terminating descriptor
                break
        if self.part_start is None or self.fsd_loc is None:
            raise CorruptError("udf: missing partition/volume descriptor")

    def _abs(self, lbn: int) -> int:
        return (self.part_start + lbn) * _SEC

    def read_icb(self, lbn: int, depth=0):
        """File entry -> (is_dir, content bytes)."""
        if depth > 64:
            raise CorruptError("udf: ICB recursion")
        off = self._abs(lbn)
        tid, _ = _tag(self.raw, off)
        if tid not in (261, 266):  # File Entry / Extended File Entry
            raise CorruptError(f"udf: expected file entry, tag {tid}")
        ext = tid == 266
        fe = self.raw[off:off + _SEC]
        ftype = fe[16 + 11]  # icbtag at 16, file type at +11
        info_len, = struct.unpack_from("<Q", fe, 56)
        if ext:
            l_ea, l_ad = struct.unpack_from("<II", fe, 208)
            ad_off = 216 + l_ea
        else:
            l_ea, l_ad = struct.unpack_from("<II", fe, 168)
            ad_off = 176 + l_ea
        ad_type = struct.unpack_from("<H", fe, 16 + 18)[0] & 7
        ads = fe[ad_off:ad_off + l_ad]
        if ad_type == 3:  # embedded in the FE
            content = ads[:info_len]
        elif ad_type == 0:  # short_ad list
            content = bytearray()
            for p in range(0, len(ads) - 7, 8):
                elen, eloc = struct.unpack_from("<II", ads, p)
                count = elen & 0x3FFFFFFF
                etype = elen >> 30
                if count == 0:
                    break
                if etype == 1:  # unrecorded: zeros
                    content.extend(b"\0" * count)
                    continue
                a = self._abs(eloc)
                if a + count > len(self.raw):
                    raise CorruptError("udf: extent outside image")
                content.extend(self.raw[a:a + count])
            content = bytes(content[:info_len])
        elif ad_type == 1:  # long_ad list
            content = bytearray()
            for p in range(0, len(ads) - 15, 16):
                elen, eloc = struct.unpack_from("<II", ads, p)
                count = elen & 0x3FFFFFFF
                if count == 0:
                    break
                a = self._abs(eloc)
                if a + count > len(self.raw):
                    raise CorruptError("udf: extent outside image")
                content.extend(self.raw[a:a + count])
            content = bytes(content[:info_len])
        else:
            raise CorruptError(f"udf: allocation type {ad_type}")
        return ftype == 4, content

    def read_dir(self, data: bytes, prefix: str, files: dict, depth=0):
        """Walk file identifier descriptors in directory content."""
        if depth > 64:
            raise CorruptError("udf: directory recursion")
        pos = 0
        while pos + 38 <= len(data):
            tid, _ = _tag(data, pos)
            if tid != 257:  # FID
                break
            fchar = data[pos + 18]
            l_fi = data[pos + 19]
            icb_len, icb_lbn = struct.unpack_from("<II", data, pos + 20)
            l_iu, = struct.unpack_from("<H", data, pos + 36)
            name = _dstring(data[pos + 38 + l_iu:pos + 38 + l_iu + l_fi])
            total = 38 + l_iu + l_fi
            pos += (total + 3) & ~3
            if fchar & 0x08:  # parent directory entry
                continue
            if fchar & 0x04:  # deleted
                continue
            is_dir, content = self.read_icb(icb_lbn, depth + 1)
            path = prefix + name
            if is_dir:
                self.read_dir(content, path + "/", files, depth + 1)
            else:
                files[path] = content


def read_udf(raw: bytes) -> dict:
    """All files keyed by path (UdfIn.cpp full-tree enumeration)."""
    fs = _Udf(raw)
    # file set descriptor: root dir ICB is a long_ad at offset 400
    fsd_off = fs._abs(fs.fsd_loc)
    tid, _ = _tag(raw, fsd_off)
    if tid != 256:
        raise CorruptError("udf: missing file set descriptor")
    _rlen, root_lbn = struct.unpack_from("<II", raw, fsd_off + 400)
    is_dir, content = fs.read_icb(root_lbn)
    if not is_dir:
        raise CorruptError("udf: root ICB is not a directory")
    files: dict = {}
    fs.read_dir(content, "", files)
    return files


def _seal(record: bytearray, tid: int, loc: int) -> bytes:
    """Fill the 16-byte descriptor tag at the head of `record`
    (checksum over tag bytes, matching _tag's verification)."""
    struct.pack_into("<HH", record, 0, tid, 2)
    record[4] = 0
    record[5] = 0
    struct.pack_into("<HHH", record, 6, 1, 0, len(record) - 16)
    struct.pack_into("<I", record, 12, loc)
    record[4] = (sum(record[:4]) + sum(record[5:16])) & 0xFF
    return bytes(record)


def _mk_file_entry(ftype: int, info_len: int, ads: bytes, loc: int,
                   embedded: bool) -> bytes:
    fe = bytearray(176)
    struct.pack_into("<H", fe, 16 + 4, 4)       # icb strategy 4
    struct.pack_into("<H", fe, 16 + 8, 1)       # max entries
    fe[16 + 11] = ftype
    struct.pack_into("<H", fe, 16 + 18, 3 if embedded else 0)
    struct.pack_into("<Q", fe, 56, info_len)
    struct.pack_into("<II", fe, 168, 0, len(ads))
    return _seal(bytearray(bytes(fe) + ads), 261, loc)


def _mk_fid(name: str, icb_lbn: int, fchar: int) -> bytes:
    enc = b"\x08" + name.encode("latin-1")
    fid = bytearray(38)
    struct.pack_into("<H", fid, 16, 1)          # file version
    fid[18] = fchar
    fid[19] = len(enc)
    struct.pack_into("<II", fid, 20, _SEC, icb_lbn)  # ICB long_ad
    struct.pack_into("<H", fid, 36, 0)          # l_iu
    full = bytes(fid) + enc
    pad = (-len(full)) % 4
    return _seal(bytearray(full + b"\0" * pad), 257, 0)


def write_udf(files: dict) -> bytes:
    """Minimal UDF/ECMA-167 image writer (single partition, short_ad
    extents, embedded root directory) — superset of the read-only
    reference handler (UdfIn.cpp), used by tests and 'a -tudf'.

    The image is tpu7z's byte for byte wherever tpu7z's reads back: tpu7z
    lays file entries and extents from sector 42 on and then writes the
    anchor over sector 256, whatever lies there (about 420 KiB of data
    in). Here a file entry or an extent that would hold sector 256 starts
    past it instead."""
    part_start = 40
    sectors: dict[int, bytes] = {}

    def clear_of_anchor(lbn: int, nsec: int) -> int:
        """Partition-relative `lbn`, or the sector past the anchor where
        [lbn, lbn + nsec) would hold it."""
        anchor = 256 - part_start
        return anchor + 1 if lbn <= anchor < lbn + nsec else lbn

    def put(abs_lbn: int, data: bytes):
        for k in range(0, len(data), _SEC):
            sectors[abs_lbn + k // _SEC] = \
                data[k:k + _SEC].ljust(_SEC, b"\0")

    # volume recognition sequence at sector 16
    for i, ident in enumerate((b"BEA01", b"NSR02", b"TEA01")):
        sectors[16 + i] = (b"\0" + ident + b"\x01").ljust(_SEC, b"\0")

    # partition-relative layout: 0 FSD, 1 root FE, 2.. file FEs, data
    fe_lbns, lbn = [], 2
    for _ in files:
        lbn = clear_of_anchor(lbn, 1)
        fe_lbns.append(lbn)
        lbn += 1
    data_lbn = lbn
    fids = bytearray()
    for fe_lbn, (name, data) in zip(fe_lbns, files.items()):
        if data:
            nsec = -(-len(data) // _SEC)
            data_lbn = clear_of_anchor(data_lbn, nsec)
            ads = struct.pack("<II", len(data), data_lbn)
            put(part_start + data_lbn, data)
            data_lbn += nsec
        else:
            ads = b""
        put(part_start + fe_lbn,
            _mk_file_entry(0, len(data), ads, fe_lbn, embedded=False))
        fids.extend(_mk_fid(name, fe_lbn, 0))
    if len(fids) + 176 <= _SEC:
        put(part_start + 1,
            _mk_file_entry(4, len(fids), bytes(fids), 1, embedded=True))
    else:  # large directory: FIDs go to their own extent
        data_lbn = clear_of_anchor(data_lbn, -(-len(fids) // _SEC))
        ads = struct.pack("<II", len(fids), data_lbn)
        put(part_start + data_lbn, bytes(fids))
        data_lbn += -(-len(fids) // _SEC)
        put(part_start + 1,
            _mk_file_entry(4, len(fids), ads, 1, embedded=False))

    # file set descriptor: root dir ICB long_ad at offset 400
    fsd = bytearray(512)
    struct.pack_into("<II", fsd, 400, _SEC, 1)
    put(part_start, _seal(fsd, 256, 0))

    # main volume descriptor sequence at sector 32
    pd = bytearray(512)
    struct.pack_into("<II", pd, 188, part_start, 960)
    put(32, _seal(pd, 5, 32))
    lvd = bytearray(512)
    struct.pack_into("<II", lvd, 248, _SEC, 0)   # FSD long_ad
    put(33, _seal(lvd, 6, 33))
    put(34, _seal(bytearray(512), 8, 34))

    # anchor volume descriptor pointer at sector 256
    av = bytearray(512)
    struct.pack_into("<II", av, 16, 3 * _SEC, 32)
    put(256, _seal(av, 2, 256))

    total = max(sectors) + 1
    out = bytearray(total * _SEC)
    for lbn, data in sectors.items():
        out[lbn * _SEC:(lbn + 1) * _SEC] = data
    return bytes(out)
