"""ZIP container (read/write), a port of tpu7z/containers/zip.py: the same
archive bytes from the same files, method and level. Methods: Store,
Deflate (the encoder's parse and bit packing on the card), Deflate64
(read), BZip2 (12; the block sort on the card), LZMA (14), Zstandard (93;
the tensor encoder, its parse on the card), XZ (95) and PPMd var.I (98,
models/ppmd/ppmd8.py on the host), each through the port's codec.

Behavioral reference: CPP/7zip/Archive/Zip/ (ZipHeader.h:59-61 method
ids incl. Zstd=93; decode ZipHandler.cpp:1169, encode
ZipAddCommon.cpp:359) — written from the public APPNOTE format.
"""

from __future__ import annotations

import struct

from ..device import resolve_device
from ..models.ppmd import ppmd8
from ..models.registry import get_codec
from ..ops.hashing import crc32_native as _crc32
from ..utils.errors import CorruptError, UnsupportedError

M_STORE = 0
M_DEFLATE = 8
M_DEFLATE64 = 9
M_BZIP2 = 12
M_LZMA = 14
M_PPMD = 98
M_ZSTD = 93
M_XZ = 95

_LOCAL_SIG = 0x04034B50
_CENTRAL_SIG = 0x02014B50
_EOCD_SIG = 0x06054B50
_EOCD64_SIG = 0x06064B50
_EOCD64_LOC_SIG = 0x07064B50
_FFFF = 0xFFFF
_FFFFFFFF = 0xFFFFFFFF


# the methods whose entry is the registry codec's stream as it is
_CODECS = {M_DEFLATE: "deflate", M_BZIP2: "bzip2", M_XZ: "xz"}


def _compress_entry(data: bytes, method: int, level: int, device):
    if method == M_STORE:
        return data
    if method in _CODECS:
        return get_codec(_CODECS[method]).compress(data, level=level, device=device)
    if method == M_ZSTD:
        from ..models.zstd import compressor
        return compressor.compress(data, level=min(level, 22), device=device)
    if method == M_LZMA:
        from ..models.lzma import encoder
        stream, props5 = encoder.compress_raw(data, end_marker=False)
        # zip-lzma payload: verMajor, verMinor, propsSize u16le, props
        return bytes([21, 3]) + struct.pack("<H", 5) + props5 + stream
    if method == M_PPMD:
        return ppmd8.compress(data)
    raise UnsupportedError(f"zip: method {method} encode unsupported")


def _decompress_entry(comp: bytes, method: int, usize: int, device) -> bytes:
    if method == M_STORE:
        return comp[:usize]
    if method in _CODECS:
        return get_codec(_CODECS[method]).decompress(comp, out_size=usize + 64, device=device)
    if method == M_DEFLATE64:
        from ..models import deflate
        return deflate.decompress(comp, max_out=usize + 64, deflate64=True)
    if method == M_ZSTD:
        from ..models.zstd import frame
        return frame.decompress(comp)
    if method == M_LZMA:
        if len(comp) < 9:
            raise CorruptError("zip: truncated lzma entry")
        psize = struct.unpack("<H", comp[2:4])[0]
        props = comp[4:4 + psize]
        from ..models.lzma import decoder
        return decoder.decompress_raw(comp[4 + psize:], props, usize)
    if method == M_PPMD:
        return ppmd8.decompress(comp, usize)
    raise UnsupportedError(f"zip: method {method} decode unsupported")


def write_zip(files: dict[str, bytes], method: int = M_DEFLATE,
              level: int = 6, zip64: bool = False, *, device=None) -> bytes:
    """`zip64` forces ZIP64 structures; they are also emitted
    automatically when any size/offset exceeds 32 bits or the entry
    count exceeds 65535 (APPNOTE 4.5; ZipOut.cpp zip64 path). The
    codecs' device stages run on `device` (the CUDA card unless it names
    the CPU)."""
    device = resolve_device(device)
    out = bytearray()
    central = bytearray()
    count = 0
    for name, data in files.items():
        nb = name.encode("utf-8")
        crc = _crc32(data)
        comp = _compress_entry(data, method, level, device)
        if len(comp) >= len(data) and method != M_STORE:
            use_method, payload = M_STORE, data
        else:
            use_method, payload = method, comp
        offset = len(out)
        use64 = zip64 or len(payload) >= _FFFFFFFF or \
            len(data) >= _FFFFFFFF or offset >= _FFFFFFFF
        # version needed: zip64 needs 45, zstd 63, deflate 20
        ver = 63 if use_method in (M_ZSTD, M_XZ) else (45 if use64
                                                       else 20)
        flags = 1 << 11  # UTF-8 names
        if use64:
            lextra = struct.pack("<HHQQ", 0x0001, 16, len(data),
                                 len(payload))
            local = struct.pack("<IHHHHHIIIHH", _LOCAL_SIG, ver, flags,
                                use_method, 0, 0, crc, _FFFFFFFF,
                                _FFFFFFFF, len(nb), len(lextra))
            out += local + nb + lextra + payload
            cextra = struct.pack("<HHQQQ", 0x0001, 24, len(data),
                                 len(payload), offset)
            central += struct.pack("<IHHHHHHIIIHHHHHII",
                                   _CENTRAL_SIG, ver, ver, flags,
                                   use_method, 0, 0, crc, _FFFFFFFF,
                                   _FFFFFFFF, len(nb), len(cextra),
                                   0, 0, 0, 0, _FFFFFFFF)
            central += nb + cextra
        else:
            local = struct.pack("<IHHHHHIIIHH", _LOCAL_SIG, ver, flags,
                                use_method, 0, 0, crc, len(payload),
                                len(data), len(nb), 0)
            out += local + nb + payload
            central += struct.pack("<IHHHHHHIIIHHHHHII",
                                   _CENTRAL_SIG, ver, ver, flags,
                                   use_method, 0, 0, crc, len(payload),
                                   len(data), len(nb), 0, 0, 0, 0, 0,
                                   offset)
            central += nb
        count += 1
    cd_off = len(out)
    out += central
    if zip64 or count >= _FFFF or cd_off >= _FFFFFFFF:
        eocd64_off = len(out)
        out += struct.pack("<IQHHIIQQQQ", _EOCD64_SIG, 44, 45, 45, 0, 0,
                           count, count, len(central), cd_off)
        out += struct.pack("<IIQI", _EOCD64_LOC_SIG, 0, eocd64_off, 1)
        out += struct.pack("<IHHHHIIH", _EOCD_SIG, 0, 0,
                           min(count, _FFFF), min(count, _FFFF),
                           len(central), min(cd_off, _FFFFFFFF), 0)
    else:
        out += struct.pack("<IHHHHIIH", _EOCD_SIG, 0, 0, count, count,
                           len(central), cd_off, 0)
    return bytes(out)


def read_zip(data: bytes, verify_crc: bool = True, *, device=None) -> dict[str, bytes]:
    """{name: content} of every entry; bzip2 entries' inverse BWT runs on
    `device` (the CUDA card unless it names the CPU)."""
    device = resolve_device(device)
    eocd = data.rfind(struct.pack("<I", _EOCD_SIG))
    if eocd < 0:
        raise CorruptError("zip: no end-of-central-directory")
    (_sig, _dn, _cdn, count, _total, cd_size, cd_off, _clen) = struct.unpack(
        "<IHHHHIIH", data[eocd:eocd + 22])
    # ZIP64: sentinel values redirect through the EOCD64 locator
    if count == _FFFF or cd_off == _FFFFFFFF:
        loc = eocd - 20
        if loc < 0 or data[loc:loc + 4] != struct.pack("<I",
                                                       _EOCD64_LOC_SIG):
            raise CorruptError("zip: missing zip64 EOCD locator")
        e64_off, = struct.unpack_from("<Q", data, loc + 8)
        if data[e64_off:e64_off + 4] != struct.pack("<I", _EOCD64_SIG):
            raise CorruptError("zip: bad zip64 EOCD")
        (_s, _sz, _vm, _vn, _d1, _d2, count, _tot, cd_size,
         cd_off) = struct.unpack_from("<IQHHIIQQQQ", data, e64_off)
    pos = cd_off
    files: dict[str, bytes] = {}
    for _ in range(count):
        if data[pos:pos + 4] != struct.pack("<I", _CENTRAL_SIG):
            raise CorruptError("zip: bad central header")
        (_sig, _vm, _vn, flags, method, _t, _d, crc, csize, usize,
         nlen, xlen, clen, _dsk, _ia, _ea, offset) = struct.unpack(
            "<IHHHHHHIIIHHHHHII", data[pos:pos + 46])
        name = data[pos + 46:pos + 46 + nlen].decode(
            "utf-8" if flags & (1 << 11) else "cp437", errors="replace")
        # zip64 extended information extra field (id 0x0001): holds,
        # in order, only the fields set to the 32-bit sentinel above
        extra = data[pos + 46 + nlen:pos + 46 + nlen + xlen]
        ep = 0
        while ep + 4 <= len(extra):
            eid, esz = struct.unpack_from("<HH", extra, ep)
            if eid == 0x0001:
                f = extra[ep + 4:ep + 4 + esz]
                fp = 0
                if usize == _FFFFFFFF:
                    usize, = struct.unpack_from("<Q", f, fp)
                    fp += 8
                if csize == _FFFFFFFF:
                    csize, = struct.unpack_from("<Q", f, fp)
                    fp += 8
                if offset == _FFFFFFFF:
                    offset, = struct.unpack_from("<Q", f, fp)
                    fp += 8
            ep += 4 + esz
        pos += 46 + nlen + xlen + clen
        # local header to find data start
        (lsig, _lv, _lf, lmethod, _lt, _ld, _lcrc, lcsize, _lusize,
         lnlen, lxlen) = struct.unpack("<IHHHHHIIIHH",
                                       data[offset:offset + 30])
        if lsig != _LOCAL_SIG:
            raise CorruptError("zip: bad local header")
        dstart = offset + 30 + lnlen + lxlen
        comp = data[dstart:dstart + csize]
        content = _decompress_entry(comp, method, usize, device)
        if len(content) != usize:
            raise CorruptError(f"zip: size mismatch for {name}")
        if verify_crc and _crc32(content) != crc:
            raise CorruptError(f"zip: crc mismatch for {name}")
        files[name] = content
    return files
