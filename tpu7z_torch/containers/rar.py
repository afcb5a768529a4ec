"""RAR 4.x and RAR 5.x archive readers (+ RAR5 writers).

A copy of tpu7z/containers/rar.py, on the host: the same bytes, lines and
errors from the same input.

Behavioral reference: CPP/7zip/Archive/Rar/RarHandler.cpp (RAR 1.5-4.x
block chain: u16 CRC / u8 type / u16 flags / u16 size) and
Rar5Handler.cpp (RAR5 vint-coded block headers, CRC32-checked).
RAR5 compressed members (methods 1-5, algo v0) decode through
models/rar5.py (Rar5Decoder.cpp analog); RAR4 compressed members
raise UnsupportedError (the v2.9 coder family is not implemented).
"""

from __future__ import annotations

import struct
import zlib

from ..utils.errors import CorruptError, UnsupportedError

SIG4 = b"Rar!\x1a\x07\x00"
SIG5 = b"Rar!\x1a\x07\x01\x00"


def is_rar(raw: bytes) -> bool:
    return raw.startswith(SIG4) or raw.startswith(SIG5)


def _vint(data: bytes, pos: int):
    """RAR5 variable-length integer (7 bits per byte, msb = continue)."""
    v = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise CorruptError("rar5: truncated vint")
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7
        if shift > 70:
            raise CorruptError("rar5: vint too long")


def _read_rar5(raw: bytes) -> dict:
    pos = len(SIG5)
    files: dict = {}
    pending: dict | None = None
    parts: list[bytes] = []

    def flush():
        nonlocal pending, parts
        if pending is not None:
            data = b"".join(parts)
            if pending["crc"] is not None and \
                    zlib.crc32(data) != pending["crc"]:
                raise CorruptError(
                    f"rar5: data CRC mismatch for {pending['name']}")
            files[pending["name"]] = data
        pending, parts = None, []

    while pos + 7 <= len(raw):
        crc, = struct.unpack_from("<I", raw, pos)
        hsize, p = _vint(raw, pos + 4)
        hdr = raw[p:p + hsize]
        if len(hdr) != hsize:
            raise CorruptError("rar5: truncated block header")
        # CRC32 covers the size vint AND the header
        # (Rar5Handler.cpp:726 CrcCalc(_buf + 4, _bufSize - 4))
        if zlib.crc32(raw[pos + 4:p + hsize]) != crc:
            raise CorruptError("rar5: header CRC mismatch")
        q = 0
        btype, q = _vint(hdr, q)
        bflags, q = _vint(hdr, q)
        extra_size = data_size = 0
        if bflags & 0x01:
            extra_size, q = _vint(hdr, q)
        if bflags & 0x02:
            data_size, q = _vint(hdr, q)
        data_start = p + hsize
        if btype == 2:  # file header
            fflags, q = _vint(hdr, q)
            usize, q = _vint(hdr, q)
            _attr, q = _vint(hdr, q)
            if fflags & 0x02:  # mtime present
                q += 4
            dcrc = None
            if fflags & 0x04:  # data CRC present
                dcrc, = struct.unpack_from("<I", hdr, q)
                q += 4
            comp, q = _vint(hdr, q)
            _host, q = _vint(hdr, q)
            nlen, q = _vint(hdr, q)
            name = hdr[q:q + nlen].decode("utf-8", "replace")
            method = (comp >> 7) & 0x7
            body = raw[data_start:data_start + data_size]
            if len(body) != data_size:
                raise CorruptError("rar5: truncated file data")
            is_dir = bool(fflags & 0x01)
            if not is_dir:
                if method != 0:
                    if comp & 0x3F:  # algo version > 0 (rar7)
                        raise UnsupportedError(
                            "rar5: algo version > 0 not supported")
                    if comp & 0x40:
                        raise UnsupportedError(
                            "rar5: solid members not supported")
                    from ..models import rar5 as _rar5
                    dict_bits = 17 + ((comp >> 10) & 0xF)
                    body = _rar5.decode(body, usize, dict_bits)
                flush()
                pending = {"name": name, "crc": dcrc, "usize": usize}
                parts = [body]
                # split-after = header flag 0x10 "data continues in next
                # volume" (not file flag 0x08 = size-unknown)
                if not bflags & 0x10:
                    flush()
        elif btype == 5:  # end of archive
            break
        pos = data_start + data_size
    flush()
    return files


def _read_rar4(raw: bytes) -> dict:
    pos = len(SIG4)
    files: dict = {}
    while pos + 7 <= len(raw):
        hcrc, htype, hflags, hsize = struct.unpack_from("<HBHH", raw,
                                                        pos)
        if hsize < 7:
            raise CorruptError("rar4: bad header size")
        add_size = 0
        if htype == 0x74 or hflags & 0x8000:
            if pos + 11 > len(raw):
                raise CorruptError("rar4: truncated header")
            add_size, = struct.unpack_from("<I", raw, pos + 7)
        hdr = raw[pos:pos + hsize]
        if len(hdr) != hsize:
            raise CorruptError("rar4: truncated header")
        # CRC16 = low 16 bits of CRC32 over the header after the CRC
        if htype != 0x72 and (zlib.crc32(hdr[2:]) & 0xFFFF) != hcrc:
            raise CorruptError("rar4: header CRC mismatch")
        if htype == 0x74:  # file header
            (csize, usize, _os, fcrc, _ft, _ver, method, nlen,
             _attr) = struct.unpack_from("<IIBIIBBHI", hdr, 7)
            name = hdr[32:32 + nlen].decode("latin-1")
            body = raw[pos + hsize:pos + hsize + csize]
            if len(body) != csize:
                raise CorruptError("rar4: truncated file data")
            if (hflags & 0xE0) != 0xE0:  # not a directory entry
                if method != 0x30:
                    raise UnsupportedError(
                        f"rar4: method {method:#x} for '{name}' not "
                        "supported (stored only)")
                if zlib.crc32(body) != fcrc:
                    raise CorruptError(
                        f"rar4: data CRC mismatch for {name}")
                files[name] = body
        elif htype == 0x7B:  # end of archive
            break
        pos += hsize + add_size
    return files


def read_rar(raw: bytes) -> dict:
    """Stored members of a RAR4/RAR5 archive, keyed by name."""
    if raw.startswith(SIG5):
        return _read_rar5(raw)
    if raw.startswith(SIG4):
        return _read_rar4(raw)
    raise CorruptError("rar: bad signature")


# --------------------------------------------------------------- writer --

def _vint_enc(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def write_rar5_store(files: dict) -> bytes:
    """Store-mode RAR5 writer (superset; the reference is read-only).
    Produces archives unrar/7zz can list and extract."""
    out = bytearray(SIG5)

    def block(btype: int, body: bytes, data: bytes = b"",
              extra: bytes = b""):
        flags = (0x01 if extra else 0) | (0x02 if data else 0)
        hdr = _vint_enc(btype) + _vint_enc(flags)
        if extra:
            hdr += _vint_enc(len(extra))
        if data:
            hdr += _vint_enc(len(data))
        hdr += body + extra
        sized = _vint_enc(len(hdr)) + hdr
        out.extend(struct.pack("<I", zlib.crc32(sized)))
        out.extend(sized)
        out.extend(data)

    # main archive header (type 1): archive flags = 0
    block(1, _vint_enc(0))
    for name, data in files.items():
        nb = name.encode("utf-8")
        body = (_vint_enc(0x04)              # file flags: CRC present
                + _vint_enc(len(data))       # unpacked size
                + _vint_enc(0)               # attributes
                + struct.pack("<I", zlib.crc32(data))
                + _vint_enc(0)               # compression: v0, store
                + _vint_enc(1)               # host os: unix
                + _vint_enc(len(nb)) + nb)
        block(2, body, data=data)
    block(5, _vint_enc(0))                   # end of archive
    return bytes(out)


def write_rar5(files: dict, compress: bool = True) -> bytes:
    """RAR5 writer with LZ compression (superset; the reference is
    read-only). Per member, picks the smaller of store and the
    models/rar5.py method-3 encoder; unrar/7zz extract the result."""
    if not compress:
        return write_rar5_store(files)
    from ..models import rar5 as _rar5

    out = bytearray(SIG5)

    def block(btype: int, body: bytes, data: bytes = b""):
        flags = 0x02 if data else 0
        hdr = _vint_enc(btype) + _vint_enc(flags)
        if data:
            hdr += _vint_enc(len(data))
        hdr += body
        sized = _vint_enc(len(hdr)) + hdr
        out.extend(struct.pack("<I", zlib.crc32(sized)))
        out.extend(sized)
        out.extend(data)

    block(1, _vint_enc(0))
    for name, data in files.items():
        nb = name.encode("utf-8")
        comp = _rar5.encode(data)
        dict_bits = max(17, (max(len(data), 1) - 1).bit_length())
        method_v = _rar5.make_method_vint(3, dict_bits)
        if len(comp) >= len(data):
            comp, method_v = data, 0
        body = (_vint_enc(0x04)
                + _vint_enc(len(data))
                + _vint_enc(0)
                + struct.pack("<I", zlib.crc32(data))
                + _vint_enc(method_v)
                + _vint_enc(1)
                + _vint_enc(len(nb)) + nb)
        block(2, body, data=comp)
    block(5, _vint_enc(0))
    return bytes(out)
