"""Small read-only handlers: SWF, FLV, IHex, Base64, Split, PE, ELF,
Mach-O, ARJ.

A copy of tpu7z/containers/misc.py, on the host: the same bytes, lines
and errors from the same input.

Behavioral references (parsed formats only — all implementations are
spec-driven, written from the public file-format layouts):
  CPP/7zip/Archive/SwfHandler.cpp   — FWS plain / CWS zlib / ZWS lzma
  CPP/7zip/Archive/FlvHandler.cpp   — tag walk, audio/video stream split
  CPP/7zip/Archive/IhexHandler.cpp  — Intel HEX records -> binary image
  CPP/7zip/Archive/Base64Handler.cpp
  CPP/7zip/Archive/SplitHandler.cpp — .001 volume concatenation
  CPP/7zip/Archive/PeHandler.cpp    — COFF sections as members
  CPP/7zip/Archive/ElfHandler.cpp   — section headers as members
  CPP/7zip/Archive/MachoHandler.cpp — load-command segments as members
  CPP/7zip/Archive/ArjHandler.cpp   — ARJ headers; method 0 (stored)
"""

from __future__ import annotations

import struct
import zlib

from ..utils.errors import CorruptError, UnsupportedError


# ----------------------------------------------------------------- swf ---

def is_swf(raw: bytes) -> bool:
    return len(raw) >= 8 and raw[:3] in (b"FWS", b"CWS", b"ZWS")


def read_swf(raw: bytes) -> dict:
    """Decompressed SWF body as a single member (SwfHandler.cpp exposes
    the uncompressed movie)."""
    if not is_swf(raw):
        raise CorruptError("swf: bad signature")
    sig = raw[:3]
    total, = struct.unpack_from("<I", raw, 4)
    if sig == b"FWS":
        body = raw[8:]
    elif sig == b"CWS":
        try:
            body = zlib.decompress(raw[8:])
        except zlib.error as e:
            raise CorruptError(f"swf: zlib body: {e}") from None
    else:  # ZWS: 4-byte compressed len + LZMA props+stream (no size field)
        if len(raw) < 17:
            raise CorruptError("swf: truncated ZWS header")
        # tpu7z decodes this body through a module it does not have
        # (models.lzma.lzma1) and fails there; decoding it would be a
        # feature tpu7z lacks
        raise UnsupportedError("swf: ZWS (LZMA) body")
    if len(body) + 8 != total:
        raise CorruptError("swf: body length mismatch")
    return {"movie.swf": b"FWS" + raw[3:8] + body}


def write_swf_cws(movie: bytes) -> bytes:
    """Compress an FWS movie to CWS (the reference handler supports
    decode only; the writer is a superset used by tests)."""
    if movie[:3] != b"FWS":
        raise CorruptError("swf: writer expects an FWS movie")
    return b"CWS" + movie[3:8] + zlib.compress(movie[8:], 9)


# ----------------------------------------------------------------- flv ---

def is_flv(raw: bytes) -> bool:
    return len(raw) >= 9 and raw[:3] == b"FLV"


def read_flv(raw: bytes) -> dict:
    """Split the tag stream into audio/video/meta elementary streams
    (FlvHandler.cpp groups tags by type)."""
    if not is_flv(raw):
        raise CorruptError("flv: bad signature")
    hlen, = struct.unpack_from(">I", raw, 5)
    if hlen < 9 or hlen > len(raw):
        raise CorruptError("flv: bad header length")
    pos = hlen + 4  # skip PreviousTagSize0
    streams: dict[str, bytearray] = {}
    names = {8: "audio", 9: "video", 18: "meta"}
    while pos + 11 <= len(raw):
        ttype = raw[pos]
        dsize = int.from_bytes(raw[pos + 1:pos + 4], "big")
        body = raw[pos + 11:pos + 11 + dsize]
        if len(body) != dsize:
            raise CorruptError("flv: truncated tag")
        key = names.get(ttype, f"type{ttype}")
        streams.setdefault(key, bytearray()).extend(body)
        pos += 11 + dsize + 4  # tag + PreviousTagSize
    return {k: bytes(v) for k, v in streams.items()}


# ---------------------------------------------------------------- ihex ---

def is_ihex(raw: bytes) -> bool:
    head = raw[:64].lstrip()
    if not head.startswith(b":"):
        return False
    line = head.split(b"\n", 1)[0].rstrip(b"\r")
    if len(line) < 11 or (len(line) - 1) % 2:
        return False
    try:
        bytes.fromhex(line[1:].decode())
    except ValueError:
        return False
    return True


def read_ihex(raw: bytes) -> dict:
    """Intel HEX records reassembled into the flat binary image
    (IhexHandler.cpp record types 00-05)."""
    segments: dict[int, bytearray] = {}
    upper = 0
    for ln, line in enumerate(raw.splitlines()):
        line = line.strip()
        if not line:
            continue
        if not line.startswith(b":"):
            raise CorruptError(f"ihex: line {ln + 1}: missing ':'")
        try:
            rec = bytes.fromhex(line[1:].decode())
        except ValueError:
            raise CorruptError(f"ihex: line {ln + 1}: bad hex") from None
        if len(rec) < 5 or rec[0] != len(rec) - 5:
            raise CorruptError(f"ihex: line {ln + 1}: bad length")
        if sum(rec) & 0xFF:
            raise CorruptError(f"ihex: line {ln + 1}: checksum")
        count, addr, rtype = rec[0], (rec[1] << 8) | rec[2], rec[3]
        data = rec[4:4 + count]
        if rtype == 0x00:
            a = upper + addr
            seg = segments.setdefault(0, bytearray())
            if len(seg) < a + count:
                seg.extend(b"\xff" * (a + count - len(seg)))
            seg[a:a + count] = data
        elif rtype == 0x01:
            break
        elif rtype == 0x02:
            upper = ((data[0] << 8) | data[1]) << 4
        elif rtype == 0x04:
            upper = ((data[0] << 8) | data[1]) << 16
        elif rtype in (0x03, 0x05):
            pass  # start address records carry no data
        else:
            raise CorruptError(f"ihex: line {ln + 1}: type {rtype:#x}")
    if not segments:
        raise CorruptError("ihex: no data records")
    return {"image.bin": bytes(segments[0])}


def write_ihex(image: bytes, base: int = 0) -> bytes:
    """Binary -> Intel HEX (writer superset; 16-byte records)."""
    out = []
    upper = -1
    for off in range(0, len(image), 16):
        a = base + off
        if (a >> 16) != upper:
            upper = a >> 16
            rec = bytes([2, 0, 0, 4, upper >> 8, upper & 0xFF])
            out.append(b":" + (rec + bytes([(-sum(rec)) & 0xFF])).hex()
                       .upper().encode())
        chunk = image[off:off + 16]
        rec = bytes([len(chunk), (a >> 8) & 0xFF, a & 0xFF, 0]) + chunk
        out.append(b":" + (rec + bytes([(-sum(rec)) & 0xFF])).hex()
                   .upper().encode())
    out.append(b":00000001FF")
    return b"\r\n".join(out) + b"\r\n"


# -------------------------------------------------------------- base64 ---

_B64 = (b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
        b"0123456789+/=\r\n \t")


def is_base64(raw: bytes) -> bool:
    probe = raw[:4096]
    return (len(probe.strip()) >= 8 and
            all(c in _B64 for c in probe))


def read_base64(raw: bytes) -> dict:
    import base64 as b64
    compact = bytes(c for c in raw if c not in b"\r\n \t")
    pad = (-len(compact)) % 4
    try:
        data = b64.b64decode(compact + b"=" * pad, validate=True)
    except Exception as e:
        raise CorruptError(f"base64: {e}") from None
    return {"data.bin": data}


# --------------------------------------------------------------- split ---

def read_split(volumes: list[bytes]) -> dict:
    """Concatenate an ordered .001/.002/... volume list
    (SplitHandler.cpp exposes the joined stream as one member)."""
    if not volumes:
        raise CorruptError("split: no volumes")
    return {"joined.bin": b"".join(volumes)}


# ----------------------------------------------------------------- pe ---

def is_pe(raw: bytes) -> bool:
    if len(raw) < 0x40 or raw[:2] != b"MZ":
        return False
    peoff, = struct.unpack_from("<I", raw, 0x3C)
    return peoff + 4 <= len(raw) and raw[peoff:peoff + 4] == b"PE\0\0"


def read_pe(raw: bytes) -> dict:
    """COFF sections as members named by their section name
    (PeHandler.cpp)."""
    if not is_pe(raw):
        raise CorruptError("pe: bad MZ/PE signature")
    peoff, = struct.unpack_from("<I", raw, 0x3C)
    machine, nsect, _t, _p, _ns, opt_size, _ch = struct.unpack_from(
        "<HHIIIHH", raw, peoff + 4)
    sect0 = peoff + 24 + opt_size
    files: dict = {}
    for k in range(nsect):
        off = sect0 + 40 * k
        if off + 40 > len(raw):
            raise CorruptError("pe: section table outside file")
        name = raw[off:off + 8].rstrip(b"\0").decode("latin-1")
        vsize, _va, rsize, rptr = struct.unpack_from("<IIII", raw,
                                                     off + 8)
        if rptr + rsize > len(raw):
            raise CorruptError(f"pe: section {name} outside file")
        take = min(rsize, vsize) if vsize else rsize
        files[name or f"sect{k}"] = raw[rptr:rptr + take]
    return files


# ----------------------------------------------------------------- elf ---

def is_elf(raw: bytes) -> bool:
    return raw[:4] == b"\x7fELF"


def read_elf(raw: bytes) -> dict:
    """Allocated sections as members named by the .shstrtab entry
    (ElfHandler.cpp)."""
    if not is_elf(raw):
        raise CorruptError("elf: bad magic")
    is64 = raw[4] == 2
    le = raw[5] == 1
    e = "<" if le else ">"
    if is64:
        shoff, = struct.unpack_from(e + "Q", raw, 0x28)
        shentsize, shnum, shstrndx = struct.unpack_from(e + "HHH", raw,
                                                        0x3A)
    else:
        shoff, = struct.unpack_from(e + "I", raw, 0x20)
        shentsize, shnum, shstrndx = struct.unpack_from(e + "HHH", raw,
                                                        0x2E)
    if shoff == 0 or shnum == 0:
        raise CorruptError("elf: no section headers")

    def sh(idx):
        off = shoff + idx * shentsize
        if is64:
            name, stype = struct.unpack_from(e + "II", raw, off)
            soff, ssize = struct.unpack_from(e + "QQ", raw, off + 0x18)
        else:
            name, stype = struct.unpack_from(e + "II", raw, off)
            soff, ssize = struct.unpack_from(e + "II", raw, off + 0x10)
        return name, stype, soff, ssize

    if shoff + shnum * shentsize > len(raw):
        raise CorruptError("elf: section table outside file")
    _, _, stroff, strsize = sh(shstrndx)
    strtab = raw[stroff:stroff + strsize]
    files: dict = {}
    for k in range(shnum):
        name_off, stype, soff, ssize = sh(k)
        if stype in (0, 8):  # NULL, NOBITS
            continue
        end = strtab.find(b"\0", name_off)
        name = strtab[name_off:end if end >= 0 else None].decode(
            "latin-1")
        if soff + ssize > len(raw):
            raise CorruptError(f"elf: section {name} outside file")
        files[name or f"sect{k}"] = raw[soff:soff + ssize]
    return files


# --------------------------------------------------------------- macho ---

_MACHO_MAGICS = {b"\xfe\xed\xfa\xce": (">", False),
                 b"\xce\xfa\xed\xfe": ("<", False),
                 b"\xfe\xed\xfa\xcf": (">", True),
                 b"\xcf\xfa\xed\xfe": ("<", True)}


def is_macho(raw: bytes) -> bool:
    return raw[:4] in _MACHO_MAGICS or raw[:4] == b"\xca\xfe\xba\xbe"


def read_macho(raw: bytes) -> dict:
    """Segments (LC_SEGMENT/LC_SEGMENT_64) as members; fat binaries
    recurse per-architecture (MachoHandler.cpp)."""
    if raw[:4] == b"\xca\xfe\xba\xbe":  # fat
        narch, = struct.unpack_from(">I", raw, 4)
        if narch > 16:
            raise CorruptError("macho: implausible fat arch count")
        files: dict = {}
        for k in range(narch):
            _ct, _cs, off, size, _al = struct.unpack_from(
                ">IIIII", raw, 8 + 20 * k)
            if off + size > len(raw):
                raise CorruptError("macho: fat slice outside file")
            for n, v in read_macho(raw[off:off + size]).items():
                files[f"arch{k}/{n}"] = v
        return files
    if raw[:4] not in _MACHO_MAGICS:
        raise CorruptError("macho: bad magic")
    e, is64 = _MACHO_MAGICS[raw[:4]]
    ncmds, = struct.unpack_from(e + "I", raw, 16)
    pos = 32 if is64 else 28
    files = {}
    for _ in range(ncmds):
        if pos + 8 > len(raw):
            raise CorruptError("macho: truncated load command")
        cmd, cmdsize = struct.unpack_from(e + "II", raw, pos)
        if cmdsize < 8 or pos + cmdsize > len(raw):
            raise CorruptError("macho: bad load command size")
        if cmd == 0x19 and is64:  # LC_SEGMENT_64
            name = raw[pos + 8:pos + 24].rstrip(b"\0").decode("latin-1")
            off, fsize = struct.unpack_from(e + "QQ", raw, pos + 40)
            if fsize:
                if off + fsize > len(raw):
                    raise CorruptError("macho: segment outside file")
                files[name or "seg"] = raw[off:off + fsize]
        elif cmd == 0x1 and not is64:  # LC_SEGMENT
            name = raw[pos + 8:pos + 24].rstrip(b"\0").decode("latin-1")
            off, fsize = struct.unpack_from(e + "II", raw, pos + 32)
            if fsize:
                if off + fsize > len(raw):
                    raise CorruptError("macho: segment outside file")
                files[name or "seg"] = raw[off:off + fsize]
        pos += cmdsize
    return files


# ----------------------------------------------------------------- arj ---

def is_arj(raw: bytes) -> bool:
    return len(raw) >= 4 and raw[:2] == b"\x60\xea"


def read_arj(raw: bytes) -> dict:
    """ARJ archive: header chain walk; method 0 (stored) extraction,
    methods 1-4 rejected with a clear error (ArjHandler.cpp; the
    reference decodes methods 1-4 via its LH-style decoder)."""
    if not is_arj(raw):
        raise CorruptError("arj: bad magic")
    pos = 0
    files: dict = {}
    first = True
    while pos + 4 <= len(raw):
        if raw[pos:pos + 2] != b"\x60\xea":
            raise CorruptError("arj: lost header sync")
        hsize, = struct.unpack_from("<H", raw, pos + 2)
        if hsize == 0:
            break  # end of archive
        hdr = raw[pos + 4:pos + 4 + hsize]
        if len(hdr) != hsize:
            raise CorruptError("arj: truncated header")
        if pos + 4 + hsize + 4 > len(raw):
            raise CorruptError("arj: truncated header CRC")
        crc, = struct.unpack_from("<I", raw, pos + 4 + hsize)
        if zlib.crc32(hdr) != crc:
            raise CorruptError("arj: header CRC mismatch")
        first_hdr_size = hdr[0]
        method = hdr[5]
        csize, osize = struct.unpack_from("<II", hdr, 12)
        name_end = hdr.find(b"\0", first_hdr_size)
        name = hdr[first_hdr_size:name_end if name_end >= 0 else None
                   ].decode("latin-1")
        pos += 4 + hsize + 4
        # extended headers: sequence of (u16 size, data, u32 crc), 0 ends
        while True:
            if pos + 2 > len(raw):
                raise CorruptError("arj: truncated extended header")
            esize, = struct.unpack_from("<H", raw, pos)
            pos += 2
            if esize == 0:
                break
            pos += esize + 4
            if pos > len(raw):
                raise CorruptError("arj: truncated extended header")
        if not first:
            body = raw[pos:pos + csize]
            if len(body) != csize:
                raise CorruptError("arj: truncated member data")
            if method == 0:
                files[name] = body
            else:
                raise CorruptError(
                    f"arj: compression method {method} not supported "
                    "(store-only reader)")
            pos += csize
        first = False
    return files


def write_arj(files: dict) -> bytes:
    """Store-mode ARJ writer (superset; the reference is read-only)."""
    import time as _t
    out = bytearray()

    def header(name: bytes, csize: int, osize: int, is_main: bool):
        fh = bytearray(34)
        fh[0] = 34           # first header size
        fh[1] = 11           # archiver version
        fh[2] = 1            # min version to extract
        fh[3] = 0            # host OS
        fh[4] = 0            # flags
        fh[5] = 0 if not is_main else 2   # method / security
        fh[6] = 0            # file type
        struct.pack_into("<I", fh, 8, int(_t.time()) & 0x7FFFFFFF)
        struct.pack_into("<II", fh, 12, csize, osize)
        hdr = bytes(fh) + name + b"\0" + b"\0"  # name + comment
        out.extend(b"\x60\xea" + struct.pack("<H", len(hdr)) + hdr
                   + struct.pack("<I", zlib.crc32(hdr))
                   + b"\x00\x00")  # no extended headers
    header(b"archive.arj", 0, 0, True)
    for name, data in files.items():
        header(name.encode("latin-1"), len(data), len(data), False)
        out.extend(data)
    out.extend(b"\x60\xea\x00\x00")
    return bytes(out)
