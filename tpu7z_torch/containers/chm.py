"""CHM (ITSF / HTML Help) container: reader + writer.

A copy of tpu7z/containers/chm.py, on the host: the same bytes, lines and
errors from the same input.

Behavioral reference: CPP/7zip/Archive/Chm/ChmIn.cpp (ITSF header,
ITSP directory, PMGL chunks with 7-bit big-endian varints, the
::DataSpace/Storage/MSCompressed section with LZXC ControlData and
ResetTable) and ChmHandler.cpp (LZX block extraction loop). The writer
is a superset — the reference is read-only — emitting a v3 ITSF with
one LZXC-compressed section that the reference can extract.
"""

from __future__ import annotations

import struct

from ..models import lzx
from ..utils.errors import CorruptError

_GUID1 = bytes.fromhex("10fd017caa7bd0119e0c00a0c922e6ec")
_GUID2 = bytes.fromhex("11fd017caa7bd0119e0c00a0c922e6ec")
_CONTENT = "::DataSpace/Storage/MSCompressed/Content"
_CONTROL = "::DataSpace/Storage/MSCompressed/ControlData"
_SPANINFO = "::DataSpace/Storage/MSCompressed/SpanInfo"
_RESETTABLE = ("::DataSpace/Storage/MSCompressed/Transform/"
               "{7FC28940-9D31-11D0-9B27-00A0C91E9C7C}/"
               "InstanceData/ResetTable")
_CHUNK = 0x1000


def is_chm(raw: bytes) -> bool:
    return raw[:4] == b"ITSF"


def _enc_read(data: bytes, pos: int):
    """7-bit big-endian varint (ChmIn.cpp ReadEncInt)."""
    v = 0
    for _ in range(9):
        if pos >= len(data):
            raise CorruptError("chm: truncated varint")
        b = data[pos]
        pos += 1
        v = (v << 7) | (b & 0x7F)
        if not b & 0x80:
            return v, pos
    raise CorruptError("chm: varint too long")


def _enc(v: int) -> bytes:
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    return bytes(reversed(out))


def _parse_directory(raw: bytes, dir_off: int, dir_len: int):
    if raw[dir_off:dir_off + 4] != b"ITSP":
        raise CorruptError("chm: missing ITSP directory header")
    hdr_len, = struct.unpack_from("<I", raw, dir_off + 8)
    num_blocks, = struct.unpack_from("<I", raw, dir_off + 0x2C)
    if num_blocks > (dir_len // _CHUNK) + 1:
        raise CorruptError("chm: directory block count outside section")
    entries = []
    for b in range(num_blocks):
        coff = dir_off + hdr_len + b * _CHUNK
        chunk = raw[coff:coff + _CHUNK]
        if chunk[:4] != b"PMGL":
            continue  # PMGI index chunks are for seek only
        quickref, = struct.unpack_from("<I", chunk, 4)
        pos = 20
        end = _CHUNK - quickref
        while pos < end:
            try:
                nlen, pos = _enc_read(chunk, pos)
            except CorruptError:
                break
            if nlen == 0 or pos + nlen > end:
                break
            name = chunk[pos:pos + nlen].decode("utf-8", "replace")
            pos += nlen
            section, pos = _enc_read(chunk, pos)
            offset, pos = _enc_read(chunk, pos)
            length, pos = _enc_read(chunk, pos)
            entries.append((name, section, offset, length))
    return entries


def read_chm(raw: bytes) -> dict:
    """All member files keyed by path. Section-1 content is LZX
    decoded per the LZXC ControlData/ResetTable protocol."""
    if not is_chm(raw):
        raise CorruptError("chm: bad ITSF signature")
    version, hdr_len = struct.unpack_from("<II", raw, 4)
    # header section table (2 x u64 offset/length pairs) after 2 GUIDs
    _s0_off, _s0_len, dir_off, dir_len = struct.unpack_from(
        "<QQQQ", raw, 0x38)
    if version >= 3:
        content_off, = struct.unpack_from("<Q", raw, 0x58)
    else:
        content_off = hdr_len
    entries = _parse_directory(raw, dir_off, dir_len)

    def sect0(off, length):
        p = content_off + off
        if p + length > len(raw):
            raise CorruptError("chm: section-0 entry outside file")
        return raw[p:p + length]

    sysfiles = {n: (s, o, l) for n, s, o, l in entries}
    section1 = None
    if _CONTENT in sysfiles:
        s, o, l = sysfiles[_CONTENT]
        blob = sect0(o, l)
        cs, co, cl = sysfiles.get(_CONTROL, (0, 0, 0))
        ctrl = sect0(co, cl)
        if len(ctrl) < 28 or ctrl[4:8] != b"LZXC":
            raise CorruptError("chm: missing LZXC control data")
        cver, reset_iv, wsize, _cache = struct.unpack_from("<IIII",
                                                           ctrl, 8)
        if cver == 2:
            reset_iv *= lzx.FRAME
            wsize *= lzx.FRAME
        wbits = wsize.bit_length() - 1
        rs, ro, rl = sysfiles.get(_RESETTABLE, (0, 0, 0))
        rt = sect0(ro, rl)
        if len(rt) < 0x28:
            raise CorruptError("chm: missing LZX reset table")
        nentries, = struct.unpack_from("<I", rt, 4)
        table_off, = struct.unpack_from("<I", rt, 12)
        total, = struct.unpack_from("<Q", rt, 16)
        offsets = [struct.unpack_from("<Q", rt, table_off + 8 * k)[0]
                   for k in range(nentries)]
        section1 = lzx.decode_frames(blob, offsets, wbits, reset_iv,
                                     total)

    files: dict = {}
    for name, section, offset, length in entries:
        if name.startswith("::") or name.startswith("/#") or \
                name.startswith("/$") or name == "/":
            continue
        if section == 0:
            files[name.lstrip("/")] = sect0(offset, length)
        elif section == 1:
            if section1 is None:
                raise CorruptError("chm: entry in missing section 1")
            if offset + length > len(section1):
                raise CorruptError("chm: entry outside section 1")
            files[name.lstrip("/")] = section1[offset:offset + length]
    return files


def write_chm(files: dict) -> bytes:
    """v3 ITSF with all content in one LZXC section (window 64KB,
    reset every frame) — readable by the reference handler."""
    # section 1: concatenated member contents
    sec1 = bytearray()
    members = []
    for name, data in files.items():
        members.append(("/" + name.lstrip("/"), 1, len(sec1),
                        len(data)))
        sec1.extend(data)
    # the reference decodes every reset block at the full 32KB frame
    # size ("chm writes full blocks", ChmHandler.cpp:701) — pad the
    # section; SpanInfo/ResetTable carry the true length
    padded = bytes(sec1)
    if len(padded) % lzx.FRAME:
        padded += b"\0" * (lzx.FRAME - len(padded) % lzx.FRAME)
    comp, offsets = lzx.encode_frames(padded, 16)

    # section-0 system files
    ctrl = struct.pack("<I4sIIIII", 6, b"LZXC", 2, 1, 2, 0, 0)
    nframes = len(offsets)
    rt = struct.pack("<IIII", 2, nframes, 8, 0x28)
    rt += struct.pack("<QQQ", len(sec1), len(comp), lzx.FRAME)
    rt += b"".join(struct.pack("<Q", o) for o in offsets)
    span = struct.pack("<Q", len(sec1))
    namelist = _mk_namelist()

    sys_entries = [
        ("::DataSpace/NameList", namelist),
        (_CONTROL, ctrl),
        (_SPANINFO, span),
        (_RESETTABLE, rt),
        (_CONTENT, comp),
    ]
    sec0 = bytearray()
    entries = list(members)
    for name, data in sys_entries:
        entries.append((name, 0, len(sec0), len(data)))
        sec0.extend(data)

    # directory: PMGL chunks
    entries.sort(key=lambda e: e[0].lower())
    chunks = []
    cur = bytearray()
    for name, sect, off, length in entries:
        nb = name.encode("utf-8")
        e = _enc(len(nb)) + nb + _enc(sect) + _enc(off) + _enc(length)
        if 20 + len(cur) + len(e) + 2 > _CHUNK:
            chunks.append(bytes(cur))
            cur = bytearray()
        cur.extend(e)
    chunks.append(bytes(cur))

    dirblocks = bytearray()
    for i, body in enumerate(chunks):
        ch = bytearray(_CHUNK)
        ch[0:4] = b"PMGL"
        struct.pack_into("<I", ch, 4, _CHUNK - 20 - len(body))
        struct.pack_into("<i", ch, 12, i - 1)
        struct.pack_into("<i", ch, 16, i + 1 if i + 1 < len(chunks)
                         else -1)
        ch[20:20 + len(body)] = body
        dirblocks.extend(ch)

    itsp = bytearray(0x54)
    itsp[0:4] = b"ITSP"
    struct.pack_into("<III", itsp, 4, 1, 0x54, 0x0A)
    struct.pack_into("<I", itsp, 16, _CHUNK)      # block length
    struct.pack_into("<II", itsp, 20, 2, 1)       # density, depth
    struct.pack_into("<i", itsp, 28, -1)          # root index chunk
    struct.pack_into("<II", itsp, 32, 0, len(chunks) - 1)
    struct.pack_into("<i", itsp, 40, -1)
    struct.pack_into("<I", itsp, 44, len(chunks))
    directory = bytes(itsp) + bytes(dirblocks)

    hdr_len = 0x60
    s0 = struct.pack("<IIQII", 0x01FE, 0, 0, 0, 0)  # size patched below
    dir_off = hdr_len + len(s0)
    content_off = dir_off + len(directory)
    total_size = content_off + len(sec0)
    s0 = struct.pack("<IIQII", 0x01FE, 0, total_size, 0, 0)

    hdr = bytearray(hdr_len)
    hdr[0:4] = b"ITSF"
    struct.pack_into("<IIIII", hdr, 4, 3, hdr_len, 1, 0, 0x409)
    hdr[0x18:0x28] = _GUID1
    hdr[0x28:0x38] = _GUID2
    struct.pack_into("<QQQQ", hdr, 0x38,
                     hdr_len, len(s0), dir_off, len(directory))
    struct.pack_into("<Q", hdr, 0x58, content_off)
    return bytes(hdr) + s0 + directory + bytes(sec0)


def _mk_namelist() -> bytes:
    """::DataSpace/NameList: UTF-16 section names (ChmIn.cpp)."""
    names = ["Uncompressed", "MSCompressed"]
    body = b""
    for n in names:
        enc = n.encode("utf-16-le")
        body += struct.pack("<H", len(n)) + enc + b"\0\0"
    total = (4 + len(body)) // 2
    return struct.pack("<HH", total, len(names)) + body
