"""NSIS installer reader.

A copy of tpu7z/containers/nsis.py, on the host: the same bytes, lines
and errors from the same input.

Behavioral reference: CPP/7zip/Archive/Nsis/NsisIn.cpp — firstheader
scan at 512-byte steps (0xDEADBEEF + "NullsoftInst"), the
solid/non-solid × lzma/bzip2/deflate/zstd stream-shape detection table
(NsisIn.cpp:5777-5820), block extraction, and entry/name recovery:
the install header's block-header table (Parse:5178) is walked for
EW_EXTRACTFILE/EW_CREATEDIR commands (ReadEntries:3482,3388) with the
ANSI/Unicode string table decoded through the NSIS-2 (0xFC..0xFE) and
NSIS-3 (1..4) escape codes, so members get their real paths (under
$INSTDIR-style prefixes); blocks no entry references keep data_NNNN
names. Remaining gaps: 64-bit block headers and NSIS-flavored bzip2.
"""

from __future__ import annotations

import struct

from ..utils.errors import CorruptError, UnsupportedError

_MAGIC = b"\xef\xbe\xad\xdeNullsoftInst"
_COMPRESSED = 0x80000000


def find_firstheader(raw: bytes):
    for off in range(0, max(len(raw) - 28, 0) + 1, 512):
        if raw[off + 4:off + 20] == _MAGIC:
            flags, = struct.unpack_from("<I", raw, off)
            hdr_size, arc_size = struct.unpack_from("<II", raw,
                                                    off + 20)
            return {"offset": off, "flags": flags,
                    "header_size": hdr_size, "arc_size": arc_size,
                    "data_offset": off + 28}
    return None


def is_nsis(raw: bytes) -> bool:
    return find_firstheader(raw) is not None


def _is_lzma(p: bytes):
    """(is_lzma, filter_flag_present) — NsisIn.cpp IsLZMA."""
    def plain(q):
        return (len(q) >= 7 and q[0] == 0x5D and q[1] == 0 and
                q[2] == 0 and q[5] == 0 and not q[6] & 0x80)
    if plain(p):
        return True, False
    if p and p[0] <= 1 and plain(p[1:]):
        return True, True
    return False, False


def _decompress(method: str, data: bytes, out_size=None) -> bytes:
    if method == "lzma":
        flt, props_off = ((True, 1) if data and data[0] <= 1 and
                          data[1:2] == b"\x5d" else (False, 0))
        if flt and data[0] == 1:
            raise UnsupportedError("nsis: BCJ-filtered LZMA stream")
        props = data[props_off:props_off + 5]
        from ..models.lzma import decoder
        if out_size is not None:
            return decoder.decompress_raw(data[props_off + 5:], props,
                                          out_size)
        # solid stream of unknown total size: end-marker terminated
        lc, lp, pb = decoder.parse_props_byte(props[0])
        dec = decoder.LzmaDecoder(lc, lp, pb, 1 << 16)
        dec.decode_chunk(data[props_off + 5:], None,
                         expect_end_marker=True)
        return dec.out[:dec.pos].tobytes()
    if method == "deflate":
        from ..models import deflate
        return deflate.decompress(data, max_out=out_size)
    if method == "zstd":
        from ..models.zstd import frame
        return frame.decompress(data)
    raise UnsupportedError(f"nsis: {method} streams not supported")


def _detect(sig: bytes, header_size: int):
    """(method, solid) per the NsisIn.cpp:5777 shape table."""
    csize, = struct.unpack_from("<I", sig, 0)
    if csize == header_size:
        return "copy", False
    if _is_lzma(sig)[0]:
        return "lzma", True
    if sig[3] == 0x80:
        if _is_lzma(sig[4:])[0]:
            return "lzma", False
        if sig[4] == 0x31 and sig[5] < 14:
            return "bzip2", False
        if sig[4:8] == b"\x28\xb5\x2f\xfd":
            return "zstd", False
        return "deflate", False
    if sig[0] == 0x31 and sig[1] < 14:
        return "bzip2", True
    if sig[:4] == b"\x28\xb5\x2f\xfd":
        return "zstd", True
    return "deflate", True


# kVarStrings (NsisIn.cpp:568): named variables from index 20 up
_VAR_NAMES = ("CMDLINE", "INSTDIR", "OUTDIR", "EXEDIR", "LANGUAGE",
              "TEMP", "PLUGINSDIR", "EXEPATH", "EXEFILE", "HWNDPARENT",
              "_CLICK", "_OUTDIR")
EW_CREATEDIR = 11
EW_EXTRACTFILE = 20
_CMD_SIZE = 28  # u32 opcode + 6 u32 params (NsisIn.cpp kCmdSize)


def _var_name(n: int) -> str:
    if n < 10:
        return f"${n}"
    if n < 20:
        return f"$R{n - 10}"
    if n - 20 < len(_VAR_NAMES):
        return "$" + _VAR_NAMES[n - 20]
    return f"$__var{n}__"


class _Strings:
    """NSIS string table reader: ANSI/Unicode with the NSIS-3 escape
    codes (1 LANG, 2 SHELL, 3 VAR, 4 SKIP at the low end) and the
    NSIS-2 codes (0xFC skip, 0xFD var, 0xFE shell at the high end) —
    NsisIn.cpp:647-665, GetNsisString_Raw:840."""

    def __init__(self, data: bytes, unicode_: bool):
        self.data = data
        self.unicode = unicode_

    def _chars(self, idx: int):
        d = self.data
        if self.unicode:
            p = 2 * idx
            while p + 2 <= len(d):
                c, = struct.unpack_from("<H", d, p)
                p += 2
                if c == 0:
                    return
                yield c
        else:
            p = idx
            while p < len(d):
                c = d[p]
                p += 1
                if c == 0:
                    return
                yield c

    def read(self, idx: int) -> str:
        out = []
        it = self._chars(idx)
        for c in it:
            if (not self.unicode and c <= 4) or \
                    (self.unicode and c <= 4):
                code = c
                c0 = next(it, 0)
                if c0 == 0:
                    break
                if code == 4:  # SKIP
                    out.append(chr(c0 & 0xFF))
                    continue
                if self.unicode:
                    n = (c0 & 0x7F) | (((c0 >> 8) & 0x7F) << 7)
                else:
                    c1 = next(it, 0)
                    if c1 == 0:
                        break
                    n = (c0 & 0x7F) | ((c1 & 0x7F) << 7)
                if code == 3:  # VAR
                    out.append(_var_name(n))
                elif code == 2:  # SHELL
                    out.append("$SHELL")
                else:  # LANG
                    out.append(f"$(LSTR_{n})")
                continue
            if not self.unicode and c >= 0xFC:
                code = c
                c0 = next(it, 0)
                if c0 == 0:
                    break
                if code == 0xFC:  # NS_CODE_SKIP
                    out.append(chr(c0))
                    continue
                c1 = next(it, 0)
                if c1 == 0:
                    break
                n = (c0 & 0x7F) | ((c1 & 0x7F) << 7)
                if code == 0xFD:
                    out.append(_var_name(n))
                elif code == 0xFE:
                    out.append("$SHELL")
                else:
                    out.append(f"$(LSTR_{n})")
                continue
            out.append(chr(c))
        return "".join(out)


def parse_entries(header: bytes):
    """Walk the install header's entries table, recovering extract-file
    names and SetOutPath prefixes (NsisIn.cpp Parse:5178 block-header
    table, ReadEntries EW_EXTRACTFILE:3482 / EW_CREATEDIR:3388).
    Returns [(name, data_pos, mtime_filetime)] or None when the header
    doesn't carry a recognizable layout (32-bit block headers only)."""
    if len(header) < 4 + 8 * 8:
        return None
    entries_off, entries_num = struct.unpack_from("<II", header, 4 + 8 * 2)
    strings_off, _snum = struct.unpack_from("<II", header, 4 + 8 * 3)
    lang_off, _lnum = struct.unpack_from("<II", header, 4 + 8 * 4)
    if not (strings_off < lang_off <= len(header)):
        return None
    if entries_off > len(header) or \
            entries_off + entries_num * _CMD_SIZE > len(header):
        return None
    if entries_num == 0 or entries_num > (1 << 22):
        return None
    sdata = header[strings_off:lang_off]
    if len(sdata) < 2 or sdata[-1] != 0:
        return None
    unicode_ = sdata[0] == 0 and sdata[1] == 0
    strings = _Strings(sdata, unicode_)

    items = []
    prefix = ""
    p = entries_off
    for _ in range(entries_num):
        op, = struct.unpack_from("<I", header, p)
        params = struct.unpack_from("<6I", header, p + 4)
        p += _CMD_SIZE
        if op == EW_CREATEDIR and params[1] != 0:  # SetOutPath
            prefix = strings.read(params[0])
        elif op == EW_EXTRACTFILE:
            name = strings.read(params[1])
            if prefix and not name.startswith(("$", "/", "\\")):
                name = prefix.rstrip("\\/") + "/" + name
            mtime = params[3] | (params[4] << 32)
            items.append((name.replace("\\", "/"), params[2], mtime))
    return items or None


def read_nsis(raw: bytes) -> dict:
    fh = find_firstheader(raw)
    if fh is None:
        raise CorruptError("nsis: no firstheader found")
    dpos = fh["data_offset"]
    sig = raw[dpos:dpos + 12]
    if len(sig) < 12:
        raise CorruptError("nsis: truncated data stream")
    method, solid = _detect(sig, fh["header_size"])
    blocks: dict = {}  # item.Pos -> bytes (EW_EXTRACTFILE addressing)
    if solid:
        blob = _decompress(method, raw[dpos:fh["offset"]
                                       + fh["arc_size"] or None])
        # solid stream layout: u32 header-block size, header, then
        # members each as u32 size + data; item.Pos is relative to
        # 4 + header_size (NsisIn.h:387 GetPosOfSolidItem)
        if len(blob) < 4:
            raise CorruptError("nsis: solid stream too short")
        hsz, = struct.unpack_from("<I", blob, 0)
        hsz &= ~_COMPRESSED
        if hsz != fh["header_size"]:
            raise CorruptError("nsis: solid header size mismatch")
        header = blob[4:4 + hsz]
        base = 4 + hsz
        pos = base
        while pos + 4 <= len(blob):
            size, = struct.unpack_from("<I", blob, pos)
            size &= ~_COMPRESSED  # solid: already decompressed
            body = blob[pos + 4:pos + 4 + size]
            if len(body) != size:
                raise CorruptError("nsis: truncated solid member")
            blocks[pos - base] = body
            pos += 4 + size
    else:
        # non-solid: header block first, then independent blocks;
        # item.Pos is relative to the first member's size word
        # (NsisIn.h:393 GetPosOfNonSolidItem: data + 4 + Pos)
        chs, = struct.unpack_from("<I", raw, dpos)
        compressed = bool(chs & _COMPRESSED)
        chs &= ~_COMPRESSED
        hdr_raw = raw[dpos + 4:dpos + 4 + chs]
        if len(hdr_raw) != chs:
            raise CorruptError("nsis: truncated header block")
        header = _decompress(method, hdr_raw, fh["header_size"]) \
            if compressed else hdr_raw
        if len(header) != fh["header_size"]:
            raise CorruptError("nsis: header size mismatch")
        pos = dpos + 4 + chs
        end = fh["offset"] + fh["arc_size"]
        while pos + 4 <= min(end, len(raw)):
            size, = struct.unpack_from("<I", raw, pos)
            comp = bool(size & _COMPRESSED)
            size &= ~_COMPRESSED
            body = raw[pos + 4:pos + 4 + size]
            if len(body) != size:
                raise CorruptError("nsis: truncated member block")
            blocks[pos - (dpos + 4)] = _decompress(method, body) \
                if comp else body
            pos += 4 + size

    files: dict = {"[NSIS].nsi-header": header}
    items = parse_entries(header)
    used = set()
    if items:
        for name, ipos, _mtime in items:
            if ipos in blocks and name:
                base_name = name
                k = 1
                while name in files:  # same target written twice
                    name = f"{base_name}.{k}"
                    k += 1
                files[name] = blocks[ipos]
                used.add(ipos)
    for idx, (bpos, body) in enumerate(sorted(blocks.items())):
        if bpos not in used:
            files[f"data_{idx:04d}.bin"] = body
    return files
