"""CAB (Microsoft Cabinet) container: reader + writer (store / MSZIP).

A copy of tpu7z/containers/cab.py: the same bytes and errors from the
same input. MSZIP is the card's part: every 32 KiB chunk of the folder a
row of one deflate parse (`deflate.compress_streams`, one `sort_rows`
launch a cabinet), every stream packed in one pass; LZX and the reader
run on the host.

Behavioral reference: CPP/7zip/Archive/Cab/ (CabIn.cpp
structure parsing, CabHandler.cpp extraction) and the published MS-CAB
layout:

  CFHEADER: "MSCF" u32 reserved1 | cbCabinet u32 | reserved2 |
            coffFiles u32 | reserved3 | verMinor(3) verMajor(1) |
            cFolders u16 | cFiles u16 | flags u16 | setID u16 |
            iCabinet u16
  CFFOLDER: coffCabStart u32 | cCFData u16 | typeCompress u16
  CFFILE:   cbFile u32 | uoffFolderStart u32 | iFolder u16 |
            date u16 | time u16 | attribs u16 | name asciiz
  CFDATA:   csum u32 | cbData u16 | cbUncomp u16 | bytes

MSZIP (typeCompress 1): each CFDATA holds "CK" + a deflate stream over
<= 32 KiB of folder data; the LZ77 window persists across CFDATA blocks
of a folder (the writer emits independent streams, a valid subset; the
reader primes the inflate window with prior blocks).
"""

from __future__ import annotations

import struct

from ..models.deflate import codec as deflate
from ..utils.errors import CorruptError, UnsupportedError

MAGIC = b"MSCF"
COMP_NONE = 0
COMP_MSZIP = 1
COMP_LZX = 3
CFDATA_MAX = 32768


def _csum(data: bytes, seed: int = 0) -> int:
    """CFDATA checksum (cabinet SDK CSUMCompute)."""
    s = seed
    n = len(data) // 4
    for i in range(n):
        s ^= struct.unpack_from("<I", data, i * 4)[0]
    rem = data[n * 4:]
    ul = 0
    if len(rem) == 3:
        ul = (rem[0] << 16) | (rem[1] << 8) | rem[2]
    elif len(rem) == 2:
        ul = (rem[0] << 8) | rem[1]
    elif len(rem) == 1:
        ul = rem[0]
    return (s ^ ul) & 0xFFFFFFFF


def write_cab(files: dict[str, bytes],
              compression: str = "mszip", device=None) -> bytes:
    """Single-folder cabinet; compression 'none', 'mszip' or 'lzx'.
    MSZIP's parse, histograms and bit packing run on `device` (the CUDA
    card unless it names the CPU), all the chunks at once."""
    comp = {"mszip": COMP_MSZIP, "lzx": COMP_LZX}.get(compression,
                                                      COMP_NONE)
    names = list(files)
    blob = b"".join(files[n] for n in names)

    lzx_wbits = 16
    rawtype = comp | (lzx_wbits << 8) if comp == COMP_LZX else comp
    # CFDATA blocks (a deflate stream over a 32 KiB chunk stays well
    # under the u16 cbData limit even on incompressible data)
    datas = []
    first = True
    prev_trees = {"main": None, "len": None}
    chunks = [blob[off:off + CFDATA_MAX] for off in range(0, max(len(blob), 1), CFDATA_MAX)]
    if comp == COMP_MSZIP:
        streams = iter(deflate.compress_streams(chunks, device=device))
    for chunk in chunks:
        if comp == COMP_MSZIP:
            payload = b"CK" + next(streams)
        elif comp == COMP_LZX:
            from ..models import lzx as lzxm
            lens = {}
            payload = lzxm.encode_frame(
                chunk, lzx_wbits, write_header=first,
                prev_main=prev_trees["main"],
                prev_len=prev_trees["len"], out_lens=lens)
            prev_trees = lens
            if len(payload) % 2:
                payload += b"\0"
        else:
            payload = chunk
        first = False
        if len(payload) > 0xFFFF:
            raise UnsupportedError("cab: CFDATA payload overflow")
        datas.append((payload, len(chunk)))

    cffile = bytearray()
    uoff = 0
    for n in names:
        name_b = n.replace("/", "\\").encode("utf-8")
        cffile += struct.pack("<IIHHHH", len(files[n]), uoff, 0,
                              0x226C, 0x59BA, 0x20)  # date/time/arch bit
        cffile += name_b + b"\x00"
        uoff += len(files[n])

    hdr_len = 36
    folder_len = 8
    coff_files = hdr_len + folder_len
    coff_data = coff_files + len(cffile)

    cfdata = bytearray()
    for payload, un in datas:
        hdr = struct.pack("<HH", len(payload), un)
        cs = _csum(payload, _csum(hdr))
        cfdata += struct.pack("<IHH", cs, len(payload), un) + payload

    total = coff_data + len(cfdata)
    out = bytearray()
    out += MAGIC + struct.pack("<IIIII", 0, total, 0, coff_files, 0)
    out += struct.pack("<BBHHHHH", 3, 1, 1, len(names), 0, 0x1234, 0)
    out += struct.pack("<IHH", coff_data, len(datas), rawtype)
    out += cffile
    out += cfdata
    return bytes(out)


def read_cab(data: bytes) -> dict[str, bytes]:
    if len(data) < 36 or data[:4] != MAGIC:
        raise CorruptError("cab: bad magic")
    (res1, cb, res2, coff_files, res3) = struct.unpack_from("<IIIII", data, 4)
    ver_min, ver_maj, nfolders, nfiles, flags, set_id, icab = \
        struct.unpack_from("<BBHHHHH", data, 24)
    if ver_maj != 1:
        raise UnsupportedError(f"cab: version {ver_maj}.{ver_min}")
    if flags & 0x0004:  # reserve fields present
        raise UnsupportedError("cab: reserved-area cabinets")
    if flags & 0x0003:
        raise UnsupportedError("cab: multi-cabinet sets")

    pos = 36
    folders = []
    for _ in range(nfolders):
        coff, ndata, ctype = struct.unpack_from("<IHH", data, pos)
        folders.append((coff, ndata, ctype))
        pos += 8

    pos = coff_files
    entries = []
    for _ in range(nfiles):
        cbfile, uoff, ifolder, _d, _t, _a = struct.unpack_from(
            "<IIHHHH", data, pos)
        pos += 16
        end = data.index(b"\x00", pos)
        name = data[pos:end].decode("utf-8", "replace").replace("\\", "/")
        pos = end + 1
        entries.append((name, cbfile, uoff, ifolder))

    # decode each folder's data stream
    folder_blobs = []
    for coff, ndata, rawtype in folders:
        ctype = rawtype & 0xF
        if ctype not in (COMP_NONE, COMP_MSZIP, COMP_LZX):
            raise UnsupportedError(f"cab: compression type {ctype}"
                                   " (Quantum not implemented)")
        lzx_state = None
        lzx_out = None
        if ctype == COMP_LZX:
            # window bits live in typeCompress bits 8-12
            # (CabIn.cpp folder parse; LZX per-CFDATA 32KB frames with
            # history kept across the folder)
            from ..models import lzx as lzxm
            wbits = (rawtype >> 8) & 0x1F
            lzx_state = lzxm.State(wbits)
            lzx_out = bytearray()
        p = coff
        blob = bytearray()
        for _ in range(ndata):
            if p + 8 > len(data):
                raise CorruptError("cab: truncated CFDATA")
            _cs, cbd, cbu = struct.unpack_from("<IHH", data, p)
            p += 8
            payload = data[p:p + cbd]
            if len(payload) != cbd:
                raise CorruptError("cab: truncated CFDATA payload")
            p += cbd
            if ctype == COMP_NONE:
                if len(payload) != cbu:
                    raise CorruptError("cab: stored size mismatch")
                blob += payload
            elif ctype == COMP_LZX:
                from ..models import lzx as lzxm
                start = len(lzx_out)
                lzxm.decode_frame(lzx_state, payload, lzx_out, cbu)
                lzxm._e8_filter(lzx_out, start, cbu,
                                lzx_state.e8_size)
                blob += lzx_out[start:start + cbu]
            else:
                if payload[:2] != b"CK":
                    raise CorruptError("cab: bad MSZIP signature")
                hist = bytes(blob[-32768:])
                dec = deflate.decompress(payload[2:],
                                         max_out=cbu + len(hist),
                                         history=hist)
                if len(dec) != cbu:
                    raise CorruptError("cab: MSZIP size mismatch")
                blob += dec
        folder_blobs.append(bytes(blob))

    out = {}
    for name, cbfile, uoff, ifolder in entries:
        if ifolder >= len(folder_blobs):
            raise CorruptError("cab: bad folder index")
        fb = folder_blobs[ifolder]
        if uoff + cbfile > len(fb):
            raise CorruptError("cab: file data out of range")
        out[name] = fb[uoff:uoff + cbfile]
    return out
