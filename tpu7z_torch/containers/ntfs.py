"""NTFS filesystem image reader.

A copy of tpu7z/containers/ntfs.py, on the host: the same bytes, lines
and errors from the same input.

Behavioral reference: CPP/7zip/Archive/NtfsHandler.cpp — walks the MFT,
applies update-sequence fixups to FILE records, reconstructs full paths
from $FILE_NAME parent references, and extracts $DATA: resident values,
non-resident run lists (sparse runs read as zeros), and
LZNT1-compressed attributes (16-cluster compression units padded by
sparse runs).
"""

from __future__ import annotations

import struct

from ..utils.errors import CorruptError


def is_ntfs(raw: bytes) -> bool:
    return len(raw) > 512 and raw[3:11] == b"NTFS    " and \
        raw[510:512] == b"\x55\xaa"


def _fixup(rec: bytes, sector: int) -> bytes:
    """Apply the update sequence array (multi-sector transfer
    protection) to a FILE/INDX record."""
    usa_off, usa_count = struct.unpack_from("<HH", rec, 4)
    if usa_count < 2 or usa_off + 2 * usa_count > len(rec):
        raise CorruptError("ntfs: bad update sequence header")
    usn = rec[usa_off:usa_off + 2]
    out = bytearray(rec)
    for k in range(1, usa_count):
        pos = k * sector - 2
        if pos + 2 > len(rec):
            break
        if out[pos:pos + 2] != usn:
            raise CorruptError("ntfs: fixup mismatch (torn record)")
        out[pos:pos + 2] = rec[usa_off + 2 * k:usa_off + 2 * k + 2]
    return bytes(out)


def lznt1_decompress(src: bytes, out_size: int | None = None) -> bytes:
    """LZNT1 (MS-XCA 2.5): 4 KiB chunks, u16 chunk headers, flag-byte
    token groups, position-dependent offset/length split — the codec
    behind NTFS compressed attributes (NtfsHandler.cpp decompression)."""
    out = bytearray()
    pos = 0
    n = len(src)
    while pos + 2 <= n:
        hdr, = struct.unpack_from("<H", src, pos)
        pos += 2
        if hdr == 0:
            break
        csize = (hdr & 0xFFF) + 1
        compressed = bool(hdr & 0x8000)
        chunk = src[pos:pos + csize]
        if len(chunk) != csize:
            raise CorruptError("ntfs: truncated LZNT1 chunk")
        pos += csize
        if not compressed:
            out.extend(chunk)
            continue
        base = len(out)
        p = 0
        while p < csize:
            flags = chunk[p]
            p += 1
            for bit in range(8):
                if p >= csize:
                    break
                if not (flags >> bit) & 1:
                    out.append(chunk[p])
                    p += 1
                    continue
                if p + 2 > csize:
                    raise CorruptError("ntfs: truncated LZNT1 phrase")
                tok, = struct.unpack_from("<H", chunk, p)
                p += 2
                cpos = len(out) - base
                if cpos == 0:
                    raise CorruptError("ntfs: LZNT1 phrase at chunk start")
                k = max(4, (cpos - 1).bit_length())
                length = (tok & ((1 << (16 - k)) - 1)) + 3
                disp = (tok >> (16 - k)) + 1
                if disp > cpos:
                    raise CorruptError("ntfs: LZNT1 displacement")
                s = len(out) - disp
                for i in range(length):
                    out.append(out[s + i])
    if out_size is not None:
        if len(out) > out_size:
            out = out[:out_size]
        else:
            out.extend(b"\0" * (out_size - len(out)))
    return bytes(out)


def lznt1_compress(data: bytes) -> bytes:
    """Greedy LZNT1 compressor (fixture/superset use; the reference
    only decompresses). Emits compressed chunks when they win."""
    out = bytearray()
    for c0 in range(0, len(data), 4096):
        chunk = data[c0:c0 + 4096]
        body = bytearray()
        i = 0
        while i < len(chunk):
            flags = 0
            group = bytearray()
            for bit in range(8):
                if i >= len(chunk):
                    break
                k = max(4, (i - 1).bit_length()) if i else 4
                maxlen = (1 << (16 - k)) - 1 + 3
                best_l = 0
                best_d = 0
                if i >= 1:
                    lim = min(len(chunk) - i, maxlen)
                    for d in range(1, min(i, (1 << k)) + 1):
                        l = 0
                        while l < lim and chunk[i + l] == chunk[i - d + l]:
                            l += 1
                        if l > best_l:
                            best_l, best_d = l, d
                            if l >= lim:
                                break
                if best_l >= 3:
                    tok = ((best_d - 1) << (16 - k)) | (best_l - 3)
                    group += struct.pack("<H", tok)
                    flags |= 1 << bit
                    i += best_l
                else:
                    group.append(chunk[i])
                    i += 1
            body.append(flags)
            body += group
        if len(body) < len(chunk):
            out += struct.pack("<H", 0x8000 | 0x3000 | (len(body) - 1))
            out += body
        else:
            out += struct.pack("<H", 0x3000 | (len(chunk) - 1))
            out += chunk
    return bytes(out)


def _runlist(data: bytes, ccount_total: int) -> list:
    """Decode a non-resident run list to [(lcn|None, count)] — None
    marks sparse runs."""
    runs = []
    pos = 0
    lcn = 0
    while pos < len(data):
        hdr = data[pos]
        pos += 1
        if hdr == 0:
            break
        lsz, osz = hdr & 0xF, hdr >> 4
        if pos + lsz + osz > len(data):
            raise CorruptError("ntfs: truncated run list")
        count = int.from_bytes(data[pos:pos + lsz], "little")
        pos += lsz
        if osz == 0:
            runs.append((None, count))  # sparse
        else:
            delta = int.from_bytes(data[pos:pos + osz], "little",
                                   signed=True)
            pos += osz
            lcn += delta
            runs.append((lcn, count))
        if sum(c for _, c in runs) > ccount_total + (1 << 20):
            raise CorruptError("ntfs: run list overruns attribute")
    return runs


class _Ntfs:
    def __init__(self, raw: bytes):
        if not is_ntfs(raw):
            raise CorruptError("ntfs: bad boot sector")
        self.raw = raw
        bps, = struct.unpack_from("<H", raw, 11)
        spc = raw[13]
        if bps not in (256, 512, 1024, 2048, 4096) or spc == 0:
            raise CorruptError("ntfs: bad geometry")
        self.bps = bps
        self.cbytes = bps * spc
        mft_lcn, = struct.unpack_from("<Q", raw, 48)
        clus_per_rec = struct.unpack_from("<b", raw, 64)[0]
        self.rec_size = (self.cbytes * clus_per_rec if clus_per_rec > 0
                         else 1 << -clus_per_rec)
        if self.rec_size < 512 or self.rec_size > (64 << 10):
            raise CorruptError("ntfs: bad MFT record size")
        self.mft_off = mft_lcn * self.cbytes
        # read MFT record 0 ($MFT) to get the full MFT run list
        rec0 = self._record_at(self.mft_off)
        attrs = self._attrs(rec0)
        mft_data = None
        for atype, res, body in attrs:
            if atype == 0x80:
                mft_data = (res, body)
        if mft_data is None:
            raise CorruptError("ntfs: $MFT has no $DATA")
        self.mft = self._attr_content(mft_data)

    def _record_at(self, off: int) -> bytes:
        rec = self.raw[off:off + self.rec_size]
        if len(rec) < self.rec_size or rec[:4] != b"FILE":
            raise CorruptError("ntfs: bad FILE record")
        return _fixup(rec, self.bps)

    def _attrs(self, rec: bytes):
        """Yield (type, is_resident, attr_bytes) for each attribute."""
        first, = struct.unpack_from("<H", rec, 20)
        pos = first
        out = []
        while pos + 8 <= len(rec):
            atype, alen = struct.unpack_from("<II", rec, pos)
            if atype == 0xFFFFFFFF:
                break
            if alen < 16 or pos + alen > len(rec):
                raise CorruptError("ntfs: bad attribute length")
            nonres = rec[pos + 8]
            out.append((atype, not nonres, rec[pos:pos + alen]))
            pos += alen
        return out

    def _attr_content(self, item) -> bytes:
        res, a = item
        if res:
            vlen, voff = struct.unpack_from("<IH", a, 16)
            if voff + vlen > len(a):
                raise CorruptError("ntfs: resident value outside attr")
            return a[voff:voff + vlen]
        flags, = struct.unpack_from("<H", a, 12)
        start_vcn, end_vcn = struct.unpack_from("<QQ", a, 16)
        run_off, = struct.unpack_from("<H", a, 32)
        real_size, = struct.unpack_from("<Q", a, 48)
        runs = _runlist(a[run_off:], end_vcn - start_vcn + 1)
        if flags & 0x0001:
            # compressed attribute (NtfsHandler.cpp compressed $DATA):
            # data is stored in compression units of 2^cu clusters; a
            # unit shorter than 2^cu data clusters (padded by a sparse
            # run) holds an LZNT1 stream, a full unit is raw, an
            # all-sparse unit is zeros.
            cu_field, = struct.unpack_from("<H", a, 34)
            cu = 1 << (cu_field if 0 < cu_field < 8 else 4)
            unit_bytes = cu * self.cbytes
            # expand runs to per-cluster lcn list in VCN order
            clusters: list = []
            for lcn, count in runs:
                for k in range(count):
                    clusters.append(None if lcn is None else lcn + k)
            out = bytearray()
            for u0 in range(0, len(clusters), cu):
                unit = clusters[u0:u0 + cu]
                datac = [c for c in unit if c is not None]
                if not datac:
                    out.extend(b"\0" * unit_bytes)
                    continue
                raw = bytearray()
                for c in datac:
                    off = c * self.cbytes
                    if off + self.cbytes > len(self.raw):
                        raise CorruptError("ntfs: run outside image")
                    raw.extend(self.raw[off:off + self.cbytes])
                if len(datac) == len(unit) and len(unit) == cu:
                    out.extend(raw)  # stored uncompressed
                else:
                    out.extend(lznt1_decompress(bytes(raw), unit_bytes))
            return bytes(out[:real_size])
        out = bytearray()
        for lcn, count in runs:
            nb = count * self.cbytes
            if lcn is None:
                out.extend(b"\0" * nb)
            else:
                off = lcn * self.cbytes
                if off + nb > len(self.raw):
                    raise CorruptError("ntfs: run outside image")
                out.extend(self.raw[off:off + nb])
            if len(out) > real_size + self.cbytes:
                break
        return bytes(out[:real_size])

    def records(self):
        n = len(self.mft) // self.rec_size
        for i in range(n):
            rec = self.mft[i * self.rec_size:(i + 1) * self.rec_size]
            if rec[:4] != b"FILE":
                continue
            try:
                yield i, _fixup(rec, self.bps)
            except CorruptError:
                continue


def read_ntfs(raw: bytes) -> dict:
    """All user files keyed by full path (NtfsHandler.cpp: MFT scan,
    paths rebuilt from $FILE_NAME parent chains, metafiles skipped)."""
    fs = _Ntfs(raw)
    names: dict[int, tuple[str, int]] = {}   # rec -> (name, parent)
    datas: dict[int, bytes] = {}
    isdir: dict[int, bool] = {}
    for i, rec in fs.records():
        flags, = struct.unpack_from("<H", rec, 22)
        if not flags & 1:  # not in use
            continue
        isdir[i] = bool(flags & 2)
        best_name = None
        data = None
        for atype, res, a in fs._attrs(rec):
            if atype == 0x30:  # $FILE_NAME
                vlen, voff = struct.unpack_from("<IH", a, 16)
                v = a[voff:voff + vlen]
                if len(v) < 66:
                    continue
                parent = struct.unpack_from("<Q", v, 0)[0] & 0xFFFFFFFFFFFF
                nlen = v[64]
                ns = v[65]
                nm = v[66:66 + 2 * nlen].decode("utf-16-le", "ignore")
                # prefer Win32/POSIX names over DOS 8.3 (ns 2)
                if best_name is None or ns != 2:
                    best_name = (nm, parent)
            elif atype == 0x80:
                # unnamed $DATA stream only
                nlen = a[9]
                if nlen == 0:
                    data = fs._attr_content((res, a))
        if best_name:
            names[i] = best_name
        if data is not None:
            datas[i] = data

    def path_of(i: int, depth=0) -> str | None:
        if depth > 64 or i not in names:
            return None
        nm, parent = names[i]
        if parent == 5 or parent == i:  # root
            return nm
        pp = path_of(parent, depth + 1)
        return f"{pp}/{nm}" if pp else nm

    files: dict = {}
    for i, data in datas.items():
        if i < 16 and (i not in names or names[i][0].startswith("$")):
            continue  # metafiles
        p = path_of(i)
        if p and not p.startswith("$"):
            files[p] = data
    return files
