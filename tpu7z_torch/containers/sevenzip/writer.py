""".7z archive writer, a port of tpu7z/containers/sevenzip/writer.py: the
same archive bytes from the same files, method, level, password and IV.

Behavioral reference: CPP/7zip/Archive/7z/7zOut.cpp and 7zUpdate.cpp
(folder construction, solid grouping); written from DOC/7zFormat.txt.

Files are grouped into solid folders (one compressed stream per group),
each encoded on its own; the header records the pack-stream layout.

Folder coder graphs are stored decoder-side: an encrypted LZMA2 folder is
[coder0 = LZMA2 (input <- coder1 output), coder1 = AES256 (input <- pack
stream)], with the final output being coder0's.

`write_archive` and `update_archive` run on the device the caller names
(the CUDA card unless `device` names the CPU): zstd folders through the
tensor encoder, whose parse runs there (models/zstd/compressor.py),
deflate folders with their parse and bit packing there, bzip2 folders
with their block sort there; LZMA2, LZ4, BCJ2, PPMd and AES encryption
(csrc/aes.cpp) on the host.
"""

from __future__ import annotations

import os

from ...device import resolve_device
from ...models import ppmd
from ...models.filters.bcj2 import bcj2_encode
from ...models.lz4 import frame as lz4_frame
from ...models.lzma import lzma2
from ...models.zstd import compressor
from ...ops.hashing import crc32_native as _crc32
from ...utils.errors import ParamError
from . import aes7z
from . import format as F
from .format import ByteWriter
from .reader import SevenZipReader, decode_folder


def _encode_stream(method: str, data: bytes, level: int, *, device=None):
    """Returns (coder_method_id, props_bytes, packed_bytes)."""
    if method == "copy":
        return F.M_COPY, b"", data
    if method == "lzma2":
        return F.M_LZMA2, bytes([24]), lzma2.compress(data, level=min(max(level, 1), 9))
    if method == "zstd":
        lvl = min(level, 22)
        return F.M_ZSTD, bytes([1, 5, lvl & 0xFF, 0, 0]), \
            compressor.compress(data, level=lvl, device=device)
    if method == "lz4":
        return F.M_LZ4, bytes([1, 10, 4, 0, 0]), lz4_frame.compress_frame(data)
    if method in ("bzip2", "deflate"):
        from ...models.registry import get_codec  # the registry imports this package
        codec = get_codec(method)
        return codec.method_id, b"", codec.compress(data, level=level, device=device)
    if method == "brotli":
        from ...models import brotli
        # the props name the level, but tpu7z compresses at brotli's
        # default quality 9 whatever the level; so does the port
        return F.M_BROTLI, bytes([1, 2, min(level, 11), 0, 0]), \
            brotli.compress_mt_container(data, device=device)
    if method == "ppmd":
        # order 6 and 16 MiB whatever the level, as tpu7z
        stream, props = ppmd.compress(data, order=6, mem=1 << 24)
        return F.M_PPMD, props, stream
    raise ParamError(f"7z writer: unknown method {method}")


def _encode_bcj2_folder(blob: bytes, pack_streams: list):
    """BCJ2 folder: 4-stream x86 split, main stream LZMA2-compressed
    (7zUpdate.cpp exe-group layout)."""
    main, call, jump, rc = bcj2_encode(blob)
    packed_main = lzma2.compress(main)
    base = len(pack_streams)
    pack_streams += [packed_main, call, jump, rc]
    return {
        # coder0 = BCJ2 (4 in, 1 out); coder1 = LZMA2 feeding bcj2.in0
        "coders": [(F.M_BCJ2, b"", 4, 1), (F.M_LZMA2, bytes([24]), 1, 1)],
        "bind": [(0, 1)],
        "packed_indices": [4, 1, 2, 3],
        "sizes": [len(blob), len(main)],
        "crc": _crc32(blob),
    }


def write_archive(files: dict[str, bytes], method: str = "lzma2",
                  level: int = 5, solid: bool = True,
                  password: str | None = None,
                  encrypt_header: bool = False, *, device=None) -> bytes:
    """Create a .7z archive from {name: content}.

    encrypt_header=True (with a password) stores the header as a
    kEncodedHeader folder chained LZMA2 <- AES256, hiding file names —
    the -mhe=on mode (reference: 7zOut.cpp WriteDatabase encodeHeaders
    path, 7zUpdate.cpp CompressHeaders)."""
    device = resolve_device(device)
    names = list(files.keys())
    nonempty = [n for n in names if len(files[n]) > 0]
    empty = [n for n in names if len(files[n]) == 0]

    if solid and len(nonempty) > 1:
        groups = [nonempty]
    else:
        groups = [[n] for n in nonempty]

    pack_streams: list[bytes] = []
    folders = []
    sub_counts = []
    sub_sizes = []
    sub_crcs = []
    for grp in groups:
        blob = b"".join(files[n] for n in grp)
        if method == "bcj2" and password is None:
            folders.append(_encode_bcj2_folder(blob, pack_streams))
            sub_counts.append(len(grp))
            for n in grp:
                sub_sizes.append(len(files[n]))
                sub_crcs.append(_crc32(files[n]))
            continue
        mid, props, packed = _encode_stream(method, blob, level, device=device)
        if password is not None:
            iv = os.urandom(16)
            # numCyclesPower 19; ivSize = 1 (base) + 15 (ext) = 16
            aprops = bytes([19 | 0x40, 0x0F]) + iv
            enc = aes7z.aes_encrypt(packed, aprops, password)
            folders.append({
                # decoder graph: coder0 main codec, coder1 = AES
                "coders": [(mid, props, 1, 1), (F.M_AES256, aprops, 1, 1)],
                # coder0's input (global in 0) <- coder1's output (out 1)
                "bind": [(0, 1)],
                "packed_indices": [1],  # coder1's input (global in 1)
                "sizes": [len(blob), len(packed)],
                "crc": _crc32(blob),
            })
            pack_streams.append(enc)
        else:
            folders.append({
                "coders": [(mid, props, 1, 1)],
                "bind": [],
                "packed_indices": [0],
                "sizes": [len(blob)],
                "crc": _crc32(blob),
            })
            pack_streams.append(packed)
        sub_counts.append(len(grp))
        for n in grp:
            sub_sizes.append(len(files[n]))
            sub_crcs.append(_crc32(files[n]))

    header = _build_header(names, files, empty, folders, pack_streams,
                           sub_counts, sub_sizes, sub_crcs)
    if encrypt_header:
        if password is None:
            raise ParamError("encrypt_header requires a password")
        header = _encrypt_header(header, password, pack_streams)
    return _archive_bytes(header, pack_streams)


def _archive_bytes(header: bytes, pack_streams: list) -> bytes:
    """The signature header, the pack streams, then the header."""
    packed_all = b"".join(pack_streams)
    start = ByteWriter()
    start.u64(len(packed_all))
    start.u64(len(header))
    start.u32(_crc32(header))
    sh = start.getvalue()
    out = bytearray()
    out += F.SIGNATURE
    out += bytes([0, 4])
    out += _crc32(sh).to_bytes(4, "little")
    out += sh
    out += packed_all
    out += header
    return bytes(out)


def _encrypt_header(header: bytes, password: str,
                    pack_streams: list) -> bytes:
    """Wrap a plain kHeader blob as kEncodedHeader: LZMA2 <- AES256
    folder whose single pack stream is appended after the data packs."""
    packed = lzma2.compress(header)
    iv = os.urandom(16)
    aprops = bytes([19 | 0x40, 0x0F]) + iv
    enc = aes7z.aes_encrypt(packed, aprops, password)
    pack_pos = sum(len(p) for p in pack_streams)
    pack_streams.append(enc)
    w = ByteWriter()
    w.number(F.K_ENCODED_HEADER)
    w.number(F.K_PACK_INFO)
    w.number(pack_pos)
    w.number(1)
    w.number(F.K_SIZE)
    w.number(len(enc))
    w.number(F.K_END)
    w.number(F.K_UNPACK_INFO)
    w.number(F.K_FOLDER)
    w.number(1)
    w.byte(0)
    _write_folder(w, {
        "coders": [(F.M_LZMA2, bytes([24]), 1, 1),
                   (F.M_AES256, aprops, 1, 1)],
        "bind": [(0, 1)],
        "packed_indices": [1],
    })
    w.number(F.K_CODERS_UNPACK_SIZE)
    w.number(len(header))
    w.number(len(packed))
    w.number(F.K_CRC)
    w.byte(1)
    w.u32(_crc32(header))
    w.number(F.K_END)
    w.number(F.K_END)
    return w.getvalue()


def _build_header(names, files, empty, folders, pack_streams,
                  sub_counts, sub_sizes, sub_crcs) -> bytes:
    w = ByteWriter()
    w.number(F.K_HEADER)
    if folders:
        w.number(F.K_MAIN_STREAMS)
        w.number(F.K_PACK_INFO)
        w.number(0)
        w.number(len(pack_streams))
        w.number(F.K_SIZE)
        for p in pack_streams:
            w.number(len(p))
        w.number(F.K_END)
        w.number(F.K_UNPACK_INFO)
        w.number(F.K_FOLDER)
        w.number(len(folders))
        w.byte(0)
        for f in folders:
            _write_folder(w, f)
        w.number(F.K_CODERS_UNPACK_SIZE)
        for f in folders:
            for s in f["sizes"]:
                w.number(s)
        defined = [f["crc"] is not None for f in folders]
        w.number(F.K_CRC)
        if all(defined):
            w.byte(1)
        else:
            w.byte(0)
            w.bitfield(defined)
        for f in folders:
            if f["crc"] is not None:
                w.u32(f["crc"])
        w.number(F.K_END)
        w.number(F.K_SUBSTREAMS_INFO)
        multi = any(c != 1 for c in sub_counts)
        if multi:
            w.number(F.K_NUM_UNPACK_STREAM)
            for c in sub_counts:
                w.number(c)
            w.number(F.K_SIZE)
            i = 0
            for c in sub_counts:
                for k in range(c - 1):
                    w.number(sub_sizes[i + k])
                i += c
            # CRCs for streams not covered by a single-stream folder crc
            num_unknown = sum(c for c in sub_counts if c != 1)
            if num_unknown:
                w.number(F.K_CRC)
                w.byte(1)
                i = 0
                for c in sub_counts:
                    if c != 1:
                        for k in range(c):
                            w.u32(sub_crcs[i + k])
                    i += c
        w.number(F.K_END)
        w.number(F.K_END)
    w.number(F.K_FILES_INFO)
    w.number(len(names))
    if empty:
        bits = [len(files[n]) == 0 for n in names]
        body = ByteWriter()
        body.bitfield(bits)
        w.number(F.K_EMPTY_STREAM)
        w.number(len(body.getvalue()))
        w.raw(body.getvalue())
        body2 = ByteWriter()
        body2.bitfield([True] * len(empty))
        w.number(F.K_EMPTY_FILE)
        w.number(len(body2.getvalue()))
        w.raw(body2.getvalue())
    body = ByteWriter()
    body.byte(0)
    for n in names:
        body.raw(n.encode("utf-16-le"))
        body.raw(b"\x00\x00")
    w.number(F.K_NAME)
    w.number(len(body.getvalue()))
    w.raw(body.getvalue())
    w.number(F.K_END)
    w.number(F.K_END)
    return w.getvalue()


def _write_folder(w: ByteWriter, f: dict):
    coders = f["coders"]
    w.number(len(coders))
    for mid, props, nin, nout in coders:
        id_bytes = mid.to_bytes(max((mid.bit_length() + 7) // 8, 1), "big")
        flags = len(id_bytes)
        if nin != 1 or nout != 1:
            flags |= 0x10
        if props:
            flags |= 0x20
        w.byte(flags)
        w.raw(id_bytes)
        if nin != 1 or nout != 1:
            w.number(nin)
            w.number(nout)
        if props:
            w.number(len(props))
            w.raw(props)
    for in_i, out_i in f["bind"]:
        w.number(in_i)
        w.number(out_i)
    if len(f["packed_indices"]) > 1:
        for pi in f["packed_indices"]:
            w.number(pi)


# ---------------------------------------------------------------------------
# Archive update (7zUpdate.cpp repack analog)
# ---------------------------------------------------------------------------

def update_archive(old: bytes, add: dict[str, bytes] | None = None,
                   delete: list[str] | None = None,
                   method: str = "lzma2", level: int = 5, *, device=None) -> bytes:
    """Update an existing archive: keep the packed streams of untouched
    solid folders verbatim (no recompression — the method-preservation
    behavior the reference regression-tests, tests/regression.test:241),
    drop folders whose every file is deleted, re-encode folders that
    lose only some files, and append new/changed files in new folders.
    """
    add = dict(add or {})
    delete = set(delete or [])
    rd = SevenZipReader(old, device=device)
    si = rd.streams

    pack_streams: list[bytes] = []
    folders: list[dict] = []
    sub_counts: list[int] = []
    sub_sizes: list[int] = []
    sub_crcs: list[int] = []
    stream_names: list[str] = []  # names in final substream order

    if si:
        spans = rd._pack_stream_data(si)
        pack_index = 0
        sub_idx = 0
        sfiles = [fe for fe in rd.files if fe.has_stream]
        fi = 0
        for folder_i, f in enumerate(si.folders):
            npack = len(f.packed_indices)
            packs = [old[o:o + s2]
                     for (o, s2) in spans[pack_index:pack_index + npack]]
            pack_index += npack
            cnt = si.num_unpack_streams[folder_i]
            names = [sfiles[fi + k].name for k in range(cnt)]
            fi += cnt
            sizes = si.sub_sizes[sub_idx:sub_idx + cnt]
            crcs = si.sub_crcs[sub_idx:sub_idx + cnt]
            sub_idx += cnt
            touched = [n for n in names if n in delete or n in add]
            if not touched:
                folders.append({
                    "coders": [(c.method_id, c.props, c.num_in, c.num_out)
                               for c in f.coders],
                    "bind": list(f.bind_pairs),
                    "packed_indices": list(f.packed_indices),
                    "sizes": list(f.unpack_sizes),
                    "crc": f.crc,
                })
                pack_streams.extend(packs)
                sub_counts.append(cnt)
                sub_sizes.extend(sizes)
                sub_crcs.extend(crcs)
                stream_names.extend(names)
            else:
                survivors = [n for n in names
                             if n not in delete and n not in add]
                if survivors:
                    data = decode_folder(f, packs, device=rd.device)
                    pos = 0
                    for n, sz in zip(names, sizes):
                        chunk = data[pos:pos + sz]
                        pos += sz
                        if n in survivors:
                            add[n] = chunk  # re-encode below

    for n, content in list(add.items()):
        if not content:
            continue
        mid, props, packed = _encode_stream(method, content, level, device=rd.device)
        folders.append({
            "coders": [(mid, props, 1, 1)],
            "bind": [],
            "packed_indices": [0],
            "sizes": [len(content)],
            "crc": _crc32(content),
        })
        pack_streams.append(packed)
        sub_counts.append(1)
        sub_sizes.append(len(content))
        sub_crcs.append(_crc32(content))
        stream_names.append(n)

    # empty entries: originals not deleted/replaced + newly-added empties
    empty_names = [fe.name for fe in rd.files
                   if not fe.has_stream and fe.name not in delete
                   and fe.name not in add]
    empty_names += [n for n, c in add.items() if not c]

    names = stream_names + empty_names
    contents = {n: b"?" for n in stream_names}
    contents.update({n: b"" for n in empty_names})
    header = _build_header(names, contents, empty_names, folders,
                           pack_streams, sub_counts, sub_sizes, sub_crcs)
    return _archive_bytes(header, pack_streams)
