"""WIM (Windows Imaging) container: reader + store-mode writer.

A copy of tpu7z/containers/wim.py, on the host: the same bytes, lines
and errors from the same input.

Behavioral reference: CPP/7zip/Archive/Wim/ (WimIn.cpp
header/lookup/dentry parsing; layout cross-checked against archives the
reference 7zz itself creates with `a -twim`).

Layout:
  header (208 B): "MSWIM\\0\\0\\0", hdrsize u32, version, flags, chunk
  size, GUID[16], part u16, total parts u16, image count u32, then
  resource headers for: offset (lookup) table, XML data, boot metadata,
  boot index u32, integrity reshdr.
  reshdr (24 B): packed u64 = size(56) | flags(8), offset u64, original
  size u64. Resource flags: 1=free 2=metadata 4=compressed 8=spanned.
  lookup entry (50 B): reshdr + part u16 + refcount u32 + SHA1[20].
  metadata resource: security block (total u32, count u32, ...) 8-byte
  aligned, then the dentry tree; each directory listing ends with an
  8-byte zero terminator.
  dentry: length u64, attrib u32, security id i32, subdir offset u64,
  unused[16], ctime/atime/wtime u64, SHA1[20], reparse[4+4+4+2?],
  short name len u16 @98, file name len u16 @100, UTF-16LE name @102,
  padded to 8.

Unix permissions ride the attrib high word with bit 0x8000 set in the
low word (same convention the fork uses for 7z/zip entries).
"""

from __future__ import annotations

import hashlib
import struct

from ..utils.errors import CorruptError, UnsupportedError

MAGIC = b"MSWIM\x00\x00\x00"
HDR_SIZE = 208
RES_METADATA = 2
RES_COMPRESSED = 4

FILE_ATTR_DIRECTORY = 0x10


def _reshdr(d: bytes, off: int):
    v = struct.unpack_from("<Q", d, off)[0]
    size = v & 0x00FFFFFFFFFFFFFF
    flags = v >> 56
    offset, orig = struct.unpack_from("<QQ", d, off + 8)
    return size, flags, offset, orig


def _pack_reshdr(size: int, flags: int, offset: int, orig: int) -> bytes:
    return struct.pack("<QQQ", size | (flags << 56), offset, orig)


def read_wim(data: bytes) -> dict[str, bytes]:
    """Extract all images; returns {path: content}. Directories appear
    as 'name/' with empty content only when empty."""
    if len(data) < HDR_SIZE or data[:8] != MAGIC:
        raise CorruptError("wim: bad magic")
    lt_size, lt_flags, lt_off, _ = _reshdr(data, 48)
    if lt_flags & RES_COMPRESSED:
        raise UnsupportedError("wim: compressed lookup table")
    if lt_off + lt_size > len(data) or lt_size % 50:
        raise CorruptError("wim: bad lookup table")

    by_hash = {}
    metas = []
    for i in range(int(lt_size // 50)):
        e = lt_off + i * 50
        size, flags, off, orig = _reshdr(data, e)
        sha1 = data[e + 30:e + 50]
        if flags & RES_COMPRESSED:
            # store-only tier: compressed resources (XPRESS/LZX) are the
            # reference's CWimHandler decode surface not yet ported
            by_hash[sha1] = None
            if flags & RES_METADATA:
                raise UnsupportedError("wim: compressed metadata")
            continue
        if off + size > len(data):
            raise CorruptError("wim: resource out of bounds")
        if flags & RES_METADATA:
            metas.append((off, size))
        else:
            by_hash[sha1] = data[off:off + size]

    out: dict[str, bytes] = {}
    multi = len(metas) > 1
    for idx, (moff, msize) in enumerate(metas):
        md = data[moff:moff + msize]
        if len(md) < 8:
            raise CorruptError("wim: short metadata")
        sec_total = struct.unpack_from("<I", md, 0)[0]
        pos = (max(sec_total, 8) + 7) & ~7
        prefix = f"{idx + 1}/" if multi else ""
        _walk(md, pos, prefix, by_hash, out, depth=0)
    return out


def _walk(md: bytes, pos: int, prefix: str, by_hash, out, depth: int):
    if depth > 64:
        raise CorruptError("wim: dentry tree too deep")
    # the entry at `pos` is the directory's own dentry (root) OR the
    # first entry of a listing; callers pass listing starts except for
    # the root, which we detect by empty name and recurse into.
    while pos + 8 <= len(md):
        ln = struct.unpack_from("<Q", md, pos)[0]
        if ln == 0:
            return
        if ln < 102 or pos + ln > len(md):
            raise CorruptError("wim: bad dentry")
        attr = struct.unpack_from("<I", md, pos + 8)[0]
        subdir = struct.unpack_from("<Q", md, pos + 16)[0]
        sha1 = md[pos + 64:pos + 84]
        fnlen = struct.unpack_from("<H", md, pos + 100)[0]
        name = md[pos + 102:pos + 102 + fnlen].decode("utf-16-le")
        if attr & FILE_ATTR_DIRECTORY:
            sub_prefix = prefix + (name + "/" if name else "")
            if subdir:
                before = len(out)
                _walk(md, subdir, sub_prefix, by_hash, out, depth + 1)
                if len(out) == before and name:
                    out[sub_prefix] = b""
            elif name:
                out[sub_prefix] = b""
        else:
            content = b""
            if sha1 != b"\x00" * 20:
                if sha1 not in by_hash:
                    raise CorruptError("wim: missing resource for file")
                blob = by_hash[sha1]
                if blob is None:
                    raise UnsupportedError(
                        "wim: compressed resource (XPRESS/LZX)")
                content = blob
            out[prefix + name] = content
        pos += (ln + 7) & ~7


# ---------------------------------------------------------------------------
# writer (store mode, one image)
# ---------------------------------------------------------------------------

def _dentry(name: str, attr: int, subdir: int, sha1: bytes,
            mtime: int = 0x01D700000000000) -> bytes:
    nm = name.encode("utf-16-le")
    # name is followed by a u16 zero terminator (when non-empty); the
    # stored length is the 8-aligned total (WimIn.cpp rejects unaligned)
    nm2 = len(nm) + (2 if nm else 0)
    ln = (102 + nm2 + 7) & ~7
    e = bytearray(ln)
    struct.pack_into("<Q", e, 0, ln)
    struct.pack_into("<I", e, 8, attr)
    struct.pack_into("<i", e, 12, -1)          # security id: none
    struct.pack_into("<Q", e, 16, subdir)
    struct.pack_into("<QQQ", e, 40, mtime, mtime, mtime)
    e[64:84] = sha1
    struct.pack_into("<H", e, 100, len(nm))
    e[102:102 + len(nm)] = nm
    return bytes(e)


def write_wim(files: dict[str, bytes]) -> bytes:
    """Single-image, store-mode WIM that the reference 7zz extracts."""
    # build the directory tree
    tree: dict = {}
    for path, content in files.items():
        parts = [p for p in path.replace("\\", "/").split("/") if p]
        cur = tree
        for part in parts[:-1]:
            cur = cur.setdefault(part, {})
        if path.endswith("/"):
            for part in parts[-1:]:
                cur = cur.setdefault(part, {})
        else:
            cur[parts[-1]] = content

    out = bytearray(HDR_SIZE)
    by_hash: dict[bytes, tuple[int, int]] = {}

    def store(content: bytes) -> bytes:
        h = hashlib.sha1(content).digest()
        if h not in by_hash and content:
            off = len(out)
            out.extend(content)
            by_hash[h] = (off, len(content))
        return h

    # file resources first (like the reference's writer)
    def store_tree(t):
        for name, node in sorted(t.items()):
            if isinstance(node, dict):
                store_tree(node)
            else:
                store(node)
    store_tree(tree)

    # metadata: security block + dentry tree (children-after-parent,
    # breadth-first per directory, each listing zero-terminated)
    md = bytearray(struct.pack("<II", 8, 0))
    root = _dentry("", 0x41ed8010, 0, b"\x00" * 20)
    root_pos = len(md)
    md.extend(root)
    md.extend(b"\x00" * 8)  # terminator of the root level listing

    def emit_listing(t, parent_pos):
        start = len(md)
        struct.pack_into("<Q", md, parent_pos + 16, start)
        entries = []
        for name, node in sorted(t.items()):
            if isinstance(node, dict):
                e = _dentry(name, 0x41ed8010, 0, b"\x00" * 20)
            else:
                h = hashlib.sha1(node).digest()
                e = _dentry(name, 0x81a48020,
                            0, h if node else b"\x00" * 20)
            entries.append((len(md), name, node))
            md.extend(e)
        md.extend(b"\x00" * 8)
        for pos, name, node in entries:
            if isinstance(node, dict):
                emit_listing(node, pos)

    emit_listing(tree, root_pos)

    meta_off = len(out)
    out.extend(md)
    meta_hash = hashlib.sha1(bytes(md)).digest()

    # lookup table: metadata entry first, then file resources
    lt = bytearray()
    lt += _pack_reshdr(len(md), RES_METADATA, meta_off, len(md))
    lt += struct.pack("<HI", 1, 1) + meta_hash
    for h, (off, size) in by_hash.items():
        lt += _pack_reshdr(size, 0, off, size)
        lt += struct.pack("<HI", 1, 1) + h
    lt_off = len(out)
    out.extend(lt)

    nfiles = sum(1 for v in files.values())
    xml = (f"<WIM><TOTALBYTES>{len(out)}</TOTALBYTES>"
           f"<IMAGE INDEX=\"1\"><NAME>1</NAME>"
           f"<FILECOUNT>{nfiles}</FILECOUNT></IMAGE></WIM>")
    xml_b = b"\xff\xfe" + xml.encode("utf-16-le")
    xml_off = len(out)
    out.extend(xml_b)

    # header
    out[0:8] = MAGIC
    struct.pack_into("<IIII", out, 8, HDR_SIZE, 0x10d00, 0, 0)
    out[24:40] = hashlib.sha1(bytes(out[HDR_SIZE:HDR_SIZE + 64])
                              + len(out).to_bytes(8, "little")).digest()[:16]
    struct.pack_into("<HHI", out, 40, 1, 1, 1)
    out[48:72] = _pack_reshdr(len(lt), 2, lt_off, len(lt))
    out[72:96] = _pack_reshdr(len(xml_b), 2, xml_off, len(xml_b))
    # boot metadata, boot index, integrity stay zero
    return bytes(out)
