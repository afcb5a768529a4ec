"""HFS+ filesystem image reader (+ minimal writer for tests).

A copy of tpu7z/containers/hfs.py, on the host: the same bytes, lines
and errors from the same input.

Behavioral reference: CPP/7zip/Archive/HfsHandler.cpp — volume header
at offset 1024 ('H+'/'HX'), catalog-file B-tree walk across leaf
nodes, file records with data-fork extents, paths reconstructed from
parent-folder IDs.  Compressed (decmpfs) forks are not present in
plain HFS+ images and are rejected if flagged.
"""

from __future__ import annotations

import struct

from ..utils.errors import CorruptError

_VH_OFF = 1024


def is_hfs(raw: bytes) -> bool:
    return len(raw) > _VH_OFF + 512 and \
        raw[_VH_OFF:_VH_OFF + 2] in (b"H+", b"HX")


def _fork_extents(fork: bytes):
    """HFSPlusForkData: u64 logicalSize, u32 clumpSize, u32 totalBlocks,
    8 x (startBlock u32, blockCount u32)."""
    logical, = struct.unpack_from(">Q", fork, 0)
    extents = []
    for k in range(8):
        start, count = struct.unpack_from(">II", fork, 16 + 8 * k)
        if count:
            extents.append((start, count))
    return logical, extents


class _Hfs:
    def __init__(self, raw: bytes):
        if not is_hfs(raw):
            raise CorruptError("hfs: bad volume header signature")
        self.raw = raw
        vh = raw[_VH_OFF:_VH_OFF + 512]
        self.block_size, = struct.unpack_from(">I", vh, 40)
        if self.block_size < 512 or \
                self.block_size & (self.block_size - 1):
            raise CorruptError("hfs: bad allocation block size")
        # catalogFile fork data at offset 272 (after two fork datas)
        cat_fork = vh[272:272 + 80]
        self.cat_logical, self.cat_extents = _fork_extents(cat_fork)

    def read_extents(self, logical: int, extents) -> bytes:
        out = bytearray()
        for start, count in extents:
            off = start * self.block_size
            nb = count * self.block_size
            if off + nb > len(self.raw):
                raise CorruptError("hfs: extent outside image")
            out.extend(self.raw[off:off + nb])
            if len(out) >= logical:
                break
        if len(out) < logical:
            raise CorruptError("hfs: fork shorter than logical size")
        return bytes(out[:logical])


def read_hfs(raw: bytes) -> dict:
    """All files keyed by full path (HfsHandler.cpp catalog walk)."""
    fs = _Hfs(raw)
    cat = fs.read_extents(fs.cat_logical, fs.cat_extents)
    if len(cat) < 512:
        raise CorruptError("hfs: catalog too small")
    # B-tree header node: node descriptor (14) + BTHeaderRec
    kind = struct.unpack_from(">b", cat, 8)[0]
    if kind != 1:
        raise CorruptError("hfs: catalog missing header node")
    node_size, = struct.unpack_from(">H", cat, 14 + 18)
    first_leaf, = struct.unpack_from(">I", cat, 14 + 10)
    if node_size < 512 or node_size & (node_size - 1):
        raise CorruptError("hfs: bad b-tree node size")

    folders: dict[int, tuple[str, int]] = {}   # cnid -> (name, parent)
    files = []  # (parent, name, logical, extents)
    node = first_leaf
    seen = set()
    while node:
        if node in seen:
            raise CorruptError("hfs: leaf chain loop")
        seen.add(node)
        off = node * node_size
        nd = cat[off:off + node_size]
        if len(nd) != node_size:
            raise CorruptError("hfs: leaf node outside catalog")
        flink, = struct.unpack_from(">I", nd, 0)
        nkind = struct.unpack_from(">b", nd, 8)[0]
        nrecs, = struct.unpack_from(">H", nd, 10)
        if nkind != -1:
            raise CorruptError("hfs: expected leaf node")
        for r in range(nrecs):
            rec_off, = struct.unpack_from(
                ">H", nd, node_size - 2 * (r + 1))
            if rec_off + 8 > node_size:
                raise CorruptError("hfs: record offset outside node")
            key_len, = struct.unpack_from(">H", nd, rec_off)
            parent, = struct.unpack_from(">I", nd, rec_off + 2)
            name_chars, = struct.unpack_from(">H", nd, rec_off + 6)
            name = nd[rec_off + 8:rec_off + 8 + 2 * name_chars
                      ].decode("utf-16-be", "replace")
            dpos = rec_off + 2 + key_len
            dpos += dpos & 1  # records are 2-byte aligned
            rtype, = struct.unpack_from(">h", nd, dpos)
            if rtype == 1:  # folder
                cnid, = struct.unpack_from(">I", nd, dpos + 8)
                folders[cnid] = (name, parent)
            elif rtype == 2:  # file
                fork = nd[dpos + 88:dpos + 88 + 80]
                logical, extents = _fork_extents(fork)
                files.append((parent, name, logical, extents))
        node = flink

    def path_of(parent: int, depth=0) -> str:
        if parent in (1, 2) or depth > 64:  # root
            return ""
        if parent not in folders:
            return ""
        name, up = folders[parent]
        p = path_of(up, depth + 1)
        return f"{p}{name}/" if name else p

    out: dict = {}
    for parent, name, logical, extents in files:
        if name.startswith("\0\0\0\0HFS+ Private Data"):
            continue
        path = path_of(parent) + name
        out[path] = fs.read_extents(logical, extents) if logical \
            else b""
    return out


def write_hfs(files: dict) -> bytes:
    """Minimal HFS+ image: one leaf catalog node, contiguous file
    extents (superset of the read-only reference handler; tests)."""
    bsize = 4096
    node_size = 8192
    # data blocks start after: 2 boot blocks + VH block + catalog
    cat_blocks = -(-2 * node_size // bsize)
    cat_start = 2
    data_start = cat_start + cat_blocks
    data = bytearray()
    recs = []  # (parent, name, rtype, payload)
    next_cnid = 16
    placed = []
    for name, content in files.items():
        nblocks = -(-len(content) // bsize) if content else 0
        start = data_start + len(data) // bsize
        data.extend(content)
        if len(data) % bsize:
            data.extend(b"\0" * (bsize - len(data) % bsize))
        placed.append((name, next_cnid, len(content), start, nblocks))
        next_cnid += 1

    # build the single leaf node (node 1)
    leaf = bytearray(node_size)
    struct.pack_into(">IIbbHH", leaf, 0, 0, 0, -1, 1, len(placed), 0)
    pos = 14
    offsets = []
    for name, cnid, logical, start, nblocks in placed:
        enc = name.encode("utf-16-be")
        key = struct.pack(">IH", 2, len(enc) // 2) + enc  # parent=root
        key_len = len(key)
        rec = struct.pack(">H", key_len) + key
        if len(rec) % 2:
            rec += b"\0"
        body = bytearray(88 + 80)
        struct.pack_into(">h", body, 0, 2)            # file record
        struct.pack_into(">I", body, 8, cnid)
        fork = bytearray(80)
        struct.pack_into(">Q", fork, 0, logical)
        struct.pack_into(">I", fork, 12, nblocks)
        struct.pack_into(">II", fork, 16, start, nblocks)
        body[88:88 + 80] = fork
        rec = bytes(rec) + bytes(body)
        offsets.append(pos)
        leaf[pos:pos + len(rec)] = rec
        pos += len(rec)
    for r, o in enumerate(offsets):
        struct.pack_into(">H", leaf, node_size - 2 * (r + 1), o)

    # header node (node 0)
    hdr = bytearray(node_size)
    struct.pack_into(">IIbbHH", hdr, 0, 0, 0, 1, 0, 3, 0)
    bth = bytearray(106)
    struct.pack_into(">HI", bth, 0, 1, len(placed))   # depth, root
    struct.pack_into(">I", bth, 6, len(placed))       # leafRecords
    struct.pack_into(">II", bth, 10, 1, 1)            # first/last leaf
    struct.pack_into(">H", bth, 18, node_size)
    hdr[14:14 + len(bth)] = bth

    cat = bytes(hdr) + bytes(leaf)
    total_blocks = data_start + len(data) // bsize + 1
    img = bytearray(total_blocks * bsize)
    vh = bytearray(512)
    vh[0:2] = b"H+"
    struct.pack_into(">H", vh, 2, 4)                  # version
    struct.pack_into(">I", vh, 40, bsize)
    struct.pack_into(">I", vh, 44, total_blocks)
    cat_fork = bytearray(80)
    struct.pack_into(">Q", cat_fork, 0, len(cat))
    struct.pack_into(">I", cat_fork, 12, cat_blocks)
    struct.pack_into(">II", cat_fork, 16, cat_start, cat_blocks)
    vh[272:272 + 80] = cat_fork
    img[_VH_OFF:_VH_OFF + 512] = vh
    img[cat_start * bsize:cat_start * bsize + len(cat)] = cat
    img[data_start * bsize:data_start * bsize + len(data)] = data
    return bytes(img)
