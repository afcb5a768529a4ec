"""SquashFS v4 container: reader (+ minimal writer used for fixtures).

A copy of tpu7z/containers/squashfs.py, on the host: the same bytes, lines
and errors from the same input.

Behavioral reference: CPP/7zip/Archive/SquashfsHandler.cpp — superblock
Parse4 (:210-248), inode CNode::Parse4 (:683-808), directory entries
(:1428-1520, v4 header {count-1 u32, startBlock u32, inodeNum u32} +
entries {offset u16, inodeDelta i16, type u16, nameSize-1 u16, name}),
dir FileSize carries a +3 bias (:1414-1419), metadata blocks are 8 KiB
with a u16 header whose bit 15 marks stored blocks (:136), data block
sizes use bit 24 for stored and 0 for sparse (:137), fragment entries
are {start u64, size u32, pad u32} reached via a u64 pointer table
(:1596-1612). Compression methods (:67-72): 1=ZLIB 2=LZMA 4=XZ 5=LZ4
6=ZSTD — decoded with this framework's own codecs.
"""

from __future__ import annotations

import struct

from ..utils.errors import CorruptError, UnsupportedError

MAGIC = 0x73717368  # "hsqs"
META_SIZE = 8192
M_ZLIB = 1
M_LZMA = 2
M_LZO = 3
M_XZ = 4
M_LZ4 = 5
M_ZSTD = 6

T_DIR = 1
T_FILE = 2
T_LNK = 3

FRAG_EMPTY = 0xFFFFFFFF


def _decompress(method: int, comp: bytes, max_out: int) -> bytes:
    if method == M_ZLIB:
        import zlib
        return zlib.decompress(comp)
    if method == M_ZSTD:
        from ..models.zstd import frame
        return frame.decompress(comp)
    if method == M_LZ4:
        from ..models.lz4 import block
        # max_out is an upper bound (metadata blocks may be short)
        return block.decompress_block(comp)
    if method == M_XZ:
        from . import xz
        return xz.decompress(comp)
    if method == M_LZMA:
        from ..models.lzma import decoder
        return decoder.decompress_alone(comp)
    raise UnsupportedError(f"squashfs: compression method {method}")


def _compress(method: int, data: bytes) -> bytes:
    if method == M_ZLIB:
        import zlib
        return zlib.compress(data, 6)
    if method == M_ZSTD:
        from ..models.zstd import frame
        return frame.compress(data, level=3)
    if method == M_LZ4:
        from ..models.lz4 import block
        return block.compress_block(data)
    raise UnsupportedError(f"squashfs: compression method {method}")


class _MetaRegion:
    """Unpacked concatenation of a metadata-block region with the
    (relative packed offset -> unpacked offset) map the inode refs and
    directory StartBlocks point into."""

    def __init__(self, raw: bytes, start: int, end: int, method: int):
        self.data = bytearray()
        self.unpack_pos = {}
        pos = start
        while pos < end:
            if pos + 2 > len(raw):
                raise CorruptError("squashfs: truncated metadata header")
            hdr = raw[pos] | (raw[pos + 1] << 8)
            size = hdr & 0x7FFF
            stored = bool(hdr & 0x8000)
            blob = raw[pos + 2:pos + 2 + size]
            if len(blob) != size:
                raise CorruptError("squashfs: truncated metadata block")
            self.unpack_pos[pos - start] = len(self.data)
            self.data += blob if stored else \
                _decompress(method, blob, META_SIZE)
            pos += 2 + size

    def at(self, block: int, offset: int) -> int:
        if block not in self.unpack_pos:
            raise CorruptError("squashfs: bad metadata block ref")
        return self.unpack_pos[block] + offset


class _Node:
    __slots__ = ("type", "mode", "file_size", "start_block", "frag",
                 "offset", "block_sizes", "symlink")


def _parse_inode(data: bytes, pos: int, block_log: int) -> _Node:
    n = _Node()
    (n.type, n.mode, _uid, _gid, _mtime, _num) = \
        struct.unpack_from("<HHHHII", data, pos)
    base = pos + 16
    n.block_sizes = []
    n.frag = FRAG_EMPTY
    n.symlink = b""
    t = n.type
    if t in (T_FILE, T_FILE + 7):
        if t == T_FILE:
            (n.start_block, n.frag, n.offset, n.file_size) = \
                struct.unpack_from("<IIII", data, base)
            base += 16
        else:
            (n.start_block, n.file_size, _sparse, _nlink, n.frag,
             n.offset, _xattr) = struct.unpack_from("<QQQIIII", data, base)
            base += 40
        nblocks = n.file_size >> block_log
        if n.frag == FRAG_EMPTY and n.file_size & ((1 << block_log) - 1):
            nblocks += 1
        n.block_sizes = list(
            struct.unpack_from(f"<{nblocks}I", data, base))
    elif t == T_DIR:
        (n.start_block, _nlink, n.file_size, n.offset, _parent) = \
            struct.unpack_from("<IIHHI", data, base)
    elif t == T_DIR + 7:
        (_nlink, n.file_size, n.start_block, _parent, icount,
         n.offset, _xattr) = struct.unpack_from("<IIIIHHI", data, base)
    elif t in (T_LNK, T_LNK + 7):
        _nlink, ln = struct.unpack_from("<II", data, base)
        n.symlink = bytes(data[base + 8:base + 8 + ln])
        n.file_size = ln
        n.start_block = n.offset = 0
    else:
        n.file_size = 0
        n.start_block = n.offset = 0
    return n


def read_squashfs(raw: bytes) -> dict:
    """Returns {path: content} for regular files (symlink targets as
    content for symlinks)."""
    if len(raw) < 96 or struct.unpack_from("<I", raw)[0] != MAGIC:
        raise CorruptError("squashfs: bad magic")
    (_magic, _ninodes, _ctime, block_size, nfrags, method, block_log,
     _flags, _nids, major, _minor, root_ref, _size, _uid_table,
     _xattr_table, inode_table, dir_table, frag_table, _lookup) = \
        struct.unpack_from("<IIIIIHHHHHHQQQQQQQQ", raw)
    if major != 4:
        raise UnsupportedError(f"squashfs: version {major}")
    if block_size != (1 << block_log):
        raise CorruptError("squashfs: block size mismatch")

    inodes = _MetaRegion(raw, inode_table, dir_table, method)
    dirs = _MetaRegion(raw, dir_table, min(frag_table, len(raw)), method)

    # fragment entries
    frags = []
    if nfrags:
        nblocks = (nfrags + 511) >> 9
        ptrs = struct.unpack_from(f"<{nblocks}Q", raw, frag_table)
        fdata = bytearray()
        for ptr in ptrs:
            hdr = raw[ptr] | (raw[ptr + 1] << 8)
            size = hdr & 0x7FFF
            blob = raw[ptr + 2:ptr + 2 + size]
            fdata += blob if hdr & 0x8000 else \
                _decompress(method, blob, META_SIZE)
        for i in range(nfrags):
            start, fsize, _pad = struct.unpack_from("<QII", fdata, i * 16)
            frags.append((start, fsize))

    def read_frag(idx: int) -> bytes:
        start, fsize = frags[idx]
        stored = bool(fsize & (1 << 24))
        size = fsize & 0xFFFFFF
        blob = raw[start:start + size]
        return blob if stored else _decompress(method, blob, block_size)

    def read_file(n: _Node) -> bytes:
        out = bytearray()
        pos = n.start_block
        for bs in n.block_sizes:
            stored = bool(bs & (1 << 24))
            size = bs & 0xFFFFFF
            if size == 0:  # sparse
                out += bytes(min(block_size,
                                 n.file_size - len(out)))
                continue
            blob = raw[pos:pos + size]
            out += blob if stored else \
                _decompress(method, blob, block_size)
            pos += size
        if n.frag != FRAG_EMPTY:
            rem = n.file_size - len(out)
            out += read_frag(n.frag)[n.offset:n.offset + rem]
        if len(out) < n.file_size:
            raise CorruptError("squashfs: short file data")
        return bytes(out[:n.file_size])

    files: dict = {}

    def walk_dir(node: _Node, prefix: str, depth: int):
        if depth > 64:
            raise CorruptError("squashfs: directory loop")
        if node.file_size < 3:
            return
        pos = dirs.at(node.start_block, node.offset)
        end = pos + node.file_size - 3  # v4 size bias
        data = dirs.data
        while pos < end:
            count, start_block, _inum = struct.unpack_from(
                "<III", data, pos)
            pos += 12
            for _ in range(count + 1):
                off, _delta, _etype, nsize = struct.unpack_from(
                    "<HhHH", data, pos)
                name = bytes(data[pos + 8:pos + 8 + nsize + 1]).decode(
                    "utf-8", "replace")
                pos += 8 + nsize + 1
                child = _parse_inode(inodes.data,
                                     inodes.at(start_block, off),
                                     block_log)
                path = f"{prefix}{name}"
                if child.type in (T_DIR, T_DIR + 7):
                    walk_dir(child, path + "/", depth + 1)
                elif child.type in (T_FILE, T_FILE + 7):
                    files[path] = read_file(child)
                elif child.type in (T_LNK, T_LNK + 7):
                    files[path] = child.symlink

    root = _parse_inode(inodes.data,
                        inodes.at(root_ref >> 16, root_ref & 0xFFFF),
                        block_log)
    if root.type not in (T_DIR, T_DIR + 7):
        raise CorruptError("squashfs: root is not a directory")
    walk_dir(root, "", 0)
    return files


# ---------------------------------------------------------------------------
# Writer (flat layout: root dir + regular files; used for fixtures and
# as the archive-creation surface — the reference is read-only here)
# ---------------------------------------------------------------------------

def _meta_blocks(payload: bytes, method: int):
    """Returns (encoded bytes, packed offset of each 8 KiB block) so
    refs can be expressed as (packed block offset << 16) | in-block
    offset."""
    out = bytearray()
    packed = []
    for i in range(0, max(len(payload), 1), META_SIZE):
        packed.append(len(out))
        chunk = payload[i:i + META_SIZE]
        comp = _compress(method, chunk)
        if len(comp) < len(chunk):
            out += struct.pack("<H", len(comp)) + comp
        else:
            out += struct.pack("<H", len(chunk) | 0x8000) + chunk
    return bytes(out), packed


def _meta_ref(packed, unpacked_pos):
    return packed[unpacked_pos // META_SIZE], unpacked_pos % META_SIZE


def write_squashfs(files: dict, method: int = M_ZSTD,
                   block_log: int = 17) -> bytes:
    block_size = 1 << block_log
    names = sorted(files)
    out = bytearray(96)  # superblock patched at the end

    # data blocks
    file_meta = []  # (start_block, [block_sizes])
    for name in names:
        data = files[name]
        start = len(out)
        sizes = []
        for i in range(0, len(data), block_size):
            chunk = data[i:i + block_size]
            comp = _compress(method, chunk)
            if len(comp) < len(chunk):
                sizes.append(len(comp))
                out += comp
            else:
                sizes.append(len(chunk) | (1 << 24))
                out += chunk
        file_meta.append((start, sizes))

    # inode payload: files then root dir; inode numbers 1..N+1
    inode_payload = bytearray()
    inode_refs = []  # unpacked positions
    for i, name in enumerate(names):
        inode_refs.append(len(inode_payload))
        start, sizes = file_meta[i]
        inode_payload += struct.pack("<HHHHII", T_FILE, 0o644, 0, 0, 0,
                                     i + 1)
        inode_payload += struct.pack("<IIII", start, FRAG_EMPTY, 0,
                                     len(files[name]))
        inode_payload += struct.pack(f"<{len(sizes)}I", *sizes)

    # group directory entries by the metadata block of their inode (one
    # header per group: a header carries a single inode start_block)
    groups = []  # (block_index, [entry indices])
    for i in range(len(names)):
        blk = inode_refs[i] // META_SIZE
        if groups and groups[-1][0] == blk:
            groups[-1][1].append(i)
        else:
            groups.append((blk, [i]))
    dir_len = sum(12 + sum(8 + len(names[i].encode()) for i in g)
                  for _blk, g in groups)

    root_unpacked = len(inode_payload)
    root_num = len(names) + 1
    inode_payload += struct.pack("<HHHHII", T_DIR, 0o755, 0, 0, 0,
                                 root_num)
    inode_payload += struct.pack("<IIHHI", 0, 2, dir_len + 3, 0,
                                 root_num)

    inode_enc, inode_packed = _meta_blocks(bytes(inode_payload), method)

    dir_payload = bytearray()
    for blk, g in groups:
        dir_payload += struct.pack("<III", len(g) - 1, inode_packed[blk],
                                   1)
        for i in g:
            nb = names[i].encode()
            dir_payload += struct.pack(
                "<HhHH", inode_refs[i] % META_SIZE, i, T_FILE,
                len(nb) - 1) + nb
    assert len(dir_payload) == dir_len
    dir_enc, _dir_packed = _meta_blocks(bytes(dir_payload), method)

    inode_table = len(out)
    out += inode_enc
    dir_table = len(out)
    out += dir_enc
    frag_table = len(out)          # zero fragments: empty table
    id_table = len(out)
    # id table: one id (0) in a metadata block + u64 pointer to it
    id_block_pos = len(out) + 8
    out += struct.pack("<Q", id_block_pos)
    out += struct.pack("<H", 4 | 0x8000) + struct.pack("<I", 0)

    size = len(out)
    pad = (-size) % 4096
    out += bytes(pad)

    rblk, roff = _meta_ref(inode_packed, root_unpacked)
    root_ref = (rblk << 16) | roff
    struct.pack_into(
        "<IIIIIHHHHHHQQQQQQQQ", out, 0,
        MAGIC, len(names) + 1, 0, block_size, 0, method, block_log,
        0, 1, 4, 0, root_ref, size, id_table,
        0xFFFFFFFFFFFFFFFF, inode_table, dir_table, frag_table,
        0xFFFFFFFFFFFFFFFF)
    return bytes(out)
