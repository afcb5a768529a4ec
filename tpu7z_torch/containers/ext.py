"""ext2/ext3/ext4 filesystem image reader.

A copy of tpu7z/containers/ext.py, on the host: the same bytes, lines
and errors from the same input.

Behavioral reference: CPP/7zip/Archive/ExtHandler.cpp
(read-only ext handler); structures per the public ext4 disk layout:

  superblock @1024: s_inodes_count u32, s_blocks_count u32, ...,
    s_log_block_size @24 (block = 1024 << v), s_inodes_per_group @40,
    s_magic 0xEF53 @56, s_feature_incompat @96, s_inode_size @88,
    s_desc_size @254 (64-bit feature)
  group descriptors after the superblock block: inode table ptr @8
    (u32 low; +u32 high @40 when 64-bit)
  inode: mode u16, size_lo @4, blocks @40.. : either the classic
    12-direct/1-indirect/2x/3x block map, or an extent tree
    (magic 0xF30A) when EXT4_EXTENTS_FL (0x80000) is set
  directory entries: inode u32, rec_len u16, name_len u8, type u8, name

Symlinks, devices and extended attributes are skipped; hardlinked
content duplicates.
"""

from __future__ import annotations

import struct

from ..utils.errors import CorruptError, UnsupportedError

MAGIC = 0xEF53
ROOT_INO = 2
EXTENTS_FL = 0x80000
INLINE_DATA_FL = 0x10000000
S_IFMT = 0xF000
S_IFDIR = 0x4000
S_IFREG = 0x8000


class _Fs:
    __slots__ = ("data", "bs", "inosz", "inodes_per_group", "group_desc",
                 "desc_size", "ngroups", "rev")


def _load_fs(data: bytes) -> _Fs:
    if len(data) < 2048:
        raise CorruptError("ext: image too small")
    sb = data[1024:2048]
    magic = struct.unpack_from("<H", sb, 56)[0]
    if magic != MAGIC:
        raise CorruptError("ext: bad superblock magic")
    fs = _Fs()
    fs.data = data
    log_bs = struct.unpack_from("<I", sb, 24)[0]
    fs.bs = 1024 << log_bs
    fs.inodes_per_group = struct.unpack_from("<I", sb, 40)[0]
    inodes_count = struct.unpack_from("<I", sb, 0)[0]
    rev = struct.unpack_from("<I", sb, 76)[0]
    fs.rev = rev
    fs.inosz = struct.unpack_from("<H", sb, 88)[0] if rev >= 1 else 128
    incompat = struct.unpack_from("<I", sb, 96)[0]
    fs.desc_size = 32
    if incompat & 0x80:  # 64-bit
        fs.desc_size = struct.unpack_from("<H", sb, 254)[0] or 64
    if incompat & 0x1:   # compression
        raise UnsupportedError("ext: compressed filesystem")
    fs.ngroups = (inodes_count + fs.inodes_per_group - 1) \
        // fs.inodes_per_group
    gd_block = 2 if fs.bs == 1024 else 1
    fs.group_desc = data[gd_block * fs.bs:
                         gd_block * fs.bs + fs.ngroups * fs.desc_size]
    return fs


def _inode_raw(fs: _Fs, ino: int) -> bytes:
    if ino < 1 or ino > fs.ngroups * fs.inodes_per_group:
        raise CorruptError(f"ext: inode {ino} out of range")
    group = (ino - 1) // fs.inodes_per_group
    index = (ino - 1) % fs.inodes_per_group
    gd = fs.group_desc[group * fs.desc_size:(group + 1) * fs.desc_size]
    table = struct.unpack_from("<I", gd, 8)[0]
    if fs.desc_size >= 64:
        table |= struct.unpack_from("<I", gd, 40)[0] << 32
    off = table * fs.bs + index * fs.inosz
    raw = fs.data[off:off + fs.inosz]
    if len(raw) < min(fs.inosz, 128):
        raise CorruptError("ext: truncated inode table")
    return raw


def _block(fs: _Fs, blk: int) -> bytes:
    if blk == 0:
        return b"\x00" * fs.bs  # sparse hole
    off = blk * fs.bs
    if off + fs.bs > len(fs.data):
        raise CorruptError("ext: block out of range")
    return fs.data[off:off + fs.bs]


def _extent_blocks(fs: _Fs, node: bytes, out: dict):
    """Walk an extent tree node (60-byte inode area or a full block)."""
    magic, entries, _maxe, depth = struct.unpack_from("<HHHH", node, 0)
    if magic != 0xF30A:
        raise CorruptError("ext: bad extent magic")
    for i in range(entries):
        e = 12 + i * 12
        if depth == 0:
            lblk, ln, hi, lo = struct.unpack_from("<IHHI", node, e)
            real_len = ln if ln <= 32768 else ln - 32768  # unwritten
            phys = (hi << 32) | lo
            for j in range(real_len):
                out[lblk + j] = 0 if ln > 32768 else phys + j
        else:
            lblk, lo, hi = struct.unpack_from("<IIH", node, e)
            child = (hi << 32) | lo
            _extent_blocks(fs, _block(fs, child), out)


def _file_content(fs: _Fs, inode: bytes) -> bytes:
    size = struct.unpack_from("<I", inode, 4)[0]
    # offset 108 is size_high only for regular files on rev>=1
    # filesystems; on rev-0/ext2 it is i_dir_acl (and always i_dir_acl
    # for directories), which would yield a bogus huge size
    mode = struct.unpack_from("<H", inode, 0)[0]
    if fs.rev >= 1 and (mode & S_IFMT) == S_IFREG:
        size |= struct.unpack_from("<I", inode, 108)[0] << 32  # size_high
    flags = struct.unpack_from("<I", inode, 32)[0]
    blockarea = inode[40:100]
    if flags & INLINE_DATA_FL:
        return blockarea[:size]
    nblocks = (size + fs.bs - 1) // fs.bs
    chunks = []
    if flags & EXTENTS_FL:
        bmap: dict[int, int] = {}
        _extent_blocks(fs, blockarea, bmap)
        for lb in range(nblocks):
            chunks.append(_block(fs, bmap.get(lb, 0)))
    else:
        ptrs = struct.unpack_from("<15I", blockarea, 0)
        per = fs.bs // 4

        def walk(blk, depth):
            if depth == 0:
                chunks.append(_block(fs, blk))
                return 1
            if blk == 0:
                n = per ** depth
                chunks.extend([b"\x00" * fs.bs] * n)
                return n
            sub = struct.unpack(f"<{per}I", _block(fs, blk))
            cnt = 0
            for p in sub:
                if len(chunks) * 1 >= nblocks:
                    break
                cnt += walk(p, depth - 1)
            return cnt

        for p in ptrs[:12]:
            if len(chunks) >= nblocks:
                break
            chunks.append(_block(fs, p))
        for depth, p in ((1, ptrs[12]), (2, ptrs[13]), (3, ptrs[14])):
            if len(chunks) < nblocks:
                walk(p, depth)
    return b"".join(chunks)[:size]


def _read_dir(fs: _Fs, inode: bytes):
    raw = _file_content(fs, inode)
    pos = 0
    while pos + 8 <= len(raw):
        ino, rec_len, name_len, _ftype = struct.unpack_from(
            "<IHBB", raw, pos)
        if rec_len < 8:
            raise CorruptError("ext: bad directory record")
        if ino:
            name = raw[pos + 8:pos + 8 + name_len].decode(
                "utf-8", "replace")
            if name not in (".", ".."):
                yield name, ino
        pos += rec_len


def read_ext(data: bytes) -> dict[str, bytes]:
    """Extract every regular file (and empty dirs as 'name/')."""
    fs = _load_fs(data)
    out: dict[str, bytes] = {}

    def walk(ino: int, prefix: str, depth: int):
        if depth > 64:
            raise CorruptError("ext: directory loop")
        inode = _inode_raw(fs, ino)
        for name, cino in _read_dir(fs, inode):
            cinode = _inode_raw(fs, cino)
            mode = struct.unpack_from("<H", cinode, 0)[0]
            kind = mode & S_IFMT
            if kind == S_IFDIR:
                before = len(out)
                walk(cino, prefix + name + "/", depth + 1)
                if len(out) == before:
                    out[prefix + name + "/"] = b""
            elif kind == S_IFREG:
                out[prefix + name] = _file_content(fs, cinode)
            # symlinks/devices/sockets skipped (reference lists them
            # but extraction of special files is not meaningful here)

    walk(ROOT_INO, "", 0)
    out.pop("lost+found/", None)
    return out
