"""APFS container/volume reader (+ minimal image writer for tests).

A copy of tpu7z/containers/apfs.py, on the host: the same bytes, lines
and errors from the same input.

Behavioral reference: CPP/7zip/Archive/ApfsHandler.cpp (struct offsets
cited inline: CSuperBlock::Parse:354, C_omap_phys::Parse:551,
CBTreeNodePhys:642, CApfs::Parse:882, j_drec_val:1005,
j_file_extent_val:1260). Subset scope, like this repo's other disk
readers: block-0 superblock (no checkpoint-descriptor scan), first
volume, unencrypted, uncompressed files; hashed and plain directory
records; fletcher64-verified object blocks.

The writer builds a tiny spec-shaped single-volume image (leaf-root
B-trees, physical omaps) so the reader and tests have fixtures —
macOS is the only producer of real APFS images and is unavailable here.
"""

from __future__ import annotations

import struct

from ..utils.errors import CorruptError, UnsupportedError

OBJECT_TYPE_NX_SUPERBLOCK = 0x1
OBJECT_TYPE_BTREE = 0x2
OBJECT_TYPE_BTREE_NODE = 0x3
OBJECT_TYPE_OMAP = 0xB
OBJECT_TYPE_FS = 0xD
OBJECT_TYPE_FSTREE = 0xE
OBJ_PHYSICAL = 0x40000000

BTNODE_ROOT = 1
BTNODE_LEAF = 2
BTNODE_FIXED_KV_SIZE = 4

APFS_TYPE_INODE = 3
APFS_TYPE_DSTREAM_ID = 6
APFS_TYPE_FILE_EXTENT = 8
APFS_TYPE_DIR_REC = 9

ROOT_DIR_INO_NUM = 2

INO_EXT_TYPE_NAME = 4
INO_EXT_TYPE_DSTREAM = 8


def fletcher64(data: bytes) -> int:
    """APFS object checksum (fletcher64 over u32 words, mod 2^32-1),
    computed with the checksum field zeroed."""
    m = 0xFFFFFFFF
    s1 = 0
    s2 = 0
    for (w,) in struct.iter_unpack("<I", data):
        s1 = (s1 + w) % m
        s2 = (s2 + s1) % m
    c1 = m - ((s1 + s2) % m)
    c2 = m - ((s1 + c1) % m)
    return c1 | (c2 << 32)


def _check_obj(block: bytes) -> None:
    want, = struct.unpack_from("<Q", block, 0)
    got = fletcher64(b"\0" * 8 + block[8:])
    if want != got:
        raise CorruptError("apfs: object checksum mismatch")


def is_apfs(raw: bytes) -> bool:
    return len(raw) > 0x28 and raw[32:36] == b"NXSB"


class _BTNode:
    __slots__ = ("flags", "level", "nkeys", "entries")


def _parse_btnode(block: bytes, is_root_hint: bool = True) -> _BTNode:
    """btree_node_phys (ApfsHandler.cpp:642): toc at 0x38+table_space.off,
    keys relative to the key area, values backwards from the block end
    (minus the 0x28-byte btree_info on root nodes)."""
    _check_obj(block)
    n = _BTNode()
    n.flags, n.level = struct.unpack_from("<HH", block, 0x20)
    n.nkeys, = struct.unpack_from("<I", block, 0x24)
    ts_off, ts_len = struct.unpack_from("<HH", block, 0x28)
    toc = 0x38 + ts_off
    key_area = toc + ts_len
    val_end = len(block) - (0x28 if n.flags & BTNODE_ROOT else 0)
    n.entries = []
    fixed = bool(n.flags & BTNODE_FIXED_KV_SIZE)
    for i in range(n.nkeys):
        if fixed:
            ko, vo = struct.unpack_from("<HH", block, toc + 4 * i)
            kl = vl = None
        else:
            ko, kl, vo, vl = struct.unpack_from("<HHHH", block, toc + 8 * i)
        kstart = key_area + ko
        key = block[kstart:kstart + kl] if kl is not None else \
            block[kstart:kstart + 16]
        if vo == 0xFFFF:
            val = b""
        else:
            vstart = val_end - vo
            val = block[vstart:vstart + vl] if vl is not None else \
                block[vstart:vstart + 16]
        n.entries.append((key, val))
    return n


class ApfsReader:
    def __init__(self, raw: bytes):
        if not is_apfs(raw):
            raise CorruptError("apfs: bad NXSB signature")
        self.raw = raw
        sb = raw[:4096]
        self.bs, = struct.unpack_from("<I", sb, 0x24)
        if self.bs < 4096 or self.bs > 65536 or self.bs & (self.bs - 1):
            raise CorruptError("apfs: bad block size")
        sb = self.block(0)
        _check_obj(sb)
        otype, = struct.unpack_from("<I", sb, 24)
        if otype & 0xFFFF != OBJECT_TYPE_NX_SUPERBLOCK:
            raise CorruptError("apfs: block 0 is not a superblock")
        self.block_count, = struct.unpack_from("<Q", sb, 0x28)
        self.nx_omap_oid, = struct.unpack_from("<Q", sb, 0xA0)
        self.fs_oid, = struct.unpack_from("<Q", sb, 0xB8)
        if self.fs_oid == 0:
            raise UnsupportedError("apfs: no volume")

    def block(self, idx: int) -> bytes:
        off = idx * self.bs
        b = self.raw[off:off + self.bs]
        if len(b) != self.bs:
            raise CorruptError("apfs: block outside image")
        return b

    def _omap_lookup_all(self, omap_paddr: int) -> dict:
        """Load an object map: oid -> paddr (latest xid wins).
        C_omap_phys::Parse:551 -> tree_oid; the tree is PHYSICAL, so
        its oid is a block address."""
        ob = self.block(omap_paddr)
        _check_obj(ob)
        otype, = struct.unpack_from("<I", ob, 24)
        if otype & 0xFFFF != OBJECT_TYPE_OMAP:
            raise CorruptError("apfs: not an omap object")
        tree_oid, = struct.unpack_from("<Q", ob, 0x30)
        out: dict = {}

        def walk(paddr: int, level_guard: int):
            if level_guard > 16:
                raise CorruptError("apfs: omap tree too deep")
            node = _parse_btnode(self.block(paddr))
            for key, val in node.entries:
                oid, xid = struct.unpack_from("<QQ", key, 0)
                if node.level == 0:
                    _fl, _sz, paddr2 = struct.unpack_from("<IIQ", val, 0)
                    if oid not in out or out[oid][0] <= xid:
                        out[oid] = (xid, paddr2)
                else:
                    child, = struct.unpack_from("<Q", val, 0)
                    walk(child, level_guard + 1)

        walk(tree_oid, 0)
        return {oid: paddr for oid, (xid, paddr) in out.items()}

    def list_files(self) -> dict:
        """Extract the first volume: name -> content bytes."""
        nx_omap = self._omap_lookup_all(self.nx_omap_oid)
        if self.fs_oid not in nx_omap:
            raise CorruptError("apfs: volume oid not in container omap")
        apsb = self.block(nx_omap[self.fs_oid])
        _check_obj(apsb)
        if apsb[32:36] != b"APSB":
            raise CorruptError("apfs: bad volume superblock")
        vol_omap_oid, = struct.unpack_from("<Q", apsb, 0x80)
        root_tree_oid, = struct.unpack_from("<Q", apsb, 0x88)
        vomap = self._omap_lookup_all(vol_omap_oid)

        # walk the FS tree, gathering records by type
        drecs = []      # (parent_id, name, file_id, flags)
        extents = {}    # file/dstream id -> [(logical, len, paddr)]
        sizes = {}      # inode id -> dstream size
        inode_stream = {}  # inode id -> private/dstream id

        def resolve(oid: int) -> int:
            if oid in vomap:
                return vomap[oid]
            return oid  # physical

        def walk(paddr: int, guard: int):
            if guard > 24:
                raise CorruptError("apfs: fs tree too deep")
            node = _parse_btnode(self.block(paddr))
            for key, val in node.entries:
                if node.level > 0:
                    child, = struct.unpack_from("<Q", val, 0)
                    walk(resolve(child), guard + 1)
                    continue
                idt, = struct.unpack_from("<Q", key, 0)
                jtype = idt >> 60
                jid = idt & 0x0FFFFFFFFFFFFFFF
                if jtype == APFS_TYPE_DIR_REC:
                    # hashed key: u32 name_len_and_hash then name;
                    # plain key: u16 name_len then name. Disambiguate by
                    # checking the trailing NUL at the hashed length.
                    nl_hash, = struct.unpack_from("<I", key, 8)
                    nlen = nl_hash & 0x3FF
                    if 12 + nlen <= len(key) and nlen and \
                            key[12 + nlen - 1] == 0:
                        name = key[12:12 + nlen - 1]
                    else:
                        nlen, = struct.unpack_from("<H", key, 8)
                        name = key[10:10 + max(nlen - 1, 0)]
                    file_id, _date, flags = struct.unpack_from("<QQH",
                                                               val, 0)
                    drecs.append((jid, name.decode("utf-8", "replace"),
                                  file_id, flags))
                elif jtype == APFS_TYPE_FILE_EXTENT:
                    logical, = struct.unpack_from("<Q", key, 8)
                    lenfl, paddr2 = struct.unpack_from("<QQ", val, 0)
                    extents.setdefault(jid, []).append(
                        (logical, lenfl & 0x00FFFFFFFFFFFFFF, paddr2))
                elif jtype == APFS_TYPE_INODE:
                    # j_inode_val fixed part is 0x5C bytes; xfields
                    # follow as a blob header (u16 num, u16 used) + 4B
                    # entries (type u8, flags u8, size u16), then data
                    # 8-byte aligned (ApfsHandler j_inode parsing)
                    if len(val) > 0x5C + 4:
                        self._inode_xfields(val, jid, sizes, inode_stream)

        walk(resolve(root_tree_oid), 0)

        # assemble paths (parent chains) and file contents
        info = {}
        for parent, name, fid, flags in drecs:
            info[fid] = (parent, name, flags)
        def path_of(fid: int) -> str:
            parts = []
            guard = 0
            cur = fid
            while cur in info and guard < 64:
                parent, name, _ = info[cur]
                parts.append(name)
                cur = parent
                guard += 1
            return "/".join(reversed(parts))

        files = {}
        for fid, (parent, name, flags) in info.items():
            is_dir = flags & 0xF == 4  # DT_DIR
            if is_dir:
                continue
            stream_id = inode_stream.get(fid, fid)
            exts = sorted(extents.get(stream_id, extents.get(fid, [])))
            size = sizes.get(fid)
            buf = bytearray()
            for (logical, ln, paddr) in exts:
                if len(buf) < logical:
                    buf.extend(b"\0" * (logical - len(buf)))
                off = paddr * self.bs
                buf += self.raw[off:off + ln]
            if size is not None:
                buf = buf[:size]
            files[path_of(fid)] = bytes(buf)
        return files

    @staticmethod
    def _inode_xfields(val: bytes, jid: int, sizes: dict,
                       inode_stream: dict):
        num, _used = struct.unpack_from("<HH", val, 0x5C)
        hdr = 0x5C + 4
        data = hdr + 4 * num
        for i in range(num):
            xt, _xf, xs = struct.unpack_from("<BBH", val, hdr + 4 * i)
            if data + xs > len(val):
                break
            if xt == INO_EXT_TYPE_DSTREAM and xs >= 8:
                size, = struct.unpack_from("<Q", val, data)
                sizes[jid] = size
            data += (xs + 7) & ~7


def read_apfs(raw: bytes) -> dict:
    return ApfsReader(raw).list_files()


# --------------------------------------------------------------- writer ---

def _obj(block: bytearray, oid: int, xid: int, otype: int, subtype: int):
    struct.pack_into("<QQII", block, 8, oid, xid, otype, subtype)
    ck = fletcher64(b"\0" * 8 + bytes(block[8:]))
    struct.pack_into("<Q", block, 0, ck)


def _btnode(bs: int, oid: int, otype_sub: int, entries, root=True,
            level=0, child_fmt=False) -> bytearray:
    """Build a leaf/internal B-tree node block with a variable-kv toc."""
    b = bytearray(bs)
    flags = (BTNODE_ROOT if root else 0) | (BTNODE_LEAF if level == 0
                                            else 0)
    struct.pack_into("<HHI", b, 0x20, flags, level, len(entries))
    toc_len = 8 * len(entries)
    toc_len = (toc_len + 7) & ~7
    struct.pack_into("<HH", b, 0x28, 0, toc_len)
    key_area = 0x38 + toc_len
    val_end = bs - (0x28 if root else 0)
    kpos = 0
    vpos = 0
    for i, (key, val) in enumerate(entries):
        b[key_area + kpos:key_area + kpos + len(key)] = key
        vpos += len(val)
        b[val_end - vpos:val_end - vpos + len(val)] = val
        struct.pack_into("<HHHH", b, 0x38 + 8 * i, kpos, len(key),
                         vpos, len(val))
        kpos += (len(key) + 7) & ~7
    _obj(b, oid, 1, OBJECT_TYPE_BTREE | OBJ_PHYSICAL, otype_sub)
    return b


def write_apfs(files: dict, bs: int = 4096) -> bytes:
    """Minimal single-volume APFS image (fixture writer; the reference
    has no APFS writer — superset, like the other disk test writers)."""
    # layout: 0 NXSB | 1 nx omap | 2 nx omap tree | 3 APSB
    #         4 vol omap | 5 vol omap tree | 6 fs root tree | 7.. data
    blocks: list = [None] * 7
    data_start = 7
    data = bytearray()
    fs_entries = []
    fid = 16
    for name, content in files.items():
        nb = (len(content) + bs - 1) // bs if content else 0
        paddr = data_start + len(data) // bs
        data += content.ljust(nb * bs, b"\0")
        nbz = name.encode() + b"\0"
        # DIR_REC (hashed key layout) under root
        key = struct.pack("<QI", (APFS_TYPE_DIR_REC << 60)
                          | ROOT_DIR_INO_NUM, len(nbz)) + nbz
        val = struct.pack("<QQH", fid, 0, 8)  # DT_REG
        fs_entries.append((key, val))
        # INODE with a dstream xfield carrying the size
        ikey = struct.pack("<Q", (APFS_TYPE_INODE << 60) | fid)
        fixed = bytearray(0x5C)
        struct.pack_into("<QQ", fixed, 0, ROOT_DIR_INO_NUM, fid)
        xf = struct.pack("<HH", 1, 0) + struct.pack("<BBH",
                                                    INO_EXT_TYPE_DSTREAM,
                                                    0, 40)
        dstream = struct.pack("<QQQQQ", len(content), nb * bs, 0, 0, 0)
        fs_entries.append((ikey, bytes(fixed) + xf + dstream))
        if nb:
            ekey = struct.pack("<QQ", (APFS_TYPE_FILE_EXTENT << 60) | fid,
                               0)
            eval_ = struct.pack("<QQQ", nb * bs, paddr, 0)
            fs_entries.append((ekey, eval_))
        fid += 1

    fs_root = _btnode(bs, 6, OBJECT_TYPE_FSTREE, fs_entries)

    # volume omap: maps root_tree_oid (1026) -> block 6
    vol_tree = _btnode(bs, 5, OBJECT_TYPE_OMAP,
                       [(struct.pack("<QQ", 1026, 1),
                         struct.pack("<IIQ", 0, bs, 6))])
    vol_omap = bytearray(bs)
    struct.pack_into("<Q", vol_omap, 0x30, 5)
    _obj(vol_omap, 4, 1, OBJECT_TYPE_OMAP | OBJ_PHYSICAL, 0)

    apsb = bytearray(bs)
    apsb[32:36] = b"APSB"
    struct.pack_into("<Q", apsb, 0x80, 4)      # omap_oid (physical)
    struct.pack_into("<Q", apsb, 0x88, 1026)   # root_tree_oid (virtual)
    _obj(apsb, 1025, 1, OBJECT_TYPE_FS, 0)

    # container omap: maps fs_oid (1025) -> block 3
    nx_tree = _btnode(bs, 2, OBJECT_TYPE_OMAP,
                      [(struct.pack("<QQ", 1025, 1),
                        struct.pack("<IIQ", 0, bs, 3))])
    nx_omap = bytearray(bs)
    struct.pack_into("<Q", nx_omap, 0x30, 2)
    _obj(nx_omap, 1, 1, OBJECT_TYPE_OMAP | OBJ_PHYSICAL, 0)

    total_blocks = data_start + len(data) // bs
    nxsb = bytearray(bs)
    nxsb[32:36] = b"NXSB"
    struct.pack_into("<I", nxsb, 0x24, bs)
    struct.pack_into("<Q", nxsb, 0x28, total_blocks)
    struct.pack_into("<Q", nxsb, 0xA0, 1)      # nx omap oid (physical)
    struct.pack_into("<Q", nxsb, 0xB8, 1025)   # fs_oid[0]
    _obj(nxsb, 1, 1, OBJECT_TYPE_NX_SUPERBLOCK, 0)

    blocks = [bytes(nxsb), bytes(nx_omap), bytes(nx_tree), bytes(apsb),
              bytes(vol_omap), bytes(vol_tree), bytes(fs_root)]
    return b"".join(blocks) + bytes(data)
