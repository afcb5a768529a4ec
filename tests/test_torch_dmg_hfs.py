"""The port's DMG and HFS+ (tpu7z_torch/containers/{dmg,hfs}.py) against
tpu7z's: the same image bytes from the same partitions and files, the
same members from each image (raw, zero, zlib and bzip2 chunks, an HFS+
volume nested in a DMG, as tests/test_dmg_hfs.py nests one), and the
same errors for corrupt and unsupported images."""

import bz2
import plistlib
import struct
import zlib

import pytest

from tests.torch_parity import flipped, noise, same, text
from tpu7z.containers import dmg as jdmg
from tpu7z.containers import hfs as jhfs
from tpu7z_torch.containers import dmg as tdmg
from tpu7z_torch.containers import hfs as thfs

PARTS = {"Apple_HFS": text(200000, 1), "rand": noise(90000, 2), "odd": text(1234, 3),
         "big": text(3 << 20, 4)[: (2 << 20) + 512 * 7]}
HFS_FILES = {"readme.txt": text(8500, 5), "empty.bin": b"", "rand.dat": noise(30000, 6),
             "big.bin": text(400000, 7)}


def _dmg(parts: dict) -> bytes:
    """A DMG of {name: [(chunk type, stored bytes, sectors)]}: the layout
    of tpu7z's write_dmg with each chunk's type chosen."""
    data, blkx = bytearray(), []
    for i, (name, chunks) in enumerate(parts.items()):
        table, sec = [], 0
        for ctype, stored, nsec in chunks:
            table.append((ctype, sec, nsec, len(data), len(stored)))
            data += stored
            sec += nsec
        table.append((0xFFFFFFFF, sec, 0, len(data), 0))
        mish = bytearray(204)
        mish[0:4] = b"mish"
        struct.pack_into(">I", mish, 4, 1)
        struct.pack_into(">QQ", mish, 8, 0, sec)
        struct.pack_into(">I", mish, 200, len(table))
        for row in table:
            mish += struct.pack(">IIQQQQ", row[0], 0, *row[1:])
        blkx.append({"Attributes": "0x0050", "ID": str(i), "Name": name, "Data": bytes(mish)})
    xml = plistlib.dumps({"resource-fork": {"blkx": blkx}})
    koly = bytearray(512)
    koly[0:4] = b"koly"
    struct.pack_into(">II", koly, 4, 4, 512)
    struct.pack_into(">QQ", koly, 24, 0, len(data))
    struct.pack_into(">QQ", koly, 216, len(data), len(xml))
    return bytes(data) + xml + bytes(koly)


SECTOR_TEXT = text(512 * 40, 8)
CHUNKS = {
    "raw": (1, SECTOR_TEXT, 40),
    "zero": (2, b"", 40),
    "zlib": (0x80000005, zlib.compress(SECTOR_TEXT), 40),
    "bzip2": (0x80000006, bz2.compress(SECTOR_TEXT), 40),
    "comment": (0x7FFFFFFE, b"", 0),
}


def test_dmg_writer_equals_tpu7z():
    img = same(jdmg.write_dmg, tdmg.write_dmg, PARTS)[1]
    assert same(jdmg.is_dmg, tdmg.is_dmg, img) == ("ok", True)
    got = same(jdmg.read_dmg, tdmg.read_dmg, img)
    assert got[0] == "ok" and got[1]["odd"][:1234] == PARTS["odd"]


def test_dmg_chunk_types_read_as_tpu7z():
    img = _dmg({"all": list(CHUNKS.values()), "bz": [CHUNKS["bzip2"]] * 3})
    got = same(jdmg.read_dmg, tdmg.read_dmg, img)
    assert got == ("ok", {"all": SECTOR_TEXT + bytes(len(SECTOR_TEXT)) + SECTOR_TEXT * 2,
                          "bz": SECTOR_TEXT * 3})


@pytest.mark.parametrize("case,error", [
    ("koly", "CorruptError"), ("plist_bounds", "CorruptError"), ("plist", "CorruptError"),
    ("no_blkx", "CorruptError"), ("mish", "CorruptError"), ("data_fork", "CorruptError"),
    ("raw_size", "CorruptError"), ("zlib", "CorruptError"), ("zlib_size", "CorruptError"),
    ("bzip2", "CorruptError"), ("bzip2_size", "CorruptError"), ("adc", "UnsupportedError"),
    ("lzfse", "UnsupportedError")])
def test_dmg_corrupt_and_unsupported_as_tpu7z(case, error):
    def one(ctype, stored, nsec):
        return _dmg({"p": [(ctype, stored, nsec)]})
    good = tdmg.write_dmg({"p": text(20000, 9)})
    koly = len(good) - 512
    bad = {"koly": lambda: flipped(good, koly),
           "plist_bounds": lambda: good[:koly + 216] + struct.pack(">Q", 1 << 40)
           + good[koly + 224:],
           "plist": lambda: flipped(good, koly - 300),
           "no_blkx": lambda: _dmg({}),
           # "mish" -> "misA" in the base64 of the one table
           "mish": lambda: _dmg({"p": []}).replace(b"\t\t\t\tbWlzaA", b"\t\t\t\tbWlzQQ"),
           "data_fork": lambda: good[:koly + 24] + struct.pack(">Q", 1 << 20) + good[koly + 32:],
           "raw_size": lambda: one(1, SECTOR_TEXT[:-1], 40),
           "zlib": lambda: one(0x80000005, flipped(zlib.compress(SECTOR_TEXT), 5), 40),
           "zlib_size": lambda: one(0x80000005, zlib.compress(SECTOR_TEXT), 41),
           "bzip2": lambda: one(0x80000006, flipped(bz2.compress(SECTOR_TEXT), 30), 40),
           "bzip2_size": lambda: one(0x80000006, bz2.compress(SECTOR_TEXT), 39),
           "adc": lambda: one(0x80000004, b"abc", 1),
           "lzfse": lambda: one(0x80000007, b"abc", 1)}[case]()
    assert same(jdmg.read_dmg, tdmg.read_dmg, bad)[0] == error


@pytest.mark.parametrize("nfiles", [0, 40, 60], ids=["files", "forty", "sixty"])
def test_hfs_writer_equals_tpu7z(nfiles):
    """From about 50 files on, tpu7z's writer makes a catalog its own
    reader refuses ("fork shorter than logical size"); the port writes
    the same bytes and refuses them alike."""
    files = {f"f{i:03d}": bytes([i]) * (i * 91 + 3) for i in range(nfiles)} or HFS_FILES
    img = same(jhfs.write_hfs, thfs.write_hfs, files)[1]
    assert same(jhfs.is_hfs, thfs.is_hfs, img) == ("ok", True)
    got = same(jhfs.read_hfs, thfs.read_hfs, img)
    assert got == (("ok", files) if nfiles < 50 else
                   ("CorruptError", "hfs: fork shorter than logical size"))


def test_hfs_in_dmg_read_as_tpu7z():
    inner = jhfs.write_hfs({"doc.txt": text(1400, 10)})
    nested = same(jdmg.read_dmg, tdmg.read_dmg, jdmg.write_dmg({"hfs_part": inner}))[1]
    assert same(jhfs.read_hfs, thfs.read_hfs, nested["hfs_part"]) == \
        ("ok", {"doc.txt": text(1400, 10)})


@pytest.mark.parametrize("case", ["signature", "block_size", "extent", "catalog_node",
                                  "node_size"])
def test_hfs_corrupt_as_tpu7z(case):
    img = thfs.write_hfs({"a.bin": b"x" * 9000, "b.txt": text(3000, 11)})
    bad = {"signature": lambda: flipped(img, 1024),
           "block_size": lambda: img[:1024 + 40] + struct.pack(">I", 1000) + img[1024 + 44:],
           "extent": lambda: img[:1024 + 272 + 16] + struct.pack(">I", 0xFFFFF)
           + img[1024 + 272 + 20:],
           "catalog_node": lambda: _catalog_byte(img, 8, 0x7F),
           "node_size": lambda: _catalog_byte(img, 32, 0x00)}[case]()
    assert same(jhfs.read_hfs, thfs.read_hfs, bad)[0] == "CorruptError"


def _catalog_byte(img: bytes, at: int, value: int) -> bytes:
    """`img` with one byte of its catalog file's header node set."""
    bs = struct.unpack_from(">I", img, 1024 + 40)[0]
    start = struct.unpack_from(">I", img, 1024 + 272 + 16)[0] * bs
    return img[:start + at] + bytes([value]) + img[start + at + 1:]
