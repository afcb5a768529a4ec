"""The port's disk images and small handlers (tpu7z_torch/containers/
disk.py and misc.py) against tpu7z's: mbr, gpt, vhd (fixed and dynamic),
qcow2, vdi, vmdk and vhdx; swf, flv, ihex, base64, split, pe, elf, macho
and arj. The same bytes from each writer (vhd, ihex, swf, arj), the same
members from each image (tests/test_disk_misc.py's fixtures among
them), the same magic tests and the same errors. A ZWS (LZMA) swf is
where the two part: tpu7z imports a module it does not have and raises
ImportError; the port raises UnsupportedError."""

import base64
import struct
import sys
import time
import zlib

import pytest

from tests.test_disk_misc import _mk_gpt, _mk_mbr, _mk_qcow2
from tests.torch_parity import flipped, noise, outcome, same, text
from tpu7z.containers import disk as jdisk
from tpu7z.containers import misc as jmisc
from tpu7z_torch.containers import disk as tdisk
from tpu7z_torch.containers import misc as tmisc

GUID_BAT = bytes.fromhex("6677c22d23f600429d64115e9bfd4a08")
GUID_META = bytes.fromhex("06a27c8b90479a4bb8a8ff25f73c5d06")
GUID_BLOCK = bytes.fromhex("3767a1ca36fa434db3b633f0aa44e76b")
GUID_SIZE = bytes.fromhex("2442a52f1bcd7648b2115dbed83bf4b8")
GUID_LSEC = bytes.fromhex("1dbf41816fa90947ba47f233a8faab5f")


def _vhd_dynamic(payload: bytes, block: int = 8192) -> bytes:
    """A dynamic VHD of two blocks: the first holds `payload`, the second
    is unallocated."""
    footer = bytearray(512)
    footer[:8] = b"conectix"
    struct.pack_into(">Q", footer, 16, 512)
    struct.pack_into(">Q", footer, 48, 2 * block)
    struct.pack_into(">I", footer, 60, 3)
    struct.pack_into(">I", footer, 64, (~sum(footer[:64] + footer[68:])) & 0xFFFFFFFF)
    dyn = bytearray(1024)
    dyn[:8] = b"cxsparse"
    struct.pack_into(">Q", dyn, 16, 1536)
    struct.pack_into(">II", dyn, 28, 2, block)
    bat = struct.pack(">II", 4, 0xFFFFFFFF).ljust(512, b"\xff")
    return bytes(footer + dyn) + bat + bytes(512) + payload.ljust(block, b"\0") + bytes(footer)


def _vdi(payload: bytes, bs: int = 1 << 16) -> bytes:
    hdr = bytearray(512)
    hdr[64:68] = b"\x7f\x10\xda\xbe"
    struct.pack_into("<II", hdr, 340, 512, 512 + 8)
    struct.pack_into("<Q", hdr, 368, 2 * bs)
    struct.pack_into("<I", hdr, 376, bs)
    struct.pack_into("<I", hdr, 384, 2)
    return bytes(hdr) + struct.pack("<II", 0, 0xFFFFFFFF) + payload.ljust(bs, b"\0")


def _vmdk(payload: bytes, grain: int = 128) -> bytes:
    hdr = bytearray(512)
    hdr[0:4] = b"KDMV"
    struct.pack_into("<IIQQQQIQQQ", hdr, 4, 1, 0, grain * 2, grain, 0, 0, 512, 0, 1, 0)
    gd = struct.pack("<I", 2) + b"\0" * 508
    gt = struct.pack("<I", 3) + b"\0" * 508
    return bytes(hdr) + gd + gt + payload.ljust(grain * 512, b"\0")


def _vhdx(payload: bytes, block: int = 1 << 20) -> bytes:
    """A VHDX of two payload blocks, the first present, the second not."""
    img = bytearray(block * 2)
    img[:8] = b"vhdxfile"
    region, meta, bat = 192 << 10, 320 << 10, 384 << 10
    img[region:region + 4] = b"regi"
    struct.pack_into("<I", img, region + 8, 2)
    img[region + 16:region + 32] = GUID_BAT
    struct.pack_into("<QI", img, region + 32, bat, 1 << 20)
    img[region + 48:region + 64] = GUID_META
    struct.pack_into("<QI", img, region + 64, meta, 1 << 20)
    img[meta:meta + 8] = b"metadata"
    struct.pack_into("<H", img, meta + 10, 3)
    for k, (guid, value) in enumerate(((GUID_BLOCK, struct.pack("<I", block)),
                                       (GUID_SIZE, struct.pack("<Q", 2 * block)),
                                       (GUID_LSEC, struct.pack("<I", 512)))):
        e = meta + 32 + 32 * k
        img[e:e + 16] = guid
        struct.pack_into("<II", img, e + 16, 4096 + 64 * k, len(value))
        img[meta + 4096 + 64 * k:meta + 4096 + 64 * k + len(value)] = value
    struct.pack_into("<QQ", img, bat, block | 6, 0)
    img[block:block + len(payload)] = payload
    return bytes(img)


PAYLOAD = text(3000, 1)
DISKS = {
    "mbr": lambda: _mk_mbr()[0],
    "gpt": lambda: _mk_gpt()[0],
    "vhd": lambda: jdisk.write_vhd_fixed(PAYLOAD),
    "vhd_dynamic": lambda: _vhd_dynamic(PAYLOAD),
    "qcow": lambda: _mk_qcow2(PAYLOAD),
    "vdi": lambda: _vdi(PAYLOAD),
    "vmdk": lambda: _vmdk(PAYLOAD),
    "vhdx": lambda: _vhdx(PAYLOAD),
}


@pytest.mark.parametrize("kind", DISKS)
def test_disk_images_read_as_tpu7z(kind):
    fmt = kind.split("_")[0]
    img = DISKS[kind]()
    assert same(getattr(jdisk, f"is_{fmt}"), getattr(tdisk, f"is_{fmt}"), img) == ("ok", True)
    got = same(getattr(jdisk, f"read_{fmt}"), getattr(tdisk, f"read_{fmt}"), img)
    assert got[0] == "ok" and len(got[1]) >= 1


@pytest.mark.parametrize("size", [0, 511, 512, 5000])
def test_vhd_writer_equals_tpu7z(size):
    img = same(jdisk.write_vhd_fixed, tdisk.write_vhd_fixed, noise(size, 2))[1]
    assert same(jdisk.read_vhd, tdisk.read_vhd, img)[0] == "ok"


CORRUPT_DISKS = {
    "mbr_signature": ("mbr", lambda: _mk_mbr()[0][:510] + b"\0\0" + _mk_mbr()[0][512:]),
    "gpt_entries": ("gpt", lambda: flipped(_mk_gpt()[0], 1024)),
    "gpt_header": ("gpt", lambda: flipped(_mk_gpt()[0], 512 + 30)),
    "vhd_checksum": ("vhd", lambda: flipped(jdisk.write_vhd_fixed(b"x" * 512), 512 + 20)),
    "vhd_cookie": ("vhd", lambda: flipped(_vhd_dynamic(PAYLOAD), 512)),
    "vhd_type": ("vhd", lambda: _retype_vhd(jdisk.write_vhd_fixed(PAYLOAD), 4)),
    "qcow_encrypted": ("qcow", lambda: _mk_qcow2(b"x")[:32] + b"\0\0\0\1" + _mk_qcow2(b"x")[36:]),
    "qcow_magic": ("qcow", lambda: flipped(_mk_qcow2(b"x"), 0)),
    "vdi_magic": ("vdi", lambda: flipped(_vdi(PAYLOAD), 64)),
    "vmdk_magic": ("vmdk", lambda: flipped(_vmdk(PAYLOAD), 0)),
    "vhdx_regions": ("vhdx", lambda: flipped(_vhdx(PAYLOAD), 192 << 10)),
    "vhdx_metadata": ("vhdx", lambda: flipped(_vhdx(PAYLOAD), 320 << 10)),
}


def _retype_vhd(img: bytes, dtype: int) -> bytes:
    ft = bytearray(img[-512:])
    struct.pack_into(">I", ft, 60, dtype)
    struct.pack_into(">I", ft, 64, (~sum(ft[:64] + ft[68:])) & 0xFFFFFFFF)
    return img[:-512] + bytes(ft)


@pytest.mark.parametrize("case", CORRUPT_DISKS)
def test_corrupt_disk_images_as_tpu7z(case):
    fmt, make = CORRUPT_DISKS[case]
    assert same(getattr(jdisk, f"read_{fmt}"), getattr(tdisk, f"read_{fmt}"),
                make())[0] == "CorruptError"


# --- misc ---

def _fws(body: bytes) -> bytes:
    return b"FWS\x06" + struct.pack("<I", 8 + len(body)) + body


def _flv() -> bytes:
    hdr = b"FLV\x01\x05" + struct.pack(">I", 9) + b"\0\0\0\0"
    out = hdr
    for kind, payload in ((8, b"\xafAUDIO" * 30), (9, b"\x17VIDEO" * 20), (18, b"meta"),
                          (8, b"\xafMORE")):
        out += (bytes([kind]) + len(payload).to_bytes(3, "big") + b"\0" * 7 + payload
                + struct.pack(">I", 11 + len(payload)))
    return out


def _pe() -> bytes:
    dos = bytearray(0x40)
    dos[0:2] = b"MZ"
    struct.pack_into("<I", dos, 0x3C, 0x40)
    coff = b"PE\0\0" + struct.pack("<HHIIIHH", 0x8664, 2, 0, 0, 0, 0, 0)
    sects = (b".text\0\0\0" + struct.pack("<IIII", 16, 0x1000, 16, 0x100) + b"\0" * 16
             + b".data\0\0\0" + struct.pack("<IIII", 8, 0x2000, 8, 0x110) + b"\0" * 16)
    return (bytes(dos) + coff + sects).ljust(0x100, b"\0") + b"SECTION-CONTENT!" + b"datadata"


def _macho() -> bytes:
    seg = (struct.pack("<II", 0x19, 72) + b"__TEXT".ljust(16, b"\0") + b"\0" * 16
           + struct.pack("<QQ", 0x70, 8) + b"\0" * 16)
    hdr = b"\xcf\xfa\xed\xfe" + struct.pack("<iiIIIII", 0x0100000c, 0, 2, 1, len(seg), 0, 0)
    return (hdr + seg).ljust(0x70, b"\0") + b"machtext"


MOVIE = _fws(b"\x78\x00" + text(4000, 3))
HANDLERS = {
    "swf_fws": ("swf", lambda: MOVIE),
    "swf_cws": ("swf", lambda: jmisc.write_swf_cws(MOVIE)),
    "flv": ("flv", _flv),
    "ihex": ("ihex", lambda: jmisc.write_ihex(noise(70000, 4))),
    "ihex_based": ("ihex", lambda: jmisc.write_ihex(noise(3000, 5), base=0x12340)),
    "base64": ("base64", lambda: base64.encodebytes(noise(5000, 6))),
    "pe": ("pe", _pe),
    "elf": ("elf", lambda: open(sys.executable, "rb").read()),
    "macho": ("macho", _macho),
    "arj": ("arj", lambda: jmisc.write_arj({"a.txt": text(2000, 7), "b.bin": noise(300, 8),
                                            "empty": b""})),
}


@pytest.mark.parametrize("kind", HANDLERS)
def test_handlers_read_as_tpu7z(kind):
    fmt, make = HANDLERS[kind]
    blob = make()
    if fmt == "elf" and blob[:4] != b"\x7fELF":
        pytest.skip("this Python is not an ELF file")
    assert same(getattr(jmisc, f"is_{fmt}"), getattr(tmisc, f"is_{fmt}"), blob) == ("ok", True)
    got = same(getattr(jmisc, f"read_{fmt}"), getattr(tmisc, f"read_{fmt}"), blob)
    assert got[0] == "ok" and got[1]


@pytest.fixture
def fixed_clock(monkeypatch):
    """write_arj stamps each header with time.time()."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)


@pytest.mark.parametrize("writer,arg", [
    ("write_swf_cws", MOVIE), ("write_swf_cws", b"CWS" + MOVIE[3:]),
    ("write_ihex", noise(70000, 9)), ("write_ihex", b""),
    ("write_arj", {"a.txt": text(2000, 10), "dir/b": noise(99, 11)}), ("write_arj", {})],
    ids=["swf", "swf_not_fws", "ihex", "ihex_empty", "arj", "arj_empty"])
def test_writers_equal_tpu7z(fixed_clock, writer, arg):
    assert same(getattr(jmisc, writer), getattr(tmisc, writer), arg)[0] in ("ok", "CorruptError")


def test_ihex_based_writer_equals_tpu7z():
    assert same(jmisc.write_ihex, tmisc.write_ihex, noise(5000, 12), base=0x1FFF0)[0] == "ok"


def test_split_equals_tpu7z():
    whole = jmisc.write_arj({"a.txt": text(9000, 13)})
    vols = [whole[i:i + 1000] for i in range(0, len(whole), 1000)]
    assert same(jmisc.read_split, tmisc.read_split, vols)[0] == "ok"


CORRUPT_HANDLERS = {
    "swf_zlib": ("swf", lambda: b"CWS\x06\x20\x00\x00\x00garbage-not-zlib"),
    "swf_length": ("swf", lambda: MOVIE[:-1]),
    "swf_signature": ("swf", lambda: b"XWS" + MOVIE[3:]),
    "swf_zws_short": ("swf", lambda: b"ZWS\x0d" + MOVIE[4:12]),
    "flv_signature": ("flv", lambda: flipped(_flv(), 0)),
    "ihex_checksum": ("ihex", lambda: b":0400000001020304FF\n"),
    "ihex_record": ("ihex", lambda: b":04000000010203\n"),
    "base64": ("base64", lambda: b"!!!! not base64 ####\n"),
    "pe_signature": ("pe", lambda: flipped(_pe(), 0x40)),
    "macho_magic": ("macho", lambda: flipped(_macho(), 0)),
    "elf_magic": ("elf", lambda: b"\x7fELX" + bytes(60)),
    "arj_header_crc": ("arj", lambda: flipped(jmisc.write_arj({"x": b"y"}), 10)),
    "arj_magic": ("arj", lambda: flipped(jmisc.write_arj({"x": b"y"}), 0)),
}


@pytest.mark.parametrize("case", CORRUPT_HANDLERS)
def test_corrupt_handlers_as_tpu7z(case):
    fmt, make = CORRUPT_HANDLERS[case]
    assert same(getattr(jmisc, f"read_{fmt}"), getattr(tmisc, f"read_{fmt}"),
                make())[0] == "CorruptError"


def test_zws_swf_is_unsupported_where_tpu7z_fails_to_import():
    """tpu7z's read_swf decodes a ZWS body through models.lzma.lzma1, which
    its package does not have: ImportError. The port does not decode what
    tpu7z cannot: UnsupportedError, which the CLI turns into exit 2."""
    body = b"\x78\x00" + text(500, 14)
    zws = (b"ZWS\x0d" + struct.pack("<I", 8 + len(body)) + struct.pack("<I", 40)
           + b"\x5d\x00\x00\x10\x00" + zlib.compress(body))
    assert outcome(jmisc.read_swf, zws)[0] == "ImportError"
    assert outcome(tmisc.read_swf, zws) == ("UnsupportedError", "swf: ZWS (LZMA) body")
