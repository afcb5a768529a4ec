"""The port's LHA codec and lzh container (tpu7z_torch/models/lha_huffman.py,
tpu7z_torch/containers/lzh.py) against tpu7z's: the same lh4-lh7 streams
and archives from the same input, the same members from tpu7z's archives
and from hand-built level-1 and level-2 headers, the same errors; and
the three places where the port repairs tpu7z (ROADMAP.md section 3):
an unchecked CRC-16, a level-1 member read from its extension headers,
and two names that one `?` makes one."""

import struct

import pytest

from tests.torch_parity import flipped, noise, outcome, same, text
from tpu7z.containers import lzh as jlzh
from tpu7z.models import lha_huffman as jlha
from tpu7z_torch.containers import lzh as tlzh
from tpu7z_torch.models import lha_huffman as tlha

SIZES = {"empty": b"", "one_byte": b"Q", "under_16": b"fifteen bytes!!",
         "exactly_32768": text(32768, 1), "32769": text(32769, 2),
         "text_and_noise": text(40000, 3) + noise(9000, 4) + text(12000, 5),
         "noise": noise(20000, 6), "zeros": bytes(30000)}
METHODS = ["lh4", "lh5", "lh6", "lh7"]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", list(SIZES))
def test_codec_equals_tpu7z(kind, method):
    data = SIZES[kind]
    stream = same(jlha.encode, tlha.encode, data, method)[1]
    assert same(jlha.decode, tlha.decode, stream, len(data), method) == ("ok", data)


@pytest.mark.parametrize("method", ["lh0", "lh5", "lh7"])
def test_write_lzh_equals_tpu7z(method):
    files = {k + ".bin": v for k, v in SIZES.items()}
    blob = same(jlzh.write_lzh, tlzh.write_lzh, files, method)[1]
    assert same(jlzh.read_lzh, tlzh.read_lzh, blob) == ("ok", files)


@pytest.mark.parametrize("kind", list(SIZES))
def test_one_member_archives_equal_tpu7z(kind):
    files = {"d/member.dat": SIZES[kind]}
    blob = same(jlzh.write_lzh, tlzh.write_lzh, files)[1]
    assert same(jlzh.read_lzh, tlzh.read_lzh, blob) == ("ok", files)


def test_empty_archive_and_input_as_tpu7z():
    blob = same(jlzh.write_lzh, tlzh.write_lzh, {})[1]
    assert blob == b"\x00"
    for raw in (blob, b"", b"\x00\x00junk"):
        assert same(jlzh.read_lzh, tlzh.read_lzh, raw) == ("ok", {})


def _archive():
    return jlzh.write_lzh({"a.txt": text(5000, 7), "b.bin": noise(300, 8)})


@pytest.mark.parametrize("case", [
    "bad_method", "bad_magic", "header_sum", "level_3", "truncated_header", "truncated_data",
    "cut_one_byte", "corrupt_body"])
def test_corrupt_archives_raise_as_tpu7z(case):
    """A bad method id, header checksum, header level, a cut header or
    member, and a flipped byte in an lh5 body: the same error class and
    message (a flipped body byte is caught by the Huffman decode before
    the CRC the port adds)."""
    blob = _archive()
    bad = {"bad_method": flipped(blob, 3, 0x20), "bad_magic": b"\x16\x00-zz5-" + blob[7:],
           "header_sum": flipped(blob, 1, 0x01), "level_3": flipped(blob, 20, 0x03),
           "truncated_header": blob[:15], "truncated_data": blob[:60],
           "cut_one_byte": blob[:-2], "corrupt_body": flipped(blob, 40)}[case]
    kind, _ = same(jlzh.read_lzh, tlzh.read_lzh, bad)
    assert kind in ("CorruptError", "UnsupportedError")


def test_unsupported_method_as_tpu7z():
    body = bytearray(_archive())
    body[2:7] = b"-lh9-"
    body[1] = sum(body[2:2 + body[0]]) & 0xFF
    assert same(jlzh.read_lzh, tlzh.read_lzh, bytes(body)) == \
        ("UnsupportedError", "lzh: method -lh9-")


def test_long_name_raises_as_tpu7z():
    """A name over 255 bytes does not fit its length byte: tpu7z's
    ValueError, reproduced."""
    assert same(jlzh.write_lzh, tlzh.write_lzh, {"n" * 300: b"abc"}) == \
        ("ValueError", "bytes must be in range(0, 256)")


def test_non_ascii_name_written_as_tpu7z():
    """One non-ASCII name: its characters written as `?`, as tpu7z writes
    them; the member's bytes read back."""
    blob = same(jlzh.write_lzh, tlzh.write_lzh, {"ünï.txt": b"payload"})[1]
    assert same(jlzh.read_lzh, tlzh.read_lzh, blob) == ("ok", {"?n?.txt": b"payload"})


def test_names_made_one_are_refused_where_tpu7z_loses_a_member():
    """Two names that `?` makes one: tpu7z writes both, and its reader
    keeps only the later; the port refuses to write them."""
    files = {"é.txt": b"first", "ü.txt": b"second"}
    assert jlzh.read_lzh(jlzh.write_lzh(files)) == {"?.txt": b"second"}
    with pytest.raises(tlzh.UnsupportedError,
                       match=r"names 'é.txt' and 'ü.txt' are both written as '\?.txt'"):
        tlzh.write_lzh(files)


def test_crc_is_checked_where_tpu7z_returns_other_bytes():
    """A flipped byte in a stored member: tpu7z returns it as read; the
    port raises on the member's CRC-16."""
    data = noise(200, 9)
    blob = jlzh.write_lzh({"s.bin": data}, method="lh0")
    bad = flipped(blob, len(blob) - 20)
    got = jlzh.read_lzh(bad)["s.bin"]
    assert got != data and len(got) == len(data)
    with pytest.raises(tlzh.CorruptError, match="lzh: CRC mismatch for s.bin"):
        tlzh.read_lzh(bad)


def _level2(name: bytes, data: bytes, method=b"-lh0-", payload=None, dirname=b""):
    """One level-2 member: the basic header, a filename (0x01) and, with
    `dirname`, a directory (0x02) extension, then the data."""
    payload = data if payload is None else payload
    exts = b""
    for etype, edata in ((0x01, name), *(((0x02, dirname),) if dirname else ())):
        exts += struct.pack("<H", 3 + len(edata)) + bytes([etype]) + edata
    exts += b"\x00\x00"
    size = 24 + len(exts) - 2
    head = (struct.pack("<H", size) + method
            + struct.pack("<III", len(payload), len(data), 0) + bytes([0x20, 2])
            + struct.pack("<H", tlzh._crc16(data)) + b"U")
    return head + exts + payload


def _level1(name: bytes, data: bytes, ext: bytes = b""):
    """One level-1 stored member, with `ext` as one extension record of
    type 0x40 (attributes) before the data, which its pack size counts."""
    exts = (bytes([0x40]) + ext + b"\x00\x00") if ext else b""
    first_next = 3 + len(ext) if ext else 0
    basic = (b"-lh0-" + struct.pack("<III", len(data) + len(exts), len(data), 0)
             + bytes([0x20, 1, len(name)]) + name + struct.pack("<H", tlzh._crc16(data))
             + b"U" + struct.pack("<H", first_next))
    return bytes([len(basic), sum(basic) & 0xFF]) + basic + exts + data


def test_level2_headers_read_as_tpu7z():
    a, b = text(3000, 10), noise(500, 11)
    raw = (_level2(b"one.txt", a) + _level2(b"two.bin", b, dirname=b"sub\xff")
           + _level2(b"lz.txt", a, b"-lh5-", jlha.encode(a, "lh5")) + b"\x00")
    assert same(jlzh.read_lzh, tlzh.read_lzh, raw) == \
        ("ok", {"one.txt": a, "sub/two.bin": b, "lz.txt": a})


def test_level1_without_extensions_reads_as_tpu7z():
    data = text(2000, 12)
    raw = _level1(b"plain.txt", data) + b"\x00"
    assert same(jlzh.read_lzh, tlzh.read_lzh, raw) == ("ok", {"plain.txt": data})


def test_level1_data_after_its_extensions_where_tpu7z_reads_them():
    """A level-1 member with an extension header: its data follows the
    extension, which its pack size counts. tpu7z's reader starts the data
    at the extension, then reads the member's last bytes as the next
    header and raises; the port reads the member."""
    data = text(2000, 13)
    raw = _level1(b"ext.txt", data, ext=b"\x20\x00") + b"\x00"
    assert outcome(jlzh.read_lzh, raw) == ("CorruptError", "lzh: truncated header")
    assert tlzh.read_lzh(raw) == {"ext.txt": data}
