"""The port's RAR5 codec and rar container (tpu7z_torch/models/rar5.py,
tpu7z_torch/containers/rar.py) against tpu7z's: the same streams and
archives from the same input, the same members from tpu7z's archives,
hand-built RAR4 stored archives and streams with rep codes and filters,
the same errors."""

import struct
import zlib

import pytest

from tests.torch_parity import flipped, noise, same, text
from tpu7z.containers import rar as jrar
from tpu7z.models import rar5 as jr5
from tpu7z_torch.containers import rar as trar
from tpu7z_torch.models import rar5 as tr5

SIZES = {"empty": b"", "one_byte": b"Q", "under_16": b"fifteen bytes!!",
         "exactly_32768": text(32768, 1), "32769": text(32769, 2),
         "text_and_noise": text(60000, 3) + noise(20000, 4) + text(40000, 5),
         "noise": noise(30000, 6), "zeros": bytes(70000)}


@pytest.mark.parametrize("kind", list(SIZES))
def test_codec_equals_tpu7z(kind):
    data = SIZES[kind]
    stream = same(jr5.encode, tr5.encode, data)[1]
    assert same(jr5.decode, tr5.decode, stream, len(data)) == ("ok", data)


def test_far_matches_equal_tpu7z():
    """Repeats at growing distances: every distance-slot class, with the
    far slots' length bonus."""
    base = noise(1 << 10, 7)
    data = bytearray()
    for k in range(9):
        data += base + noise(1 << (10 + k // 2), 8 + k)
    data = bytes(data[:1 << 18])
    stream = same(jr5.encode, tr5.encode, data)[1]
    assert same(jr5.decode, tr5.decode, stream, len(data)) == ("ok", data)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_delta_filter_equals_tpu7z(channels):
    data = bytes((i * 5 + (i >> 3)) & 0xFF for i in range(4096)) + b"t" * 64
    filters = [(0, 4096, jr5.FILTER_DELTA, channels)]
    stream = same(jr5.encode, tr5.encode, data, filters)[1]
    assert same(jr5.decode, tr5.decode, stream, len(data)) == ("ok", data)


def test_encoder_refuses_other_filters_as_tpu7z():
    assert same(jr5.encode, tr5.encode, b"x" * 100, [(0, 50, jr5.FILTER_E8, 0)]) == \
        ("UnsupportedError", "encoder supports delta filters only")


@pytest.mark.parametrize("ftype", [jr5.FILTER_E8, jr5.FILTER_E8E9, jr5.FILTER_ARM,
                                   jr5.FILTER_DELTA, 7])
def test_decoder_filters_equal_tpu7z(ftype):
    """The decoder's filter pass over code-like bytes: E8 and E9 calls,
    ARM BL words, delta, an unknown type; and a range past the end."""
    body = bytearray(noise(8192, 20))
    for i in range(0, 8000, 37):
        body[i] = (0xE8, 0xE9)[i % 2]
        body[i + 4] = (0x00, 0xFF)[i % 3 == 0]
    for k in range(3, 8192, 64):
        body[k] = 0xEB
    body = bytes(body)
    filters = [(100, 4000, ftype, 2), (5000, 3000, ftype, 3)]
    assert same(jr5._apply_filters, tr5._apply_filters, body, filters)[0] in \
        ("ok", "UnsupportedError")
    same(jr5._apply_filters, tr5._apply_filters, body, [(100, 9000, ftype, 1)])
    same(jr5._apply_filters, tr5._apply_filters, body, [(500, 10, ftype, 1), (100, 10, ftype, 1)])


@pytest.mark.parametrize("method,dict_bits", [(3, 17), (1, 22), (5, 30), (0, 12)])
def test_method_vint_equals_tpu7z(method, dict_bits):
    assert same(jr5.make_method_vint, tr5.make_method_vint, method, dict_bits)[0] == "ok"


@pytest.mark.parametrize("where", ["flags", "checksum", "cut", "middle", "short_out"])
def test_corrupt_streams_as_tpu7z(where):
    data = text(20000, 9)
    stream = jr5.encode(data)
    bad = {"flags": flipped(stream, 0, 0x40), "checksum": flipped(stream, 1),
           "cut": stream[:len(stream) // 2], "middle": flipped(stream, len(stream) // 2),
           "short_out": stream}[where]
    size = len(data) + 100 if where == "short_out" else len(data)
    same(jr5.decode, tr5.decode, bad, size)


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("kind", list(SIZES))
def test_write_rar5_equals_tpu7z(kind, compress):
    files = {"dir/m.bin": SIZES[kind], "a.txt": text(3000, 10), "e": b""}
    blob = same(jrar.write_rar5, trar.write_rar5, files, compress)[1]
    assert same(jrar.read_rar, trar.read_rar, blob) == ("ok", files)


def test_write_rar5_store_equals_tpu7z():
    files = {"doc.txt": b"rar5 store payload " * 100, "z.bin": bytes(range(256)), "e": b"",
             "ünï.txt": noise(5000, 11)}
    blob = same(jrar.write_rar5_store, trar.write_rar5_store, files)[1]
    assert same(jrar.read_rar, trar.read_rar, blob) == ("ok", files)
    assert trar.is_rar(blob) and jrar.is_rar(blob)


@pytest.mark.parametrize("size", [1, 1 << 17, (1 << 17) + 1, (1 << 18) + 3])
def test_dictionary_from_member_size_as_tpu7z(size):
    """`write_rar5` declares a dictionary of the member's size rounded up
    to a power of two, at least 128 KiB (tpu7z/containers/rar.py:247):
    every distance lies inside it, so the archive reads back; the port
    writes the same."""
    data = (text(3000, 12) * (size // 3000 + 1))[:size]
    blob = same(jrar.write_rar5, trar.write_rar5, {"m": data})[1]
    assert same(jrar.read_rar, trar.read_rar, blob) == ("ok", {"m": data})


def _rar4(files, method=0x30, flags=0):
    out = bytearray(jrar.SIG4)

    def block(htype, hflags, body, data=b""):
        hdr = struct.pack("<BHH", htype, hflags, 7 + len(body)) + body
        out.extend(struct.pack("<H", zlib.crc32(hdr) & 0xFFFF) + hdr + data)

    block(0x73, 0, b"\0" * 6)
    for name, data in files.items():
        nb = name.encode("latin-1")
        body = struct.pack("<IIBIIBBHI", len(data), len(data), 0, zlib.crc32(data), 0, 20,
                           method, len(nb), 0) + nb
        block(0x74, flags, body, data)
    block(0x7B, 0, b"")
    return bytes(out)


def test_rar4_stored_read_as_tpu7z():
    files = {"old.txt": b"rar4 stored " * 50, "e": b"", "bin": noise(3000, 13)}
    assert same(jrar.read_rar, trar.read_rar, _rar4(files)) == ("ok", files)
    # a directory entry is skipped
    assert same(jrar.read_rar, trar.read_rar, _rar4({"d": b""}, flags=0xE0)) == ("ok", {})


def _rar5_compressed(comp: int, data: bytes = b"y" * 64):
    """One RAR5 member whose compression info is `comp`, its body the data."""
    nb = b"a.txt"
    body = (jrar._vint_enc(0x04) + jrar._vint_enc(len(data)) + jrar._vint_enc(0)
            + struct.pack("<I", zlib.crc32(data)) + jrar._vint_enc(comp)
            + jrar._vint_enc(1) + jrar._vint_enc(len(nb)) + nb)
    hdr = jrar._vint_enc(2) + jrar._vint_enc(0x02) + jrar._vint_enc(len(data)) + body
    sized = jrar._vint_enc(len(hdr)) + hdr
    return jrar.SIG5 + struct.pack("<I", zlib.crc32(sized)) + sized + data


def _rar():
    return jrar.write_rar5({"a.txt": text(8000, 14), "b.bin": noise(900, 15)})


@pytest.mark.parametrize("case", [
    "bad_magic", "empty", "header_crc", "data_crc", "truncated_header", "truncated_data",
    "garbage_member", "algo_v1", "solid", "rar4_header_crc", "rar4_data_crc", "rar4_method",
    "rar4_truncated", "rar4_bad_size", "vint_too_long"])
def test_corrupt_archives_as_tpu7z(case):
    """Each error of the readers: the same class and message."""
    blob = _rar()
    store = jrar.write_rar5_store({"s.bin": noise(500, 16)})
    r4 = _rar4({"f": b"data" * 40})
    bad = {
        "bad_magic": b"Rar!\x1a\x07\x02\x00" + blob[8:], "empty": b"",
        "header_crc": flipped(blob, 20), "data_crc": flipped(store, len(store) - 30),
        "truncated_header": blob[:26], "truncated_data": store[:len(store) - 100],
        "garbage_member": _rar5_compressed(1 << 7), "algo_v1": _rar5_compressed(1 | 3 << 7),
        "solid": _rar5_compressed(0x40 | 3 << 7), "rar4_header_crc": flipped(r4, 10),
        "rar4_data_crc": flipped(r4, len(r4) - 20), "rar4_method": _rar4({"f": b"x"}, 0x33),
        "rar4_truncated": r4[:30], "rar4_bad_size": r4[:7 + 5] + b"\x03\x00" + r4[14:],
        "vint_too_long": jrar.SIG5 + b"\0\0\0\0" + b"\xff" * 12,
    }[case]
    kind, _ = same(jrar.read_rar, trar.read_rar, bad)
    assert kind in ("CorruptError", "UnsupportedError")
