"""The port's NTFS reader and LZNT1 codec (tpu7z_torch/containers/ntfs.py)
against tpu7z's, on the volumes tests/test_ntfs.py builds (resident,
non-resident and LZNT1-compressed $DATA), on LZNT1 streams of seeded
inputs, and on torn and corrupt volumes: the same files, bytes and
errors."""

import struct

import pytest

from tests.test_ntfs import (CB, REC, _attr_nonres_comp, _attr_resident, _file_record, _fname,
                             _mk_volume)
from tests.torch_parity import flipped, noise, same, text
from tpu7z.containers import ntfs as jntfs
from tpu7z_torch.containers import ntfs as tntfs

STREAMS = {
    "text": lambda: text(3 * 4096 + 123, 1),
    "noise": lambda: noise(4096 + 7, 2),
    "zeros": lambda: bytes(10000),
    "period": lambda: b"ntfs compressed payload line\n" * 700,
    "short": lambda: b"abc",
    "empty": lambda: b"",
}


@pytest.mark.parametrize("kind", STREAMS)
def test_lznt1_equals_tpu7z(kind):
    data = STREAMS[kind]()
    packed = same(jntfs.lznt1_compress, tntfs.lznt1_compress, data)[1]
    assert same(jntfs.lznt1_decompress, tntfs.lznt1_decompress, packed) == ("ok", data)
    assert same(jntfs.lznt1_decompress, tntfs.lznt1_decompress, packed,
                out_size=len(data) + 4096)[0] == "ok"


@pytest.mark.parametrize("case", ["truncated_chunk", "truncated_phrase", "phrase_at_start",
                                  "displacement"])
def test_lznt1_corrupt_as_tpu7z(case):
    bad = {"truncated_chunk": lambda: tntfs.lznt1_compress(text(5000, 3))[:-40],
           "truncated_phrase": lambda: struct.pack("<H", 0xB000 | 2) + b"\x02a\x01",
           "phrase_at_start": lambda: struct.pack("<H", 0xB000 | 2) + b"\x01\x00\x10",
           "displacement": lambda: struct.pack("<H", 0xB000 | 3) + b"\x02a\x00\x70"}[case]()
    assert same(jntfs.lznt1_decompress, tntfs.lznt1_decompress, bad)[0] == "CorruptError"


def _compressed_volume(payload: bytes) -> bytes:
    """tests/test_ntfs.py's volume with an LZNT1-compressed $DATA in place
    of hello.txt (16-cluster units, padded by a sparse run)."""
    img, _big = _mk_volume()
    img = bytearray(img + b"\0" * (16 * CB))
    comp = jntfs.lznt1_compress(payload.ljust(16 * CB, b"\0"))
    nc = -(-len(comp) // CB)
    img[16 * CB:16 * CB + len(comp)] = comp
    runs = bytes([0x11, nc, 16]) + bytes([0x01, 16 - nc])
    rec = _file_record([_attr_resident(0x30, _fname(5, "packed.bin")),
                        _attr_nonres_comp(0x80, runs, 16, len(payload))])
    img[2 * CB + 6 * REC:2 * CB + 7 * REC] = rec
    return bytes(img)


VOLUMES = {
    "plain": lambda: _mk_volume()[0],
    "compressed": lambda: _compressed_volume((b"ntfs compressed payload line\n" * 2000)
                                             [: 3 * CB + 123]),
    "compressed_text": lambda: _compressed_volume(text(5 * CB, 4)),
}


@pytest.mark.parametrize("kind", VOLUMES)
def test_volumes_read_as_tpu7z(kind):
    img = VOLUMES[kind]()
    assert same(jntfs.is_ntfs, tntfs.is_ntfs, img) == ("ok", True)
    got = same(jntfs.read_ntfs, tntfs.read_ntfs, img)
    assert got[0] == "ok" and "sub/inner.bin" in got[1]


@pytest.mark.parametrize("case", ["torn", "boot", "zeros", "geometry", "record_size",
                                  "file_magic", "run_outside", "usa_header", "attr_length"])
def test_corrupt_volumes_as_tpu7z(case):
    img, _ = _mk_volume()
    bad = {"torn": lambda: flipped(img, 2 * CB + 510),
           "boot": lambda: flipped(img, 3),
           "zeros": lambda: bytes(8192),
           "geometry": lambda: img[:11] + struct.pack("<H", 0) + img[13:],
           "record_size": lambda: img[:64] + b"\x30" + img[65:],
           "file_magic": lambda: flipped(img, 2 * CB),
           "run_outside": lambda: _runs_past_end(img),
           "usa_header": lambda: img[:2 * CB + 4] + struct.pack("<HH", 0x30, 1)
           + img[2 * CB + 8:],
           "attr_length": lambda: img[:2 * CB + 0x3C] + bytes(4) + img[2 * CB + 0x40:]}[case]()
    assert same(jntfs.read_ntfs, tntfs.read_ntfs, bad)[0] == "CorruptError"


def _runs_past_end(img: bytes) -> bytes:
    """big.dat's run list pointed at a cluster past the image's end."""
    rec = img[2 * CB + 9 * REC:2 * CB + 10 * REC]
    at = rec.index(bytes([0x11, 0x02, 0x06]))
    return (img[:2 * CB + 9 * REC + at] + bytes([0x11, 0x02, 0x7F])
            + img[2 * CB + 9 * REC + at + 3:])
