"""The port's NSIS reader (tpu7z_torch/containers/nsis.py) against
tpu7z's, on the installers tests/test_nsis.py builds (non-solid deflate,
solid LZMA, an install header naming its files) and on the other stream
shapes of NsisIn.cpp's table (non-solid LZMA, zstd either way, stored):
the same files; and the same errors for bzip2, BCJ-filtered LZMA and
damaged installers."""

import struct

import pytest

from tests.test_nsis import (_BLOCKS, _HDR, _firstheader, _mk_entries_header,
                             _mk_nonsolid_deflate, _mk_solid_lzma)
from tests.torch_parity import flipped, same
from tpu7z.containers import nsis as jnsis
from tpu7z.models.lzma import encoder as jlzenc
from tpu7z.models.zstd import frame as jzstd
from tpu7z_torch.containers import nsis as tnsis


def _nonsolid(pack, header=_HDR, flag=0x80000000):
    body = b""
    for part in (header, *_BLOCKS):
        packed = pack(part)
        body += struct.pack("<I", len(packed) | flag) + packed
    return b"\0" * 512 + _firstheader(len(header), len(body)) + body


def _solid(pack, header=_HDR):
    blob = struct.pack("<I", len(header)) + header
    for b in _BLOCKS:
        blob += struct.pack("<I", len(b)) + b
    body = pack(blob)
    return b"\0" * 1024 + _firstheader(len(header), len(body)) + body


def _lzma(data):
    stream, props = jlzenc.compress_raw(data, end_marker=True)
    return props + stream


INSTALLERS = {
    "nonsolid_deflate": _mk_nonsolid_deflate,
    "solid_lzma": _mk_solid_lzma,
    "entries": lambda: _mk_solid_lzma(_mk_entries_header()),
    "nonsolid_lzma": lambda: _nonsolid(_lzma),
    "solid_zstd": lambda: _solid(lambda b: jzstd.compress(b, level=3)),
    "nonsolid_zstd": lambda: _nonsolid(lambda b: jzstd.compress(b, level=3)),
    "stored": lambda: _nonsolid(lambda b: b, flag=0),
    "mz_stub": lambda: b"MZ" + _mk_nonsolid_deflate()[2:],
}


@pytest.mark.parametrize("kind", INSTALLERS)
def test_installers_read_as_tpu7z(kind):
    arc = INSTALLERS[kind]()
    assert same(jnsis.is_nsis, tnsis.is_nsis, arc) == ("ok", True)
    got = same(jnsis.read_nsis, tnsis.read_nsis, arc)
    assert got[0] == "ok" and _BLOCKS[0] in got[1].values() and _BLOCKS[1] in got[1].values()


def test_entries_header_parsed_as_tpu7z():
    assert same(jnsis.parse_entries, tnsis.parse_entries, _mk_entries_header())[0] == "ok"


@pytest.mark.parametrize("case,error", [
    ("not_nsis", "CorruptError"), ("truncated", "CorruptError"),
    ("truncated_stream", "CorruptError"), ("solid_header_size", "CorruptError"),
    ("bcj", "UnsupportedError"), ("solid_bzip2", "UnsupportedError"),
    ("nonsolid_bzip2", "UnsupportedError"), ("header_size", "CorruptError")])
def test_damaged_and_unsupported_as_tpu7z(case, error):
    bad = {"not_nsis": lambda: b"\0" * 4096,
           "truncated": lambda: _mk_nonsolid_deflate()[:-40],
           "truncated_stream": lambda: _mk_nonsolid_deflate()[:512 + 28 + 6],
           "solid_header_size": lambda: _solid(_lzma, header=_HDR)[:1024 + 20]
           + struct.pack("<I", len(_HDR) + 1) + _solid(_lzma)[1024 + 24:],
           "bcj": lambda: _solid(lambda b: b"\x01" + _lzma(b)),
           "solid_bzip2": lambda: _solid(lambda b: b"1\x05" + b),
           "nonsolid_bzip2": lambda: _nonsolid(lambda b: b"1\x05" + b),
           "header_size": lambda: flipped(_nonsolid(lambda b: b, flag=0), 512 + 20, 0x01)
           }[case]()
    assert same(jnsis.read_nsis, tnsis.read_nsis, bad)[0] == error
