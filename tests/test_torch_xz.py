"""The .xz container in the port (tpu7z_torch/containers/xz.py), its
checks (tpu7z_torch/ops/hashing.py: crc32, crc64 and their native forms)
and LZMA2's group-parallel decode (tpu7z_torch/parallel/decode.py:
scan_lzma2_groups, decompress_lzma2) against tpu7z's on the CPU: the
same bytes for every check and for multi-block streams, empty input,
corrupt checks and headers detected, the standard library's .xz read
and the port's read by it, and the same bytes from 1, 2 and 4 threads."""

import lzma as std
import zlib

import numpy as np
import pytest

pytest.importorskip("torch")

from tpu7z.containers import xz as jxz  # noqa: E402
from tpu7z.ops import hashing as jhash  # noqa: E402
from tpu7z.parallel import decode as jdecode  # noqa: E402
from tpu7z_torch.containers import xz  # noqa: E402
from tpu7z_torch.models.lzma import lzma2  # noqa: E402
from tpu7z_torch.ops import hashing  # noqa: E402
from tpu7z_torch.parallel import decode  # noqa: E402
from tpu7z_torch.utils.corpus import make_corpus  # noqa: E402
from tpu7z_torch.utils.errors import CorruptError  # noqa: E402

TEXT = 696156
CHECKS = {"none": xz.CHECK_NONE, "crc32": xz.CHECK_CRC32, "crc64": xz.CHECK_CRC64}


@pytest.fixture(scope="module")
def data():
    return make_corpus(TEXT + (1 << 20))[TEXT:TEXT + 300000]


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 31, 4096, 100003])
def test_crcs_equal_zlib_and_tpu7z(n):
    buf = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    want32 = zlib.crc32(buf)
    assert hashing.crc32(buf) == hashing.crc32_native(buf) == jhash.crc32(buf) == want32
    want64 = jhash.crc64(buf)
    assert hashing.crc64(buf) == hashing.crc64_native(buf) == want64
    cut = n // 3
    assert hashing.crc32_native(buf[cut:], hashing.crc32_native(buf[:cut])) == want32
    assert hashing.crc64_native(buf[cut:], hashing.crc64_native(buf[:cut])) == want64


def test_crc64_check_value():
    assert hashing.crc64_native(b"123456789") == 0x995DC9BBDF1939FA


@pytest.mark.parametrize("block_size", [None, 1 << 16, 100000])
@pytest.mark.parametrize("check", list(CHECKS))
def test_compress_equals_tpu7z(data, check, block_size):
    got = xz.compress(data, check=CHECKS[check], block_size=block_size)
    assert got == jxz.compress(data, check=CHECKS[check], block_size=block_size)
    assert xz.decompress(got) == data
    assert jxz.decompress(got) == data
    assert std.decompress(got, format=std.FORMAT_XZ) == data


@pytest.mark.parametrize("check", list(CHECKS))
def test_empty_input(check):
    got = xz.compress(b"", check=CHECKS[check])
    assert got == jxz.compress(b"", check=CHECKS[check])
    assert xz.decompress(got) == b""
    assert std.decompress(got) == b""


@pytest.mark.parametrize("check", [std.CHECK_NONE, std.CHECK_CRC32, std.CHECK_CRC64])
@pytest.mark.parametrize("preset", [1, 6])
def test_standard_library_xz_decodes(data, check, preset):
    framed = std.compress(data, format=std.FORMAT_XZ, check=check, preset=preset)
    assert xz.decompress(framed) == data == jxz.decompress(framed)


@pytest.mark.parametrize("check", ["crc32", "crc64"])
def test_corrupt_check_is_detected(data, check):
    framed = bytearray(xz.compress(data, check=CHECKS[check]))
    index_at = len(framed) - 12 - 12     # the footer, then the index's 12 bytes
    framed[index_at - 1] ^= 1            # the last byte of the block's check
    with pytest.raises(CorruptError, match=f"block {check} mismatch"):
        xz.decompress(bytes(framed))
    assert xz.decompress(bytes(framed), verify_check=False) == data
    with pytest.raises(Exception, match=f"block {check} mismatch"):
        jxz.decompress(bytes(framed))


@pytest.mark.parametrize("case", ["magic", "header_crc", "block_header_crc", "footer",
                                  "truncated", "filter"])
def test_corrupt_stream_raises_as_tpu7z(data, case):
    good = bytearray(xz.compress(data[:20000]))
    bad = {"magic": b"\xfd7zXY\x00" + bytes(good[6:]),
           "header_crc": bytes(good[:8]) + b"\x00\x00\x00\x00" + bytes(good[12:]),
           "block_header_crc": bytes(good[:14]) + bytes([good[14] ^ 4]) + bytes(good[15:]),
           "footer": bytes(good[:-2]) + b"ZY",
           "truncated": bytes(good[:len(good) // 2]),
           "filter": None}[case]
    if case == "filter":
        # a block header naming a delta filter before LZMA2
        bad = std.compress(data[:20000], format=std.FORMAT_XZ, filters=[
            {"id": std.FILTER_DELTA, "dist": 1}, {"id": std.FILTER_LZMA2}])
    with pytest.raises(Exception) as got:
        xz.decompress(bad)
    with pytest.raises(Exception) as want:
        jxz.decompress(bad)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("threads", [1, 2, 4])
@pytest.mark.parametrize("shards", [None, 1 << 15, 100000])
def test_decompress_lzma2_in_threads(data, shards, threads):
    stream = lzma2.compress(data, shard_size=shards)
    assert decode.scan_lzma2_groups(stream) == jdecode.scan_lzma2_groups(stream)
    assert decode.decompress_lzma2(stream, threads=threads) == data
    assert jdecode.decompress_lzma2(stream, threads=threads) == data


@pytest.mark.parametrize("case", ["bad_control", "first_not_reset", "overrun"])
def test_scan_lzma2_groups_refuses_as_tpu7z(data, case):
    stream = lzma2.compress(data[:50000], shard_size=1 << 14)
    bad = {"bad_control": b"\x03" + stream[1:],
           "first_not_reset": b"\x02\x00\x00x" + stream,
           "overrun": stream[:10]}[case]
    with pytest.raises(CorruptError) as got:
        decode.scan_lzma2_groups(bad)
    with pytest.raises(Exception) as want:
        jdecode.scan_lzma2_groups(bad)
    assert str(got.value) == str(want.value)
