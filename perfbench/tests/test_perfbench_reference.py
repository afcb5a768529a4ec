"""The plain references against the port's own output on the CPU, and
against independent readers: the port's LZ4 frame decoder, zlib."""

import zlib

import numpy as np
import pytest

from pb.corpus import make_corpus
from reference import gzip_member, lz4_frame


@pytest.fixture(scope="module")
def inputs():
    pool = make_corpus(3 << 20)
    rng = np.random.default_rng(19)
    out = [b"", b"x", b"abcd" * 5, bytes(300), b"abc" * 40000,
           rng.integers(0, 256, 70000, dtype=np.uint8).tobytes()]
    for _ in range(8):
        off = int(rng.integers(0, len(pool) - 300000))
        out.append(pool[off:off + int(rng.integers(1, 300000))])
    return out


def test_lz4_frame_is_the_ports(inputs):
    from tpu7z_torch.models.lz4 import frame
    from tpu7z_torch.parallel import sharded

    for data in inputs:
        want = lz4_frame.compress(data)
        assert sharded.shard_compress_lz4_device(memoryview(data), W=0, device="cpu") == want
        assert frame.decompress(want) == data
        assert lz4_frame.compare([(data, want, want)]) == [{"blocks_differing": 0,
                                                             "frames_not_decoding": 0}]


def test_gzip_member_is_the_ports(inputs):
    from tpu7z_torch.models.deflate import codec

    for data in inputs:
        want = gzip_member.compress(data)
        assert codec.gzip_compress(memoryview(data), device="cpu") == want
        assert zlib.decompress(want, wbits=31) == data
        assert gzip_member.compare([(data, want, want)]) == [{"members_differing": 0,
                                                               "members_not_inflating": 0}]


def test_controls_differ(inputs):
    data = inputs[-1] + inputs[4]
    assert lz4_frame.compress(data, tier_b=False) != lz4_frame.compress(data)
    weak = gzip_member.compress(data, hashlog=12)
    assert weak != gzip_member.compress(data) and zlib.decompress(weak, wbits=31) == data


def test_compare_counts_what_differs(inputs):
    data = inputs[4]
    want = lz4_frame.compress(data)
    bad = bytearray(want)
    bad[len(bad) // 2] ^= 1
    assert lz4_frame.compare([(data, want, bytes(bad))]) == [{"blocks_differing": 1,
                                                              "frames_not_decoding": 1}]
    assert lz4_frame.compare([(data, want, b"junk")])[0]["blocks_differing"] >= 1
    g = bytearray(gzip_member.compress(data))
    g[len(g) // 2] ^= 1
    got = gzip_member.compare([(data, gzip_member.compress(data), bytes(g))])
    assert got == [{"members_differing": 1, "members_not_inflating": 1}]


def test_block_decoder_reads_every_frame_back(inputs):
    """All frames' blocks decoded side by side, as the check decodes a
    window's sample; the port's frame decoder agrees."""
    from tpu7z_torch.models.lz4 import frame

    frames = [lz4_frame.compress(d) for d in inputs]
    assert lz4_frame.decodes(list(zip(inputs, frames))) == [True] * len(inputs)
    other = [lz4_frame.compress(d, tier_b=False) for d in inputs]
    assert lz4_frame.decodes(list(zip(inputs, other))) == [True] * len(inputs)
    assert all(frame.decompress(f) == d for d, f in zip(inputs, frames))


def test_block_decoder_refuses_damage(inputs):
    """A byte altered anywhere, a frame cut short or run on, another
    input: not read back; where the port's decoder reads the damaged frame
    to the input, so does this one."""
    from tpu7z_torch.models.lz4 import frame

    data = inputs[-1]
    good = lz4_frame.compress(data)
    cases = []
    for at in range(len(lz4_frame.HEADER), len(good), max(1, len(good) // 97)):
        bad = bytearray(good)
        bad[at] ^= 0x5A
        cases.append(bytes(bad))
    got = lz4_frame.decodes([(data, c) for c in cases])
    for c, fine in zip(cases, got):
        try:
            port = frame.decompress(c) == data
        except Exception:
            port = False
        assert fine == port
    assert sum(got) <= len(got) // 10
    assert lz4_frame.decodes([(data, good[:-1]), (data, good + b"\0"), (data[1:], good),
                              (data, lz4_frame.HEADER + bytes(4))]) == [False] * 4


def test_block_decoder_overlapping_matches():
    """Offsets shorter than their match (a period repeated), and lengths
    with extension bytes, as the block format writes them."""
    blk = bytes([0x1F, ord("a"), 1, 0, 255, 10])      # 'a', then 15 + 4 + 265 of it
    blk += bytes([0x30]) + b"xyz"                       # the last sequence: literals
    word = len(blk).to_bytes(4, "little")
    want = b"a" * (1 + 284) + b"xyz"
    f = lz4_frame.HEADER + word + blk + lz4_frame.ENDMARK
    assert lz4_frame.decodes([(want, f)]) == [True]
    assert lz4_frame.decode_blocks([blk, bytes([0x10, 7, 0, 0])]) == [want, None]
