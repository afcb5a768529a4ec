"""The port's zstd decoders and span-parallel decode against tpu7z's: the
host library (csrc/zstd_dec.cpp) and the plain decoder give tpu7z's
content on frames from both packages, skippable, checksum-less and
concatenated frames, and raise where tpu7z raises on corrupt and
truncated ones; `decompress_zstd` and `decompress_lz4`
(parallel/decode.py) give the serial paths' bytes; the bit readers,
writer, packer and chain decoder give tpu7z's values."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu7z.models.lz4 import frame as jlz4  # noqa: E402
from tpu7z.models.zstd import frame as jframe  # noqa: E402
from tpu7z.models.zstd import huffman as jhuf  # noqa: E402
from tpu7z.ops import bitchain as jchain  # noqa: E402
from tpu7z.ops import bitstream as jbits  # noqa: E402
from tpu7z.parallel import decode as jdecode  # noqa: E402
from tests.test_torch_zstd_parse import CHUNKS, _chunk, corpus  # noqa: E402,F401
from tpu7z_torch.models.lz4 import frame as tlz4  # noqa: E402
from tpu7z_torch.models.zstd import frame as tframe  # noqa: E402
from tpu7z_torch.models.zstd import huffman as thuf  # noqa: E402
from tpu7z_torch.models.zstd import native as tnative  # noqa: E402
from tpu7z_torch.ops import bitchain as tchain  # noqa: E402
from tpu7z_torch.ops import bitstream as tbits  # noqa: E402
from tpu7z_torch.ops.hashing import xxh32  # noqa: E402
from tpu7z_torch.parallel import decode as tdecode  # noqa: E402
from tpu7z_torch.utils.errors import CorruptError  # noqa: E402


def _skippable(payload: bytes, magic: int = 0x184D2A53) -> bytes:
    return magic.to_bytes(4, "little") + len(payload).to_bytes(4, "little") + payload


@pytest.fixture(scope="module")
def frames(corpus):
    """name -> (frame bytes, content) from both packages' encoders."""
    text = _chunk(corpus, "text", 150000).tobytes()
    mixed = np.concatenate([_chunk(corpus, k, 60000) for k in CHUNKS]).tobytes()
    out = {
        "host_l3": (tframe.compress(mixed, level=3), mixed),
        "host_l19": (tframe.compress(text, level=19), text),
        "tpu7z_tensor": (jframe.compress(text[:60000], level=5, window_log=16),
                         text[:60000]),
        "port_tensor": (tframe.compress(mixed[:80000], level=9, window_log=20,
                                        device="cpu"), mixed[:80000]),
        "no_checksum": (tnative.zstd_encode(mixed, 3, checksum=False), mixed),
        "empty": (tframe.compress(b""), b""),
        "small_host": (tframe.compress(mixed[:24000], level=3), mixed[:24000]),
        "small_no_checksum": (tnative.zstd_encode(text[:24000], 5, checksum=False),
                              text[:24000]),
        "small_tensor": (tframe.compress(text[:24000], level=9, window_log=14,
                                         device="cpu"), text[:24000]),
    }
    a, b = out["host_l3"], out["tpu7z_tensor"]
    out["concatenated"] = (a[0] + _skippable(b"meta") + b[0] + out["empty"][0],
                           a[1] + b[1])
    out["skippable_only"] = (_skippable(b"x" * 10) + _skippable(b"", 0x184D2A5F), b"")
    # a dictionary ID the host library refuses and the plain decoder ignores
    h = bytearray(tframe.compress(text[:5000], level=3))
    out["dict_id"] = (bytes(h[:4]) + bytes([h[4] | 1]) + bytes([7]) + bytes(h[5:]),
                      text[:5000])
    return out


def _outcome(fn, data):
    try:
        return "ok", fn(data)
    except Exception as exc:  # noqa: BLE001 - the type is what is compared
        return "raise", type(exc).__name__


@pytest.mark.parametrize("name", ["host_l3", "host_l19", "tpu7z_tensor", "port_tensor",
                                  "no_checksum", "empty", "concatenated",
                                  "skippable_only", "dict_id"])
def test_decoders_equal_tpu7z(frames, name):
    framed, content = frames[name]
    assert jframe.decompress(framed) == content
    assert tframe.decompress(framed) == content
    assert tframe.decompress(framed, use_native=False) == content
    assert tframe.decompress(framed, verify_checksum=False) == content
    assert tdecode.decompress_zstd(framed) == content
    assert tdecode.decompress_zstd(framed, threads=1) == content
    if name == "dict_id":
        assert tnative.zstd_decode(framed) is None
    else:
        assert tnative.zstd_decode(framed) == content
    assert tdecode.scan_zstd_frames(framed) == jdecode.scan_zstd_frames(framed)


def test_decompress_frame_consumes_one_frame(frames):
    framed, _ = frames["concatenated"]
    first, _ = frames["host_l3"]
    data, used = tframe.decompress_frame(framed)
    assert (data, used) == jframe.decompress_frame(framed)
    assert used == len(first)


@pytest.mark.parametrize("name", ["small_host", "small_tensor", "small_no_checksum"])
def test_corrupt_and_truncated_frames_raise_where_tpu7z_raises(frames, name):
    framed, _ = frames[name]
    rng = np.random.default_rng(len(framed))
    cases = [framed[:k] for k in (0, 3, 4, 5, 6, 9, len(framed) // 2, len(framed) - 1)]
    for pos in sorted(set(rng.integers(0, len(framed), 24).tolist()) | {4, 5, 6}):
        bad = bytearray(framed)
        bad[pos] ^= 0x5A
        cases.append(bytes(bad))
    cases.append(framed + b"\x01\x02")
    cases.append(b"\x00\x01\x02\x03" + framed)
    raised = 0
    for case in cases:
        want = _outcome(jframe.decompress, case)
        assert _outcome(tframe.decompress, case) == want
        assert _outcome(lambda d: tframe.decompress(d, use_native=False), case) == \
            _outcome(lambda d: jframe.decompress(d, use_native=False), case)
        raised += want[0] == "raise"
    assert raised >= 8     # the truncations at least


def test_corrupt_error_is_the_ports():
    with pytest.raises(CorruptError, match="bad magic"):
        tframe.decompress(b"\x00\x01\x02\x03\x04\x05\x06\x07\x08")


@pytest.mark.parametrize("threads", [None, 1, 2, 8])
def test_frame_parallel_zstd_equals_serial(frames, threads):
    parts = [frames[k][0] for k in ("host_l3", "host_l19", "empty", "no_checksum")]
    framed = parts[0] + _skippable(b"zz") + parts[1] + parts[2] + parts[3]
    want = tframe.decompress(framed)
    assert tdecode.decompress_zstd(framed, threads=threads) == want
    assert jdecode.decompress_zstd(framed, threads=threads) == want


@pytest.mark.parametrize("independent", [True, False])
@pytest.mark.parametrize("threads", [None, 1, 4])
def test_block_parallel_lz4_equals_serial(corpus, independent, threads):
    data = np.concatenate([_chunk(corpus, k, 100000) for k in CHUNKS]).tobytes()
    framed = (jlz4.compress_frame(data, block_size=1 << 16, block_checksum=True,
                                  block_independence=independent)
              + _skippable(b"meta")
              + tlz4.compress_frame(data[:70000]))
    want = tlz4.decompress(framed)
    assert want == data + data[:70000]
    assert tdecode.decompress_lz4(framed, threads=threads) == want
    assert jdecode.decompress_lz4(framed, threads=threads) == want


def test_parallel_decoders_raise_on_corrupt_input(frames, corpus):
    framed, _ = frames["host_l3"]
    with pytest.raises(CorruptError):
        tdecode.decompress_zstd(framed + framed[:10], threads=2)
    lz = tlz4.compress_frame(_chunk(corpus, "text", 200000).tobytes(), block_size=1 << 16)
    with pytest.raises(CorruptError, match="content checksum"):
        tdecode.decompress_lz4(lz[:-1] + bytes([lz[-1] ^ 1]), threads=2)


def _lz4_corrupt(framed: bytes, kind: str) -> bytes:
    """`framed` (FLG 0x7C: block and content checksums, content size)
    broken one way; where the descriptor changes, its checksum is made
    anew so that the check under test is the one that fails."""
    bad = bytearray(framed)
    if kind == "block_checksum":
        first = int.from_bytes(bad[15:19], "little") & 0x7FFFFFFF
        bad[19 + first] ^= 1
    elif kind == "header_checksum":
        bad[14] ^= 1
    else:
        if kind == "content_size":
            bad[6:14] = (int.from_bytes(bad[6:14], "little") + 1).to_bytes(8, "little")
        elif kind == "block_size_code":
            bad[5] = 3 << 4
        elif kind == "version":
            bad[4] &= 0x3F
        elif kind == "dictionary_id":
            bad[4] |= 1
        bad[14] = (xxh32(bytes(bad[4:14])) >> 8) & 0xFF
    return bytes(bad)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("kind,message", [
    ("block_checksum", "block checksum mismatch"),
    ("header_checksum", "header checksum mismatch"),
    ("content_size", "content size mismatch"),
    ("block_size_code", "bad block size code 3"),
    ("version", "unsupported version 0"),
    ("dictionary_id", "dictionaries not supported"),
])
def test_parallel_lz4_checks_what_the_serial_decoder_checks(corpus, kind, message,
                                                            threads):
    data = _chunk(corpus, "text", 200000).tobytes()
    framed = tlz4.compress_frame(data, block_size=1 << 16, block_checksum=True)
    assert tdecode.decompress_lz4(framed, threads=threads) == data
    bad = _lz4_corrupt(framed, kind)
    with pytest.raises(CorruptError, match=message):
        tlz4.decompress(bad)
    with pytest.raises(CorruptError, match=message):
        tdecode.decompress_lz4(bad, threads=threads)


def test_bit_readers_writer_and_packer_equal_tpu7z():
    rng = np.random.default_rng(5)
    nbits = rng.integers(0, 25, 500)
    vals = rng.integers(0, 1 << 30, 500).astype(np.uint64)
    packed = tbits.pack_bits_lsb(vals, nbits)
    assert packed == jbits.pack_bits_lsb(vals, nbits)
    assert tbits.pack_bits_lsb(vals, nbits, end_marker=False) == \
        jbits.pack_bits_lsb(vals, nbits, end_marker=False)
    assert tbits.reverse_pack_bits_lsb(vals, nbits) == jbits.reverse_pack_bits_lsb(vals, nbits)
    fw, fj = tbits.ForwardBitReader(packed), jbits.ForwardBitReader(packed)
    bw, bj = tbits.BackwardBitReader(packed), jbits.BackwardBitReader(packed)
    for nb in nbits.tolist() + [9, 30]:
        assert fw.read(nb) == fj.read(nb)
        assert bw.read(nb) == bj.read(nb)
    assert (fw.bytes_consumed(), bw.bitpos, bw.overread) == \
        (fj.bytes_consumed(), bj.bitpos, bj.overread)
    wt, wj = tbits.BitWriterLSB(), jbits.BitWriterLSB()
    for v, nb in zip(vals.tolist(), nbits.tolist()):
        wt.write(v, nb)
        wj.write(v, nb)
    assert wt.close_with_end_marker() == wj.close_with_end_marker()
    with pytest.raises(CorruptError):
        tbits.BackwardBitReader(b"\x01\x00")


def test_chain_decoder_equals_tpu7z(corpus):
    lits = _chunk(corpus, "text", 3000)
    weights, _ = thuf.build_weights(np.bincount(lits, minlength=256))
    code_val, code_bits, _ = thuf.build_encode_table(weights)
    stream = tbits.pack_bits_lsb(code_val[lits][::-1].astype(np.uint64),
                                 code_bits[lits][::-1].astype(np.int64))
    sym, nb, tl = thuf.build_decode_table(weights)
    assert [np.array_equal(a, b) for a, b in zip((sym, nb), jhuf.build_decode_table(weights))] \
        == [True, True]
    s = np.frombuffer(stream, np.uint8)
    got = tchain.chain_decode(s, sym, nb, tl, lits.size)
    assert np.array_equal(got, lits)
    assert np.array_equal(got, jchain.chain_decode(s, sym, nb, tl, lits.size))
    assert np.array_equal(tchain.peek_table(s, tl, 40), jchain.peek_table(s, tl, 40))
    with pytest.raises(CorruptError):
        tchain.chain_decode(s, sym, nb, tl, 10 * lits.size)
