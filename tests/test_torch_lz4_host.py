"""The port's native LZ4 host codec (csrc/lz4_host.cpp, bound in
tpu7z_torch/models/lz4/block.py) against tpu7z's: the decoder, with
dst_size and with cap_hint, on valid and malformed blocks, beside its numpy
twin `decompress_block_ref`; its window (a linked block's prefix) against
tpu7z's linked-block decoder; and `compress_block_native` byte for byte
against tpu7z.native's tz_lz4_encode. Exact equality throughout."""

import ctypes

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tpu7z import native as jnative  # noqa: E402
from tpu7z.models.lz4 import block as jblock  # noqa: E402
from tpu7z.models.lz4 import frame as jframe  # noqa: E402
from tpu7z.utils.errors import CorruptError as JCorruptError  # noqa: E402
from tpu7z_torch.models.lz4 import block as tblock  # noqa: E402
from tpu7z_torch.models.lz4 import frame as tframe  # noqa: E402
from tpu7z_torch.ops import _build  # noqa: E402
from tpu7z_torch.ops import lz4_cuda  # noqa: E402
from tpu7z_torch.parallel import sharded  # noqa: E402
from tpu7z_torch.utils.corpus import make_corpus  # noqa: E402

BLOCK = 1 << 16
CORPUS = make_corpus(2 << 20)
RNG = np.random.default_rng(17)
RANDOM = RNG.integers(0, 256, 5 << 20, np.uint8).tobytes()


@pytest.fixture(scope="module")
def jlib():
    """tpu7z's native library, built as tpu7z's own tests build it."""
    lib = jnative._load()
    assert lib is not None, "tpu7z/native did not build"
    return lib


def _lsic(n: int) -> bytes:
    """The extension bytes of a length field whose nibble is 15."""
    n -= 15
    return b"\xff" * (n // 255) + bytes([n % 255])


def seq(lits: bytes, offset: int | None = None, mlen: int | None = None) -> bytes:
    """One sequence: its literals and, unless it is the last, a match."""
    lit_code = min(len(lits), 15)
    ml_code = 0 if mlen is None else min(mlen - 4, 15)
    out = bytes([lit_code << 4 | ml_code])
    if len(lits) >= 15:
        out += _lsic(len(lits))
    out += lits
    if offset is not None:
        out += offset.to_bytes(2, "little")
        if mlen - 4 >= 15:
            out += _lsic(mlen - 4)
    return out


def _expand(parts) -> bytes:
    """What a list of (literals, offset, mlen) sequences decodes to."""
    out = bytearray()
    for lits, offset, mlen in parts:
        out += lits
        for _ in range(mlen or 0):
            out.append(out[-offset])
    return bytes(out)


def _block(parts) -> tuple[bytes, bytes]:
    return b"".join(seq(*p) for p in parts), _expand(parts)


def _hand_blocks():
    """(name, block, decoded): an empty block, literal-only blocks, length
    fields at 14, 15, 15 + 255 and 15 + 510, overlapping offsets 1-4 and
    7, and offset 65535."""
    text = CORPUS[800_000:900_000]
    cases = [("empty_input", b"", b""), ("empty_block", b"\x00", b"")]
    for n in (1, 14, 15, 16, 15 + 255, 15 + 510, 1000):
        cases.append((f"literals_{n}", *_block([(text[:n], None, None)])))
    for n in (14, 15, 15 + 255, 15 + 510):
        cases.append((f"litlen_{n}", *_block([(text[:n], 8, 20), (text[:7], None, None)])))
        cases.append((f"mlen_{n + 4}", *_block([(text[:16], 16, n + 4), (text[:5], None, None)])))
    for off in (1, 2, 3, 4, 7):
        cases.append((f"overlap_{off}", *_block(
            [(text[:off], off, 300), (text[100:103], off + 1, 19), (b"end", None, None)])))
    far = RANDOM[:65535]
    cases.append(("offset_65535", *_block([(far, 65535, 40), (b"tail!", None, None)])))
    return cases


HAND = _hand_blocks()


def _corpus_blocks():
    """(name, block, decoded): corpus slices of every kind encoded by
    tpu7z's host encoder, and blocks of the port's device encoder run on
    the CPU."""
    cases = []
    for at, n in ((0, BLOCK), (700_000, BLOCK), (1_000_000, 12345),
                  (1_500_000, 200_000), (1_900_000, BLOCK)):
        raw = CORPUS[at:at + n]
        cases.append((f"tpu7z_host_{at}_{n}", jblock.compress_block(raw), raw))
    cases.append(("tpu7z_host_random", jblock.compress_block(RANDOM[:BLOCK]), RANDOM[:BLOCK]))
    data = CORPUS[650_000:650_000 + 4 * BLOCK - 1000]
    cb, cn = sharded.split_blocks(data, "cpu")
    out, used = lz4_cuda.encode_blocks(cb, cn, 0)
    for b in range(cb.shape[0]):
        raw = data[b * BLOCK:(b + 1) * BLOCK]
        cases.append((f"device_{b}", out[b, :int(used[b])].numpy().tobytes(), raw))
    return cases


@pytest.fixture(scope="module")
def corpus_blocks():
    return {name: (blk, raw) for name, blk, raw in _corpus_blocks()}


CORPUS_NAMES = ([f"tpu7z_host_{a}_{n}" for a, n in ((0, BLOCK), (700_000, BLOCK),
                                                   (1_000_000, 12345), (1_500_000, 200_000),
                                                   (1_900_000, BLOCK))]
                + ["tpu7z_host_random"] + [f"device_{b}" for b in range(4)])


def _decode_all(blk, **kw):
    """The block decoded by the port's native decoder, its numpy twin and
    tpu7z's decoder."""
    return (tblock.decompress_block(blk, **kw), tblock.decompress_block_ref(blk, **kw),
            jblock.decompress_block(blk, **kw))


@pytest.mark.parametrize("name,blk,raw", HAND, ids=[c[0] for c in HAND])
@pytest.mark.parametrize("arg", ["dst_size", "cap_hint"])
def test_hand_blocks_decode_as_tpu7z(jlib, name, blk, raw, arg):
    size = len(raw) if arg == "dst_size" else len(raw) + 100
    got = _decode_all(blk, **{arg: size})
    assert got == (raw, raw, raw)


@pytest.mark.parametrize("name", CORPUS_NAMES)
@pytest.mark.parametrize("arg", ["dst_size", "cap_hint"])
def test_corpus_blocks_decode_as_tpu7z(jlib, corpus_blocks, name, arg):
    blk, raw = corpus_blocks[name]
    size = len(raw) if arg == "dst_size" else BLOCK << 2
    assert _decode_all(blk, **{arg: size}) == (raw, raw, raw)


def test_no_size_takes_the_numpy_twin(monkeypatch):
    blk, raw = HAND[-1][1:]
    monkeypatch.setattr(tblock, "_decode_native", None)
    assert tblock.decompress_block(blk) == raw == jblock.decompress_block(blk)


def _malformed():
    """(name, block, kwargs): each is refused by every decoder."""
    text = CORPUS[800_000:800_100]
    good, raw = _block([(text[:20], 4, 40), (text[:6], None, None)])
    return [
        ("truncated_literal_length", b"\xf0\xff\xff", {"cap_hint": 1000}),
        ("literals_past_input", b"\x50abc", {"cap_hint": 1000}),
        ("truncated_offset", seq(text[:5]) + b"\x01", {"cap_hint": 1000}),
        ("truncated_match_length", b"\x5f" + text[:5] + b"\x01\x00\xff\xff",
         {"cap_hint": 1000}),
        ("offset_0", seq(text[:8], 0, 4) + seq(b"xy"), {"cap_hint": 1000}),
        ("offset_past_start", seq(text[:8], 9, 4) + seq(b"xy"), {"cap_hint": 1000}),
        ("overflow_literals", good, {"cap_hint": 10}),
        ("overflow_match", good, {"dst_size": 30}),
        ("wrong_dst_size", good, {"dst_size": len(raw) + 1}),
    ]


MALFORMED = _malformed()


@pytest.mark.parametrize("name,blk,kw", MALFORMED, ids=[c[0] for c in MALFORMED])
def test_malformed_blocks_raise_as_in_tpu7z(jlib, name, blk, kw):
    with pytest.raises(JCorruptError):
        jblock.decompress_block(blk, **kw)
    with pytest.raises(tblock.CorruptError):
        tblock.decompress_block(blk, **kw)
    with pytest.raises(tblock.CorruptError):
        tblock.decompress_block_ref(blk, **kw)


def _linked_frames():
    """Linked-block frames as tpu7z's tests make them: 1 MiB of mixed
    corpus at 64 KiB blocks, and a repeated pattern at 4 KiB blocks."""
    mixed = (CORPUS[700_000:1_400_000] + CORPUS[1_500_000:1_900_000])[:1 << 20]
    return {"mixed_64k": (mixed, jframe.compress_frame(
                mixed, block_size=BLOCK, block_independence=False)),
            "repeat_4k": (b"abcdef" * 10000, jframe.compress_frame(
                b"abcdef" * 10000, block_size=4096, block_independence=False))}


@pytest.mark.parametrize("name", ["mixed_64k", "repeat_4k"])
def test_window_decodes_linked_blocks_as_tpu7z(jlib, name):
    data, framed = _linked_frames()[name]
    window, out, reached = b"", [], 0
    for stored, payload in tframe.iter_blocks(framed):
        if stored:
            got = payload
        else:
            got = tblock.decompress_block(payload, cap_hint=BLOCK, window=window)
            assert got == jframe._decode_linked(payload, window, BLOCK)
            assert got == tblock.decompress_block_ref(payload, cap_hint=BLOCK, window=window)
            try:
                tblock.decompress_block(payload, cap_hint=BLOCK)
            except tblock.CorruptError:
                reached += 1
        out.append(got)
        window = (window + got)[-BLOCK:]
    assert b"".join(out) == data
    assert reached, "no block reaches back into its window"


def test_window_offset_past_its_start_raises(jlib):
    blk = seq(b"ab", 7, 4) + seq(b"z")
    assert tblock.decompress_block(blk, cap_hint=100, window=b"12345") == b"ab1234z"
    assert jframe._decode_linked(blk, b"12345", 100) == b"ab1234z"
    with pytest.raises(tblock.CorruptError):
        tblock.decompress_block(blk, cap_hint=100, window=b"1234")
    with pytest.raises(tblock.CorruptError):
        tblock.decompress_block_ref(blk, cap_hint=100, window=b"1234")
    with pytest.raises(JCorruptError):
        jframe._decode_linked(blk, b"1234", 100)


ENCODE_SIZES = [1, 5, 12, 13, 100, 4096, BLOCK, 1 << 20, 4 << 20]


def _tz_encode(lib, raw: bytes) -> bytes:
    cap = len(raw) + len(raw) // 255 + 64
    buf = ctypes.create_string_buffer(cap)
    r = lib.tz_lz4_encode(raw, len(raw), buf, cap)
    assert r > 0
    return buf.raw[:r]


@pytest.mark.parametrize("kind", ["corpus", "random", "zeros"])
@pytest.mark.parametrize("n", ENCODE_SIZES)
def test_encoder_equals_tz_lz4_encode(jlib, kind, n):
    src = {"corpus": (CORPUS * 3)[:n], "random": RANDOM[:n], "zeros": bytes(n)}[kind]
    got = tblock.compress_block_native(src)
    assert got == _tz_encode(jlib, src)
    assert tblock.decompress_block(got, dst_size=n) == src


def test_encoder_empty_input():
    assert tblock.compress_block_native(b"") == b"\x00" == jblock.compress_block(b"")
    assert tblock.decompress_block(b"\x00", dst_size=0) == b""


@pytest.mark.parametrize("start", [1, 4096, BLOCK, 100_000])
def test_encode_region_equals_tpu7z(jlib, start):
    src = CORPUS[700_000:700_000 + start + 50_000]
    cap = 50_000 + 50_000 // 128 + 64
    got, want = ctypes.create_string_buffer(cap), ctypes.create_string_buffer(cap)
    r = tblock._library().lz4_encode_region(src, len(src), start, ctypes.addressof(got), cap)
    assert r == jlib.tz_lz4_encode_region(src, len(src), start, want, cap) > 0
    assert got.raw[:r] == want.raw[:r]
    window = src[:start][-BLOCK:]
    assert tblock.decompress_block(got.raw[:r], dst_size=len(src) - start,
                                   window=window) == src[start:]


def test_build_failure_raises(monkeypatch, tmp_path):
    """With no library and no compiler, the decoder and encoder raise; they
    never drop to the numpy twin."""
    monkeypatch.setattr(tblock, "_lib", None)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD", tmp_path)
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        tblock.decompress_block(b"\x00", dst_size=0)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        tblock.compress_block_native(b"abc")
