"""LZ5 and Lizard in the port (tpu7z_torch/models/lz5, models/lizard)
against tpu7z's on the CPU.

Frames give tpu7z's bytes: LZ5 with one block and several (block sizes
64 KiB and 4 MiB), Lizard at levels 10, 11, 19, 20, 25, 29, 30, 39, 40
and 49 (both code-word families, raw and Huffman-coded streams), over
inputs made from seeds: empty, one byte, a few bytes under and over each
codec's shortest parsed block, random bytes, zeros, a period-3 repeat,
the corpus's text, and several blocks whose last block is short (5, 10,
12, 13, 40 and 47 bytes past the last full block, and 1000). The batched
parses (every block a row of one candidate sort, a short last block its
own, per-block limits) are held against tpu7z's parse of each block
alone. Each decoder reads the other's frames, and on cut and bit-flipped
frames raises tpu7z's error class and message (or gives its bytes)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu7z.models.lizard import codec as jliz  # noqa: E402
from tpu7z.models.lz4 import block as jblock  # noqa: E402
from tpu7z.models.lz5 import codec as jlz5  # noqa: E402
from tpu7z_torch.models.lizard import codec as tliz  # noqa: E402
from tpu7z_torch.models.lz5 import codec as tlz5  # noqa: E402
from tpu7z_torch.utils.corpus import make_corpus  # noqa: E402

TEXT = 696156            # the corpus's first byte past its sparse chunk
KINDS = ["empty", "one", "twelve", "fifteen", "forty_seven", "forty_eight", "random",
         "zeros", "period3", "text4k", "text100k"]
LEVELS = [10, 11, 19, 20, 25, 29, 30, 39, 40, 49]
TAILS = [5, 10, 12, 13, 40, 47, 1000]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def text():
    return make_corpus(TEXT + (300 << 10))[TEXT:]


def _input(text, kind) -> bytes:
    rng = np.random.default_rng(len(kind))
    return {
        "empty": b"",
        "one": b"q",
        "twelve": text[:12],
        "fifteen": text[:15],
        "forty_seven": text[:47],
        "forty_eight": text[:48],
        "random": rng.integers(0, 256, 5000, np.uint8).tobytes(),
        "zeros": bytes(3000),
        "period3": bytes(np.resize(np.array([7, 1, 200], np.uint8), 4000)),
        "text4k": text[:4096],
        "text100k": text[:100000],
    }[kind]


def _outcome(fn, data):
    """fn(data), or what it raised: the class name and message of a
    format error, the class name of anything else (an IndexError from a
    read past the end names numpy's array in tpu7z, bytes here)."""
    try:
        return fn(data)
    except Exception as e:  # noqa: BLE001 - the decoders must agree on any error
        if type(e).__name__ in ("CorruptError", "UnsupportedError", "ParamError"):
            return (type(e).__name__, str(e))
        return type(e).__name__


# --- LZ5 -------------------------------------------------------------------

@pytest.mark.parametrize("block_size", [1 << 16, 1 << 22], ids=["64k", "4m"])
@pytest.mark.parametrize("kind", KINDS)
def test_lz5_frame_equals_tpu7z(text, kind, block_size):
    data = _input(text, kind)
    want = jlz5.compress_frame(data, block_size=block_size)
    got = tlz5.compress_frame(data, block_size=block_size, device="cpu")
    assert got == want
    assert tlz5.decompress(want) == data
    assert jlz5.decompress(got) == data


@pytest.mark.parametrize("tail", TAILS)
def test_lz5_frame_with_a_short_last_block_equals_tpu7z(text, tail):
    data = text[:2 * (1 << 16) + tail]
    want = jlz5.compress_frame(data, block_size=1 << 16)
    assert tlz5.compress_frame(data, block_size=1 << 16, device="cpu") == want
    assert tlz5.decompress(want) == data


@pytest.mark.parametrize("kind", ["one", "twelve", "fifteen", "random", "zeros", "text4k"])
def test_lz5_block_equals_tpu7z(text, kind):
    data = _input(text, kind)
    want = jlz5.compress_block(data)
    assert tlz5.compress_block(data, device="cpu") == want
    assert tlz5.decompress_block(want, dst_size=len(data)) == data
    assert tlz5.compress_block(b"", device="cpu") == jlz5.compress_block(b"") == b"\x00"


@pytest.mark.parametrize("tail", TAILS)
def test_lz5_batched_parse_equals_each_block_alone(text, tail):
    """The rows form: each block's matches are tpu7z's parse of it alone
    (block_size 64 KiB, three full blocks and a short one)."""
    bs = 1 << 16
    data = text[:3 * bs + tail]
    s = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    mpos, mlen, moff = tlz5._parse(s, bs)
    for start in range(0, len(data), bs):
        block = np.frombuffer(data[start:start + bs], np.uint8)
        sel = (mpos >= start) & (mpos < start + bs)
        want = _lz5_block_parse(block)
        assert np.array_equal(mpos[sel] - start, want[0])
        assert np.array_equal(mlen[sel], want[1])
        assert np.array_equal(moff[sel], want[2])


def _lz5_block_parse(s):
    """tpu7z's `compress_block` parse of one block (lz5/codec.py:117-142),
    its matches as arrays."""
    n = s.size
    empty = np.empty(0, np.int64)
    if n < jlz5.MF_LIMIT + 1:
        return empty, empty, empty
    cand = jblock._find_candidates(s, hashlog=16)
    pos_all = np.arange(cand.size, dtype=np.int64)
    offset = pos_all - cand
    valid = (cand >= 0) & (offset <= 0xFFFF) & (pos_all <= n - jlz5.MF_LIMIT - 1)
    limit = np.zeros(cand.size, dtype=np.int64)
    limit[valid] = (n - jlz5.LAST_LITERALS) - pos_all[valid]
    mlen = np.zeros(cand.size, dtype=np.int64)
    vidx = np.where(valid)[0]
    if vidx.size:
        mlen[vidx] = jblock._match_lengths(s, pos_all[vidx], cand[vidx], limit[vidx])
    valid &= mlen >= jlz5.MIN_MATCH + 1
    nxt = np.where(valid, pos_all + mlen, pos_all + 1)
    full_next = np.full(n, n, dtype=np.int64)
    full_next[: nxt.size] = nxt
    visited = jblock._greedy_parse(full_next, n)
    is_match = np.zeros(n, dtype=bool)
    is_match[: valid.size] = valid
    m_sel = visited[is_match[visited]]
    return m_sel, mlen[m_sel], offset[m_sel]


def test_lz5_decoders_fail_as_tpu7z(text):
    rng = np.random.default_rng(2)
    frame = jlz5.compress_frame(text[:20000])
    for cut in rng.integers(0, len(frame), 30):
        assert _outcome(tlz5.decompress, frame[:cut]) == _outcome(jlz5.decompress, frame[:cut])
    for pos in rng.integers(0, len(frame), 60):
        bad = bytearray(frame)
        bad[pos] ^= 1 << int(rng.integers(0, 8))
        bad = bytes(bad)
        assert _outcome(tlz5.decompress, bad) == _outcome(jlz5.decompress, bad)
    block = jlz5.compress_block(text[:5000])
    for cut in range(0, len(block), 97):
        for kw in ({"dst_size": 5000}, {"max_out": 4000}, {}):
            assert _outcome(lambda b: tlz5.decompress_block(b, **kw), block[:cut]) == \
                _outcome(lambda b: jlz5.decompress_block(b, **kw), block[:cut])
    # a token that takes a 10-bit offset, a 24-bit offset and a repeat
    hand = bytes([0x08, 65, 0x80 | (0 << 5) | 1, 1, 0x40, 2, 0, 0, 0x60 | 1])
    assert _outcome(tlz5.decompress_block, hand) == _outcome(jlz5.decompress_block, hand)


# --- Lizard ------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", LEVELS)
def test_lizard_frame_equals_tpu7z(text, level, kind):
    data = _input(text, kind)
    want = jliz.compress_frame(data, level=level)
    got = tliz.compress_frame(data, level=level, device="cpu")
    assert got == want
    assert tliz.decompress(want) == data
    assert jliz.decompress(got) == data


@pytest.mark.parametrize("tail", [10, 40, 47, 48, 100])
@pytest.mark.parametrize("level", [11, 25, 31, 41])
def test_lizard_frame_with_a_short_last_block_equals_tpu7z(text, level, tail):
    data = text[:2 * tliz.BLOCK_SIZE + tail]
    want = jliz.compress_frame(data, level=level)
    assert tliz.compress_frame(data, level=level, device="cpu") == want
    assert tliz.decompress(want) == data


@pytest.mark.parametrize("level", [11, 25, 35, 45])
def test_lizard_block_equals_tpu7z(text, level):
    """A block of several 128 KiB chunks: each chunk a row."""
    data = text[:2 * tliz.BLOCK_SIZE + 77]
    want = jliz.compress_block(data, level=level)
    assert tliz.compress_block(data, level=level, device="cpu") == want
    assert tliz.decompress_block(want, len(data)) == data
    assert tliz.compress_block(b"", level=level, device="cpu") == \
        jliz.compress_block(b"", level=level)


@pytest.mark.parametrize("liz_words", [False, True], ids=["lz4_words", "lizv1"])
@pytest.mark.parametrize("tail", [0, 15, 16, 40, 47, 48, 1000])
def test_lizard_batched_parse_equals_each_chunk_alone(text, liz_words, tail):
    bs = tliz.BLOCK_SIZE
    data = text[:2 * bs + tail]
    s = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    mpos, mlen, moff = tliz._parse(s, liz_words)
    find = jliz._find_liz if liz_words else jliz._find
    for start in range(0, len(data), bs):
        want = find(np.frombuffer(data[start:start + bs], np.uint8))
        sel = (mpos >= start) & (mpos < start + bs)
        assert np.array_equal(mpos[sel] - start, want[0])
        assert np.array_equal(mlen[sel], want[1])
        assert np.array_equal(moff[sel], want[2])


@pytest.mark.parametrize("level", [11, 25, 35, 45])
def test_lizard_decoders_fail_as_tpu7z(text, level):
    rng = np.random.default_rng(level)
    frame = jliz.compress_frame(text[:30000], level=level)
    for cut in rng.integers(0, len(frame), 25):
        assert _outcome(tliz.decompress, frame[:cut]) == _outcome(jliz.decompress, frame[:cut])
    for pos in rng.integers(0, len(frame), 50):
        bad = bytearray(frame)
        bad[pos] ^= 1 << int(rng.integers(0, 8))
        bad = bytes(bad)
        assert _outcome(tliz.decompress, bad) == _outcome(jliz.decompress, bad)
    for block in (b"", bytes([9]), bytes([50]), bytes([level, 0x90])):
        assert _outcome(lambda b: tliz.decompress_block(b, 100), block) == \
            _outcome(lambda b: jliz.decompress_block(b, 100), block)


def test_huffman_streams_equal_tpu7z(text):
    """`_huf_compress` (None where a stream would not shrink) and its
    decoder on the literals of a chunk, a flat stream and short ones."""
    rng = np.random.default_rng(4)
    for data in (text[:30000], bytes(200), rng.integers(0, 256, 3000, np.uint8).tobytes(),
                 text[:63], text[:64], bytes(np.resize(np.array([1, 2], np.uint8), 500))):
        want = jliz._huf_compress(data)
        assert tliz._huf_compress(data) == want
        if want is not None:
            assert tliz._huf_decompress(want, len(data)) == data


def test_frames_need_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for fn in (tlz5.compress_frame, tliz.compress_frame):
        with pytest.raises(RuntimeError, match="none is available"):
            fn(b"abc" * 100)
