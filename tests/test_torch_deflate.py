"""DEFLATE and Deflate64 in the port (tpu7z_torch/models/deflate) against
tpu7z's (tpu7z/models/deflate) on the CPU, and the pieces the encoder runs
as tensor code: the rows form of the LZ candidates, the walk from every
block's first position (ops/hash_chain.py) and the tensor bit packer
(ops/bitstream.py). Inputs are made from seeds: empty, 1 and 15 bytes,
random bytes, zeros, a period-3 repeat, and the corpus past its sparse
first 696156 bytes at 4 KiB, 131072 bytes and 300 KiB (three blocks,
two joins); at the block edges, 1, 15, 16 and 17 bytes, a block less
one byte, a block, a block and one byte, and 4 MiB (32 blocks), whole
streams and `compress_streams`' chunks. zlib reads every stream the port writes, and both packages
read zlib's streams. tpu7z has no Deflate64 encoder, so the Deflate64
streams are built here: a fixed-Huffman block whose matches use length
symbol 285 with its 16 extra bits and distance codes 30 and 31.
Everything compared is bytes or integers, so equality is exact."""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu7z.models.deflate import codec as jdef  # noqa: E402
from tpu7z.models.lz4 import block as jblock  # noqa: E402
from tpu7z.ops import bitstream as jbits  # noqa: E402
from tpu7z_torch.models.deflate import codec as tdef  # noqa: E402
from tpu7z_torch.ops import bitstream, hash_chain  # noqa: E402
from tpu7z_torch.utils.corpus import make_corpus  # noqa: E402

TEXT = 696156            # the corpus's first byte past its sparse chunk
KINDS = ["empty", "one", "fifteen", "random", "zeros", "period3", "text4k",
         "text128k", "text300k"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(TEXT + (300 << 10))[TEXT:]


def _input(corpus, kind) -> bytes:
    rng = np.random.default_rng(len(kind))
    return {
        "empty": b"",
        "one": b"q",
        "fifteen": corpus[:15],
        "random": rng.integers(0, 256, 5000, np.uint8).tobytes(),
        "zeros": bytes(3000),
        "period3": bytes(np.resize(np.array([7, 1, 200], np.uint8), 4000)),
        "text4k": corpus[:4096],
        "text128k": corpus[:131072],
        "text300k": corpus[:300 << 10],
    }[kind]


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as exc:  # noqa: BLE001 - the class is what is compared
        return ("raises", type(exc).__name__)


@pytest.mark.parametrize("kind", KINDS)
def test_compress_equals_tpu7z(corpus, kind):
    data = _input(corpus, kind)
    got = tdef.compress(data, device="cpu")
    assert got == jdef.compress(data)
    assert zlib.decompress(got, -15) == data
    assert tdef.decompress(got) == data


@pytest.mark.parametrize("block_size", [20, 1000, 4096, 5000])
def test_compress_block_sizes_equal_tpu7z(corpus, block_size):
    """Rows of other widths, a short last block over and under 16 bytes."""
    for n in (9000, 9010, 10000):
        data = corpus[:n]
        got = tdef.compress(data, block_size=block_size, device="cpu")
        assert got == jdef.compress(data, block_size=block_size), n
        assert zlib.decompress(got, -15) == data


@pytest.mark.parametrize("block_size", [1, 8, 15])
def test_blocks_under_16_bytes_equal_tpu7z(corpus, block_size):
    """Blocks too short to parse: no block gets a match, as in tpu7z
    (the port once parsed such an input as one block)."""
    data = corpus[:120]
    got = tdef.compress(data, block_size=block_size, device="cpu")
    assert got == jdef.compress(data, block_size=block_size)
    assert zlib.decompress(got, -15) == data


@pytest.fixture(scope="module")
def tile():
    """4 MiB of the corpus past its sparse chunk: 32 blocks."""
    return make_corpus(TEXT + (4 << 20))[TEXT:]


EDGES = [1, 15, 16, 17, tdef.BLOCK - 1, tdef.BLOCK, tdef.BLOCK + 1, 4 << 20]


@pytest.mark.parametrize("n", EDGES)
def test_block_edges_equal_tpu7z(tile, n):
    """Inputs at the edges of the parse (16 bytes) and of a block: each
    stream tpu7z's bytes, read back by zlib."""
    data = tile[:n]
    got = tdef.compress(data, device="cpu")
    assert got == jdef.compress(data)
    assert zlib.decompress(got, -15) == data


@pytest.mark.parametrize("width,n", [(16, 16 * 5 + 1), (17, 17 * 4 + 15), (4096, 4096 * 3),
                                     (tdef.BLOCK, tdef.BLOCK + 1), (32768, 5 * 32768 - 1)])
def test_compress_streams_equal_tpu7z_per_chunk(tile, width, n):
    """Every chunk its own stream, tpu7z's `compress` of that chunk, a
    last chunk of one byte, 15 bytes, a full chunk and a chunk less one."""
    data = tile[:n]
    chunks = [data[off:off + width] for off in range(0, n, width)]
    got = tdef.compress_streams(chunks, device="cpu")
    assert got == [jdef.compress(c) for c in chunks]
    assert [zlib.decompress(g, -15) for g in got] == chunks


def test_level_is_ignored_as_in_tpu7z(corpus):
    data = corpus[:3000]
    assert {tdef.compress(data, level=lv, device="cpu") for lv in (1, 6, 9)} == \
        {jdef.compress(data, level=6)}


@pytest.mark.parametrize("kind", ["random", "text4k", "text128k", "text300k"])
@pytest.mark.parametrize("zlevel,strategy", [(0, zlib.Z_DEFAULT_STRATEGY),
                                              (1, zlib.Z_DEFAULT_STRATEGY),
                                              (9, zlib.Z_DEFAULT_STRATEGY),
                                              (6, zlib.Z_FIXED)],
                         ids=["stored", "level1", "level9", "fixed"])
def test_decompress_reads_zlib_as_tpu7z(corpus, kind, zlevel, strategy):
    data = _input(corpus, kind)
    c = zlib.compressobj(zlevel, zlib.DEFLATED, -15, 9, strategy)
    stream = c.compress(data) + c.flush()
    assert tdef.decompress(stream) == jdef.decompress(stream) == data


def test_decompress_history_and_limit_as_tpu7z(corpus):
    hist = corpus[:5000]
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 9)
    c.compress(hist)
    c.flush(zlib.Z_SYNC_FLUSH)
    tail = c.compress(corpus[5000:9000]) + c.flush()
    assert tdef.decompress(tail, history=hist) == jdef.decompress(tail, history=hist) \
        == corpus[5000:9000]
    stream = tdef.compress(corpus[:9000], device="cpu")
    for limit in (8999, 9000, 20000):
        assert _outcome(tdef.decompress, stream, max_out=limit) == \
            _outcome(jdef.decompress, stream, max_out=limit)


def _corruptions(stream):
    cases = [stream[:len(stream) // 2], stream[:1], b"", b"\x07" + stream[1:]]
    for at in (0, 3, len(stream) // 3, len(stream) - 2):
        bad = bytearray(stream)
        bad[at] ^= 0x5A
        cases.append(bytes(bad))
    return cases


@pytest.mark.parametrize("kind", ["text4k", "zeros"])
def test_corrupt_streams_raise_as_tpu7z(corpus, kind):
    stream = jdef.compress(_input(corpus, kind))
    for bad in _corruptions(stream):
        assert _outcome(tdef.decompress, bad) == _outcome(jdef.decompress, bad)


# --- Deflate64 ---------------------------------------------------------------

def _fixed_block(w, items):
    """One final fixed-Huffman block (Deflate64's length and distance
    tables) of literals (ints) and matches ((length, distance))."""
    lit_codes = jdef._canonical_codes(jdef._FIXED_LIT_LEN)
    w.write(1, 1)
    w.write(1, 2)

    def sym(s):
        n = int(jdef._FIXED_LIT_LEN[s])
        w.write(jdef._rev_bits(int(lit_codes[s]), n), n)

    for it in items:
        if isinstance(it, int):
            sym(it)
            continue
        length, dist = it[:2]
        wide = length > 258 or len(it) > 2       # symbol 285: 3 + 16 extra bits
        li = 28 if wide else int(np.searchsorted(jdef.LENGTH_BASE64[:28], length,
                                                 side="right") - 1)
        sym(257 + li)
        if jdef.LENGTH_EXTRA64[li]:
            w.write(length - int(jdef.LENGTH_BASE64[li]), int(jdef.LENGTH_EXTRA64[li]))
        dc = int(np.searchsorted(jdef.DIST_BASE64, dist, side="right") - 1)
        w.write(jdef._rev_bits(dc, 5), 5)
        if jdef.DIST_EXTRA64[dc]:
            w.write(dist - int(jdef.DIST_BASE64[dc]), int(jdef.DIST_EXTRA64[dc]))
    sym(256)
    return w.close()


def _deflate64_stream(prefix_len, matches):
    rng = np.random.default_rng(prefix_len)
    prefix = rng.integers(0, 256, prefix_len).tolist()
    return _fixed_block(jdef._LSBWriter(), prefix + matches)


@pytest.mark.parametrize("matches", [
    [(3, 1)], [(258, 40000)], [(259, 2)], [(65538, 1)], [(1000, 32769)], [(300, 49153)],
    [(65000, 65536), (259, 33000), (4, 1)], [(3, 7, "285"), (258, 1, "285")],
], ids=["short", "len258_far", "len259", "longest", "dist30", "dist31", "mixed", "sym285_short"])
def test_deflate64_streams_decode_as_tpu7z(matches):
    stream = _deflate64_stream(70000, matches)
    want = jdef.decompress(stream, deflate64=True)
    assert tdef.decompress(stream, deflate64=True) == want
    assert len(want) == 70000 + sum(m[0] for m in matches)


def test_length_258_differs_between_the_modes():
    """Symbol 285 is length 258 in DEFLATE and 3 + 16 extra bits in
    Deflate64: a plain stream with a 258 match decodes differently."""
    data = bytes(range(256)) * 2 + bytes(range(256))[:258]
    c = zlib.compressobj(9, zlib.DEFLATED, -15)
    stream = c.compress(data) + c.flush()
    plain = (tdef.decompress(stream), jdef.decompress(stream))
    wide = (_outcome(tdef.decompress, stream, deflate64=True),
            _outcome(jdef.decompress, stream, deflate64=True))
    assert plain[0] == plain[1] == data
    assert wide[0] == wide[1] and wide[0] != ("ok", data)


# --- the tensor stages ---------------------------------------------------------

@pytest.mark.parametrize("width", [16, 1000, 1 << 17])
def test_candidate_rows_equal_tpu7z(corpus, width):
    """find_candidates of a (B, n) tensor: each row's tpu7z
    `_find_candidates`, in row-local positions, from one sort."""
    data = np.frombuffer(make_corpus(TEXT + 3 * width)[TEXT:], np.uint8).reshape(3, width)
    got = hash_chain.find_candidates(torch.from_numpy(data.copy()), 15)
    assert got.shape == (3, width - 3)
    for b in range(3):
        assert np.array_equal(got[b].numpy(), jblock._find_candidates(data[b], hashlog=15))
        assert torch.equal(got[b], hash_chain.find_candidates(torch.from_numpy(data[b].copy()),
                                                              15))


def test_block_joins_keep_matches_inside_their_block(corpus):
    """The flat parse of a 300 KiB input (two joins): every block's
    selected matches are tpu7z's `_find_matches` of that block alone, so no
    match and no length crosses a join."""
    data = corpus[:300 << 10]
    take, mlen, off = tdef._find_matches(torch.from_numpy(np.frombuffer(data, np.uint8).copy()),
                                         tdef.BLOCK)
    sel = torch.nonzero(take).flatten().numpy()
    for start in range(0, len(data), tdef.BLOCK):
        blk = np.frombuffer(data[start:start + tdef.BLOCK], np.uint8)
        mpos, jlen, joff = jdef._find_matches(blk)
        mine = sel[(sel >= start) & (sel < start + blk.size)]
        assert np.array_equal(mine - start, mpos)
        assert np.array_equal(mlen[mine].numpy(), jlen)
        assert np.array_equal(off[mine].numpy(), joff)
        assert (mine + mlen[mine].numpy() <= start + blk.size).all()


def test_walk_from_every_row_start_equals_tpu7z(corpus):
    """greedy_walk with a start at every row's first position: the union of
    tpu7z's `_greedy_parse` of each row."""
    rng = np.random.default_rng(3)
    width, rows = 1000, 5
    step = rng.integers(1, 40, width * rows)
    local = np.arange(width * rows) % width
    nxt = np.minimum(local + step, width) + (np.arange(width * rows) // width) * width
    starts = torch.arange(0, width * rows, width)
    got = hash_chain.greedy_walk(torch.from_numpy(nxt), width * rows, starts)
    for b in range(rows):
        want = jblock._greedy_parse(nxt[b * width:(b + 1) * width] - b * width, width)
        assert np.array_equal(torch.nonzero(got[b * width:(b + 1) * width]).flatten().numpy(),
                              want)


@pytest.mark.parametrize("count", [0, 1, 7, 1000])
def test_pack_bits_tensor_equals_the_writers(count):
    rng = np.random.default_rng(count)
    nbits = rng.integers(0, 57, count)
    values = rng.integers(0, 1 << 62, count)
    w = jbits.BitWriterLSB()
    for v, n in zip(values.tolist(), nbits.tolist()):
        w.write(v, n)
    got = bitstream.pack_bits_lsb_tensor(torch.from_numpy(values), torch.from_numpy(nbits))
    assert got.dtype == torch.uint8
    assert got.numpy().tobytes() == w.close() == bitstream.pack_bits_lsb(
        values.astype(np.uint64), nbits, end_marker=False)
    with pytest.raises(ValueError, match="at most 56 bits"):
        bitstream.pack_bits_lsb_tensor(torch.tensor([1]), torch.tensor([57]))


def test_compress_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        tdef.compress(b"abc")
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        tdef.gzip_compress(b"abc")
