"""bzip2 in the port (tpu7z_torch/models/bzip2) against tpu7z's
(tpu7z/models/bzip2) on the CPU: the stream byte for byte at levels 1 and
9, the BWT's doubling sort and its inverse (`sort_rows`' plain version on
CPU tensors), the CRC, and the decoder on tpu7z's, bz2's and corrupt
streams. Inputs are made from seeds: empty, 1 and 15 bytes, random bytes,
zeros, a period-3 repeat, the corpus past its sparse first 696156 bytes at
4 KiB, 131072 bytes and 300 KiB (three blocks at level 1), and RLE1 runs
placed across the 100000-byte block cut. Everything compared is bytes or
integers, so equality is exact."""

import bz2

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu7z.models.bzip2 import bwt as jbwt  # noqa: E402
from tpu7z.models.bzip2 import codec as jbz  # noqa: E402
from tpu7z_torch.models import registry as treg  # noqa: E402
from tpu7z_torch.models.bzip2 import bwt as tbwt  # noqa: E402
from tpu7z_torch.models.bzip2 import codec as tbz  # noqa: E402
from tpu7z_torch.ops import sort_cuda  # noqa: E402
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


# text300k is one block at level 9; level 1 gives it three
@pytest.mark.parametrize("kind,level", [(k, lv) for k in KINDS for lv in (1, 9)
                                        if (k, lv) != ("text300k", 9)])
def test_compress_equals_tpu7z(corpus, kind, level):
    data = _input(corpus, kind)
    got = tbz.compress(data, level=level, device="cpu")
    assert got == jbz.compress(data, level=level)
    assert bz2.decompress(got) == data
    assert tbz.decompress(got, device="cpu") == data


def _across_the_cut(at: int, run: bytes) -> bytes:
    """101000 bytes without runs but `run` placed at `at`, across the
    level-1 cut of the RLE1 stream at 100000."""
    rng = np.random.default_rng(at)
    data = bytearray(rng.integers(2, 255, 101000, np.uint8))
    for i in range(1, len(data)):        # no accidental runs
        if data[i] == data[i - 1]:
            data[i] = 2 + (data[i] - 1) % 253
    data[at:at + len(run)] = run
    return bytes(data)


@pytest.mark.parametrize("at", [99996, 99997, 99998, 99999, 100000])
def test_runs_across_the_block_cut_equal_tpu7z(at):
    """A run of nine bytes (RLE1: four and a count) placed across the
    level-1 cut at 100000. A whole group at the cut moves into the next
    block, as in tpu7z. A cut after the run's first 1-3 bytes: tpu7z
    leaves them ending one block, and every reader then takes the count
    byte that starts the next block for a literal (ROADMAP.md §3); the
    port carries them into the next block, so its stream decodes right
    and differs from tpu7z's there only."""
    data = _across_the_cut(at, b"\xff" * 9)
    got = tbz.compress(data, level=1, device="cpu")
    ref = jbz.compress(data, level=1)
    assert bz2.decompress(got) == tbz.decompress(got, device="cpu") == data
    assert (bz2.decompress(ref) == data) == (at not in (99997, 99998, 99999))
    assert (got == ref) == (bz2.decompress(ref) == data)


@pytest.mark.parametrize("at", [99997, 99998, 99999])
def test_a_cut_group_that_tpu7z_decodes_right_stays_as_tpu7z(at):
    """Five 0x01 are the group 01 01 01 01 and count 1. tpu7z's cut after
    its second or third byte decodes right all the same (the next block's
    01 01 01 or 01 01 and its count 01 read as that many literals), so the
    port keeps tpu7z's stream there; after its first byte it does not."""
    data = _across_the_cut(at, b"\x01" * 5)
    got = tbz.compress(data, level=1, device="cpu")
    ref = jbz.compress(data, level=1)
    assert bz2.decompress(got) == tbz.decompress(got, device="cpu") == data
    assert (got == ref) == (at != 99999) == (bz2.decompress(ref) == data)


@pytest.mark.parametrize("seed", range(4))
def test_blocks_decode_right_and_are_tpu7z_split_where_it_is_sound(seed):
    """Small block limits over runs of 1-3 bytes with none, a few or many
    runs of 4-299 among them: the blocks' own RLE1 decodes join up to the
    data, and where tpu7z's split (`carry_heads=False`) is sound, as it is
    without runs of four, the blocks are its."""
    rng = np.random.default_rng(seed)
    for share in (0.0, 0.01, 0.3):
        runs = np.where(rng.random(300) < share, rng.integers(4, 300, 300),
                        rng.integers(1, 4, 300))
        values = np.cumsum(rng.integers(1, 3, 300)) % 3     # no two runs join
        data = bytes(np.repeat(values.astype(np.uint8), runs))
        rle = tbz._rle1_encode(data)
        for limit in (5, 6, 7, 9, 13, 64):
            blocks, plains = tbz._blocks(data, limit)
            assert b"".join(plains) == data
            assert plains == [tbz._rle1_decode(b) for b in blocks]
            split = tbz._split_blocks(rle, limit, carry_heads=False)
            if b"".join(map(tbz._rle1_decode, split)) == data:
                assert blocks == split


@pytest.mark.parametrize("kind", ["random", "text4k", "text128k"])
def test_decompress_reads_bz2_as_tpu7z(corpus, kind):
    data = _input(corpus, kind)
    for level in (1, 9):
        stream = bz2.compress(data, level)
        assert tbz.decompress(stream, device="cpu") == jbz.decompress(stream) == data


@pytest.mark.parametrize("kind", ["empty", "one", "random", "zeros", "period3", "text4k"])
def test_bwt_equals_tpu7z(corpus, kind):
    data = _input(corpus, kind)
    last, ptr = tbwt.bwt_forward(data, device="cpu")
    assert (last, ptr) == jbwt.bwt_forward(data)
    assert tbwt.bwt_inverse(last, ptr, device="cpu") == jbwt.bwt_inverse(last, ptr) == data


@pytest.mark.parametrize("data", [b"ab" * 50, b"abc" * 7, b"aa", b"xyxyxyz" * 3],
                         ids=["period2", "period3", "two", "near_periodic"])
def test_bwt_tie_break_of_periodic_blocks_equals_tpu7z(data):
    """A periodic block never ranks every rotation apart: k reaches n and
    tpu7z breaks ties by index."""
    assert tbwt.bwt_forward(data, device="cpu") == jbwt.bwt_forward(data)


def test_packed_key_is_cut_so_two_passes_sort(corpus):
    """sort_rows takes 32-bit keys: a packed (rank << 20 | key2) key of
    ranks at or above 2**12, cut to its low 32 bits, sorts wrong, which
    is why bwt_forward sorts in two stable passes, and those give
    np.lexsort's order."""
    rng = np.random.default_rng(5)
    n = 5000
    rank = rng.integers(0, 1 << 20, n)
    key2 = rng.integers(0, 1 << 20, n)
    want = np.lexsort((key2, rank))
    packed = torch.from_numpy((rank << 20) | key2)[None]
    idx = torch.arange(n, dtype=torch.int32)[None]
    _, cut = sort_cuda.sort_rows(sort_cuda.raw_bits(packed), idx)
    assert not np.array_equal(cut[0].numpy(), want)
    got = tbwt._lexsort2(torch.from_numpy(rank), torch.from_numpy(key2), 20)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["random", "zeros", "text4k"])
def test_occurrence_index_and_orbit_equal_tpu7z(corpus, kind):
    s = np.frombuffer(_input(corpus, kind), np.uint8)
    occ = tbwt._occurrence_index(torch.from_numpy(s.astype(np.int64)))
    assert np.array_equal(occ.numpy(), jbwt._occurrence_index(s))
    perm = np.random.default_rng(1).permutation(s.size)
    got = tbwt._orbit(torch.from_numpy(perm), 7, s.size)
    assert np.array_equal(got.numpy(), jbwt._orbit(perm, 7, s.size))


@pytest.mark.parametrize("crc", [0xFFFFFFFF, 0, 0x12345678])
def test_crc_equals_tpu7z(corpus, crc):
    for data in (b"", b"a", b"123456789", corpus[:3000]):
        assert tbz.bz_crc32(data, crc) == jbz.bz_crc32(data, crc)


def _corruptions(stream):
    cases = [stream[:len(stream) // 2], stream[:12], stream[:3], b"BZh0" + stream[4:],
             b"BZx9" + stream[4:]]
    for at in (5, 11, 20, len(stream) // 2, len(stream) - 3):
        bad = bytearray(stream)
        bad[at] ^= 0x21
        cases.append(bytes(bad))
    return cases


@pytest.mark.parametrize("kind", ["text4k", "zeros"])
def test_corrupt_streams_raise_as_tpu7z(corpus, kind):
    stream = jbz.compress(_input(corpus, kind), level=1)
    for bad in _corruptions(stream):
        assert _outcome(tbz.decompress, bad, device="cpu") == _outcome(jbz.decompress, bad)


def test_pointer_outside_the_block_raises_as_tpu7z():
    last, _ = jbwt.bwt_forward(b"banana bandana")
    for ptr in (len(last), len(last) + 5):
        assert _outcome(tbwt.bwt_inverse, last, ptr, device="cpu") == \
            _outcome(jbwt.bwt_inverse, last, ptr) == ("raises", "IndexError")


def test_level_out_of_range_raises_as_tpu7z():
    for level in (0, 10):
        assert _outcome(tbz.compress, b"x", level, device="cpu") == \
            _outcome(jbz.compress, b"x", level)


def test_registry_bzip2_equals_tpu7z(corpus):
    from tpu7z.models import registry as jreg
    data = corpus[:20000]
    mine, ref = treg.get_codec("bzip2"), jreg.get_codec("bzip2")
    assert (mine.name, mine.method_id, mine.levels) == (ref.name, ref.method_id, ref.levels)
    for level in (0, 5, 12):
        packed = mine.compress(data, level=level, device="cpu")
        assert packed == ref.compress(data, level=level)
        assert mine.decompress(packed, device="cpu") == data


def test_bzip2_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        tbz.compress(b"abc")
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        tbz.decompress(jbz.compress(b"abc"))
