"""Deflate's block tables from the host library (tpu7z_torch/csrc/
deflate_tables.cpp, bound in tpu7z_torch/models/deflate/codec.py as
`_tables` and `_code_lengths`) against tpu7z's Python on the CPU: the
code lengths (`_lens_from_hist` over the package-merge), the
bit-reversed canonical codes (`_canonical_codes`, `_rev_bits`) and every
block's header fields (`_write_dynamic_header` into a recording
`_LSBWriter`), as tpu7z's `_compress_block` makes them up to the body.
Histograms: seeded random ones full of equal counts (the package-merge's
tie order), Fibonacci weights that make the 15-bit and the 7-bit limits
engage, one and two used symbols, all-zero and negative distance counts,
and the histograms of every block of a 4 MiB tile of the corpus; each
with and without `streams`. Everything compared is integers or bytes, so
equality is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu7z.models.deflate import codec as jdef  # noqa: E402
from tpu7z_torch.models.deflate import codec as tdef  # noqa: E402
from tpu7z_torch.utils.corpus import make_corpus  # noqa: E402

NLIT, NDIST = tdef.NLIT, tdef.NDIST
TEXT = 696156            # the corpus's first byte past its sparse chunk
FIB = np.array([1, 1], dtype=np.int64)
while FIB.size < 60:
    FIB = np.append(FIB, FIB[-1] + FIB[-2])


class _Recorder(jdef._LSBWriter):
    """tpu7z's bit writer that also keeps every (value, nbits) written."""

    __slots__ = ("fields",)

    def __init__(self):
        super().__init__()
        self.fields = []

    def write(self, value: int, bits: int):
        self.fields.append((value & ((1 << bits) - 1), bits))
        super().write(value, bits)


def _reversed(lens):
    codes = jdef._canonical_codes(lens)
    return np.array([jdef._rev_bits(int(c), int(n)) for c, n in zip(codes, lens)],
                    dtype=np.int64)


def _reference(lit_hist, dist_hist, streams):
    """Per block, tpu7z's `_compress_block` up to the body: lit_lens,
    dist_lens, their reversed codes, the header's fields and bytes."""
    nb = lit_hist.shape[0]
    out = []
    for b in range(nb):
        lit_lens = jdef._lens_from_hist(lit_hist[b], NLIT, 15)
        if dist_hist[b].sum() == 0:
            dist_lens = np.zeros(NDIST, dtype=np.int64)
            dist_lens[0] = 1
        else:
            dist_lens = jdef._lens_from_hist(np.maximum(dist_hist[b], 0), NDIST, 15)
        w = _Recorder()
        w.write(1 if streams or b == nb - 1 else 0, 1)
        w.write(2, 2)
        jdef._write_dynamic_header(w, lit_lens, dist_lens)
        out.append((lit_lens, dist_lens, _reversed(lit_lens), _reversed(dist_lens),
                    w.fields, w.close()))
    return out


def _check(lit_hist, dist_hist, streams):
    """The library's tables of every block equal to tpu7z's; returns them."""
    lit_hist = np.asarray(lit_hist, dtype=np.int64)
    dist_hist = np.asarray(dist_hist, dtype=np.int64)
    got = tdef._tables(lit_hist, dist_hist, streams)
    lit_lens, dist_lens, lit_codes, dist_codes, heads, hvals, hbits = got
    assert heads.sum() == hvals.size == hbits.size
    ends = np.cumsum(heads)
    for b, want in enumerate(_reference(lit_hist, dist_hist, streams)):
        assert np.array_equal(lit_lens[b], want[0]), b
        assert np.array_equal(dist_lens[b], want[1]), b
        assert np.array_equal(lit_codes[b], want[2]), b
        assert np.array_equal(dist_codes[b], want[3]), b
        lo, hi = ends[b] - heads[b], ends[b]
        fields = list(zip(hvals[lo:hi].tolist(), hbits[lo:hi].tolist()))
        assert fields == want[4], b
        w = jdef._LSBWriter()
        for v, n in fields:
            w.write(v, n)
        assert w.close() == want[5], b
    return got


def _random_hists(seed, nb, top):
    """Counts drawn from a few values, so most counts tie with others,
    and about a third of the symbols unused."""
    rng = np.random.default_rng(seed)
    lit = rng.integers(0, top, (nb, NLIT)) * (rng.random((nb, NLIT)) < 0.67)
    lit[:, 256] = 1
    dist = rng.integers(0, top, (nb, NDIST)) * (rng.random((nb, NDIST)) < 0.67)
    return lit, dist


@pytest.mark.parametrize("streams", [False, True])
@pytest.mark.parametrize("seed,nb,top", [(1, 1, 2), (2, 3, 3), (3, 8, 4), (4, 5, 9),
                                         (5, 4, 1000), (6, 2, 1 << 17)])
def test_random_histograms_with_ties(seed, nb, top, streams):
    _check(*_random_hists(seed, nb, top), streams)


def _fibonacci(used, size, seed, first=None):
    """`used` symbols of `size` with Fibonacci counts (in cycles of 50, so
    sums stay in 64 bits) at seeded places, symbol `first` (if given) the
    first count 1, the rest unused."""
    places = np.random.default_rng(seed).permutation(size)
    if first is not None:
        places = np.concatenate([[first], places[places != first]])
    hist = np.zeros(size, dtype=np.int64)
    hist[places[:used]] = FIB[np.arange(used) % 50]
    return hist


@pytest.mark.parametrize("streams", [False, True])
@pytest.mark.parametrize("used", [20, 33, 100, 200, 285])
def test_fibonacci_counts_hit_the_15_bit_limit(used, streams):
    # EOB's count of 1 is one of the chain's two first counts
    lit = np.stack([_fibonacci(used, NLIT, seed, first=256) for seed in (used, used + 1)])
    dist = np.stack([_fibonacci(NDIST, NDIST, used), _fibonacci(21, NDIST, used + 2)])
    lit_lens, dist_lens = _check(lit, dist, streams)[:2]
    assert lit_lens.max() == dist_lens.max() == 15


@pytest.mark.parametrize("size,used,max_bits", [(19, 19, 7), (19, 12, 7), (19, 9, 7),
                                                (19, 19, 5), (NDIST, NDIST, 15),
                                                (NLIT, 100, 15), (NLIT, NLIT, 15),
                                                (NLIT, 256, 8)])
def test_one_alphabet_at_its_limit(size, used, max_bits):
    """The library's one-alphabet entry against `_lens_from_hist`, with
    counts skewed so that the limit engages (the 7-bit code-length
    alphabet among them)."""
    for seed in range(3):
        hist = _fibonacci(used, size, seed)
        got = tdef._code_lengths(hist, max_bits)
        assert np.array_equal(got, jdef._lens_from_hist(hist, size, max_bits))
        assert got.max() == max_bits


@pytest.mark.parametrize("seed", range(6))
def test_one_alphabet_random_ties(seed):
    rng = np.random.default_rng(seed)
    size = int(rng.integers(2, NLIT + 1))
    max_bits = int(rng.integers(max(1, int(np.ceil(np.log2(size)))), 16))
    hist = rng.integers(0, 4, size) * (rng.random(size) < 0.8)
    assert np.array_equal(tdef._code_lengths(hist, max_bits),
                          jdef._lens_from_hist(hist, size, max_bits))


def test_one_alphabet_refuses_what_no_code_holds():
    for hist, max_bits in ((np.ones(NLIT + 1), 15), (np.ones(19), 0), (np.ones(19), 16),
                           (np.ones(19), 4)):
        with pytest.raises(ValueError, match="_code_lengths"):
            tdef._code_lengths(hist, max_bits)
    # one and no used symbol
    assert tdef._code_lengths(np.array([0, 0, 5, 0]), 1).tolist() == [0, 0, 1, 0]
    assert tdef._code_lengths(np.zeros(7), 3).tolist() == [0] * 7


def test_tables_refuse_other_shapes():
    with pytest.raises(ValueError, match="histograms must be"):
        tdef._tables(np.ones((2, NLIT)), np.ones((3, NDIST)))
    with pytest.raises(ValueError, match="histograms must be"):
        tdef._tables(np.ones((2, NLIT + 1)), np.ones((2, NDIST)))


@pytest.mark.parametrize("streams", [False, True])
def test_one_and_two_used_symbols(streams):
    lit = np.zeros((4, NLIT), dtype=np.int64)
    lit[:, 256] = 1
    lit[1, 65] = 7            # two used literal symbols
    lit[2, 270] = 3           # a match code beside EOB
    lit[3, :256] = 1          # every literal once
    dist = np.zeros((4, NDIST), dtype=np.int64)
    dist[1, 4] = 9            # one used distance code
    dist[2, [0, 29]] = [1, 2]
    dist[3, 7] = 1
    lit_lens, dist_lens = _check(lit, dist, streams)[:2]
    assert lit_lens[0, 256] == 1 and lit_lens[0].sum() == 1
    assert lit_lens[1, [65, 256]].tolist() == [1, 1]
    assert dist_lens[1, 4] == 1 and dist_lens[1].sum() == 1


@pytest.mark.parametrize("streams", [False, True])
def test_zero_and_negative_distance_counts(streams):
    """An all-zero distance histogram codes distance 0 at length 1;
    negative counts are taken as 0, and a sum of 0 counts as none."""
    lit, _ = _random_hists(11, 4, 6)
    dist = np.zeros((4, NDIST), dtype=np.int64)
    dist[1, [0, 3, 5]] = [-3, 5, 2]
    dist[2, [1, 2]] = [-2, 2]
    dist[3, [2, 9]] = [-1, -4]
    dist_lens = _check(lit, dist, streams)[1]
    assert dist_lens[0].tolist() == [1] + [0] * (NDIST - 1)
    assert dist_lens[2].tolist() == [1] + [0] * (NDIST - 1)
    assert dist_lens[1, 0] == 0 and dist_lens[3].sum() == 0


@pytest.fixture(scope="module")
def tile_hists():
    """The histograms `_encode` hands the library for a 4 MiB tile of the
    corpus (32 blocks), and the library's tables of them."""
    data = make_corpus(TEXT + (4 << 20))[TEXT:]
    seen = []
    real = tdef._tables

    def spy(lit_hist, dist_hist, streams=False):
        seen.append((lit_hist.copy(), dist_hist.copy()))
        return real(lit_hist, dist_hist, streams)

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    tdef._tables = spy
    try:
        tdef.compress(data, device="cpu")
    finally:
        tdef._tables = real
        torch.set_num_threads(before)
    (hists,) = seen
    return hists


@pytest.mark.parametrize("streams", [False, True])
def test_every_block_of_a_corpus_tile(tile_hists, streams):
    lit, dist = tile_hists
    assert lit.shape == (32, NLIT) and (lit[:, 256] == 1).all()
    heads = _check(lit, dist, streams)[4]
    assert heads.size == 32
