"""The shared LZ matcher as tensor code (tpu7z_torch/ops/hash_chain.py:
`find_candidates`, `match_lengths`, `greedy_walk`) against tpu7z's numpy
matcher (tpu7z/models/lz4/block.py `_find_candidates`, `_match_lengths`,
`_greedy_parse`; tpu7z/models/lzma/encoder.py `_parse_from`) on the CPU.
Inputs are made from seeds: corpus slices past its sparse first 696156
bytes, random bytes, all zeros and a period-3 repeat, at lengths 0-20,
499-501, 4096 and 65546 (zeros and the repeat, whose every position
matches to the end, cost tpu7z's compares the square of their length, so
they stop at 4096). Everything compared is integers, so equality is
exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu7z.models.lz4 import block as jblock  # noqa: E402
from tpu7z.models.lzma import encoder as jenc  # noqa: E402
from tpu7z_torch.ops import hash_chain  # noqa: E402
from tpu7z_torch.utils.corpus import make_corpus  # noqa: E402
from tests.test_torch_lz_match_cuda import EDGES, edge_cases  # noqa: E402

TEXT = 696156            # the corpus's first byte past its sparse chunk
LENGTHS = ["0-20", 499, 500, 501, 4096, 65546]
KINDS = ["corpus", "random", "zeros", "period3"]
HASHLOGS = [12, 16, 20]


@pytest.fixture(scope="module")
def corpus():
    return np.frombuffer(make_corpus(TEXT + (1 << 20)), np.uint8)[TEXT:].copy()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _input(corpus, kind, n):
    if kind == "corpus":
        return corpus[:n].copy()
    if kind == "random":
        return np.random.default_rng(n).integers(0, 256, n, np.uint8)
    if kind == "zeros":
        return np.zeros(n, np.uint8)
    return np.resize(np.array([7, 1, 200], np.uint8), n)


def _inputs(corpus, kind, length):
    sizes = range(21) if length == "0-20" else [length]
    return [_input(corpus, kind, n) for n in sizes]


def _cases():
    for length in LENGTHS:
        for kind in KINDS:
            if length == 65546 and kind in ("zeros", "period3"):
                continue
            yield length, kind


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("hashlog", HASHLOGS)
@pytest.mark.parametrize("length,kind", list(_cases()))
def test_candidates_equal_tpu7z(corpus, length, kind, hashlog):
    for s in _inputs(corpus, kind, length):
        want = jblock._find_candidates(s, hashlog=hashlog)
        got = hash_chain.find_candidates(_t(s), hashlog)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want), s.size


def _limits(s, pos):
    """The two callers' caps: LZ4's (up to the last 5 bytes) and LZMA's
    (273 and the end), and one that leaves some rows below 4."""
    n = s.size
    return {"lz4": (n - 5) - pos, "lzma": np.minimum(n - pos, 273),
            "short": np.minimum(n - pos, pos % 9)}


@pytest.mark.parametrize("hashlog", [12, 16])
@pytest.mark.parametrize("length,kind", list(_cases()))
def test_match_lengths_equal_tpu7z(corpus, length, kind, hashlog):
    for s in _inputs(corpus, kind, length):
        cand = jblock._find_candidates(s, hashlog=hashlog)
        pos = np.nonzero(cand >= 0)[0].astype(np.int64)
        for name, limit in _limits(s, pos).items():
            limit = limit.astype(np.int64)
            want = jblock._match_lengths(s, pos, cand[pos], limit)
            got = hash_chain.match_lengths(_t(s), _t(pos), _t(cand[pos]), _t(limit))
            assert np.array_equal(got.numpy(), want), (s.size, name)


def test_match_lengths_past_a_chain_end():
    """A position whose successor has a nearer candidate ends its chain,
    and its own panels run the whole match: a 3000-byte block repeated,
    with a copy of its second half in between."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, 3000, np.uint8)
    s = np.concatenate([a, a[1500:], rng.integers(0, 256, 40, np.uint8), a, a[:100]])
    cand = jblock._find_candidates(s, hashlog=16)
    pos = np.nonzero(cand >= 0)[0].astype(np.int64)
    limit = ((s.size - 5) - pos).astype(np.int64)
    want = jblock._match_lengths(s, pos, cand[pos], limit)
    got = hash_chain.match_lengths(_t(s), _t(pos), _t(cand[pos]), _t(limit)).numpy()
    assert np.array_equal(got, want)
    assert want.max() > 2000


@pytest.mark.parametrize("name", EDGES)
def test_match_lengths_edges_equal_tpu7z(name):
    """The edge inputs that the card's kernel is held to (an empty `pos`,
    limits under 4, positions at n - 4, a chain end past which the match
    runs on, a bound long enough to be split, entries out of order)
    through the plain version on the CPU."""
    s, pos, cand, limit = edge_cases()[name]
    want = jblock._match_lengths(s, pos, cand, limit)
    got = hash_chain.match_lengths(_t(s), _t(pos), _t(cand), _t(limit))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


def _next_from_parse(s):
    """tpu7z's LZ4 successor array of `s` (block.py:369-387)."""
    n = s.size
    cand = jblock._find_candidates(s)
    p = np.arange(cand.size, dtype=np.int64)
    valid = (cand >= 0) & (p - cand <= 0xFFFF) & (p <= n - 13)
    limit = np.where(valid, (n - 5) - p, 0)
    mlen = np.zeros(cand.size, np.int64)
    v = np.nonzero(valid)[0]
    if v.size:
        mlen[v] = jblock._match_lengths(s, p[v], cand[v], limit[v])
    valid &= mlen >= 4
    full = np.full(n, n, np.int64)
    full[:cand.size] = np.where(valid, p + mlen, p + 1)
    return full


@pytest.mark.parametrize("length,kind", list(_cases()))
def test_greedy_walk_equals_tpu7z(corpus, length, kind):
    for s in _inputs(corpus, kind, length):
        n = s.size
        nxt = _next_from_parse(s)
        got = hash_chain.greedy_walk(_t(nxt), n).numpy()
        assert got.shape == (n + 1,)
        assert np.array_equal(np.nonzero(got[:n])[0], jblock._greedy_parse(nxt, n))
        start = n // 3
        lzma_next = nxt.copy()
        lzma_next[:start] = 0
        want = jenc._parse_from(lzma_next, start, n) if n else np.empty(0, np.int64)
        got = hash_chain.greedy_walk(_t(nxt), n, start).numpy()
        assert np.array_equal(np.nonzero(got[:n])[0], want), n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_walk_of_random_successors(seed):
    """Random jumps of 1 to 300, some past the end, and successors for
    only part of the positions (the rest lead to the end)."""
    rng = np.random.default_rng(seed)
    n = 7000
    nxt = np.arange(n) + np.where(rng.random(n) < 0.3, rng.integers(2, 300, n), 1)
    got = hash_chain.greedy_walk(_t(nxt.astype(np.int64)), n).numpy()
    assert np.array_equal(np.nonzero(got[:n])[0], jblock._greedy_parse(nxt, n))
    part = nxt[:5000].astype(np.int64)
    full = np.full(n, n, np.int64)
    full[:5000] = part
    got = hash_chain.greedy_walk(_t(part), n).numpy()
    assert np.array_equal(np.nonzero(got[:n])[0], jblock._greedy_parse(full, n))


def test_spans_are_traced(corpus):
    from tpu7z_torch.utils import trace
    s = _t(corpus[:4096])
    trace.attach(keep_records=True)
    trace.clear()
    try:
        cand = hash_chain.find_candidates(s)
        pos = torch.nonzero(cand >= 0).flatten()
        mlen = hash_chain.match_lengths(s, pos, cand[pos], 4091 - pos)
        nxt = torch.arange(4096) + 1
        nxt[pos] = pos + mlen
        hash_chain.greedy_walk(nxt, 4096)
        names = [r["name"] for r in trace.records()]
    finally:
        trace.detach()
        trace.clear()
    assert [n for n in names if n.startswith("lz.")] == ["lz.sort", "lz.match_lengths", "lz.walk"]
    # inside them: the sort's launch and the matcher's host reads
    assert names[0] == "sort.rows" and names[1] == "lz.sort"
    assert set(names) - {"lz.sort", "lz.match_lengths", "lz.walk"} == {
        "sort.rows", "read.lz_chain_ends", "read.lz_panel_rows", "read.lz_panel_pass"}
