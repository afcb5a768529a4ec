"""The zstd tensor encoder's parse (tpu7z_torch/ops/hash_chain.py and
models/zstd/compressor.py) against tpu7z's numpy parse, on the CPU: the
rolling hash's bits, the depth-k candidates and their stable sort, the
match lengths, the pointer-doubling walk, and `find_sequences_windowed`
on inputs of 0-15 bytes (test_torch_zstd_windowed.py holds it on larger
ones). Inputs are small, since tpu7z's side runs its numpy parse too."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu7z.models.lz4 import block as jblock  # noqa: E402
from tpu7z.models.zstd import compressor as jcomp  # noqa: E402
from tpu7z_torch.ops import hash_chain, match, sort_cuda  # noqa: E402
from tpu7z_torch.models.zstd import compressor as tcomp  # noqa: E402
from tpu7z_torch.utils.corpus import make_corpus  # noqa: E402

# offsets of the first chunk of each kind in make_corpus's bytes
CHUNKS = {"sparse": 0, "text": 696156, "struct": 1040837, "random": 1674070,
          "log": 5886072}
LEVELS = (-1, 1, 3, 5, 9, 12, 17, 19)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(6 << 20)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _chunk(corpus, kind, size):
    return np.frombuffer(corpus, np.uint8)[CHUNKS[kind]:CHUNKS[kind] + size].copy()


def _samples(corpus, size):
    out = {k: _chunk(corpus, k, size) for k in CHUNKS}
    out["zeros"] = np.zeros(size, np.uint8)
    out["random_seeded"] = np.random.default_rng(10).integers(0, 256, size, np.uint8)
    return out


def _cpu(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("kind", ["text", "zeros", "random_seeded", "struct"])
def test_prefix_hash_bits_equal_numpys(corpus, kind):
    s = _samples(corpus, 40000)[kind]
    h_j, a_j = jblock.build_prefix_hash(s)
    h_t, a_t = hash_chain.build_prefix_hash(_cpu(s))
    assert np.array_equal(h_t.numpy(), h_j.view(np.int64))
    assert np.array_equal(a_t.numpy(), a_j.view(np.int64))


def test_powers_and_inverse_match_python_ints():
    inv = hash_chain.modinv_pow2(hash_chain.POLY_A)
    assert inv == int(jblock._modinv_pow2(jblock._POLY_A))
    assert (inv * hash_chain.POLY_A) % (1 << 64) == 1
    got = hash_chain.powers(hash_chain.POLY_A, 70, "cpu").numpy().view(np.uint64)
    want = [pow(hash_chain.POLY_A, i, 1 << 64) for i in range(70)]
    assert [int(x) for x in got] == want


@pytest.mark.parametrize("hashlog,depth", [(16, 1), (17, 3), (18, 6), (20, 16)])
@pytest.mark.parametrize("kind", ["text", "zeros", "log"])
def test_candidates_equal_tpu7z(corpus, kind, hashlog, depth):
    s = _samples(corpus, 30000)[kind]
    want = jblock._find_candidates_multi(s, hashlog=hashlog, depth=depth)
    got = hash_chain.find_candidates_multi(_cpu(s), hashlog, depth)
    assert len(got) == depth
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("hashlog", [16, 17, 18, 19, 20])
def test_sort_order_is_numpys_stable_argsort(corpus, hashlog):
    """The stable sort by hash, `match.sort_order`, as the parse calls it:
    no sentinel, n - 3 word positions; on a duplicate-heavy row (zeros
    with a text tail) and on text."""
    key, begin_bit = match.hash_key(torch.tensor([1 << hashlog]), hashlog)
    shift = 31 - hashlog
    assert begin_bit == 8 * (shift // 8) and int(key) == (1 << 31) - (1 << 32)
    for s in (np.concatenate([np.zeros(20000, np.uint8), _chunk(corpus, "text", 5000)]),
              _chunk(corpus, "text", 20000)):
        h = hash_chain.hashes(hash_chain.u32_at(_cpu(s)), hashlog)
        v = jblock._u32_at(s)
        h_np = ((v * jblock._HASH_MULT) >> np.uint32(32 - hashlog)).astype(np.uint32)
        assert np.array_equal(h.numpy(), h_np)
        order = match.sort_order(h[None], hashlog)[0]
        assert np.array_equal(order.numpy(), np.argsort(h_np, kind="stable"))
        plain = match.sort_order(h[None], hashlog, sort=sort_cuda.sort_rows_ref)[0]
        assert torch.equal(order, plain)


@pytest.mark.parametrize("kind", ["text", "zeros", "struct", "log"])
def test_match_lengths_equal_tpu7z(corpus, kind):
    s = _samples(corpus, 50000)[kind]
    cand = jblock._find_candidates_multi(s, hashlog=17, depth=2)[1]
    pos = np.arange(cand.size)
    ok = cand >= 0
    p, c = pos[ok], cand[ok]
    limit = s.size - p
    want = jblock.match_lengths_hashed(jblock.build_prefix_hash(s), p, c, limit)
    hash_chain.reset_steps()
    got = hash_chain.match_lengths_hashed(hash_chain.build_prefix_hash(_cpu(s)),
                                          _cpu(p), _cpu(c), _cpu(limit))
    assert np.array_equal(got.numpy(), want)
    if p.size:
        assert hash_chain.STEPS["gallop"] >= 1


@pytest.mark.parametrize("start", [0, 1, 777])
def test_greedy_walk_equals_tpu7z(start):
    rng = np.random.default_rng(start)
    n = 5000
    step = np.where(rng.random(n) < 0.3, rng.integers(4, 300, n), 1)
    nxt = np.arange(n) + step
    want = jcomp._greedy_parse_from(nxt.astype(np.int64), n, start)
    got = hash_chain.greedy_walk(_cpu(nxt.astype(np.int64)), n, start)
    assert np.array_equal(np.nonzero(got[:n].numpy())[0], want)


def _parse_equal(s, level, seg_size=1 << 22, window_log=None):
    hl, depth, wlog, lazy = jcomp._level_params(level, s.size)
    if window_log is not None:
        wlog = window_log
    want = jcomp.find_sequences_windowed(s, hl, wlog, depth=depth, lazy=lazy,
                                         seg_size=seg_size)
    got = tcomp.find_sequences_windowed(s, hl, wlog, depth=depth, lazy=lazy,
                                        seg_size=seg_size, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and g.device.type == "cpu"
        assert np.array_equal(g.numpy(), w)
    return want


@pytest.mark.parametrize("n", range(16))
def test_windowed_parse_of_tiny_inputs(n):
    s = (np.arange(n) % 3).astype(np.uint8)
    mpos, _, _ = _parse_equal(s, 3)
    assert mpos.size == 0


def test_parse_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tcomp.find_sequences_windowed(np.zeros(100, np.uint8), 17, 21)
