import hashlib
import zlib

import pytest

from pb import corpus, traffic
from pb.corpus import CORPUS_SHA256, make_corpus, make_pool

KAFKA = {"loop": "closed", "clients": 1, "pool": {"corpus_bytes": 1 << 20}, "align": 4096,
         "sizes": [{"weight": 0.8, "dist": "uniform", "lo": 4096, "hi": 16384},
                   {"weight": 0.2, "dist": "loguniform", "lo": 16384, "hi": 1 << 20}]}


def test_frozen_corpus_is_pinned():
    assert hashlib.sha256(make_corpus(32 << 20)).hexdigest() == CORPUS_SHA256


def test_pool_is_pinned():
    pool = make_pool(32 << 20, corpus.POOL_PIN_SEED)
    assert hashlib.sha256(pool).hexdigest() == corpus.POOL_SHA256


def test_pool_follows_the_seed_and_keeps_its_mix():
    """Every seed gives other bytes of the same size, in the same shares of
    the kinds, so the pool compresses alike on every seed."""
    pools = [make_pool(4 << 20, s) for s in (1, 2, 2**31 + 9, -4)]
    assert all(len(p) == 4 << 20 for p in pools)
    assert len({hashlib.sha256(p).digest() for p in pools}) == 4
    assert make_pool(4 << 20, 2) == pools[1]
    blocks = [{p[k:k + 65536] for k in range(0, len(p), 65536)} for p in pools]
    assert len(blocks[0] & blocks[1]) <= 8          # runs of zeros alike, no more
    ratios = [len(p) / len(zlib.compress(p, 1)) for p in pools]
    assert max(ratios) / min(ratios) < 1.03


@pytest.fixture(scope="module")
def pool():
    return make_pool(1 << 20, 5)


def test_same_seed_same_requests(pool):
    a = traffic.Traffic(KAFKA, 2**31 + 12345, pool)
    b = traffic.Traffic(KAFKA, 2**31 + 12345, pool)
    c = traffic.Traffic(KAFKA, 2**31 + 12346, pool)
    assert [bytes(a.request(i)) for i in range(50)] == [bytes(b.request(i)) for i in range(50)]
    assert [a.shape(i) for i in range(50)] != [c.shape(i) for i in range(50)]


@pytest.mark.parametrize("seed", [0, 1, -7, 2**40 + 3])
def test_requests_are_aligned_views_of_the_pool(pool, seed):
    t = traffic.Traffic(KAFKA, seed, pool)
    for i in range(200):
        off, size = t.shape(i)
        assert off % KAFKA["align"] == 0 and 0 <= off < len(pool)
        assert 4096 <= size <= 1 << 20
        want = (pool * 3)[off:off + size]
        assert bytes(t.request(i)) == want


def test_mix_shares_and_spread(pool):
    """About 80% of sizes in 4-16 KiB; each pass of 256 requests sends
    every one of the pool's 256 slots once, in another order on every
    seed and pass; the warm-up's requests are other draws."""
    orders = set()
    for seed in (3, 4, 5):
        t = traffic.Traffic(KAFKA, seed, pool)
        shapes = [t.shape(i) for i in range(4096)]
        small = sum(1 for _, s in shapes if s <= 16384) / len(shapes)
        assert 0.77 <= small <= 0.83
        for k in range(0, 4096, 256):
            offs = tuple(o for o, _ in shapes[k:k + 256])
            assert sorted(offs) == [j * KAFKA["align"] for j in range(256)]
            orders.add(offs)
        assert [t.shape(-1 - i) for i in range(50)] != shapes[:50]
    assert len(orders) == 3 * 16


def test_fixed_size_is_a_rotation(pool):
    bulk = {**KAFKA, "sizes": [{"weight": 1, "dist": "fixed", "bytes": len(pool)}]}
    t = traffic.Traffic(bulk, 9, pool)
    off, size = t.shape(5)
    assert size == len(pool)
    assert bytes(t.request(5)) == pool[off:] + pool[:off]


def test_scaled_keeps_the_shape_of_the_mix():
    s = traffic.scaled(KAFKA, 1 / 16)
    assert s["align"] == 256 and s["pool"]["corpus_bytes"] == 65536
    assert s["sizes"][0]["lo"] == 256 and s["sizes"][1]["hi"] == 65536


def test_bad_mix_is_refused():
    with pytest.raises(ValueError):
        traffic.check_params({**KAFKA, "clients": 2})
    with pytest.raises(ValueError):
        traffic.check_params({**KAFKA, "sizes": [{"weight": 1, "dist": "zipf"}]})
