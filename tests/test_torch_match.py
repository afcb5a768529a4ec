"""The port's device match-finder path against the JAX package: the match
finder itself at every position (hashlog 0-31, rows over 64 KiB), the
.lz4 frame of the device backend (blocks over 64 KiB too), the
skippable-frame container, the entry point, and the device encoder's
frame without the sorted-neighbour tiers.

On the CPU the match finder's sort is the plain `torch.sort`. All outputs
are integers or bytes, so the tolerance is exact equality.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
from tpu7z.containers import skippable as jskippable  # noqa: E402
from tpu7z.models.lz4 import frame as jframe  # noqa: E402
from tpu7z.models.lz4 import jax_backend  # noqa: E402
from tpu7z.ops import match_jax  # noqa: E402
from tpu7z.ops.hashing import xxh32_fast  # noqa: E402
from tpu7z.parallel import shard_compress_lz4 as jax_shard  # noqa: E402
from tpu7z.parallel.mesh import make_mesh  # noqa: E402
from tpu7z.parallel.sharded import (  # noqa: E402
    shard_compress_lz4_device as jax_device_frame)
from tpu7z.parallel.sharded import (  # noqa: E402
    sharded_find_matches as jax_sharded_find_matches)
from tpu7z_torch.containers import skippable  # noqa: E402
from tpu7z_torch.entry import entry  # noqa: E402
from tpu7z_torch.models.lz4 import frame as tframe  # noqa: E402
from tpu7z_torch.models.lz4 import torch_backend  # noqa: E402
from tpu7z_torch.ops import match  # noqa: E402
from tpu7z_torch.parallel import sharded  # noqa: E402
from tpu7z_torch.utils.corpus import make_corpus  # noqa: E402

BLOCK = 1 << 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one intra-op
    thread each keeps PyTorch's thread pools from contending for the
    cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batches():
    """(blocks, lengths) batches: the entry point's sample, two 64 KiB
    corpus blocks (the second short), and one 16 KiB batch of an empty,
    a random, an all-zero and a short text block, and a block whose last
    in-range word hashes to 0xFFFF (at hashlog 16 the largest hash, just
    below the sentinel)."""
    _, (eb, el) = __graft_entry__.entry()
    two = torch_backend.pad_blocks(make_corpus(BLOCK + 40000), BLOCK)
    rng = np.random.default_rng(4)
    N = 16384
    mixed = np.zeros((5, N), np.uint8)
    mixed[1] = rng.integers(0, 256, N, dtype=np.uint8)
    text = b"".join(rng.choice([b"ab ", b"abc ", b"tpu "], 3000))[:9000]
    mixed[3, :len(text)] = np.frombuffer(text, np.uint8)
    L = 7000
    mixed[4, :L] = np.frombuffer(text[:L], np.uint8)
    word = (0xFFFF1234 * pow(match.HASH_MULT, -1, 1 << 32)) % (1 << 32)
    mixed[4, L - 4:L] = np.frombuffer(word.to_bytes(4, "little"), np.uint8)
    return {"entry": (np.array(eb), np.array(el)),
            "two_64k_one_short": two,
            "empty_random_zero_short": (
                mixed, np.array([0, N, N, 9000, L], np.int32))}


@pytest.fixture(scope="module")
def batches():
    return _batches()


@pytest.mark.parametrize("hashlog", [16, 12, 0, 17, 20, 24, 31])
@pytest.mark.parametrize("name", ["entry", "two_64k_one_short",
                                  "empty_random_zero_short"])
def test_find_matches_equals_jax_everywhere(batches, name, hashlog):
    blocks, lengths = batches[name]
    want = match_jax.find_matches(jnp.asarray(blocks), jnp.asarray(lengths),
                                  hashlog=hashlog)
    got = match.find_matches(torch.from_numpy(blocks),
                             torch.from_numpy(lengths), hashlog=hashlog)
    for g, w, dt in zip(got, want, (torch.bool, torch.int32, torch.int32)):
        assert g.dtype == dt
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kw", [{"hashlog": 32}, {"hashlog": -1}])
def test_find_matches_rejects_hashlog(kw):
    """hashlog runs 0-31: at 32 the sentinel hash 1 << 32 no longer fits
    the u32 hash."""
    with pytest.raises(ValueError, match="hashlog"):
        match.find_matches(torch.zeros((1, 64), dtype=torch.uint8),
                           torch.tensor([64], dtype=torch.int32), **kw)


def test_find_matches_rejects_rows_over_64k():
    """Rows over 64 KiB are taken now (test_find_matches_long_rows_equals_jax);
    what is still refused is a batch that is not 2-D."""
    for blocks in (torch.zeros(BLOCK + 1, dtype=torch.uint8),
                   torch.zeros((1, 2, BLOCK + 1), dtype=torch.uint8)):
        with pytest.raises(ValueError, match="blocks"):
            match.find_matches(blocks, torch.tensor([BLOCK], dtype=torch.int32))


@pytest.mark.parametrize("hashlog", [12, 20])
@pytest.mark.parametrize("N", [1 << 17, 1 << 18])
def test_find_matches_long_rows_equals_jax(N, hashlog):
    """Rows of 128 and 256 KiB (the row sort's key then carries the hash
    alone, with the position as its payload): one whole row and one cut
    short, every position equal to tpu7z's."""
    rows = 2 if N == 1 << 17 else 1
    blocks = np.frombuffer(make_corpus(rows * N), np.uint8).reshape(rows, N)
    lengths = np.array([N, N - 5000][:rows], np.int32)
    want = match_jax.find_matches(jnp.asarray(blocks), jnp.asarray(lengths),
                                  hashlog=hashlog)
    got = match.find_matches(torch.from_numpy(blocks.copy()),
                             torch.from_numpy(lengths), hashlog=hashlog)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("hashlog", [0, 12, 16, 20, 31])
def test_sort_order_is_a_stable_argsort_of_the_hash(hashlog):
    """The order the match finder takes from the row sort, at rows of
    64 KiB (hashlog <= 16) and just over, is numpy's stable argsort of h,
    sentinel tail last."""
    N = BLOCK if hashlog <= 16 else BLOCK + 3
    blocks = torch.from_numpy(np.frombuffer(make_corpus(2 * N), np.uint8)
                              .reshape(2, N).copy())
    lengths = torch.tensor([N, 30000], dtype=torch.int32)
    _, h, _ = match.hashes(blocks, lengths, hashlog)
    order = match.sort_order(h, hashlog)
    assert np.array_equal(order.numpy(),
                          np.argsort(h.numpy(), axis=1, kind="stable"))
    assert torch.equal(order[1, -(N - 29997):], torch.arange(29997, N))


SIZES = {"empty": 0, "100000": 100000, "three_blocks_short_tail": 3 * BLOCK + 1234}


@pytest.mark.parametrize("size", SIZES.values(), ids=SIZES.keys())
def test_compress_frame_device_equals_jax_and_decodes(size):
    data = make_corpus(3 * BLOCK + 1234)[:size]
    got = torch_backend.compress_frame_device(data, device="cpu")
    assert got == jax_backend.compress_frame_device(data)
    assert jframe.decompress(got, verify_checksums=True) == data
    assert tframe.decompress(got) == data


def test_compress_frame_device_256k_blocks_equals_jax_and_decodes():
    """A frame of 256 KiB blocks: one whole, one short."""
    data = make_corpus(400000)
    got = torch_backend.compress_frame_device(data, block_size=1 << 18,
                                              device="cpu")
    assert got == jax_backend.compress_frame_device(data, block_size=1 << 18)
    assert len(list(tframe.iter_blocks(got))) == 2
    assert jframe.decompress(got, verify_checksums=True) == data
    assert tframe.decompress(got) == data


@pytest.mark.parametrize("block_size", [1 << 14, 1 << 16, 1 << 17])
def test_shard_compress_lz4_equals_jax_and_decodes(block_size):
    data = make_corpus(100000) if block_size < 1 << 17 else make_corpus(300000)
    got = sharded.shard_compress_lz4(data, block_size=block_size, device="cpu")
    assert got == jax_shard(data, mesh=make_mesh(1), block_size=block_size)
    spans = skippable.parse_container(got)
    assert spans == jskippable.parse_container(got)
    assert len(spans) == -(-len(data) // block_size)
    parts = [tframe.decompress(got[o:o + n]) for o, n in spans]
    assert b"".join(parts) == data == tframe.decompress(got)
    assert jframe.decompress(got) == data


def test_sharded_find_matches_covered_bytes():
    blocks, lengths = torch_backend.pad_blocks(make_corpus(BLOCK + 500), BLOCK)
    sel, mlen, moff, covered = sharded.sharded_find_matches(
        blocks, lengths, device="cpu")
    want = match_jax.find_matches(jnp.asarray(blocks), jnp.asarray(lengths))
    for g, w in zip((sel, mlen, moff), want):
        assert np.array_equal(g, np.asarray(w))
    assert covered == int(np.where(sel, mlen, 0).sum()) > 0


def test_sharded_find_matches_long_rows_and_hashlog_equal_jax():
    blocks, lengths = torch_backend.pad_blocks(make_corpus(200000), 1 << 17)
    got = sharded.sharded_find_matches(blocks, lengths, hashlog=20,
                                       device="cpu")
    want = jax_sharded_find_matches(blocks, lengths, make_mesh(1), hashlog=20)
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, w)
    assert got[3] == want[3] > 0


def test_sharded_entry_points_take_no_positional_options():
    """tpu7z's third and second parameters are a mesh, and the port's a
    process group, with every option after it keyword-only: a positional
    option lands on the group and raises, as it would bind the mesh in
    tpu7z."""
    blocks, lengths = torch_backend.pad_blocks(b"abcd" * 100, 1 << 16)
    with pytest.raises(TypeError):
        sharded.sharded_find_matches(blocks, lengths, 16)
    with pytest.raises(TypeError):
        sharded.shard_compress_lz4(b"abcd" * 100, 1 << 16)


def test_entry_equals_jax_entry():
    jfn, jargs = __graft_entry__.entry()
    fn, args = entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    for g, w in zip(fn(*args), jfn(*jargs)):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("W", [0, 16])
def test_device_frame_without_tier_b_equals_jax(W):
    data = make_corpus(BLOCK + 5000)
    got = sharded.shard_compress_lz4_device(data, W=W, tier_b=False,
                                            device="cpu")
    assert got == jax_device_frame(data, mesh=make_mesh(1), W=W, tier_b=False)
    assert got != sharded.shard_compress_lz4_device(data, W=W, device="cpu")
    assert tframe.decompress(got) == data


def _frame(data=b"a frame with a checksum " * 40):
    return data, torch_backend.compress_frame_device(data, device="cpu")


def test_decoder_rejects_altered_content_checksum():
    data, good = _frame()
    bad = good[:-1] + bytes([good[-1] ^ 1])
    with pytest.raises(tframe.CorruptError, match="content checksum"):
        tframe.decompress(bad)


def test_decoder_rejects_altered_content_size():
    data, good = _frame()
    desc = bytearray(good[4:14])
    desc[2:10] = (len(data) + 1).to_bytes(8, "little")
    hc = (xxh32_fast(bytes(desc)) >> 8) & 0xFF
    bad = good[:4] + bytes(desc) + bytes([hc]) + good[15:]
    with pytest.raises(tframe.CorruptError, match="content size"):
        tframe.decompress(bad)


def test_decoder_rejects_altered_header():
    data, good = _frame()
    bad = good[:6] + bytes([good[6] ^ 1]) + good[7:]
    with pytest.raises(tframe.CorruptError, match="header checksum"):
        tframe.decompress(bad)
