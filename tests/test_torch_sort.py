"""The port's row sort (tpu7z_torch.ops.sort_cuda) against the JAX
package's bitonic sort and numpy's stable argsort.

On CPU tensors `sort_rows` runs its plain version, `sort_rows_ref`; the
CUDA kernel behind it is held against that plain version on the card by
chip_smoke.py. Its contract is what its two callers pass: int32 keys
(the raw bits of uint32) with no payload or one int32 payload, as
`lz4_cuda.candidates` (no payload, begin_bit 16) and `match.sort_order`
(the position as payload) call it. Keys and payloads are integers, so
the tolerance is exact equality.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tpu7z.ops.sort_pallas import bitonic_sort  # noqa: E402
from tpu7z_torch.ops import sort_cuda  # noqa: E402

ODD = 2654435761


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one intra-op
    thread each keeps PyTorch's thread pools from contending for the
    cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _matcher_keys(B, N, seed=11):
    """tools/probe_bitonic.py's keys: random 16-bit hash << 16 | pos."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 1 << 16, (B, N), dtype=np.uint32)
    return (h << 16) | np.arange(N, dtype=np.uint32)


def _random_unique_keys(B, N, seed=5):
    """Unique 32-bit keys over the whole range: (pos * odd + c) mod 2**32,
    shuffled within each row."""
    rng = np.random.default_rng(seed)
    rows = []
    for b in range(B):
        c = int(rng.integers(0, 1 << 32))
        k = (np.arange(N, dtype=np.uint64) * ODD + c) % (1 << 32)
        rows.append(rng.permutation(k).astype(np.uint32))
    return np.stack(rows)


def _i32(keys_u32):
    """uint32 keys as the int32 tensor of their raw bits."""
    return torch.from_numpy(np.ascontiguousarray(keys_u32).view(np.int32))


def _u32(t):
    """Sorted int32 keys back as numpy uint32."""
    return t.numpy().view(np.uint32)


def test_sort_rows_equals_bitonic_sort_interpret():
    key = _matcher_keys(1, 65536)
    pi = np.random.default_rng(12).integers(-(1 << 31), 1 << 31, key.shape, dtype=np.int32)
    jk, jpi = (np.asarray(x) for x in bitonic_sort(jnp.asarray(key), jnp.asarray(pi),
                                                   interpret=True))
    tk, tpi = sort_cuda.sort_rows(_i32(key), torch.from_numpy(pi))
    assert (tk.dtype, tpi.dtype) == (torch.int32, torch.int32)
    assert np.array_equal(_u32(tk), jk)
    assert np.array_equal(tpi.numpy(), jpi)
    order = np.argsort(key, axis=1, kind="stable")
    assert np.array_equal(jk, np.take_along_axis(key, order, 1))


# no payload, as the LZ4 candidate stage sorts; the position, as
# match.sort_order sorts
PAYLOADS = ["none", "position"]


def _payloads(kind, shape):
    if kind == "none":
        return ()
    return (torch.arange(shape[0] * shape[1], dtype=torch.int32).view(shape),)


def _check_sorted(key_u32, begin_bit, pays, got):
    order = np.argsort(key_u32 >> begin_bit, axis=1, kind="stable")
    assert len(got) == 1 + len(pays)
    assert all(g.dtype == torch.int32 for g in got)
    assert np.array_equal(_u32(got[0]), np.take_along_axis(key_u32, order, 1))
    for g, p in zip(got[1:], pays):
        assert np.array_equal(g.numpy(), np.take_along_axis(p.numpy(), order, 1))


@pytest.mark.parametrize("begin_bit", [0, 8, 16, 24])
@pytest.mark.parametrize("pays", PAYLOADS)
@pytest.mark.parametrize("N", [16384, 65536])
def test_sort_rows_random_unique_keys(N, pays, begin_bit):
    key = _random_unique_keys(2, N)
    ptens = _payloads(pays, key.shape)
    _check_sorted(key, begin_bit, ptens,
                  sort_cuda.sort_rows(_i32(key), *ptens, begin_bit=begin_bit))


def test_sort_rows_begin_bit_16_gives_the_full_order_of_matcher_keys():
    key = _matcher_keys(3, 65536, seed=2)
    full, = sort_cuda.sort_rows(_i32(key))
    fast, = sort_cuda.sort_rows(_i32(key), begin_bit=16)
    want = np.sort(key, axis=1)
    assert np.array_equal(_u32(full), want)
    assert np.array_equal(_u32(fast), want)


@pytest.mark.parametrize("begin_bit", [8, 16, 24])
def test_sort_rows_begin_bit_is_a_stable_sort_of_the_high_bits(begin_bit):
    key = _random_unique_keys(2, 5000, seed=begin_bit)
    pay = np.arange(key.size, dtype=np.int32).reshape(key.shape)
    k, p = sort_cuda.sort_rows(_i32(key), torch.from_numpy(pay), begin_bit=begin_bit)
    order = np.argsort(key >> begin_bit, axis=1, kind="stable")
    assert np.array_equal(_u32(k), np.take_along_axis(key, order, 1))
    assert np.array_equal(p.numpy(), np.take_along_axis(pay, order, 1))


def _numpy_sorted(key_u32, begin_bit, *payloads):
    order = np.argsort(key_u32 >> begin_bit, axis=1, kind="stable")
    return [np.take_along_axis(a, order, 1) for a in (key_u32,) + payloads]


# rows of one tile or less, a last tile of one key short, exact, or one key
# over (tiles of 4096 keys on the card), and several tiles with a short end
@pytest.mark.parametrize("begin_bit", [0, 8, 16, 24])
@pytest.mark.parametrize("N", [1, 4095, 4096, 4097, 65537, 131072])
def test_sort_rows_ragged_rows(N, begin_bit):
    key = _random_unique_keys(3, N, seed=N)
    pay = np.arange(key.size, dtype=np.int32).reshape(key.shape)
    k, p = sort_cuda.sort_rows(_i32(key), torch.from_numpy(pay), begin_bit=begin_bit)
    want_k, want_p = _numpy_sorted(key, begin_bit, pay)
    assert k.dtype == torch.int32 and p.dtype == torch.int32
    assert np.array_equal(_u32(k), want_k)
    assert np.array_equal(p.numpy(), want_p)


@pytest.mark.parametrize("begin_bit", [0, 16])
def test_sort_rows_row_of_one_digit(begin_bit):
    """An all-zero block's tier-B4 keys share one hash: every key of the
    row has the same digit in each pass over bits 16..31."""
    from tpu7z_torch.ops import lz4_plane
    words = lz4_plane.phase0_words(torch.zeros((2, lz4_plane.BLOCK), dtype=torch.uint8))
    key = sort_cuda.raw_bits(lz4_plane.tier_b4_key(words))
    assert bool(((key >> 16) == (key[0, 0] >> 16)).all())
    k, = sort_cuda.sort_rows(key, begin_bit=begin_bit)
    assert k.dtype == torch.int32
    assert np.array_equal(_u32(k), _numpy_sorted(_u32(key), begin_bit)[0])
    assert torch.equal(k, key)   # already in position order


@pytest.mark.parametrize("hashlog", [16, 12])
def test_sort_rows_sentinel_tail(hashlog):
    """The match finder's keys for short rows: h << (31 - hashlog) with the
    position as payload fills each row's tail with the sentinel hash,
    which must stay last and in position order."""
    from tpu7z_torch.ops import match
    rng = np.random.default_rng(hashlog)
    blocks = torch.from_numpy(rng.integers(0, 256, (3, 65536), dtype=np.uint8))
    lengths = torch.tensor([30000, 65536, 4100], dtype=torch.int32)
    _, h, _ = match.hashes(blocks, lengths, hashlog)
    key, begin_bit = match.hash_key(h, hashlog)
    pos = torch.arange(65536, dtype=torch.int32).expand(3, 65536).contiguous()
    k, order = sort_cuda.sort_rows(key, pos, begin_bit=begin_bit)
    want_k, want_p = _numpy_sorted(key.numpy().view(np.uint32), begin_bit, pos.numpy())
    assert np.array_equal(k.numpy().view(np.uint32), want_k)
    assert np.array_equal(order.numpy(), want_p)
    for b, n in enumerate(lengths.tolist()):
        tail = order[b, n - 3:] if n >= 3 else order[b]
        assert torch.equal(tail, torch.arange(max(n - 3, 0), 65536, dtype=torch.int32))


@pytest.mark.parametrize("pays", PAYLOADS)
def test_sort_rows_keys_at_or_above_2_31(pays):
    """Keys >= 2**31 sort after the smaller ones (as int32 they read
    negative; the order is that of the unsigned value)."""
    rng = np.random.default_rng(31)
    key = _random_unique_keys(2, 3000, seed=31)
    key[:, ::2] |= np.uint32(0x80000000)
    key[:, 1::2] &= np.uint32(0x7FFFFFFF)
    key = np.stack([rng.permutation(np.unique(r))[:1000] for r in key])
    ptens = _payloads(pays, key.shape)
    got = sort_cuda.sort_rows(_i32(key), *ptens)
    _check_sorted(key, 0, ptens, got)
    k = _u32(got[0])
    assert (k[:, -1] >= 1 << 31).all() and (k[:, 0] < 1 << 31).all()


# rows of one tile or less, at the tile edges, and over 65536 keys (17
# and 32 tiles on the card)
@pytest.mark.parametrize("begin_bit", [0, 8, 16, 24])
@pytest.mark.parametrize("N", [1, 4095, 4096, 4097, 65537, 1 << 17])
def test_sort_rows_is_stable_on_duplicate_keys(N, begin_bit):
    """Rows of any length, keys drawn from 300 values a row: equal keys keep
    their input order, so the position payload rises within each run of
    equal keys."""
    rng = np.random.default_rng(N + begin_bit)
    vals = rng.integers(0, 1 << 32, (2, 300), dtype=np.uint32)
    key = np.take_along_axis(vals, rng.integers(0, 300, (2, N)), 1)
    pos = np.broadcast_to(np.arange(N, dtype=np.int32), key.shape).copy()
    k, p = sort_cuda.sort_rows(_i32(key), torch.from_numpy(pos), begin_bit=begin_bit)
    want_k, want_p = _numpy_sorted(key, begin_bit, pos)
    assert k.dtype == torch.int32 and p.dtype == torch.int32
    assert np.array_equal(_u32(k), want_k)
    assert np.array_equal(p.numpy(), want_p)
    hi = want_k >> begin_bit
    run = hi[:, 1:] == hi[:, :-1]
    assert run.any() or N == 1
    assert (np.diff(want_p, axis=1)[run] > 0).all()


@pytest.mark.parametrize("pays", PAYLOADS)
@pytest.mark.parametrize("shape", [(0, 16), (3, 0)], ids=["B0", "N0"])
def test_sort_rows_empty(shape, pays):
    key = torch.zeros(shape, dtype=torch.int32)
    ptens = _payloads(pays, shape)
    got = sort_cuda.sort_rows(key, *ptens, begin_bit=16)
    assert len(got) == 1 + len(ptens)
    assert all(g.dtype == torch.int32 and tuple(g.shape) == shape for g in got)


# what each caller passes: the LZ4 candidate stage's 1024 rows of 65536
# keys at begin_bit 16, no payload; deflate's rows through
# match.sort_order, 256 rows of 131069 hashes at hashlog 15 with the
# position payload. `kernels.own_hbm_pct` reads these bytes through the
# span `sort.rows`, so they are pinned.
@pytest.mark.parametrize("shape,npay,begin_bit,want", [
    ((1024, 65536), 0, 16, 1073741824),
    ((256, 131069), 1, 16, 1073717248),
], ids=["lz4_candidates", "deflate_sort_order"])
def test_launch_bytes_of_the_callers(shape, npay, begin_bit, want):
    key = torch.empty(shape, dtype=torch.int32, device="meta")
    assert sort_cuda.launch_bytes(key, (key,) * npay, begin_bit) == want


def _bad_calls():
    k = torch.zeros((2, 16), dtype=torch.int32)
    return {
        "key_3d": ((torch.zeros((1, 2, 16), dtype=torch.int32),), {}, ValueError),
        "key_int16": ((k.to(torch.int16),), {}, TypeError),
        "key_float32": ((k.to(torch.float32),), {}, TypeError),
        "key_1d": ((k[0],), {}, ValueError),
        "key_int64": ((k.to(torch.int64),), {}, TypeError),
        "key_uint32": ((k.view(torch.uint32),), {}, TypeError),
        "payload_int64": ((k, k.to(torch.int64)), {}, TypeError),
        "payload_float32": ((k, k.view(torch.float32)), {}, TypeError),
        "payload_shape": ((k, k[:, :8].contiguous()), {}, ValueError),
        "two_payloads": ((k, k, k), {}, ValueError),
        "four_payloads": ((k, k, k, k, k), {}, ValueError),
        "not_contiguous": ((torch.zeros((16, 2), dtype=torch.int32).t(),), {}, ValueError),
        "begin_bit_4": ((k,), {"begin_bit": 4}, ValueError),
    }


@pytest.mark.parametrize("case", _bad_calls().keys())
def test_sort_rows_raises(case):
    args, kw, exc = _bad_calls()[case]
    with pytest.raises(exc):
        sort_cuda.sort_rows(*args, **kw)
