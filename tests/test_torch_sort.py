"""The port's row sort (tpu7z_torch.ops.sort_cuda) against the JAX
package's bitonic sort and numpy's stable argsort.

On CPU tensors `sort_rows` runs its plain version, `sort_rows_ref`; the
CUDA kernel behind it is held against that plain version on the card by
chip_smoke.py. Keys and payloads are integers or raw bits, so the
tolerance is exact equality.
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


def _as(keys_u32, dtype):
    t = torch.from_numpy(keys_u32)
    if dtype == torch.int64:
        return t.to(torch.int64)
    return t.view(dtype)


def _u32(t):
    """Sorted keys back as numpy uint32, whatever their carrier dtype."""
    if t.dtype == torch.int64:
        return t.numpy().astype(np.uint32)
    return t.view(torch.int32).numpy().view(np.uint32)


def test_sort_rows_equals_bitonic_sort_interpret():
    key = _matcher_keys(1, 65536)
    rng = np.random.default_rng(12)
    pu = rng.integers(0, 1 << 32, key.shape, dtype=np.uint32)
    pi = rng.integers(-(1 << 31), 1 << 31, key.shape, dtype=np.int32)
    jk, jpu, jpi = (np.asarray(x) for x in bitonic_sort(
        jnp.asarray(key), jnp.asarray(pu), jnp.asarray(pi), interpret=True))
    tk, tpu, tpi = sort_cuda.sort_rows(torch.from_numpy(key),
                                       torch.from_numpy(pu),
                                       torch.from_numpy(pi))
    assert (tk.dtype, tpu.dtype, tpi.dtype) == (torch.uint32, torch.uint32,
                                                torch.int32)
    assert np.array_equal(_u32(tk), jk)
    assert np.array_equal(_u32(tpu), jpu)
    assert np.array_equal(tpi.numpy(), jpi)
    order = np.argsort(key, axis=1, kind="stable")
    assert np.array_equal(jk, np.take_along_axis(key, order, 1))


PAYLOAD_SETS = {"none": (), "one_int32": (torch.int32,),
                "three": (torch.int32, torch.uint32, torch.float32)}


@pytest.mark.parametrize("pays", PAYLOAD_SETS.values(), ids=PAYLOAD_SETS.keys())
@pytest.mark.parametrize("key_dtype", [torch.int32, torch.uint32, torch.int64],
                         ids=["int32", "uint32", "int64"])
@pytest.mark.parametrize("N", [16384, 65536])
def test_sort_rows_random_unique_keys(N, key_dtype, pays):
    key = _random_unique_keys(2, N)
    rng = np.random.default_rng(N)
    raw = [rng.integers(0, 1 << 32, key.shape, dtype=np.uint32) for _ in pays]
    ptens = [torch.from_numpy(r).view(dt) for r, dt in zip(raw, pays)]
    got = sort_cuda.sort_rows(_as(key, key_dtype), *ptens)
    order = np.argsort(key, axis=1, kind="stable")
    assert got[0].dtype == key_dtype
    assert np.array_equal(_u32(got[0]), np.take_along_axis(key, order, 1))
    for g, r, dt in zip(got[1:], raw, pays):
        assert g.dtype == dt
        assert np.array_equal(g.view(torch.int32).numpy().view(np.uint32),
                              np.take_along_axis(r, order, 1))


def test_sort_rows_begin_bit_16_gives_the_full_order_of_matcher_keys():
    key = _matcher_keys(3, 65536, seed=2)
    full, = sort_cuda.sort_rows(torch.from_numpy(key))
    fast, = sort_cuda.sort_rows(torch.from_numpy(key), begin_bit=16)
    want = np.sort(key, axis=1)
    assert np.array_equal(_u32(full), want)
    assert np.array_equal(_u32(fast), want)


@pytest.mark.parametrize("begin_bit", [8, 16, 24])
def test_sort_rows_begin_bit_is_a_stable_sort_of_the_high_bits(begin_bit):
    key = _random_unique_keys(2, 5000, seed=begin_bit)
    pay = np.arange(key.size, dtype=np.int32).reshape(key.shape)
    k, p = sort_cuda.sort_rows(torch.from_numpy(key), torch.from_numpy(pay),
                               begin_bit=begin_bit)
    order = np.argsort(key >> begin_bit, axis=1, kind="stable")
    assert np.array_equal(_u32(k), np.take_along_axis(key, order, 1))
    assert np.array_equal(p.numpy(), np.take_along_axis(pay, order, 1))


def _numpy_sorted(key_u32, begin_bit, *payloads):
    order = np.argsort(key_u32 >> begin_bit, axis=1, kind="stable")
    return [np.take_along_axis(a, order, 1) for a in (key_u32,) + payloads]


# rows of one tile or less, a last tile of one key short, exact, or one key
# over (tiles of 4096 keys on the card), and several tiles with a short end
@pytest.mark.parametrize("begin_bit", [0, 16])
@pytest.mark.parametrize("N", [1, 4095, 4096, 4097, 12345])
def test_sort_rows_ragged_rows(N, begin_bit):
    key = _random_unique_keys(3, N, seed=N)
    pay = np.arange(key.size, dtype=np.int32).reshape(key.shape)
    k, p = sort_cuda.sort_rows(_as(key, torch.int32), torch.from_numpy(pay),
                               begin_bit=begin_bit)
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
    key = lz4_plane.tier_b4_key(words)
    assert key.dtype == torch.int64
    assert bool(((key >> 16) == (key[0, 0] >> 16)).all())
    k, = sort_cuda.sort_rows(key, begin_bit=begin_bit)
    assert k.dtype == torch.int64
    assert np.array_equal(k.numpy(), _numpy_sorted(key.numpy(), begin_bit)[0])
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


@pytest.mark.parametrize("key_dtype", [torch.int32, torch.uint32, torch.int64],
                         ids=["int32", "uint32", "int64"])
def test_sort_rows_keys_at_or_above_2_31(key_dtype):
    """Keys >= 2**31 sort after the smaller ones (as int32 they read
    negative; the order is that of the unsigned value)."""
    rng = np.random.default_rng(31)
    key = _random_unique_keys(2, 3000, seed=31)
    key[:, ::2] |= np.uint32(0x80000000)
    key[:, 1::2] &= np.uint32(0x7FFFFFFF)
    key = np.stack([rng.permutation(np.unique(r))[:1000] for r in key])
    k, = sort_cuda.sort_rows(_as(key, key_dtype))
    got = _u32(k)
    assert np.array_equal(got, np.sort(key, axis=1))
    assert (got[:, -1] >= 1 << 31).all() and (got[:, 0] < 1 << 31).all()


@pytest.mark.parametrize("begin_bit", [0, 16])
def test_sort_rows_int64_and_int32_carriers_agree(begin_bit):
    key = _matcher_keys(2, 20000, seed=9) ^ np.uint32(0x80000000)
    pay = np.random.default_rng(9).integers(0, 1 << 32, key.shape, dtype=np.uint32)
    got = {dt: sort_cuda.sort_rows(_as(key, dt), torch.from_numpy(pay).view(torch.float32),
                                   begin_bit=begin_bit)
           for dt in (torch.int32, torch.uint32, torch.int64)}
    bits = {dt: (_u32(k), p.view(torch.int32).numpy().view(np.uint32))
            for dt, (k, p) in got.items()}
    want = _numpy_sorted(key, begin_bit, pay)
    for dt, (k, p) in bits.items():
        assert np.array_equal(k, want[0]) and np.array_equal(p, want[1]), dt
    k64 = got[torch.int64][0]
    assert k64.dtype == torch.int64 and bool((k64 >= 0).all() and (k64 < 1 << 32).all())


@pytest.mark.parametrize("begin_bit", [0, 8, 16, 24])
@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("N", [5000, 65537, 1 << 17])
def test_sort_rows_is_stable_on_duplicate_keys(N, key_dtype, begin_bit):
    """Rows of any length, keys drawn from 300 values a row: equal keys keep
    their input order, so the position payload rises within each run of
    equal keys (on the card, rows over 65536 keys span 17 and 32 tiles)."""
    rng = np.random.default_rng(N + begin_bit)
    vals = rng.integers(0, 1 << 32, (2, 300), dtype=np.uint32)
    key = np.take_along_axis(vals, rng.integers(0, 300, (2, N)), 1)
    pos = np.broadcast_to(np.arange(N, dtype=np.int32), key.shape).copy()
    k, p = sort_cuda.sort_rows(_as(key, key_dtype), torch.from_numpy(pos),
                               begin_bit=begin_bit)
    want_k, want_p = _numpy_sorted(key, begin_bit, pos)
    assert k.dtype == key_dtype and p.dtype == torch.int32
    assert np.array_equal(_u32(k), want_k)
    assert np.array_equal(p.numpy(), want_p)
    hi = want_k >> begin_bit
    run = hi[:, 1:] == hi[:, :-1]
    assert run.any() and (np.diff(want_p, axis=1)[run] > 0).all()


@pytest.mark.parametrize("key_dtype", [torch.int32, torch.uint32, torch.int64],
                         ids=["int32", "uint32", "int64"])
@pytest.mark.parametrize("shape", [(0, 16), (3, 0)], ids=["B0", "N0"])
def test_sort_rows_empty(shape, key_dtype):
    key = torch.zeros(shape, dtype=key_dtype)
    pay = torch.zeros(shape, dtype=torch.float32)
    k, p = sort_cuda.sort_rows(key, pay, begin_bit=16)
    assert (k.dtype, p.dtype) == (key_dtype, torch.float32)
    assert tuple(k.shape) == shape and tuple(p.shape) == shape


def _bad_calls():
    k = torch.zeros((2, 16), dtype=torch.int32)
    return {
        "key_3d": ((torch.zeros((1, 2, 16), dtype=torch.int32),), {}, ValueError),
        "key_int16": ((k.to(torch.int16),), {}, TypeError),
        "key_float32": ((k.to(torch.float32),), {}, TypeError),
        "key_1d": ((k[0],), {}, ValueError),
        "payload_int64": ((k, k.to(torch.int64)), {}, TypeError),
        "payload_shape": ((k, k[:, :8].contiguous()), {}, ValueError),
        "four_payloads": ((k, k, k, k, k), {}, ValueError),
        "not_contiguous": ((torch.zeros((16, 2), dtype=torch.int32).t(),), {}, ValueError),
        "begin_bit_4": ((k,), {"begin_bit": 4}, ValueError),
    }


@pytest.mark.parametrize("case", _bad_calls().keys())
def test_sort_rows_raises(case):
    args, kw, exc = _bad_calls()[case]
    with pytest.raises(exc):
        sort_cuda.sort_rows(*args, **kw)
