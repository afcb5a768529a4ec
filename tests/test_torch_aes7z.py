"""The port's 7z AES-256 (`tpu7z_torch.containers.sevenzip.aes7z`) against
tpu7z's on the CPU: the S-boxes and key schedule; the tensor decrypt
equal to tpu7z's `_decrypt_blocks` on random blocks and on the FIPS-197
AES-256 vector, and `aes_decrypt` equal to tpu7z's, also in passes of
a few blocks; the native CBC
encrypt (csrc/aes.cpp, built with the host C++ compiler) and its Python
twin equal to tpu7z's `aes_encrypt`; the KDF and the coder props. tpu7z's
encrypt is a Python loop of numpy calls a block (about 5 KB/s), so
encrypted inputs stay under 2 KiB."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu7z.containers.sevenzip import aes7z as ja  # noqa: E402
from tpu7z_torch.containers.sevenzip import aes7z as ta  # noqa: E402

# FIPS-197 appendix C.3: AES-256
FIPS_KEY = bytes(range(32))
FIPS_PT = bytes.fromhex("00112233445566778899aabbccddeeff")
FIPS_CT = bytes.fromhex("8ea2b7ca516745bfeafc49904b496089")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _props(iv: bytes, cycles: int = 19, salt: bytes = b"") -> bytes:
    """tpu7z's writer layout, with a salt where one is given."""
    if not salt:
        return bytes([cycles | 0x40, 0x0F]) + iv
    return bytes([cycles | 0xC0, ((len(salt) - 1) << 4) | 0x0F]) + salt + iv


def _blocks(data: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy()).view(-1, 16)


def test_tables_and_key_schedule_equal_tpu7z():
    ja._init_tables()
    ta._init_tables()
    assert np.array_equal(ta._SBOX, ja._SBOX) and np.array_equal(ta._INV_SBOX, ja._INV_SBOX)
    assert ta._SBOX[0] == 0x63 and ta._INV_SBOX[0x63] == 0
    rng = np.random.default_rng(0)
    for n in (16, 24, 32):
        key = rng.integers(0, 256, n, np.uint8).tobytes()
        (rk, nr), (want, wnr) = ta._expand_key(key), ja._expand_key(key)
        assert nr == wnr and np.array_equal(rk, want)


def test_fips197_vector():
    rk, nr = ta._expand_key(FIPS_KEY)
    got = ta._decrypt_blocks(_blocks(FIPS_CT), rk, nr).numpy().tobytes()
    assert got == FIPS_PT
    jrk, jnr = ja._expand_key(FIPS_KEY)
    assert ja._decrypt_blocks(np.frombuffer(FIPS_CT, np.uint8).reshape(1, 16), jrk,
                              jnr).tobytes() == FIPS_PT
    assert ta._encrypt_block_ref(FIPS_PT, rk, nr) == FIPS_CT
    # CBC with a zero IV is ECB on the first block
    assert ta.encrypt_cbc(FIPS_PT, FIPS_KEY, bytes(16)) == FIPS_CT
    assert ta.decrypt_cbc(_blocks(FIPS_CT), FIPS_KEY, bytes(16)).numpy().tobytes() == FIPS_PT


@pytest.mark.parametrize("nblocks", [1, 2, 7, 64, 1000])
@pytest.mark.parametrize("keylen", [16, 32])
def test_decrypt_blocks_equal_tpu7z(nblocks, keylen):
    rng = np.random.default_rng(nblocks * keylen)
    key = rng.integers(0, 256, keylen, np.uint8).tobytes()
    ct = rng.integers(0, 256, (nblocks, 16), np.uint8)
    rk, nr = ja._expand_key(key)
    want = ja._decrypt_blocks(ct, rk, nr)
    got = ta._decrypt_blocks(torch.from_numpy(ct.copy()), rk, nr)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [0, 15, 16, 17, 100, 4096 + 5])
def test_aes_decrypt_equals_tpu7z(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, n, np.uint8).tobytes()
    props = _props(rng.integers(0, 256, 16, np.uint8).tobytes(), cycles=6,
                   salt=b"\x01\x02\x03\x04")
    want = ja.aes_decrypt(data, props, "pässwörd")
    assert ta.aes_decrypt(data, props, "pässwörd", device="cpu") == want


@pytest.mark.parametrize("chunk", [1, 3, 64])
def test_chunked_decrypt_equals_tpu7z(monkeypatch, chunk):
    """CBC across the passes of CHUNK_BLOCKS blocks: each pass XORs its
    first block with the last ciphertext block of the one before."""
    monkeypatch.setattr(ta, "CHUNK_BLOCKS", chunk)
    rng = np.random.default_rng(chunk)
    data = rng.integers(0, 256, 100 * 16 + 9, np.uint8).tobytes()
    props = _props(rng.integers(0, 256, 16, np.uint8).tobytes(), cycles=3)
    assert ta.aes_decrypt(data, props, "pw", device="cpu") == ja.aes_decrypt(data, props, "pw")


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 100, 1500])
def test_native_encrypt_and_its_twin_equal_tpu7z(n):
    rng = np.random.default_rng(100 + n)
    data = rng.integers(0, 256, n, np.uint8).tobytes()
    props = _props(rng.integers(0, 256, 16, np.uint8).tobytes(), cycles=4)
    want = ja.aes_encrypt(data, props, "pw")
    assert ta.aes_encrypt(data, props, "pw") == want
    assert ta.aes_encrypt_ref(data, props, "pw") == want
    # and back again, by the tensor decrypt
    assert ta.aes_decrypt(want, props, "pw", device="cpu")[:n] == data


def test_native_encrypt_round_trips_64k():
    data = np.random.default_rng(7).integers(0, 256, 1 << 16, np.uint8).tobytes()
    key, iv = bytes(range(1, 33)), bytes(range(16))
    enc = ta.encrypt_cbc(data, key, iv)
    assert ta.decrypt_cbc(_blocks(enc), key, iv).numpy().tobytes() == data
    props = _props(iv, cycles=2)
    head = data[:1 << 14]
    assert ta.aes_encrypt(head, props, "pw") == ta.aes_encrypt_ref(head, props, "pw")
    with pytest.raises(ValueError, match="whole number of blocks"):
        ta.encrypt_cbc(data[:100], key, iv)


@pytest.mark.parametrize("cycles", [0, 1, 5, 12, 19, 0x3F])
@pytest.mark.parametrize("password", ["", "pw", "pässwörd ☃"])
def test_derive_key_equals_tpu7z(cycles, password):
    for salt in (b"", b"\x00\x11\x22\x33salt"):
        assert ta.derive_key(password, salt, cycles) == ja.derive_key(password, salt, cycles)


@pytest.mark.parametrize("props", [
    bytes([19 | 0x40, 0x0F]) + bytes(range(16)),
    bytes([19 | 0xC0, 0x3F]) + b"SALT" + bytes(range(16)),
    bytes([0x3F]),
    bytes([19 | 0x40, 0x03]) + b"abcd",
    bytes([5 | 0x80, 0x20]) + b"xyz",
], ids=["iv16", "salt4_iv16", "raw_key", "iv4", "salt3"])
def test_parse_props_equal_tpu7z(props):
    assert ta.parse_props(props) == ja.parse_props(props)


@pytest.mark.parametrize("props", [b"", bytes([0x40])], ids=["empty", "truncated"])
def test_bad_props_raise_as_tpu7z(props):
    from tpu7z.utils.errors import CorruptError as JCorrupt
    from tpu7z_torch.utils.errors import CorruptError
    with pytest.raises(JCorrupt):
        ja.parse_props(props)
    with pytest.raises(CorruptError):
        ta.parse_props(props)


def test_decrypt_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        ta.aes_decrypt(bytes(32), _props(bytes(16), cycles=1), "pw")
