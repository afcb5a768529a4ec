"""The port's hashers (tpu7z_torch/ops/hashers.py) against tpu7z's on the
CPU: every entry of HASHERS but MD2 and BLAKE3 gives tpu7z's string at
every length from 0 to 2100, at 4095-4097, 65535-65537 and 1 MiB + 7
(MD2 and BLAKE3, the slow ones: test_torch_hashers_md2.py and
test_torch_hashers_blake3*.py); XXH3 from csrc/xxh3.cpp matches the
public digests of the empty input, independent of any package; BLAKE3's
tensor code on CPU tensors equals its plain version, a copy of tpu7z's,
at every block, chunk and tree edge and for long outputs; a name the
host's hashlib lacks raises; and no module of the port imports xxhash.
Inputs are seeded random bytes; every comparison is exact."""

import hashlib
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu7z.ops import hashers as jh  # noqa: E402
from tpu7z_torch.ops import hashers as th  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# the lengths each hasher is held at, in cases of about equal cost
RANGES = {"0-699": range(0, 700), "700-1399": range(700, 1400), "1400-2100": range(1400, 2101),
          "4095-4097": range(4095, 4098), "65535-65537": range(65535, 65538),
          "1MiB+7": [(1 << 20) + 7]}
SLOW = ("MD2", "BLAKE3")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def data() -> bytes:
    return np.random.default_rng(15).integers(0, 256, (1 << 20) + 7, np.uint8).tobytes()


def check_lengths(name: str, lengths, buf: bytes):
    """HASHERS[name] of `buf`'s prefix of each length, both sides."""
    for n in lengths:
        assert th.HASHERS[name](buf[:n], device="cpu") == jh.HASHERS[name](buf[:n]), (name, n)


@pytest.fixture(scope="module")
def buf():
    return data()


def test_the_table_is_tpu7z_s():
    assert sorted(th.HASHERS) == sorted(jh.HASHERS)
    assert len(th.HASHERS) == 21


@pytest.mark.parametrize("span", sorted(RANGES))
@pytest.mark.parametrize("name", sorted(n for n in jh.HASHERS if n not in SLOW))
def test_hasher_equals_tpu7z(buf, name, span):
    check_lengths(name, RANGES[span], buf)


def test_xxh3_known_digests():
    """The public XXH3 digests of the empty input (seed 0, default
    secret), and 7-Zip's little-endian presentation of XXH3-64."""
    assert th.xxh3_64(b"") == 0x2D06800538D394C2
    assert th.xxh3_128(b"") == 0x99AA06D3014798D86001C324468D497F
    assert th.HASHERS["XXH3-64"](b"") == "c294d3380580062d"
    assert th.HASHERS["XXH3-128"](b"") == "99aa06d3014798d86001c324468d497f"


@pytest.mark.parametrize("n", [1, 3, 4, 8, 9, 16, 17, 128, 129, 240, 241, 1024, 1025, 100000])
def test_xxh3_takes_any_buffer(buf, n):
    """bytes, bytearray, memoryview and a uint8 array give one digest."""
    want = jh.xxh3_64(buf[:n]), jh.xxh3_128(buf[:n])
    for form in (bytearray(buf[:n]), memoryview(buf)[:n], np.frombuffer(buf[:n], np.uint8)):
        assert (th.xxh3_64(form), th.xxh3_128(form)) == want


EDGES = [0, 1, 63, 64, 65, 127, 128, 1023, 1024, 1025, 1087, 2047, 2048, 2049, 3072, 3073,
         4095, 4096, 4097, 5121, 7 * 1024 + 1, 65535, 65536, 65537]


@pytest.mark.parametrize("out_len", [1, 32, 64, 65, 200])
@pytest.mark.parametrize("n", EDGES)
def test_blake3_tensor_code_equals_plain(buf, n, out_len):
    """Short last blocks and chunks, one chunk or many (odd counts carried
    up a level), and the extendable root output's counter."""
    want = th.blake3_ref(buf[:n], out_len)
    assert th.blake3(buf[:n], out_len, device="cpu") == want
    if out_len == 65:
        assert want == jh.blake3(buf[:n], out_len)


def test_blake3_public_vector():
    """BLAKE3 of the empty input, from the specification's test vectors."""
    want = "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262"
    assert th.blake3(b"", device="cpu").hex() == th.blake3_ref(b"").hex() == want


def test_blake3_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        th.blake3(b"abc")
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        th.HASHERS["BLAKE3"](b"abc")


def test_a_name_hashlib_lacks_raises(monkeypatch):
    """SHA-3 missing from the host's hashlib: its entry stays in the
    table and raises when it is called, as tpu7z's does."""
    real = hashlib.new

    def new(name, *args):
        if name.startswith("sha3"):
            raise ValueError(f"unsupported hash type {name}")
        return real(name, *args)

    monkeypatch.setattr(hashlib, "new", new)
    assert "SHA3-256" in th.HASHERS
    with pytest.raises(ValueError, match="unsupported hash type sha3_256"):
        th.HASHERS["SHA3-256"](b"abc")
    assert th.HASHERS["SHA256"](b"abc") == jh.HASHERS["SHA256"](b"abc")


def test_a_failed_build_raises(monkeypatch):
    """XXH3 has no Python fallback: a library that does not build raises."""
    from tpu7z_torch.ops import _build

    def broken(name):
        raise RuntimeError(f"native build failed: {name}")

    monkeypatch.setattr(th, "_xxh3", {})
    monkeypatch.setattr(_build, "load", broken)
    with pytest.raises(RuntimeError, match="native build failed: xxh3"):
        th.xxh3_64(b"abc")


def test_no_port_module_imports_xxhash():
    pattern = re.compile(r"^\s*(import\s+xxhash|from\s+xxhash\s+import)", re.M)
    found = [str(p.relative_to(REPO)) for p in (REPO / "tpu7z_torch").rglob("*.py")
             if pattern.search(p.read_text())]
    assert found == []
