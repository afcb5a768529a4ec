""".Z (LZW) and lzip in the port (tpu7z_torch/models/z_lzw.py,
containers/lzip.py) against tpu7z's on the CPU: `.Z` at maxbits 9-16 on
inputs made from seeds (empty, one byte, random bytes that fill and clear
the table, zeros, the corpus's text), lzip members alone and
concatenated (its LZMA parse on the CPU here, the card by default); each
decoder reads the other's streams, and corrupt inputs raise tpu7z's
errors (class and message) or give its bytes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu7z.containers import lzip as jlzip  # noqa: E402
from tpu7z.models import z_lzw as jz  # noqa: E402
from tpu7z_torch.containers import lzip as tlzip  # noqa: E402
from tpu7z_torch.models import z_lzw as tz  # noqa: E402
from tpu7z_torch.utils.corpus import make_corpus  # noqa: E402

TEXT = 696156            # the corpus's first byte past its sparse chunk
KINDS = ["empty", "one", "random", "zeros", "text"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def text():
    return make_corpus(TEXT + 120000)[TEXT:]


def _input(text, kind) -> bytes:
    rng = np.random.default_rng(len(kind))
    return {
        "empty": b"",
        "one": b"q",
        "random": rng.integers(0, 256, 40000, np.uint8).tobytes(),
        "zeros": bytes(70000),
        "text": text,
    }[kind]


def _outcome(fn, data):
    try:
        return fn(data)
    except Exception as e:  # noqa: BLE001 - the decoders must agree on any error
        if type(e).__name__ in ("CorruptError", "UnsupportedError", "ParamError"):
            return (type(e).__name__, str(e))
        return type(e).__name__


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("maxbits", range(9, 17))
def test_z_equals_tpu7z(text, maxbits, kind):
    data = _input(text, kind)
    want = jz.compress(data, maxbits)
    assert tz.compress(data, maxbits) == want
    assert tz.decompress(want) == data
    assert jz.decompress(tz.compress(data, maxbits)) == data


def test_z_errors_as_tpu7z(text):
    for bits in (8, 17):
        assert _outcome(lambda d: tz.compress(d, bits), b"abc") == \
            _outcome(lambda d: jz.compress(d, bits), b"abc") == ("CorruptError", "z: bad maxbits")
    stream = jz.compress(text[:20000], 12)
    cases = [b"", b"\x1f", b"\x1f\x9e\x90", b"\x1f\x9d\xf0", b"\x1f\x9d\x88", b"\x1f\x9d\x91",
             b"\x1f\x9d\x10" + stream[3:]]          # without the block-mode flag
    rng = np.random.default_rng(7)
    cases += [stream[:cut] for cut in rng.integers(3, len(stream), 20)]
    for pos in rng.integers(3, len(stream), 40):
        bad = bytearray(stream)
        bad[pos] ^= 1 << int(rng.integers(0, 8))
        cases.append(bytes(bad))
    for case in cases:
        assert _outcome(tz.decompress, case) == _outcome(jz.decompress, case)


@pytest.mark.parametrize("kind", KINDS)
def test_lzip_equals_tpu7z(text, kind):
    data = _input(text, kind)[:60000]
    want = jlzip.compress(data)
    got = tlzip.compress(data, device="cpu")
    assert got == want
    assert tlzip.decompress(want) == data
    assert jlzip.decompress(got) == data


def test_lzip_members_concatenated(text):
    parts = [text[:30000], b"", b"x", text[30000:50000]]
    stream = b"".join(tlzip.compress(p, device="cpu") for p in parts)
    assert stream == b"".join(jlzip.compress(p) for p in parts)
    assert tlzip.decompress(stream) == jlzip.decompress(stream) == b"".join(parts)


def test_lzip_errors_as_tpu7z(text):
    member = jlzip.compress(text[:8000])
    footer = len(member) - 20
    cases = [b"", b"LZIP", b"LZIQ\x01\x10", b"LZIP\x02\x10", b"LZIP\x01\x0b", b"LZIP\x01\x1e",
             member[:footer + 10]]
    for at in (footer, footer + 4, footer + 12):      # CRC, data size, member size
        bad = bytearray(member)
        bad[at] ^= 1
        cases.append(bytes(bad))
    rng = np.random.default_rng(9)
    for pos in rng.integers(6, footer, 20):
        bad = bytearray(member)
        bad[pos] ^= 1 << int(rng.integers(0, 8))
        cases.append(bytes(bad))
    cases.append(member + b"garbage")
    for case in cases:
        assert _outcome(tlzip.decompress, case) == _outcome(jlzip.decompress, case)
    assert _outcome(tlzip.decompress, cases[7]) == ("CorruptError", "lzip: CRC mismatch")


def test_lzip_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="none is available"):
        tlzip.compress(b"abc" * 100)
