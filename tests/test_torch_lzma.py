"""LZMA and LZMA2 in the port (tpu7z_torch/models/lzma) against tpu7z's
(tpu7z/models/lzma) on the CPU: the fast parse's matches chunk by chunk
(`_find_matches_window`, and the once-per-input `WindowMatcher` that
`compress_chunks` uses), `compress_chunks`, `compress_raw` with an end
marker, the host library's `lzma2.compress`, `compress_raw` and
`compress_alone`; the decoders (the host library's and the Python twin)
on the port's, tpu7z's and the standard library's streams; and corrupt
and truncated input raising CorruptError. tpu7z's Python range coder
costs about 6 s a MiB here, so its inputs stay at 192 KiB or less."""

import lzma as std

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu7z.models.lzma import encoder as jenc  # noqa: E402
from tpu7z.models.lzma import lzma2 as j2  # noqa: E402
from tpu7z_torch.models.lzma import decoder as tdec  # noqa: E402
from tpu7z_torch.models.lzma import encoder as tenc  # noqa: E402
from tpu7z_torch.models.lzma import lzma2 as t2  # noqa: E402
from tpu7z_torch.utils.corpus import make_corpus  # noqa: E402
from tpu7z_torch.utils.errors import CorruptError  # noqa: E402

TEXT = 696156
RAW2 = [{"id": std.FILTER_LZMA2, "dict_size": 1 << 24}]


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(TEXT + (1 << 20))[TEXT:]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _data(corpus, kind):
    return {"text_64k_10": corpus[:(64 << 10) + 10],
            "mixed_192k": corpus[300000:300000 + (192 << 10)],
            "random": np.random.default_rng(5).integers(0, 256, 30000, np.uint8).tobytes(),
            "zeros": bytes(70000),
            "period3": b"\x01\x02\xfe" * 25000,
            "tiny": corpus[:15],
            "empty": b""}[kind]


@pytest.mark.parametrize("span", [(0, 65536), (65536, 131072), (131072, 196608),
                                  (196598, 196608), (100, 5000), (0, 15), (40, 55)])
def test_matches_of_a_chunk_equal_tpu7z(corpus, span):
    """Each chunk's matches over window[:end] (tpu7z) against the port's,
    alone and from one matcher over the whole input."""
    w = np.frombuffer(_data(corpus, "mixed_192k"), np.uint8)
    a, b = span
    want = jenc._find_matches_window(w, a, b)
    got = tenc._find_matches_window(w, a, b, device="cpu")
    whole = tenc.WindowMatcher(w, device="cpu").matches(a, b)
    for x, y, z in zip(want, got, whole):
        assert np.array_equal(y.numpy(), x) and np.array_equal(z.numpy(), x)


@pytest.mark.parametrize("kind", ["text_64k_10", "mixed_192k", "random", "zeros",
                                  "period3", "tiny", "empty"])
def test_compress_chunks_equals_tpu7z(corpus, kind):
    data = _data(corpus, kind)
    want = j2.compress_chunks(data)
    got = t2.compress_chunks(data, device="cpu")
    assert got == want
    assert t2.decompress(got + b"\x00") == data
    if data:
        assert std.decompress(got + b"\x00", format=std.FORMAT_RAW, filters=RAW2) == data


@pytest.mark.parametrize("props", [(3, 0, 2), (0, 2, 0), (4, 0, 4)])
def test_compress_chunks_with_other_props(corpus, props):
    data = _data(corpus, "text_64k_10")[:30000]
    assert t2.compress_chunks(data, *props, device="cpu") == j2.compress_chunks(data, *props)


@pytest.mark.parametrize("kind", ["text_64k_10", "zeros", "tiny", "empty"])
def test_compress_raw_with_end_marker_equals_tpu7z(corpus, kind):
    data = _data(corpus, kind)
    want = jenc.compress_raw(data, end_marker=True)
    got = tenc.compress_raw(data, end_marker=True, device="cpu")
    assert got == want
    stream, props = got
    alone = props + b"\xff" * 8 + stream
    assert tdec.decompress_alone(alone) == data
    assert std.decompress(alone, format=std.FORMAT_ALONE) == data


@pytest.mark.parametrize("kind", ["text_64k_10", "mixed_192k", "random", "zeros",
                                  "period3", "tiny", "empty"])
def test_native_encoders_equal_tpu7z(corpus, kind):
    data = _data(corpus, kind)
    assert t2.compress(data) == j2.compress(data)
    assert t2.compress(data, level=5) == j2.compress(data, level=5)
    assert t2.compress(data, shard_size=1 << 15) == j2.compress(data, shard_size=1 << 15)
    assert tenc.compress_raw(data) == jenc.compress_raw(data)
    assert tenc.compress_alone(data) == jenc.compress_alone(data)
    for stream in (t2.compress(data), t2.compress(data, shard_size=1 << 15)):
        assert t2.decompress(stream) == data
        assert std.decompress(stream, format=std.FORMAT_RAW, filters=RAW2) == data
    alone = tenc.compress_alone(data)
    assert tdec.decompress_alone(alone) == data
    assert tdec.decompress_alone(alone, native=False) == data
    assert std.decompress(alone, format=std.FORMAT_ALONE) == data


@pytest.mark.parametrize("preset", [0, 6, 9 | std.PRESET_EXTREME])
@pytest.mark.parametrize("kind", ["mixed_192k", "zeros", "random"])
def test_standard_library_streams_decode(corpus, kind, preset):
    data = _data(corpus, kind)
    raw2 = std.compress(data, format=std.FORMAT_RAW,
                        filters=[{"id": std.FILTER_LZMA2, "preset": preset}])
    assert t2.decompress(raw2) == data
    alone = std.compress(data, format=std.FORMAT_ALONE, preset=preset)
    assert tdec.decompress_alone(alone) == data
    raw1 = std.compress(data, format=std.FORMAT_RAW,
                        filters=[{"id": std.FILTER_LZMA1, "preset": preset}])
    props = bytes([3 + 9 * 5 * 2]) + (1 << 20).to_bytes(4, "little")
    assert tdec.decompress_raw(raw1, props, len(data)) == data
    assert tdec.decompress_raw(raw1, props, len(data), native=False) == data


def test_python_decoder_equals_the_library(corpus):
    """The Python engine, the library's twin, on a raw stream of the
    library's optimal parse."""
    data = _data(corpus, "mixed_192k")
    stream, props = tenc.compress_raw(data)
    assert tdec.decompress_raw(stream, props, len(data), native=False) == \
        tdec.decompress_raw(stream, props, len(data)) == data


def _flip(stream: bytes, at: int) -> bytes:
    b = bytearray(stream)
    b[at] ^= 0x5A
    return bytes(b)


@pytest.mark.parametrize("case", ["control", "truncated", "no_end", "props", "range_byte",
                                  "first_chunk", "size"])
def test_corrupt_lzma2_raises(corpus, case):
    data = _data(corpus, "text_64k_10")
    stream = t2.compress(data)
    bad = {"control": b"\x05" + stream[1:],
           "truncated": stream[:len(stream) // 2],
           "no_end": stream[:-1],
           "props": stream[:5] + b"\xff" + stream[6:],
           "range_byte": stream[:6] + b"\x01" + stream[7:],
           "first_chunk": b"\x80" + stream[1:],
           "size": stream}[case]
    with pytest.raises(CorruptError):
        t2.decompress(bad, None if case != "size" else len(data) + 1)


@pytest.mark.parametrize("native", [True, False])
def test_corrupt_lzma_raises(corpus, native):
    data = _data(corpus, "text_64k_10")
    alone = tenc.compress_alone(data)
    for bad in (alone[:12], bytes([230]) + alone[1:], alone[:13] + b"\x01" + alone[14:],
                alone[:40]):
        with pytest.raises(CorruptError):
            tdec.decompress_alone(bad, native=native)
    # a flipped byte deep in the stream: an error, or bytes that differ
    try:
        out = tdec.decompress_alone(_flip(alone, len(alone) // 2), native=native)
    except CorruptError:
        return
    assert out != data
