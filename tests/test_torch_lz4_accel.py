"""LZ4's data-parallel parse in the port (tpu7z_torch/models/lz4/block.py
`compress_block`, `compress_block_continuation`; frame.py
`compress_frame(accel=...)`) against tpu7z's on the CPU: where tpu7z
takes its host library (accel 1, hashlog 16) the port takes its own, and
everywhere else the tensor parse gives tpu7z's numpy parse's bytes.
Inputs are made from seeds: corpus slices past the sparse first 696156
bytes, random bytes, all zeros and a period-3 repeat (zeros and the
repeat cost tpu7z's compares the square of their length, so they stay at
4 KiB)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu7z.models.lz4 import block as jblock  # noqa: E402
from tpu7z.models.lz4 import frame as jframe  # noqa: E402
from tpu7z_torch.models.lz4 import block as tblock  # noqa: E402
from tpu7z_torch.models.lz4 import frame as tframe  # noqa: E402
from tpu7z_torch.utils.corpus import make_corpus  # noqa: E402

TEXT = 696156


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
    if kind == "text":
        return corpus[:70000]
    if kind == "records":
        return corpus[344681:344681 + 70000]   # the corpus's struct chunk
    if kind == "random":
        return np.random.default_rng(4).integers(0, 256, 20000, np.uint8).tobytes()
    if kind == "zeros":
        return bytes(4096)
    return bytes([5, 9, 250]) * 1365


KINDS = ["text", "records", "random", "zeros", "period3"]


@pytest.mark.parametrize("accel,hashlog,use_native", [
    *((1, hashlog, True) for hashlog in range(12, 21)),
    (2, 16, True), (1, 16, False), (3, 18, False)])
@pytest.mark.parametrize("kind", KINDS)
def test_compress_block_equals_tpu7z(corpus, kind, accel, hashlog, use_native):
    data = _data(corpus, kind)
    want = jblock.compress_block(data, accel=accel, hashlog=hashlog, use_native=use_native)
    got = tblock.compress_block(data, accel=accel, hashlog=hashlog, use_native=use_native,
                                device="cpu")
    assert got == want
    assert tblock.decompress_block(got, dst_size=len(data)) == data


@pytest.mark.parametrize("n", list(range(0, 21)) + [499, 500, 501])
def test_compress_block_short_inputs(corpus, n):
    """Empty (one zero token), all-literal below 13 bytes, and the
    first matches just past that."""
    data = (corpus[:n // 2] * 3)[:n]
    for accel in (1, 2):
        want = jblock.compress_block(data, accel=accel)
        assert tblock.compress_block(data, accel=accel, device="cpu") == want


@pytest.mark.parametrize("hashlog", [12, 16])
@pytest.mark.parametrize("kind", KINDS)
def test_continuation_equals_tpu7z(corpus, kind, hashlog):
    """A linked block behind up to 64 KiB of window: the host library at
    hashlog 16, the tensor parse from the window's end at 12."""
    data = _data(corpus, kind)
    cut = len(data) // 3
    window, chunk = data[max(cut - 65536, 0):cut], data[cut:]
    want = jblock.compress_block_continuation(chunk, window, hashlog=hashlog)
    got = tblock.compress_block_continuation(chunk, window, hashlog=hashlog, device="cpu")
    assert got == want
    assert tblock.decompress_block(got, dst_size=len(chunk), window=window) == chunk
    for n in (0, 5, 12, 13):
        assert tblock.compress_block_continuation(
            chunk[:n], window, hashlog=12, device="cpu") == \
            jblock.compress_block_continuation(chunk[:n], window, hashlog=12)


@pytest.mark.parametrize("options", [
    {}, {"block_size": 1 << 16}, {"block_size": 1 << 16, "block_independence": False},
    {"block_size": 1 << 16, "block_checksum": True, "content_size": False}],
    ids=["one_block", "independent", "linked", "block_checksum"])
def test_compress_frame_accel2_equals_tpu7z(corpus, options):
    data = corpus[:200000]
    want = jframe.compress_frame(data, accel=2, **options)
    got = tframe.compress_frame(data, accel=2, device="cpu", **options)
    assert got == want
    assert got != tframe.compress_frame(data, **options)
    assert tframe.decompress(got) == data


def test_compress_frame_of_nothing(corpus):
    assert tframe.compress_frame(b"", accel=2, device="cpu") == \
        jframe.compress_frame(b"", accel=2)
