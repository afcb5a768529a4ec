"""The zstd tensor encoder, `compressor.compress` (tpu7z_torch/models/zstd),
against tpu7z's numpy encoder on the CPU: the same frame bytes at every
level's parameters and at window logs 10 and 24, `frame.compress`'s
dispatch to it, the same ParamError refusals, and every frame decoded by
both packages. Inputs are at most 128 KiB (64 KiB at levels 17 and 19),
since tpu7z's side runs its numpy encoder too."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu7z.models.zstd import compressor as jcomp  # noqa: E402
from tpu7z.models.zstd import frame as jframe  # noqa: E402
from tpu7z.utils.errors import ParamError as JParamError  # noqa: E402
from tests.test_torch_zstd_parse import (  # noqa: E402,F401
    CHUNKS, LEVELS, _chunk, _one_torch_thread, corpus)
from tpu7z_torch.models.zstd import compressor as tcomp  # noqa: E402
from tpu7z_torch.models.zstd import frame as tframe  # noqa: E402
from tpu7z_torch.utils import trace  # noqa: E402
from tpu7z_torch.utils.errors import ParamError  # noqa: E402


def _mixed(corpus, size):
    """Equal shares of each chunk kind, back to back."""
    part = size // len(CHUNKS)
    return np.concatenate([_chunk(corpus, k, part) for k in CHUNKS]).tobytes()


def _same(data, **kw):
    want = jcomp.compress(data, **kw)
    got = tcomp.compress(data, device="cpu", **kw)
    assert got == want
    assert tframe.decompress(got) == data
    assert tframe.decompress(got, use_native=False) == data
    assert jframe.decompress(got) == data
    return got


@pytest.mark.parametrize("level", LEVELS)
def test_frame_bytes_equal_tpu7z_at_every_level(corpus, level):
    _same(_mixed(corpus, (128 << 10) if level < 17 else (64 << 10)), level=level)


@pytest.mark.parametrize("window_log", [10, 24])
@pytest.mark.parametrize("level", [3, 9])
def test_frame_bytes_equal_tpu7z_at_window_logs(corpus, level, window_log):
    _same(_mixed(corpus, 96 << 10), level=level, window_log=window_log)


@pytest.mark.parametrize("data", [b"", b"a", b"abc" * 5, bytes(200), bytes(range(256)) * 3],
                         ids=["empty", "one", "fifteen", "zeros200", "ramp768"])
def test_small_inputs(data):
    _same(data, level=3)


def test_rle_raw_and_small_blocks(corpus):
    """Several blocks: an RLE block (all zeros), a raw one (random bytes)
    and compressed ones; with and without the checksum."""
    data = (bytes(40000) + np.random.default_rng(2).integers(0, 256, 40000, np.uint8).tobytes()
            + _chunk(corpus, "text", 50000).tobytes())
    _same(data, level=5, block_size=1 << 14)
    _same(data, level=1, checksum=False)


@pytest.mark.parametrize("kw", [{"level": -8}, {"level": 23}, {"window_log": 9},
                                {"window_log": 32}])
def test_refusals_are_tpu7z_refusals(kw):
    with pytest.raises(JParamError):
        jcomp.compress(b"some bytes to compress", **kw)
    with pytest.raises(ParamError):
        tcomp.compress(b"some bytes to compress", device="cpu", **kw)


def test_frame_compress_dispatches_as_tpu7z(corpus):
    """A keyword (window_log, device) or use_native=False runs the tensor
    encoder; no keyword runs the host encoder."""
    data = _mixed(corpus, 64 << 10)
    tensor = tcomp.compress(data, level=5, window_log=17, device="cpu")
    assert tframe.compress(data, level=5, window_log=17, device="cpu") == tensor
    assert jframe.compress(data, level=5, window_log=17) == tensor
    assert tframe.compress(data, level=5, use_native=False, device="cpu") == \
        jframe.compress(data, level=5, use_native=False)
    assert tframe.compress(data, level=5) == jframe.compress(data, level=5)


def test_stages_are_traced(corpus):
    data = _mixed(corpus, 32 << 10)
    trace.attach(keep_records=True)
    try:
        trace.clear()
        tframe.compress(data, level=5, window_log=16, device="cpu")
        names = [r["name"] for r in trace.records()]
    finally:
        trace.detach()
        trace.clear()
    for stage in ("zstd.sort", "zstd.match_lengths", "zstd.walk", "zstd.entropy",
                  "zstd.compress"):
        assert stage in names
