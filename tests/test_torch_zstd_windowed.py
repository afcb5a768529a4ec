"""`find_sequences_windowed`, the zstd tensor encoder's whole-input parse
(tpu7z_torch/models/zstd/compressor.py), against tpu7z's numpy parse on
the CPU: the same (mpos, mlen, moff) arrays at every level's parameters
on each chunk kind of the corpus, on an all-zero block and random bytes,
and across segment joins. Inputs are small (96 KiB, 48 KiB at levels 17
and 19; 256 KiB for the join), since tpu7z's side runs its numpy parse
too."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_zstd_parse import (  # noqa: E402,F401
    LEVELS, _chunk, _one_torch_thread, _parse_equal, corpus)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", ["sparse", "text", "struct", "random", "log"])
def test_windowed_parse_equals_tpu7z_per_chunk_kind(corpus, kind, level):
    size = (96 << 10) if level < 17 else (48 << 10)
    _parse_equal(_chunk(corpus, kind, size), level)


@pytest.mark.parametrize("level", LEVELS)
def test_windowed_parse_of_zeros_and_random_bytes(level):
    """All zeros: every candidate runs to the end of its segment, the
    rolling-hash search's long-match case; random bytes: few matches."""
    mpos, mlen, _ = _parse_equal(np.zeros(64 << 10, np.uint8), level)
    assert mpos.size and int(mlen.max()) > 30000
    _parse_equal(np.random.default_rng(level + 50).integers(0, 256, 64 << 10, np.uint8),
                 level)


@pytest.mark.parametrize("level", [1, 5, 12])
def test_history_crosses_segments(corpus, level):
    """seg_size 64 KiB over 256 KiB: every segment but the first is parsed
    behind the window before it, and matches reach back across the join."""
    s = np.concatenate([_chunk(corpus, "text", 96 << 10), _chunk(corpus, "log", 64 << 10),
                        _chunk(corpus, "text", 96 << 10)])
    mpos, _, moff = _parse_equal(s, level, seg_size=64 << 10)
    second = mpos >= (64 << 10)
    assert np.any((mpos - moff < (64 << 10)) & second)


