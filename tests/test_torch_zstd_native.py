"""The port's host zstd tier against tpu7z's: `frame.compress` through the
library built from csrc/zstd_enc.cpp, the zstdmt job model
(parallel/zstd_jobs.py) at 1, 2 and 4 workers with jobs small enough to
make several, `xxh64`, and the constant tables the codec carries (the
predefined distributions, code tables and the level table), each equal
to tpu7z's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu7z import native as jnative  # noqa: E402
from tpu7z.models.zstd import compressor as jcomp  # noqa: E402
from tpu7z.models.zstd import frame as jframe  # noqa: E402
from tpu7z.models.zstd import huffman as jhuf  # noqa: E402
from tpu7z.models.zstd import sequences as jseq  # noqa: E402
from tpu7z.ops.hashing import xxh64 as jxxh64  # noqa: E402
from tpu7z.parallel import zstd_jobs as jjobs  # noqa: E402
from tests.test_torch_zstd_parse import CHUNKS, _chunk, corpus  # noqa: E402,F401
from tpu7z_torch.models.zstd import compressor as tcomp  # noqa: E402
from tpu7z_torch.models.zstd import frame as tframe  # noqa: E402
from tpu7z_torch.models.zstd import huffman as thuf  # noqa: E402
from tpu7z_torch.models.zstd import native as tnative  # noqa: E402
from tpu7z_torch.models.zstd import sequences as tseq  # noqa: E402
from tpu7z_torch.ops.hashing import xxh64, xxh64_native  # noqa: E402
from tpu7z_torch.parallel import progress, zstd_jobs  # noqa: E402


@pytest.fixture(scope="module")
def mixed(corpus):
    """1.5 MiB: each chunk kind of the corpus, 300 KiB of each."""
    return np.concatenate([_chunk(corpus, k, 300 << 10) for k in CHUNKS]).tobytes()


@pytest.mark.parametrize("level", [1, 3, 9, 19])
def test_host_encoder_bytes_equal_tpu7z(mixed, level):
    got = tframe.compress(mixed, level=level)
    assert got == jframe.compress(mixed, level=level)
    assert got == tnative.zstd_encode(mixed, level=level)
    assert tframe.decompress(got) == mixed


@pytest.mark.parametrize("data", [b"", b"x", bytes(1000), b"abcd" * 40000])
@pytest.mark.parametrize("checksum", [True, False])
def test_host_encoder_small_and_checksumless(data, checksum):
    got = tnative.zstd_encode(data, level=3, checksum=checksum)
    assert got == jnative.zstd_encode(data, level=3, checksum=checksum)
    assert tframe.decompress(got) == data


@pytest.mark.parametrize("workers", [1, 2, 4])
@pytest.mark.parametrize("level", [1, 5])
def test_job_model_equals_tpu7z_at_every_worker_count(mixed, workers, level):
    kw = dict(level=level, job_size=256 << 10, overlap=128 << 10)
    got = zstd_jobs.compress_sharded(mixed, workers=workers, **kw)
    assert len(zstd_jobs._job_layout(len(mixed), kw["job_size"], kw["overlap"])) == 6
    assert got == jjobs.compress_sharded(mixed, workers=workers, **kw)
    assert got == zstd_jobs.compress_sharded(mixed, workers=1, **kw)
    assert tframe.decompress(got) == mixed
    assert jframe.decompress(got) == mixed


def test_threads_run_the_job_model(mixed):
    data = mixed + mixed      # 3 MiB: two jobs of the default 2 MiB
    got = tframe.compress(data, level=3, threads=4)
    assert got == zstd_jobs.compress_sharded(data, level=3, workers=4)
    assert got == zstd_jobs.compress_sharded(data, level=3, workers=1)
    assert got == jframe.compress(data, level=3, threads=4)
    assert got != tframe.compress(data, level=3)
    assert tframe.decompress(got) == data


def test_job_model_progress_and_one_job(mixed):
    prog = progress.Progress()
    out = zstd_jobs.compress_sharded(mixed, level=3, job_size=512 << 10, progress=prog)
    assert prog.in_total == len(mixed) and 0 < prog.out_total < len(out)
    small = mixed[:1000]
    assert zstd_jobs.compress_sharded(small, level=3) == tnative.zstd_encode(small, level=3)


def test_job_failure_raises(monkeypatch, mixed):
    def fail(*a, **k):
        raise RuntimeError("tz_zstd_encode_job failed (-1)")
    monkeypatch.setattr(tnative, "zstd_encode_job", fail)
    with pytest.raises(RuntimeError, match="encode_job"):
        zstd_jobs.compress_sharded(mixed, job_size=512 << 10, workers=2)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 7, 8, 31, 32, 33, 63, 64, 100, 4099])
def test_xxh64_equals_tpu7z(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    want = jxxh64(data)
    assert xxh64(data) == want == xxh64_native(data)
    assert xxh64_native(data, seed=12345) == jxxh64(data, seed=12345)


def test_constant_tables_equal_tpu7z():
    for name in ("LL_BITS", "LL_BASE", "ML_BITS", "ML_BASE", "LL_DEFAULT_NORM",
                 "ML_DEFAULT_NORM", "OF_DEFAULT_NORM"):
        t, j = getattr(tseq, name), getattr(jseq, name)
        assert t.dtype == j.dtype and np.array_equal(t, j), name
    for name in ("MAX_LL_CODE", "MAX_ML_CODE", "MAX_OF_CODE", "LL_DEFAULT_LOG",
                 "ML_DEFAULT_LOG", "OF_DEFAULT_LOG", "MAX_LL_LOG", "MAX_ML_LOG",
                 "MAX_OF_LOG", "MODE_PREDEFINED", "MODE_RLE", "MODE_FSE", "MODE_REPEAT"):
        assert getattr(tseq, name) == getattr(jseq, name), name
    for name in ("MAX_TABLE_LOG", "MAX_TABLE_LOG_DECODE", "MAX_SYMBOLS"):
        assert getattr(thuf, name) == getattr(jhuf, name), name
    for level in range(-8, 24):
        for n in (0, 1, 1000, 1 << 16, 1 << 20, 5 << 20, 1 << 26):
            assert tcomp._level_params(level, n) == jcomp._level_params(level, n)
    for name in ("MAGIC", "MAGIC_SKIPPABLE_MIN", "MAGIC_SKIPPABLE_MAX", "MAX_BLOCK_SIZE"):
        assert getattr(tframe, name) == getattr(jframe, name), name
    assert (zstd_jobs.KBLOCK, zstd_jobs.DEFAULT_JOB, zstd_jobs.DEFAULT_OVERLAP) == \
        (jjobs.KBLOCK, jjobs.DEFAULT_JOB, jjobs.DEFAULT_OVERLAP)


def test_progress_totals_are_exact_under_threads():
    """The job model's workers share one Progress: 16 threads, more than
    the cores, each adding 2000 times with a short switch interval."""
    import sys
    import threading

    prog = progress.Progress()
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [prog.add(1, 2) for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    assert (prog.in_total, prog.out_total) == (32000, 64000)
