"""One zstd frame from parallel jobs: the zstdmt job model on the host
(tpu7z/parallel/zstd_jobs.py).

Behavioral reference: the reference's ZSTDMT_compressionJob: the input
is cut into fixed-size jobs; every job is seeded with the window before
it as a raw-content prefix, so matches reach across the cut; repeat
offsets reset at each job start; the first job writes the frame header;
one XXH64 over the whole input closes the frame. The result is ONE
standard zstd frame.

Determinism: the job partition depends only on (len(data), job_size),
never on the worker count, so the bytes are the same at every number of
workers. Workers run the host job encoder (csrc/zstd_enc.cpp) through
ctypes, which releases the GIL, so a thread pool runs jobs side by side.
Progress and the first error aggregate through parallel.progress.Progress.
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor

from ..models.zstd import native
from ..ops.hashing import xxh64_native
from .progress import Progress

KBLOCK = 128 * 1024          # zstd block size (must divide job/overlap)
DEFAULT_JOB = 2 << 20
DEFAULT_OVERLAP = 512 << 10  # the window prefix of each job


def _job_layout(n: int, job_size: int, overlap: int):
    """[(prefix start, start, end, kind)] of each job; kind bit 1 marks the
    first job (it writes the header), bit 0 the last (its last block)."""
    job_size = max(KBLOCK, (job_size // KBLOCK) * KBLOCK)
    overlap = (overlap // KBLOCK) * KBLOCK
    jobs = []
    njobs = max(1, (n + job_size - 1) // job_size)
    for j in range(njobs):
        s = j * job_size
        e = min(s + job_size, n)
        p0 = max(0, s - overlap)
        kind = (2 if j == 0 else 0) | (1 if j == njobs - 1 else 0)
        jobs.append((p0, s, e, kind))
    return jobs


def compress_sharded(data: bytes, level: int = 3, checksum: bool = True,
                     job_size: int = DEFAULT_JOB,
                     overlap: int = DEFAULT_OVERLAP,
                     workers: int = 4,
                     progress: Progress | None = None) -> bytes:
    """One zstd frame of `data` from overlap-prefix jobs run by `workers`
    threads; an input of at most one job is one call of the host
    encoder."""
    data = bytes(data)
    n = len(data)
    if n == 0 or n <= job_size:
        c = native.zstd_encode(data, level=level, checksum=checksum)
        if progress is not None:
            progress.add(n, len(c))
        return c

    jobs = _job_layout(n, job_size, overlap)
    prog = progress or Progress()

    def run(job):
        p0, s, e, kind = job
        if prog.error is not None:
            return b""  # first error wins; peers bail out
        try:
            out = native.zstd_encode_job(data[p0:e], s - p0, n, level, kind, checksum)
        except RuntimeError as exc:
            prog.set_error(exc)
            return b""
        prog.add(e - s, len(out))
        return out

    if workers <= 1:
        parts = [run(j) for j in jobs]
    else:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            parts = list(pool.map(run, jobs))
    prog.check()
    out = b"".join(parts)
    if checksum:
        out += struct.pack("<I", xxh64_native(data) & 0xFFFFFFFF)
    return out
