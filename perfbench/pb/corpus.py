"""Frozen copy of the port's corpus generator (`tpu7z_torch/utils/corpus.py`
at the time the benchmark was defined), so that no later change to the
program can move the bytes the benchmark feeds it.

Deterministic mixed corpus: text, binary records, sparse, random and log
lines. numpy's `Generator.zipf` changed after 2.0, so the word indices
come from `_zipf`, numpy 2.0's rejection sampler written out on
`Generator.random`: the bytes are the same under any numpy.
`CORPUS_SHA256` pins `make_corpus(32 MiB)` at the default seed, and so
the chunk generators that `make_pool`, the benchmark's pool, shares with
it; `POOL_SHA256` pins `make_pool(32 MiB, POOL_PIN_SEED)`.
"""

from __future__ import annotations

import math
from itertools import repeat

import numpy as np

_INT64_MAX = float(2**63 - 1)
# sha256 of make_corpus(32 MiB), and of make_pool(32 MiB, POOL_PIN_SEED)
CORPUS_SHA256 = "05224620a507811d6a855ddf98cc7f0a4a1ede748fba0f6f8747ddb639b6cb2a"
POOL_PIN_SEED = 0x51E51A
POOL_SHA256 = "2389b1ca73c94649fa95d2dca07045645b00dbeebe2a87acbebf1f7a6bbdae85"

_WORDS = (
    "the of and a to in is was he for it with as his on be at by i this had "
    "not are but from or have an they which one you were her all she there "
    "would their we him been has when who will more no if out so said what "
    "up its about into than them can only other new some could time these "
    "two may then do first any my now such like our over man me even most "
    "made after also did many before must through back years where much "
    "your way well down should because each just those people mr how too "
    "little state good very make world still own see men work long get "
    "here between both life being under never day same another know while "
    "last might us great old year off come since against go came right "
    "used take three").split()


def _zipf(rng, a: float, size: int) -> np.ndarray:
    """`rng.zipf(a, size)` as numpy 2.0 draws it: two doubles per trial,
    U = 1 - d0 and V = d1, X = floor(U ** (-1 / (a - 1))), accepted by the
    same test. The generator ends where numpy 2.0's would. The powers go
    through `math.pow` (the C library's, as in numpy 2.0's sampler); the
    rest is IEEE arithmetic in the sampler's order, so the draws are the
    same bits whether taken one by one or, as here, a batch at a time."""
    am1 = a - 1.0
    b = math.pow(2.0, am1)
    inv = -1.0 / am1
    parts, have = [], 0
    while have < size:
        need = size - have
        trials = need + need // 4 + 16
        state = rng.bit_generator.state
        d = rng.random(2 * trials)
        X = np.floor(np.fromiter(map(math.pow, (1.0 - d[0::2]).tolist(), repeat(inv)),
                                 dtype=np.float64, count=trials))
        ok = (X <= _INT64_MAX) & (X >= 1.0)
        Xs = np.where(ok, X, 1.0)
        T = np.fromiter(map(math.pow, (1.0 + 1.0 / Xs).tolist(), repeat(am1)),
                        dtype=np.float64, count=trials)
        accept = ok & (d[1::2] * Xs * (T - 1.0) / (b - 1.0) <= T / b)
        take = np.flatnonzero(accept)[:need]
        parts.append(X[take].astype(np.int64))
        have += take.size
        if take.size == need and 2 * (int(take[-1]) + 1) < 2 * trials:
            rng.bit_generator.state = state      # give back the draws not used
            rng.random(2 * (int(take[-1]) + 1))
    return np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)


KINDS = ("text", "struct", "sparse", "random", "log")
WEIGHTS = (0.4, 0.2, 0.15, 0.1, 0.15)
CHUNK_LO, CHUNK_HI = 1 << 18, 1 << 21


def _chunk(kind: str, n: int, rng, t0: int = 0) -> bytes:
    """Up to `n` bytes of one kind (text and records may come out a little
    shorter); the records start at record number `t0`."""
    if kind == "text":
        idx = _zipf(rng, 1.3, n // 5) % len(_WORDS)
        return " ".join([_WORDS[i] for i in idx.tolist()]).encode()[:n]
    if kind == "struct":
        t = np.arange(t0, t0 + n // 8, dtype=np.uint64)
        rec = (t * 2654435761 % 1000003).astype("<u4")
        ts = (1700000000 + t * 37).astype("<u4")
        return np.stack([rec, ts], axis=1).tobytes()[:n]
    if kind == "sparse":
        z = np.zeros(n, dtype=np.uint8)
        hits = rng.integers(0, n, n // 400)
        z[hits] = rng.integers(1, 256, hits.size)
        return z.tobytes()
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    lines = []                                  # log-like lines
    have = 0
    t = 1700000000
    while have < n:
        t += int(rng.integers(1, 30))
        lvl = ("INFO", "WARN", "DEBUG")[int(rng.integers(0, 3))]
        lines.append(
            f"{t} {lvl} svc-{int(rng.integers(0, 8))} "
            f"request id={int(rng.integers(0, 1 << 20)):07d} "
            f"latency={int(rng.integers(1, 500))}ms status=200\n"
            .encode())
        have += len(lines[-1])
    return b"".join(lines)[:n]


def make_corpus(size: int = 32 << 20, seed: int = 0x51E51A) -> bytes:
    """The program's corpus, byte for byte: chunks of 256 KiB-2 MiB whose
    kinds are drawn one by one with WEIGHTS."""
    rng = np.random.default_rng(seed)
    parts = []
    remaining = size
    while remaining > 0:
        kind = rng.choice(list(KINDS), p=list(WEIGHTS))
        n = int(min(remaining, rng.integers(CHUNK_LO, CHUNK_HI)))
        chunk = _chunk(str(kind), n, rng)
        parts.append(chunk[:remaining])
        remaining -= len(chunk[:remaining])
    return b"".join(parts)


def make_pool(size: int, seed: int) -> bytes:
    """The benchmark's pool for `seed`: every byte drawn from the seed by
    the corpus's own chunk generators, the records from a seeded start,
    the chunks in a seeded order; each kind holds exactly its share of
    WEIGHTS (the last kind the rest), so the mix, and with it the work
    and the ratio, is the same on every seed. `make_corpus` draws each
    chunk's kind instead, so its mix moves with the seed."""
    rng = np.random.default_rng(int(seed) % (1 << 64))
    plan = []
    left = size
    for k, (kind, w) in enumerate(zip(KINDS, WEIGHTS)):
        budget = left if k == len(KINDS) - 1 else int(round(w * size))
        left -= budget
        while budget > 0:
            n = int(min(budget, rng.integers(CHUNK_LO, CHUNK_HI)))
            plan.append((kind, n))
            budget -= n
    parts = []
    for j in rng.permutation(len(plan)).tolist():
        kind, n = plan[j]
        t0 = int(rng.integers(0, 1 << 24))
        got, have = [], 0
        while have < n:                         # text and records run short
            c = _chunk(kind, max(n - have, 64), rng, t0)
            got.append(c)
            have += len(c)
            t0 += len(c) // 8
        parts.append(b"".join(got)[:n])
    return b"".join(parts)
