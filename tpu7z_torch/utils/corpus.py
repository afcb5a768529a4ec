"""Deterministic mixed benchmark corpus: text, binary records, sparse,
random and log lines. The same seed gives the same bytes as the JAX
package's corpus under numpy 2.0, so ratios compare across the two.

numpy's `Generator.zipf` changed after 2.0 (2.3.5 gives other values from
the same seed), so the text would differ under a newer numpy. The word
indices therefore come from `_zipf`, numpy 2.0's rejection sampler
written out on `Generator.random`, and the bytes are the same under any
numpy.
"""

from __future__ import annotations

import math

import numpy as np

_INT64_MAX = float(2**63 - 1)
# sha256 of make_corpus(32 MiB), and the device encoder's ratio over those
# bytes at W = 0 (bytes / sum of min(used, 65540), to three places)
CORPUS_SHA256 = "05224620a507811d6a855ddf98cc7f0a4a1ede748fba0f6f8747ddb639b6cb2a"
CORPUS_RATIO = 1.818

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
    same test. The generator ends where numpy 2.0's would."""
    am1 = a - 1.0
    b = math.pow(2.0, am1)
    inv = -1.0 / am1
    out = []
    while len(out) < size:
        need = size - len(out)
        trials = need + need // 4 + 16
        state = rng.bit_generator.state
        d = rng.random(2 * trials).tolist()
        drawn = 2 * trials
        for j in range(trials):
            X = math.floor(math.pow(1.0 - d[2 * j], inv))
            if X > _INT64_MAX or X < 1.0:
                continue
            T = math.pow(1.0 + 1.0 / X, am1)
            if d[2 * j + 1] * X * (T - 1.0) / (b - 1.0) <= T / b:
                out.append(int(X))
                if len(out) == size:
                    drawn = 2 * (j + 1)
                    break
        if drawn < 2 * trials:         # give back the draws not used
            rng.bit_generator.state = state
            rng.random(drawn)
    return np.array(out, dtype=np.int64)


def make_corpus(size: int = 32 << 20, seed: int = 0x51E51A) -> bytes:
    rng = np.random.default_rng(seed)
    parts = []
    remaining = size
    kinds = ["text", "struct", "sparse", "random", "log"]
    weights = [0.4, 0.2, 0.15, 0.1, 0.15]
    while remaining > 0:
        kind = rng.choice(kinds, p=weights)
        n = int(min(remaining, rng.integers(1 << 18, 1 << 21)))
        if kind == "text":
            idx = _zipf(rng, 1.3, n // 5) % len(_WORDS)
            chunk = " ".join(_WORDS[i] for i in idx).encode()[:n]
        elif kind == "struct":
            t = np.arange(n // 8, dtype=np.uint64)
            rec = (t * 2654435761 % 1000003).astype("<u4")
            ts = (1700000000 + t * 37).astype("<u4")
            chunk = np.stack([rec, ts], axis=1).tobytes()[:n]
        elif kind == "sparse":
            z = np.zeros(n, dtype=np.uint8)
            hits = rng.integers(0, n, n // 400)
            z[hits] = rng.integers(1, 256, hits.size)
            chunk = z.tobytes()
        elif kind == "random":
            chunk = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        else:  # log-like lines
            lines = []
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
            chunk = b"".join(lines)[:n]
        parts.append(chunk[:remaining])
        remaining -= len(chunk[:remaining])
    return b"".join(parts)
