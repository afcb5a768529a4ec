"""The one traffic generator. Every mix is a data file,
`perfbench/traffic/<name>.json`, that this module reads:

    {"loop": "closed", "clients": 1,
     "pool": {"corpus_bytes": 33554432},
     "align": 65536,
     "sizes": [{"weight": 0.8, "dist": "uniform", "lo": 4096, "hi": 16384},
               {"weight": 0.2, "dist": "loguniform", "lo": 16384, "hi": 1048576}]}

Requests are cut from one pool, `make_pool(corpus_bytes, seed)`
(`pb/corpus.py`), made from `--seed` in set-up. Request i is `size_i`
bytes from offset `off_i` of the pool, read on around its end (the ring
holds the pool as often as the largest request needs), so a request is a
zero-copy view of the ring. Both are drawn from the seed: the offsets
pass over the pool's slots (multiples of `align`) in a seeded order, each
slot once a pass, so a window sends every part of the pool about as often
as any other and a seed changes the order of the work, not its mix;
`size_i` comes from the mix's size distribution at a uniform quantile.
Warm-up takes its requests from negative indices, draws of their own.
"""

from __future__ import annotations

import math

import numpy as np

_DISTS = ("fixed", "uniform", "loguniform")


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """Stream `stream` of draws for any whole number (negative ones too)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def check_params(params: dict) -> None:
    """Raise ValueError for a mix this generator cannot draw."""
    if params.get("loop") != "closed" or params.get("clients") != 1:
        raise ValueError("traffic: only a closed loop with one client is drawn")
    sizes = params.get("sizes")
    if not sizes:
        raise ValueError("traffic: no sizes")
    for part in sizes:
        if part.get("dist") not in _DISTS:
            raise ValueError(f"traffic: unknown size distribution {part.get('dist')!r}")
        if part["weight"] <= 0:
            raise ValueError("traffic: every weight must be positive")
    if int(params["align"]) <= 0:
        raise ValueError("traffic: align must be positive")


def max_size(params: dict) -> int:
    return max(int(p["bytes"]) if p["dist"] == "fixed" else int(p["hi"])
               for p in params["sizes"])


def scaled(params: dict, factor: float) -> dict:
    """The mix with its pool, sizes and alignment scaled by `factor` (the
    tests' small runs on the CPU)."""
    def sc(x):
        return max(1, int(x * factor))

    sizes = [{k: (sc(v) if k in ("bytes", "lo", "hi") else v) for k, v in p.items()}
             for p in params["sizes"]]
    return {**params, "sizes": sizes, "align": sc(params["align"]),
            "pool": {"corpus_bytes": sc(params["pool"]["corpus_bytes"])}}


def size_at(params: dict, u: float) -> int:
    """The size at quantile u in [0, 1) of the mix's size distribution."""
    parts = params["sizes"]
    total = sum(p["weight"] for p in parts)
    acc = 0.0
    for k, part in enumerate(parts):
        w = part["weight"] / total
        if u < acc + w or k == len(parts) - 1:
            x = min(max((u - acc) / w, 0.0), 1.0 - 1e-12)
            break
        acc += w
    if part["dist"] == "fixed":
        return int(part["bytes"])
    lo, hi = int(part["lo"]), int(part["hi"])
    if part["dist"] == "uniform":
        return lo + int(x * (hi - lo + 1))
    return min(hi, int(lo * math.exp(x * math.log(hi / lo))))


class Traffic:
    """Requests of one mix for one seed, over one pool."""

    def __init__(self, params: dict, seed: int, pool: bytes):
        check_params(params)
        self.params = params
        self.pool_bytes = len(pool)
        self.align = int(params["align"])
        self.slots = max(1, self.pool_bytes // self.align)
        big = max_size(params)
        copies = 1 + -(-big // self.pool_bytes)
        self.ring = memoryview(pool * copies)
        # the window's requests (i >= 0) and the warm-up's (i < 0)
        self._rng = [seed_rng(seed, 1), seed_rng(seed, 2)]
        self._slot = [np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)]
        self._u = [np.zeros(0), np.zeros(0)]

    def shape(self, i: int) -> tuple[int, int]:
        """(offset, size) of request i; any integer i."""
        s, k = (0, i) if i >= 0 else (1, -1 - i)
        while k >= len(self._slot[s]):              # one more pass over the slots
            self._slot[s] = np.concatenate([self._slot[s], self._rng[s].permutation(self.slots)])
            self._u[s] = np.concatenate([self._u[s], self._rng[s].random(self.slots)])
        return int(self._slot[s][k]) * self.align, size_at(self.params, float(self._u[s][k]))

    def request(self, i: int) -> memoryview:
        off, size = self.shape(i)
        return self.ring[off:off + size]
