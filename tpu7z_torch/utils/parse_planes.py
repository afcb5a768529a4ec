"""Synthetic mlen planes for checking lz4_parse's walk.

`parse_planes(B)` returns name -> (B, 65536) int32 numpy plane, made from
a numpy seed, each of 128-position rows built to reach one edge of the
parse: random values capped at the row end, as the main path caps them;
uncapped values in [-1, 256]; chains of defers; 4 and 0 everywhere; a take
only at position 127; one match a row that ends at the row end;
alternating 0/4; and int32 extremes, where mlen[c] + 1 and c + mlen[c]
leave int32 (tpu7z's parse works in int32 and wraps there, so only the
port's int64 plain version is the reference for that plane). The CPU
tests and chip_smoke.py use the same planes.
"""

from __future__ import annotations

import numpy as np

ROW = 128
NROWS = 512


def parse_planes(B=2):
    """name -> (B, NROWS * ROW) int32 mlen plane."""
    rng = np.random.default_rng(21)
    shape = (B * NROWS, ROW)
    lane = np.arange(ROW)
    planes = {}
    planes["random_capped"] = np.minimum(rng.integers(0, 24, shape), ROW - lane)
    planes["uncapped"] = rng.integers(-1, 257, shape)
    # runs in which each position is 2 longer than the one before, so each
    # defers to the next; the first row is one run of the whole row
    ch = np.zeros(shape, np.int64)
    for r in range(shape[0]):
        p = 0
        while p < ROW:
            n = ROW if r == 0 else int(rng.integers(1, 13))
            base = int(rng.integers(2, 9))
            ch[r, p:p + n] = base + 2 * np.arange(min(n, ROW - p))
            p += n
    planes["defer_chains"] = ch
    planes["fours"] = np.full(shape, 4)
    planes["zeros"] = np.zeros(shape, np.int64)
    t127 = rng.integers(0, 4, shape)
    t127[:, 127] = rng.integers(4, 300, shape[0])
    planes["take_at_127"] = t127
    # one match per row from p to the row end, after zeros; short ones after
    end = rng.integers(0, 4, shape)
    at = rng.integers(0, ROW - 3, shape[0])
    end[lane < at[:, None]] = 0
    end[np.arange(shape[0]), at] = ROW - at
    planes["ends_at_row_end"] = end
    planes["alternating"] = np.tile(np.array([0, 4]), (shape[0], ROW // 2))
    i32 = np.iinfo(np.int32)
    vals = np.array([i32.min, i32.min + 1, -1, 0, 3, 4, 5, i32.max - 1, i32.max])
    planes["int32_extremes"] = vals[np.random.default_rng(5).integers(0, len(vals), shape)]
    return {k: v.astype(np.int32).reshape(B, NROWS * ROW) for k, v in planes.items()}
