"""Bit-position chain decoding: the zstd plain decoder's Huffman streams
as array code instead of a serial loop per symbol (tpu7z/ops/bitchain.py,
host numpy there too; it has no Pallas kernel).

A table-driven prefix decoder (Huffman, and FSE state machines collapsed
onto bit positions) is a chain r_{i+1} = r_i - nbits(peek(r_i)) over the
stream's bit positions, read from the top (zstd backward streams). The
reference decodes this with a serial loop per stream
(C/zstd/huf_decompress.c HUF_decompress4X1_usingDTable_internal). Here we:

  1. compute peek(r) for EVERY bit position r in one vectorized pass,
  2. build next[r] = r - nbits[peek(r)],
  3. extract the visited chain via pointer doubling (log2 passes),
  4. gather symbols along the chain.

All four steps are gathers/maps — data-parallel across positions and
across the block's 4 (or N) independent streams.
"""

from __future__ import annotations

import numpy as np

from ..utils.errors import CorruptError


def usable_bits(stream: np.ndarray) -> int:
    """Bits below the end marker of a zstd backward stream."""
    if stream.size == 0:
        raise CorruptError("empty entropy stream")
    last = int(stream[-1])
    if last == 0:
        raise CorruptError("entropy stream missing end marker")
    return 8 * stream.size - (8 - (last.bit_length() - 1))


def peek_table(stream: np.ndarray, nbits: int, max_pos: int) -> np.ndarray:
    """peek[r] = the `nbits` bits ending at bit position r (LSB-first
    stream), for r in [0, max_pos]. Positions below 0 are zero-filled
    (zstd allows terminal overread into the init padding).
    """
    n = stream.size
    r = np.arange(max_pos + 1, dtype=np.int64)
    start = r - nbits
    b0 = start >> 3
    sh = (start & 7).astype(np.uint32)
    # gather 4 bytes covering [start, start+nbits) for nbits <= 25
    acc = np.zeros(r.size, dtype=np.uint32)
    for i in range(4):
        idx = b0 + i
        valid = (idx >= 0) & (idx < n)
        byte = np.where(valid, stream[np.clip(idx, 0, n - 1)], 0)
        acc |= byte.astype(np.uint32) << np.uint32(8 * i)
    vals = (acc >> sh) & np.uint32((1 << nbits) - 1)
    # start < 0: only (nbits + start) high bits exist; shift them up,
    # zero-filling the low (-start) bits
    neg = start < 0
    if np.any(neg):
        head = np.zeros(r.size, dtype=np.uint32)
        nb = min(4, n)
        lowbytes = np.uint32(0)
        for i in range(nb):
            lowbytes |= np.uint32(int(stream[i]) << (8 * i))
        rr = r[neg].astype(np.uint32)
        width_mask = (np.uint32(1) << rr) - np.uint32(1)
        head[neg] = (lowbytes & width_mask) << (np.uint32(nbits) - rr)
        vals = np.where(neg, head, vals)
    return vals


def chain_decode(stream: np.ndarray, sym_of_peek: np.ndarray,
                 nbits_of_peek: np.ndarray, table_log: int,
                 nsyms: int) -> np.ndarray:
    """Decode `nsyms` symbols from a backward bitstream via a table where
    index = peeked `table_log` bits, giving (symbol, bits consumed).

    Serial-equivalent: r = usable_bits; repeat nsyms times:
    v = peek(r); emit sym[v]; r -= nbits[v].
    """
    total = usable_bits(stream)
    peeks = peek_table(stream, table_log, total)
    nb = nbits_of_peek[peeks].astype(np.int64)
    if np.any(nb <= 0):
        # corrupt table entries reachable => must not be visited; guard by
        # forcing them to step by 1 (will be caught by symbol validity)
        nb = np.maximum(nb, 1)
    nxt = np.arange(total + 1, dtype=np.int64) - nb

    # pointer doubling from position `total`
    visited = _chain_positions(nxt, total, nsyms)
    if visited.size < nsyms:
        raise CorruptError("entropy stream exhausted early")
    return sym_of_peek[peeks[visited[:nsyms]]]


def _chain_positions(nxt: np.ndarray, start: int, count: int) -> np.ndarray:
    """First `count` positions of the chain start, nxt[start], ... — in
    chain order. Positions strictly decrease; negatives terminate."""
    size = nxt.size
    cur = np.array([start], dtype=np.int64)
    jump = np.clip(nxt, -1, size - 1)
    while cur.size < count:
        take = np.clip(cur, 0, size - 1)
        ext = np.where(cur >= 0, jump[take], -1)
        cur = np.concatenate([cur, ext])
        # square the jump table: jump <- jump o jump
        jump = np.where(jump >= 0, jump[np.clip(jump, 0, size - 1)], -1)
        if cur.size > 4 * (count + size):
            break  # safety against degenerate cycles
    # chain positions strictly decrease: order = sort descending
    pos = np.unique(cur[cur >= 0])[::-1]
    return pos[:count]
