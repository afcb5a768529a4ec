"""FSE (tANS) engine for the zstd path.

Behavioral reference: RFC 8878 section 4.1 and C/zstd/fse_compress.c /
fse_decompress.c (FSE_readNCount, FSE_buildDTable, FSE_buildCTable).
This implementation is written from the format specification; tables are
numpy arrays so state transitions can run as gathers. Host code: the
encoder's and the plain decoder's tables (tpu7z/models/zstd/fse.py).

Conventions:
- counts: int array over symbols 0..maxSym; -1 denotes the "less than 1"
  probability (takes one slot from the table's high end).
- decode table: arrays (symbol, nb_bits, base) of size 2^accuracy_log;
  decode step: sym = symbol[state]; state' = base[state] + read(nb_bits).
- encode table: per-symbol (delta_nb_bits, delta_find_state) plus a
  state-transition array; encode step mirrors FSE_encodeSymbol.
"""

from __future__ import annotations

import numpy as np

from ...ops.bitstream import BitWriterLSB, ForwardBitReader
from ...utils.errors import CorruptError


def read_ncount(reader: ForwardBitReader, max_symbol: int, max_accuracy: int):
    """Read an FSE table description (normalized counts) from a forward
    bitstream. Returns (counts array, accuracy_log)."""
    accuracy_log = reader.read(4) + 5
    if accuracy_log > max_accuracy:
        raise CorruptError(f"FSE accuracy {accuracy_log} > max {max_accuracy}")
    table_size = 1 << accuracy_log
    remaining = table_size + 1
    threshold = table_size
    nb_bits = accuracy_log + 1
    counts = []
    prev_zero = False
    while remaining > 1:
        if len(counts) > max_symbol + 1:
            raise CorruptError("FSE ncount: too many symbols")
        if prev_zero:
            while True:
                rep = reader.read(2)
                counts.extend([0] * rep)
                if rep < 3:
                    break
                if len(counts) > max_symbol + 1:
                    raise CorruptError("FSE ncount: zero-run overflow")
            prev_zero = False
            continue
        maxv = 2 * threshold - 1 - remaining
        value = reader.read(nb_bits - 1)
        if value < maxv:
            count = value
        else:
            extra = reader.read(1)
            value |= extra << (nb_bits - 1)
            if value >= threshold:
                value -= maxv
            count = value
        count -= 1  # shifted encoding: -1 .. remaining-1
        remaining -= -count if count < 0 else count
        counts.append(count)
        prev_zero = count == 0
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1
    if remaining != 1:
        raise CorruptError("FSE ncount: counts exceed table size")
    if len(counts) > max_symbol + 1:
        raise CorruptError("FSE ncount: symbol out of range")
    out = np.zeros(max_symbol + 1, dtype=np.int32)
    out[: len(counts)] = counts
    return out, accuracy_log


def write_ncount(counts: np.ndarray, accuracy_log: int) -> bytes:
    """Serialize normalized counts (inverse of read_ncount)."""
    w = BitWriterLSB()
    w.write(accuracy_log - 5, 4)
    table_size = 1 << accuracy_log
    remaining = table_size + 1
    threshold = table_size
    nb_bits = accuracy_log + 1
    # trim trailing zeros (the stream stops once remaining == 1)
    counts = np.asarray(counts, dtype=np.int64)
    i = 0
    n = counts.size
    while remaining > 1 and i < n:
        c = int(counts[i])
        maxv = 2 * threshold - 1 - remaining
        value = c + 1
        if value < maxv:
            w.write(value, nb_bits - 1)
        else:
            # large encoding: nb_bits bits; values >= threshold shifted up
            v = value if value < threshold else value + maxv
            w.write(v, nb_bits)
        remaining -= -c if c < 0 else c
        i += 1
        if c == 0:
            # zero-run flags
            j = i
            while remaining > 1:
                run = 0
                while j < n and counts[j] == 0 and run < 3:
                    run += 1
                    j += 1
                w.write(run, 2)
                if run < 3:
                    break
            i = j
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1
    if remaining != 1:
        raise ValueError("write_ncount: counts do not sum to table size")
    return w.close()


def _spread_symbols(counts: np.ndarray, accuracy_log: int) -> np.ndarray:
    """Assign symbols to table slots (shared by decode and encode table
    construction; reference: FSE_buildDTable's spread loop)."""
    table_size = 1 << accuracy_log
    table = np.zeros(table_size, dtype=np.int32)
    high = table_size - 1
    # "less than 1" symbols occupy the high end
    for s in range(counts.size):
        if counts[s] == -1:
            table[high] = s
            high -= 1
    step = (table_size >> 1) + (table_size >> 3) + 3
    mask = table_size - 1
    pos = 0
    for s in range(counts.size):
        c = int(counts[s])
        for _ in range(max(c, 0)):
            table[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise CorruptError("FSE table spread did not close")
    return table


class DTable:
    __slots__ = ("symbol", "nb_bits", "base", "accuracy_log")

    def __init__(self, symbol, nb_bits, base, accuracy_log):
        self.symbol = symbol
        self.nb_bits = nb_bits
        self.base = base
        self.accuracy_log = accuracy_log


def build_dtable(counts: np.ndarray, accuracy_log: int) -> DTable:
    table_size = 1 << accuracy_log
    if int(np.sum(np.where(counts < 0, 1, counts))) != table_size:
        raise CorruptError("FSE counts do not sum to table size")
    spread = _spread_symbols(counts, accuracy_log)
    symbol_next = np.where(counts < 0, 1, counts).astype(np.int64)
    nb_bits = np.empty(table_size, dtype=np.int32)
    base = np.empty(table_size, dtype=np.int32)
    for u in range(table_size):
        s = spread[u]
        next_state = int(symbol_next[s])
        symbol_next[s] += 1
        nb = accuracy_log - (next_state.bit_length() - 1)
        nb_bits[u] = nb
        base[u] = (next_state << nb) - table_size
    return DTable(spread, nb_bits, base, accuracy_log)


def build_rle_dtable(symbol: int) -> DTable:
    """Degenerate 1-entry table for RLE symbol mode (accuracy 0)."""
    return DTable(np.array([symbol], dtype=np.int32),
                  np.array([0], dtype=np.int32),
                  np.array([0], dtype=np.int32), 0)


class CTable:
    __slots__ = ("state_table", "delta_nb_bits", "delta_find_state",
                 "accuracy_log")

    def __init__(self, state_table, delta_nb_bits, delta_find_state,
                 accuracy_log):
        self.state_table = state_table
        self.delta_nb_bits = delta_nb_bits
        self.delta_find_state = delta_find_state
        self.accuracy_log = accuracy_log


def build_ctable(counts: np.ndarray, accuracy_log: int) -> CTable:
    """Build the encode table (reference behavior: FSE_buildCTable_wksp)."""
    table_size = 1 << accuracy_log
    spread = _spread_symbols(counts, accuracy_log)
    nsym = counts.size

    # cumulative slot start per symbol (in "state number" space)
    cumul = np.zeros(nsym + 1, dtype=np.int64)
    acc = 0
    for s in range(nsym):
        c = int(counts[s])
        cumul[s] = acc
        acc += 1 if c == -1 else c
    cumul[nsym] = acc

    # state transition table: for each slot u (ascending), assign the
    # next free state number of its symbol
    state_table = np.zeros(table_size, dtype=np.int64)
    fill = cumul[:nsym].copy()
    # "less than 1" symbols sit at the high end of the spread; they also
    # consume their single state slot via the same pass
    for u in range(table_size):
        s = spread[u]
        state_table[fill[s]] = table_size + u
        fill[s] += 1

    delta_nb = np.zeros(nsym, dtype=np.int64)
    delta_fs = np.zeros(nsym, dtype=np.int64)
    total = 0
    for s in range(nsym):
        c = int(counts[s])
        if c == 0:
            # unused symbol; fill with safe values
            delta_nb[s] = ((accuracy_log + 1) << 16) - (1 << accuracy_log)
            delta_fs[s] = 0
            continue
        if c == -1 or c == 1:
            delta_nb[s] = (accuracy_log << 16) - (1 << accuracy_log)
            delta_fs[s] = total - 1
            total += 1
        else:
            max_bits_out = accuracy_log - ((c - 1).bit_length() - 1)
            min_state_plus = c << max_bits_out
            delta_nb[s] = (max_bits_out << 16) - min_state_plus
            delta_fs[s] = total - c
            total += c
    return CTable(state_table, delta_nb, delta_fs, accuracy_log)


class Encoder:
    """Scalar FSE encoder state (FSE_initCState2/FSE_encodeSymbol/
    FSE_flushCState semantics). Emits (value, nbits) pairs for the
    vectorized bit packer rather than writing a stream directly. The
    tables are read as Python lists: one lookup a symbol, on the host."""

    __slots__ = ("ct", "state", "_st", "_dnb", "_dfs")

    def __init__(self, ct: CTable, first_symbol: int):
        self.ct = ct
        self._st = ct.state_table.tolist()
        self._dnb = ct.delta_nb_bits.tolist()
        self._dfs = ct.delta_find_state.tolist()
        dnb = self._dnb[first_symbol]
        nb = (dnb + (1 << 15)) >> 16
        state = (nb << 16) - dnb
        self.state = self._st[(state >> nb) + self._dfs[first_symbol]]

    def encode(self, symbol: int):
        """Returns (bits_value, nb_bits) to append to the stream."""
        state = self.state
        nb = (state + self._dnb[symbol]) >> 16
        self.state = self._st[(state >> nb) + self._dfs[symbol]]
        return state & ((1 << nb) - 1), nb

    def flush(self):
        """Returns (state_value, accuracy_log) for the final state write."""
        mask = (1 << self.ct.accuracy_log) - 1
        return self.state & mask, self.ct.accuracy_log


def normalize_counts(hist: np.ndarray, accuracy_log: int, total: int,
                     max_symbol: int) -> np.ndarray:
    """Normalize a histogram to sum to 2^accuracy_log.

    Behavioral reference: FSE_normalizeCount (C/zstd/fse_compress.c:465):
    low-probability symbols get -1, the rest are scaled, and the largest
    symbol absorbs the remainder.
    """
    if total == 0:
        raise ValueError("empty histogram")
    table_size = 1 << accuracy_log
    hist = np.asarray(hist[: max_symbol + 1], dtype=np.int64)
    norm = np.zeros(max_symbol + 1, dtype=np.int64)

    scale = 62 - accuracy_log
    step = (1 << 62) // total
    v_step = 1 << (scale - 20)
    still_to_distribute = table_size
    largest, largest_norm = -1, 0
    low_threshold = total >> accuracy_log
    for s in range(max_symbol + 1):
        c = int(hist[s])
        if c == 0:
            continue
        if c == total:
            # RLE case: caller should use RLE mode; make a valid table anyway
            norm[:] = 0
            norm[s] = table_size
            return norm
        if c <= low_threshold:
            norm[s] = -1
            still_to_distribute -= 1
        else:
            proba = (c * step) >> scale
            if proba < 8:
                rest_to_beat = v_step * proba
                if (c * step) - (proba << scale) > rest_to_beat:
                    proba += 1
            if proba > largest_norm:
                largest, largest_norm = s, proba
            norm[s] = proba
            still_to_distribute -= proba
    if -still_to_distribute >= (largest_norm >> 1):
        # corner case: rebalance with a simple exact fallback
        return _normalize_fallback(hist, accuracy_log, total, max_symbol)
    norm[largest] += still_to_distribute
    assert int(np.sum(np.where(norm < 0, 1, norm))) == table_size
    return norm


def _normalize_fallback(hist, accuracy_log, total, max_symbol):
    """Slow exact normalization: largest remainders first."""
    table_size = 1 << accuracy_log
    hist = np.asarray(hist[: max_symbol + 1], dtype=np.float64)
    norm = np.zeros(max_symbol + 1, dtype=np.int64)
    nz = hist > 0
    ideal = hist * table_size / total
    norm[nz] = np.maximum(1, np.floor(ideal[nz]).astype(np.int64))
    diff = table_size - int(norm.sum())
    order = np.argsort(-(ideal - norm))
    i = 0
    while diff != 0:
        s = order[i % order.size]
        if diff > 0:
            if norm[s] > 0:
                norm[s] += 1
                diff -= 1
        else:
            if norm[s] > 1:
                norm[s] -= 1
                diff += 1
        i += 1
        if i > 10 * order.size:
            raise RuntimeError("normalization failed to converge")
    return norm
