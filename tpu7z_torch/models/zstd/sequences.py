"""Zstd sequences: code tables, section decode, and execution.

Behavioral reference: RFC 8878 section 3.1.1.3.2 and
C/zstd/zstd_decompress_block.c (ZSTD_decodeSeqHeaders,
ZSTD_decompressSequences, ZSTD_execSequence). Written from the spec.
"""

from __future__ import annotations

import numpy as np

from ...ops.bitstream import BackwardBitReader, ForwardBitReader
from ...utils.errors import CorruptError
from . import fse

# --- Literals-length codes (RFC 8878 table 10) -----------------------------
LL_BITS = np.array([0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10,
                               11, 12, 13, 14, 15, 16], dtype=np.int64)
LL_BASE = np.array(list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64,
                                      128, 256, 512, 1024, 2048, 4096, 8192,
                                      16384, 32768, 65536], dtype=np.int64)
MAX_LL_CODE = 35

# --- Match-length codes (RFC 8878 table 12); base is the true match length
ML_BITS = np.array([0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10,
                               11, 12, 13, 14, 15, 16], dtype=np.int64)
ML_BASE = np.array([i + 3 for i in range(32)]
                   + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259,
                      515, 1027, 2051, 4099, 8195, 16387, 32771, 65539],
                   dtype=np.int64)
MAX_ML_CODE = 52

MAX_OF_CODE = 31  # offset code == number of extra bits

# --- Predefined FSE distributions (RFC 8878 sections 3.1.1.3.2.2.x) --------
LL_DEFAULT_NORM = np.array(
    [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
     2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], dtype=np.int32)
LL_DEFAULT_LOG = 6

ML_DEFAULT_NORM = np.array(
    [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1,
     -1, -1, -1, -1, -1, -1], dtype=np.int32)
ML_DEFAULT_LOG = 6

OF_DEFAULT_NORM = np.array(
    [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     -1, -1, -1, -1, -1], dtype=np.int32)
OF_DEFAULT_LOG = 5

MAX_LL_LOG = 9
MAX_ML_LOG = 9
MAX_OF_LOG = 8

MODE_PREDEFINED = 0
MODE_RLE = 1
MODE_FSE = 2
MODE_REPEAT = 3


def ll_code_of(ll: np.ndarray) -> np.ndarray:
    """Literals-length value -> code (vectorized)."""
    ll = np.asarray(ll, dtype=np.int64)
    small = ll < 16
    big = np.searchsorted(LL_BASE[16:], ll, side="right") + 15
    return np.where(small, ll, big)


def ml_code_of(ml: np.ndarray) -> np.ndarray:
    """Match-length value (>=3) -> code (vectorized)."""
    ml = np.asarray(ml, dtype=np.int64)
    small = ml < 35
    big = np.searchsorted(ML_BASE[32:], ml, side="right") + 31
    return np.where(small, ml - 3, big)


def of_code_of(off_value: np.ndarray) -> np.ndarray:
    """Offset_Value (offset+3 or repeat 1-3) -> code = floor(log2)."""
    return floor_log2(off_value)


def floor_log2(v: np.ndarray) -> np.ndarray:
    """Exact elementwise floor(log2(v)) for positive integers."""
    x = np.asarray(v, dtype=np.uint64)
    bits = np.zeros(x.shape, dtype=np.int64)
    for shift in (32, 16, 8, 4, 2, 1):
        mask = x >= (np.uint64(1) << np.uint64(shift))
        bits = np.where(mask, bits + shift, bits)
        x = np.where(mask, x >> np.uint64(shift), x)
    return bits


class SeqTables:
    """The three FSE decode tables (and their repeat state across blocks)."""

    __slots__ = ("ll", "of", "ml")

    def __init__(self):
        self.ll = fse.build_dtable(LL_DEFAULT_NORM, LL_DEFAULT_LOG)
        self.of = fse.build_dtable(OF_DEFAULT_NORM, OF_DEFAULT_LOG)
        self.ml = fse.build_dtable(ML_DEFAULT_NORM, ML_DEFAULT_LOG)


def _read_table(mode: int, src: bytes, pos: int, default_norm, default_log,
                max_sym: int, max_log: int, prev: fse.DTable | None):
    if mode == MODE_PREDEFINED:
        return fse.build_dtable(default_norm, default_log), pos
    if mode == MODE_RLE:
        if pos >= len(src):
            raise CorruptError("sequences: truncated RLE symbol")
        sym = src[pos]
        if sym > max_sym:
            raise CorruptError("sequences: RLE symbol out of range")
        return fse.build_rle_dtable(sym), pos + 1
    if mode == MODE_FSE:
        r = ForwardBitReader(src[pos:])
        counts, log = fse.read_ncount(r, max_symbol=max_sym,
                                      max_accuracy=max_log)
        return fse.build_dtable(counts, log), pos + r.bytes_consumed()
    if prev is None:
        raise CorruptError("sequences: repeat mode without previous table")
    return prev, pos


def decode_section(src: bytes, tables: SeqTables):
    """Decode a Sequences_Section. Returns (ll, of_value, ml arrays, nseq)
    with of_value still in Offset_Value form (repeat codes unresolved),
    and updates `tables` for Repeat_Mode in later blocks.
    """
    if len(src) == 0:
        raise CorruptError("sequences: empty section")
    b0 = src[0]
    pos = 1
    if b0 < 128:
        nseq = b0
    elif b0 < 255:
        if len(src) < 2:
            raise CorruptError("sequences: truncated count")
        nseq = ((b0 - 128) << 8) + src[1]
        pos = 2
    else:
        if len(src) < 3:
            raise CorruptError("sequences: truncated count")
        nseq = src[1] + (src[2] << 8) + 0x7F00
        pos = 3
    if nseq == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.int64))
    if pos >= len(src):
        raise CorruptError("sequences: missing compression modes")
    modes = src[pos]
    pos += 1
    if modes & 3:
        raise CorruptError("sequences: reserved mode bits set")
    ll_mode = (modes >> 6) & 3
    of_mode = (modes >> 4) & 3
    ml_mode = (modes >> 2) & 3

    ll_dt, pos = _read_table(ll_mode, src, pos, LL_DEFAULT_NORM,
                             LL_DEFAULT_LOG, MAX_LL_CODE, MAX_LL_LOG,
                             tables.ll)
    of_dt, pos = _read_table(of_mode, src, pos, OF_DEFAULT_NORM,
                             OF_DEFAULT_LOG, MAX_OF_CODE, MAX_OF_LOG,
                             tables.of)
    ml_dt, pos = _read_table(ml_mode, src, pos, ML_DEFAULT_NORM,
                             ML_DEFAULT_LOG, MAX_ML_CODE, MAX_ML_LOG,
                             tables.ml)
    tables.ll, tables.of, tables.ml = ll_dt, of_dt, ml_dt

    br = BackwardBitReader(src[pos:])
    ll_state = br.read(ll_dt.accuracy_log)
    of_state = br.read(of_dt.accuracy_log)
    ml_state = br.read(ml_dt.accuracy_log)

    ll_out = np.empty(nseq, dtype=np.int64)
    of_out = np.empty(nseq, dtype=np.int64)
    ml_out = np.empty(nseq, dtype=np.int64)

    ll_sym, ll_nb, ll_base_t = ll_dt.symbol, ll_dt.nb_bits, ll_dt.base
    of_sym, of_nb, of_base_t = of_dt.symbol, of_dt.nb_bits, of_dt.base
    ml_sym, ml_nb, ml_base_t = ml_dt.symbol, ml_dt.nb_bits, ml_dt.base

    for i in range(nseq):
        ll_code = int(ll_sym[ll_state])
        of_code = int(of_sym[of_state])
        ml_code = int(ml_sym[ml_state])
        if of_code > MAX_OF_CODE:
            raise CorruptError("sequences: offset code out of range")
        # value bits: offset, then match length, then literals length
        of_out[i] = (1 << of_code) + br.read(of_code)
        ml_out[i] = int(ML_BASE[ml_code]) + br.read(int(ML_BITS[ml_code]))
        ll_out[i] = int(LL_BASE[ll_code]) + br.read(int(LL_BITS[ll_code]))
        if i + 1 < nseq:
            # state updates: literals, match, offset
            ll_state = int(ll_base_t[ll_state]) + br.read(int(ll_nb[ll_state]))
            ml_state = int(ml_base_t[ml_state]) + br.read(int(ml_nb[ml_state]))
            of_state = int(of_base_t[of_state]) + br.read(int(of_nb[of_state]))
    if br.bitpos < 0:
        raise CorruptError("sequences: bitstream overread")
    return ll_out, of_out, ml_out


def resolve_offsets(ll: np.ndarray, of_value: np.ndarray,
                    rep: list[int]) -> np.ndarray:
    """Resolve Offset_Value (1-3 = repeat codes) into actual offsets and
    update the repeat-offset history (rep, mutated in place).
    Serial by definition (history dependency); nseq-length host loop.
    """
    n = of_value.size
    out = np.empty(n, dtype=np.int64)
    r0, r1, r2 = rep
    for i in range(n):
        v = int(of_value[i])
        if v > 3:
            off = v - 3
            r2 = r1
            r1 = r0
            r0 = off
        else:
            if int(ll[i]) == 0:
                # shifted repeat codes
                if v == 1:
                    off = r1
                    r1 = r0
                    r0 = off
                elif v == 2:
                    off = r2
                    r2 = r1
                    r1 = r0
                    r0 = off
                else:
                    off = r0 - 1
                    if off <= 0:
                        raise CorruptError("sequences: repeat offset 0")
                    r2 = r1
                    r1 = r0
                    r0 = off
            else:
                if v == 1:
                    off = r0
                elif v == 2:
                    off = r1
                    r1 = r0
                    r0 = off
                else:
                    off = r2
                    r2 = r1
                    r1 = r0
                    r0 = off
        out[i] = off
    rep[0], rep[1], rep[2] = r0, r1, r2
    return out


def execute(literals: np.ndarray, ll: np.ndarray, offsets: np.ndarray,
            ml: np.ndarray, out: np.ndarray, op: int) -> int:
    """Execute sequences into `out` starting at `op` (which may be nonzero:
    earlier frame blocks form the window). Returns the new `op`.

    Reference hot loop: ZSTD_execSequence (zstd_decompress_block.c:1001).
    Literal copies are vectorized; overlapping match copies use the
    period-replication trick.
    """
    lp = 0
    n = ll.size
    cap = out.size
    for i in range(n):
        l = int(ll[i])
        if l:
            if op + l > cap:
                raise CorruptError("sequences: output overflow")
            out[op:op + l] = literals[lp:lp + l]
            lp += l
            op += l
        m = int(ml[i])
        off = int(offsets[i])
        if off > op:
            raise CorruptError("sequences: offset beyond window start")
        if op + m > cap:
            raise CorruptError("sequences: output overflow (match)")
        start = op - off
        if off >= m:
            out[op:op + m] = out[start:start + m]
        else:
            period = out[start:start + off]
            reps = -(-m // off)
            out[op:op + m] = np.tile(period, reps)[:m]
        op += m
    # trailing literals
    rest = literals.size - lp
    if rest:
        if op + rest > cap:
            raise CorruptError("sequences: output overflow (tail literals)")
        out[op:op + rest] = literals[lp:]
        op += rest
    return op
