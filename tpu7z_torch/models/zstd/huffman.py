"""Huffman coding for zstd literals.

Behavioral reference: RFC 8878 section 4.2 and C/zstd/huf_compress.c /
huf_decompress.c (HUF_readStats, HUF_buildCTable, HUF_compress4X,
HUF_decompress4X1). Written from the format spec.

Weights: symbol weight w>0 means code length = table_log + 1 - w; the last
symbol's weight is implied by the power-of-two completion rule. The decode
table lays symbols out by ascending (weight, symbol); the encode code for
symbol s is its table start slot >> (table_log - nbits) — both sides share
one canonical layout, so encode and decode are provably consistent.

The plain decoder's streams go through the bit-position chain decoder
(ops/bitchain.py, literals.py). Host code (tpu7z/models/zstd/huffman.py).
"""

from __future__ import annotations

import numpy as np

from ...ops.bitstream import (BackwardBitReader, ForwardBitReader,
                              pack_bits_lsb)
from ...utils.errors import CorruptError
from . import fse

MAX_TABLE_LOG = 11  # encoder limit (RFC: max code length 11)
MAX_TABLE_LOG_DECODE = 12
MAX_SYMBOLS = 256


# ---------------------------------------------------------------------------
# Tree (weights) description
# ---------------------------------------------------------------------------

def read_tree_description(src: bytes):
    """Parse a Huffman_Tree_Description. Returns (weights[256], consumed).

    weights includes the implied last symbol. header byte >= 128 => direct
    4-bit weights; else FSE-compressed weights with two interleaved states.
    """
    if len(src) < 1:
        raise CorruptError("huffman: empty tree description")
    hdr = src[0]
    if hdr >= 128:
        num = hdr - 127
        nbytes = (num + 1) // 2
        if len(src) < 1 + nbytes:
            raise CorruptError("huffman: truncated direct weights")
        w = np.zeros(MAX_SYMBOLS, dtype=np.int64)
        payload = src[1:1 + nbytes]
        for i in range(num):
            b = payload[i // 2]
            w[i] = (b >> 4) if i % 2 == 0 else (b & 0xF)
        consumed = 1 + nbytes
        nsym_explicit = num
    else:
        csize = hdr
        if len(src) < 1 + csize:
            raise CorruptError("huffman: truncated FSE weights")
        payload = src[1:1 + csize]
        w_list = _fse_decode_weights(payload)
        if len(w_list) > 255:
            raise CorruptError("huffman: too many weights")
        w = np.zeros(MAX_SYMBOLS, dtype=np.int64)
        w[: len(w_list)] = w_list
        consumed = 1 + csize
        nsym_explicit = len(w_list)

    # implied last weight: total must complete to a power of two
    total = int(np.sum(np.where(w > 0, 1 << (w - 1), 0)))
    if total == 0:
        raise CorruptError("huffman: all-zero weights")
    table_log = total.bit_length()  # smallest L with 2^L > total
    if table_log > MAX_TABLE_LOG_DECODE:
        raise CorruptError("huffman: table log too large")
    rest = (1 << table_log) - total
    if rest & (rest - 1):
        raise CorruptError("huffman: weights do not complete a power of 2")
    last_weight = rest.bit_length()  # log2(rest) + 1
    if nsym_explicit >= MAX_SYMBOLS:
        raise CorruptError("huffman: symbol overflow")
    w[nsym_explicit] = last_weight
    return w, consumed


def _fse_decode_weights(payload: bytes):
    """FSE-decompress huffman weights: forward ncount, then a backward
    stream with two interleaved states (reference: FSE_decompress flow in
    HUF_readStats)."""
    r = ForwardBitReader(payload)
    counts, acc_log = fse.read_ncount(r, max_symbol=255, max_accuracy=6)
    hdr = r.bytes_consumed()
    dt = fse.build_dtable(counts, acc_log)
    stream = payload[hdr:]
    br = BackwardBitReader(stream)
    s1 = br.read(acc_log)
    s2 = br.read(acc_log)
    if br.bitpos < 0:
        raise CorruptError("huffman weights: stream too short")
    out = []
    states = [s1, s2]
    i = 0
    # Alternate states, each step emitting a symbol then transitioning
    # (reading bits). Decoding ends when a transition overreads the
    # stream: the other state then flushes its final symbol.
    # (Reference semantics: FSE_decompress_usingDTable_generic tail loop.)
    while len(out) <= 255:
        st = states[i & 1]
        out.append(int(dt.symbol[st]))
        states[i & 1] = int(dt.base[st]) + br.read(int(dt.nb_bits[st]))
        if br.bitpos < 0:
            out.append(int(dt.symbol[states[(i + 1) & 1]]))
            return out
        i += 1
    raise CorruptError("huffman weights: no termination")


def write_tree_description(weights: np.ndarray, nsym: int) -> bytes:
    """Serialize weights for symbols [0, nsym) (the last nonzero weight is
    implied and must not be written). Direct 4-bit form for robustness;
    FSE-compressed form is used when it is smaller."""
    # find last symbol with nonzero weight: implied, not written
    nz = np.nonzero(weights[:nsym])[0]
    if nz.size == 0:
        raise ValueError("huffman: no symbols")
    last = int(nz[-1])
    to_write = weights[:last]
    direct = _write_weights_direct(to_write) if to_write.size < 128 else None
    fse_form = _write_weights_fse(to_write)
    if fse_form is not None and (direct is None or len(fse_form) < len(direct)):
        return fse_form
    if direct is None:
        return None
    return direct


def _write_weights_direct(to_write: np.ndarray) -> bytes:
    num = int(to_write.size)
    out = bytearray([127 + num])
    for i in range(0, num, 2):
        hi = int(to_write[i]) & 0xF
        lo = int(to_write[i + 1]) & 0xF if i + 1 < num else 0
        out.append((hi << 4) | lo)
    return bytes(out)


def _write_weights_fse(to_write: np.ndarray):
    """FSE-compress the weight stream (two interleaved states), as
    HUF_compressWeights does. Returns None when not representable/beneficial."""
    n = int(to_write.size)
    if n <= 1:
        return None
    hist = np.bincount(to_write.astype(np.int64), minlength=1)
    max_sym = int(np.max(to_write))
    if int((hist > 0).sum()) < 2:
        return None  # RLE-ish; direct form is fine at these sizes
    table_log = min(6, max(1, (n - 1).bit_length() - 1 or 1))
    # choose accuracy: smallest covering distribution, capped at 6
    table_log = min(6, max(table_log, (int(hist[hist > 0].size) - 1).bit_length()))
    try:
        norm = fse.normalize_counts(hist, table_log, n, max_sym)
    except Exception:
        return None
    header = fse.write_ncount(norm, table_log)
    ct = fse.build_ctable(norm, table_log)
    # encode: two interleaved states, symbols written in reverse order.
    # Decode order alternates states starting with state1; mirror exactly.
    syms = to_write.astype(np.int64)
    e1_syms = syms[0::2][::-1]  # state1's symbols (even positions), last first
    e2_syms = syms[1::2][::-1]
    enc1 = fse.Encoder(ct, int(e1_syms[0]))
    enc2 = fse.Encoder(ct, int(e2_syms[0])) if e2_syms.size else None
    pairs = []
    # Decoder bit-read order: init1, init2, then the transition after each
    # decoded symbol k (k = 0..n-3; the final two symbols flush without
    # reads). The encoder therefore writes trans(n-3)..trans(0), then
    # init2, init1. trans(k) is emitted by encoding syms[k] on the state
    # that owns position k (state1 for even k).
    for k in range(n - 3, -1, -1):
        enc = enc1 if (k & 1) == 0 else enc2
        v, nb = enc.encode(int(syms[k]))
        pairs.append((v, nb))
    # final states: decoder reads init1 first, then init2 => write init2
    # then init1
    if enc2 is not None:
        v, nb = enc2.flush()
        pairs.append((v, nb))
    v, nb = enc1.flush()
    pairs.append((v, nb))
    vals = np.array([p[0] for p in pairs], dtype=np.uint64)
    nbs = np.array([p[1] for p in pairs], dtype=np.int64)
    stream = pack_bits_lsb(vals, nbs, end_marker=True)
    payload = header + stream
    if len(payload) >= 128 or len(payload) >= n:
        return None
    # safety: the overread-terminated decode rule can overshoot for
    # pathological nb==0 tails; verify the exact round-trip
    try:
        back = _fse_decode_weights(payload)
    except CorruptError:
        return None
    if len(back) != n or any(int(b) != int(s) for b, s in zip(back, syms)):
        return None
    return bytes([len(payload)]) + payload


# ---------------------------------------------------------------------------
# Table construction (shared canonical layout)
# ---------------------------------------------------------------------------

def table_log_from_weights(weights: np.ndarray) -> int:
    total = int(np.sum(np.where(weights > 0, 1 << (weights - 1), 0)))
    if total == 0 or total & (total - 1):
        raise CorruptError("huffman: invalid weight sum")
    return total.bit_length() - 1


def build_decode_table(weights: np.ndarray):
    """Returns (sym_of_peek, nbits_of_peek, table_log): arrays of size
    2^table_log indexed by the peeked table_log bits."""
    table_log = table_log_from_weights(weights)
    size = 1 << table_log
    sym = np.zeros(size, dtype=np.int32)
    nb = np.zeros(size, dtype=np.int32)
    # canonical layout: ascending (weight, symbol)
    pos = 0
    for w in range(1, table_log + 1):
        symbols = np.nonzero(weights == w)[0]
        span = 1 << (w - 1)
        for s in symbols:
            sym[pos: pos + span] = s
            nb[pos: pos + span] = table_log + 1 - w
            pos += span
    if pos != size:
        raise CorruptError("huffman: decode table underfilled")
    return sym, nb, table_log


def build_encode_table(weights: np.ndarray):
    """Returns (code_value[256], code_bits[256], table_log), consistent with
    build_decode_table: code = start_slot >> (table_log - nbits)."""
    table_log = table_log_from_weights(weights)
    code_val = np.zeros(MAX_SYMBOLS, dtype=np.uint32)
    code_bits = np.zeros(MAX_SYMBOLS, dtype=np.int32)
    pos = 0
    for w in range(1, table_log + 1):
        symbols = np.nonzero(weights == w)[0]
        span = 1 << (w - 1)
        nbits = table_log + 1 - w
        for s in symbols:
            code_val[s] = pos >> (table_log - nbits)
            code_bits[s] = nbits
            pos += span
    return code_val, code_bits, table_log


# ---------------------------------------------------------------------------
# Weight assignment (encoder): length-limited Huffman via package-merge
# ---------------------------------------------------------------------------

def build_weights(hist: np.ndarray, max_bits: int = MAX_TABLE_LOG):
    """Optimal length-limited code lengths (package-merge), returned as
    zstd weights. Replaces HUF_buildCTable's heuristic with the optimal
    algorithm — compressed size <= reference for the same literals.

    Returns (weights[256], nsym) or None when <2 distinct symbols.
    """
    hist = np.asarray(hist, dtype=np.int64)
    syms = np.nonzero(hist)[0]
    if syms.size < 2:
        return None
    if syms.size > (1 << max_bits):
        raise ValueError("alphabet larger than 2^max_bits")
    lengths = _package_merge(hist[syms], max_bits)
    max_len = int(lengths.max())
    weights = np.zeros(MAX_SYMBOLS, dtype=np.int64)
    weights[syms] = max_len + 1 - lengths
    nsym = int(syms[-1]) + 1
    return weights, nsym


def _package_merge(freqs: np.ndarray, max_bits: int) -> np.ndarray:
    """Package-merge: optimal code lengths bounded by max_bits."""
    n = freqs.size
    order = np.argsort(freqs, kind="stable")
    sorted_f = freqs[order].astype(np.int64)
    # each level: list of (weight, set-of-leaf-counts as array)
    lengths = np.zeros(n, dtype=np.int64)
    # packages as (weight, leaf_count_vector) — use index lists for speed
    level_items = []  # items at current level: (weight, leaves list)
    prev = []
    for _level in range(max_bits):
        items = [(int(sorted_f[i]), (i,)) for i in range(n)]
        # merge with packaged pairs from previous level
        merged = sorted(items + prev, key=lambda t: t[0])
        # package pairs for next level
        prev = []
        for i in range(0, len(merged) - 1, 2):
            a, b = merged[i], merged[i + 1]
            prev.append((a[0] + b[0], a[1] + b[1]))
        level_items = merged
    # take first 2n-2 items of the final level
    take = 2 * n - 2
    counts = np.zeros(n, dtype=np.int64)
    for w, leaves in level_items[:take]:
        for leaf in leaves:
            counts[leaf] += 1
    lengths[order] = counts
    return lengths
