"""The zstd tensor encoder: a data-parallel parse as tensor code on the
device of the caller's choice (the CUDA card unless `device` names the
CPU), then per-block entropy sections on the host.

The counterpart of tpu7z/models/zstd/compressor.py, giving its bytes.
Behavioral reference: RFC 8878 (format) and the reference encoder's
block loop (ZSTD_compressBlock_internal = ZSTD_buildSeqStore +
ZSTD_entropyCompressSeqStore_internal). Stages:

  parse      `find_sequences_windowed`: segments of `seg_size` bytes,
             each behind up to a window of history; in each, depth-k
             hash-chain candidates from one stable sort (`sort_rows` on
             the card, ops/hash_chain.py), exact match lengths by rolling
             hash probes, a price score, the lazy deferral as a local
             score comparison, and the greedy cursor as a pointer-doubling
             walk of reachability
  split      matches cut at the 128 KiB block boundaries (host)
  entropy    literals (length-limited Huffman, 4 streams) and sequences
             (FSE, predefined or RLE tables) per block (host numpy)

When tracing is on (utils/trace.py), each stage is a span
(`zstd.sort`, `zstd.match_lengths`, `zstd.walk`, `zstd.entropy`) that
synchronizes the card at its ends, so its host-clock time is the
stage's.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from ...ops import hash_chain
from ...ops.bitstream import pack_bits_lsb
from ...ops.hashing import xxh64_native
from ...utils import trace as _trace
from ...utils.errors import ParamError
from . import fse, huffman
from . import sequences as seq_mod
from .frame import MAX_BLOCK_SIZE, write_frame_header

MIN_MATCH = 3
_NO_SCORE = -(1 << 30)


# ---------------------------------------------------------------------------
# Sequence extraction: tensor code
# ---------------------------------------------------------------------------

def _parse_segment(s, base: int, hashlog: int, max_offset: int,
                   depth: int = 2, lazy: int = 0):
    """Best-match parse of s[base:] (a uint8 tensor); candidate sources may
    lie in the history s[:base]. Returns (mpos, mlen, moff), int64
    tensors on s's device, positions relative to s.

    depth-k candidate chains (one stable sort, k sorted-neighbour
    gathers); each candidate's exact length; a price score of 8 bits a
    matched byte less the offset's extra bits; `lazy` one-byte deferrals
    of a match to a strictly better one at the next position; then the
    greedy walk from `base`."""
    n = s.numel()
    dev = s.device
    empty = torch.empty(0, dtype=torch.int64, device=dev)
    if n - base < 16:
        return empty, empty, empty
    with _trace.stage("zstd.sort", dev):
        cands = hash_chain.find_candidates_multi(s, hashlog, depth)
    pos_all = torch.arange(cands[0].numel(), dtype=torch.int64, device=dev)
    return _best_parse(s, cands, (pos_all >= base) & (pos_all <= n - 8), n - pos_all,
                       max_offset, lazy, base)


def _best_parse(s, cands, in_segment, limit, max_offset: int, lazy: int, start):
    """The scoring, lazy rule and walk of `_parse_segment` over the first
    m = len(in_segment) positions of s: each candidate's exact length up
    to `limit`, the best by price, the lazy deferrals, the greedy walk
    from `start` (a position, or ascending positions each starting a walk
    that runs to the next)."""
    n = s.numel()
    dev = s.device
    with _trace.stage("zstd.match_lengths", dev):
        phash = hash_chain.build_prefix_hash(s)
        m = in_segment.numel()
        pos_all = torch.arange(m, dtype=torch.int64, device=dev)
        best_len = torch.zeros(m, dtype=torch.int64, device=dev)
        best_off = torch.zeros(m, dtype=torch.int64, device=dev)
        best_score = torch.full((m,), _NO_SCORE, dtype=torch.int64, device=dev)
        for cand in cands:
            offset = pos_all - cand
            ok = (cand >= 0) & (offset <= max_offset) & in_segment
            mlen = torch.zeros(m, dtype=torch.int64, device=dev)
            vidx = torch.nonzero(ok).flatten()
            if vidx.numel():
                mlen[vidx] = hash_chain.match_lengths_hashed(phash, pos_all[vidx], cand[vidx],
                                                             limit[vidx])
            score = 8 * mlen - hash_chain.floor_log2(offset.clamp(min=1))
            score = torch.where(mlen >= 4, score, _NO_SCORE)
            better = score > best_score
            best_score = torch.where(better, score, best_score)
            best_len = torch.where(better, mlen, best_len)
            best_off = torch.where(better, offset, best_off)
    with _trace.stage("zstd.walk", dev):
        valid = best_len >= 4
        # lazy deferral: a match at p yields to a strictly better one at
        # p + 1 (the cost of deferring, one literal, about 6 bits)
        for _ in range(lazy):
            nxt_score = torch.full_like(best_score, _NO_SCORE)
            nxt_score[:-1] = best_score[1:]
            defer = valid & (nxt_score > best_score + 6)
            defer[:-1] &= valid[1:]
            valid &= ~defer
        next_pos = torch.where(valid, pos_all + best_len, pos_all + 1)
        full_next = torch.full((n,), n, dtype=torch.int64, device=dev)
        full_next[:m] = next_pos
        visited = hash_chain.greedy_walk(full_next, n, start)
        take = visited[:m] & valid
        sel = torch.nonzero(take).flatten()
    return sel, best_len[sel], best_off[sel]


def parse_blocks(s, block_size: int, hashlog: int, depth: int = 2, lazy: int = 0,
                 min_block: int = 16):
    """`_parse_segment(block, 0, hashlog, max_offset >= block_size, depth,
    lazy)` of every `block_size` block of the uint8 tensor `s` at once,
    no match reaching outside its block: the blocks are the rows of one
    candidate sort, a short last block (at least `min_block` bytes) padded
    to a full row, and blocks shorter than that get no matches. The
    scoring runs over the whole input with each block's limits, and one
    walk starts at every block. Returns (mpos, mlen, moff), int64 tensors,
    positions in `s`."""
    n = s.numel()
    dev = s.device
    with _trace.stage("zstd.sort", dev):
        cands = hash_chain.block_candidates(s, block_size, hashlog, depth,
                                            max(min_block, 16))
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    block_end = torch.clamp((pos // block_size + 1) * block_size, max=n)
    starts = torch.arange(0, n, block_size, dtype=torch.int64, device=dev)
    # a block's positions up to 8 before its end, as `_parse_segment`'s
    return _best_parse(s, cands, pos <= block_end - 8, block_end - pos, block_size, lazy,
                       starts)


def find_sequences_windowed(s, hashlog: int, window_log: int, depth: int = 2,
                            lazy: int = 0, seg_size: int = 1 << 22, device=None):
    """Whole-input parse with a sliding history window, on `device` (the
    card unless it names the CPU). `s`: the input, bytes-like, a uint8
    array or a uint8 tensor. Returns (mpos, mlen, moff), int64 tensors on
    the device, tpu7z's arrays.

    Segments bound peak memory: each segment [a, b) is parsed against
    history s[a-hist : a] with hist = min(a, window). Matches never cross
    a segment end, which splits a few matches every `seg_size` bytes."""
    dev = resolve_device(device)
    if isinstance(s, torch.Tensor):
        t = s.to(dev)
    else:
        arr = np.frombuffer(bytes(s), dtype=np.uint8) if not isinstance(
            s, np.ndarray) else s
        t = torch.from_numpy(np.array(arr, dtype=np.uint8)).to(dev)
    n = t.numel()
    window = 1 << window_log
    out_p, out_l, out_o = [], [], []
    for a in range(0, n, seg_size):
        b = min(a + seg_size, n)
        hist = min(a, window)
        mp, ml, mo = _parse_segment(t[a - hist:b], hist, hashlog, window,
                                    depth=depth, lazy=lazy)
        out_p.append(mp + (a - hist))
        out_l.append(ml)
        out_o.append(mo)
    if not out_p:
        empty = torch.empty(0, dtype=torch.int64, device=dev)
        return empty, empty, empty
    return torch.cat(out_p), torch.cat(out_l), torch.cat(out_o)


# ---------------------------------------------------------------------------
# Block split and entropy sections: host code
# ---------------------------------------------------------------------------

def _split_at_block_boundaries(mpos, mlen, moff, block_size):
    """Split matches that straddle a block boundary (a zstd block's
    sequences regenerate exactly that block's bytes; pieces shorter than
    the 3-byte minimum match fall back to literals)."""
    if mpos.size == 0:
        return mpos, mlen, moff
    crosses = (mpos // block_size) != ((mpos + mlen - 1) // block_size)
    if not crosses.any():
        return mpos, mlen, moff
    keep = ~crosses
    pieces_p = [mpos[keep]]
    pieces_l = [mlen[keep]]
    pieces_o = [moff[keep]]
    for p, l, o in zip(mpos[crosses], mlen[crosses], moff[crosses]):
        p, l, o = int(p), int(l), int(o)
        while l > 0:
            room = block_size - (p % block_size)
            take = min(l, room)
            if take >= MIN_MATCH:
                pieces_p.append(np.array([p], dtype=np.int64))
                pieces_l.append(np.array([take], dtype=np.int64))
                pieces_o.append(np.array([o], dtype=np.int64))
            p += take
            l -= take
    mp = np.concatenate(pieces_p)
    order = np.argsort(mp, kind="stable")
    return (mp[order], np.concatenate(pieces_l)[order],
            np.concatenate(pieces_o)[order])


# ---------------------------------------------------------------------------
# Literals section encode
# ---------------------------------------------------------------------------

def _encode_literals(lits: np.ndarray) -> bytes:
    """Emit a Literals_Section (choosing Raw / RLE / Compressed)."""
    n = lits.size
    raw = _literals_raw(lits)
    if n == 0:
        return raw
    if np.all(lits == lits[0]):
        return _literals_rle(int(lits[0]), n)
    if n < 32:
        return raw
    hist = np.bincount(lits, minlength=256)
    built = huffman.build_weights(hist)
    if built is None:
        return raw
    weights, nsym = built
    tree = huffman.write_tree_description(weights, nsym)
    if tree is None:
        return raw
    code_val, code_bits, _tl = huffman.build_encode_table(weights)

    use_4 = n >= 256
    if use_4:
        n123 = (n + 3) // 4
        parts = [lits[0:n123], lits[n123:2 * n123], lits[2 * n123:3 * n123],
                 lits[3 * n123:]]
        streams = []
        for p in parts:
            streams.append(_huf_stream(p, code_val, code_bits))
        jump = b"".join(len(x).to_bytes(2, "little") for x in streams[:3])
        payload = tree + jump + b"".join(streams)
    else:
        payload = tree + _huf_stream(lits, code_val, code_bits)
    hdr = _literals_comp_header(n, len(payload), use_4)
    if hdr is None or len(hdr) + len(payload) >= len(raw):
        return raw
    return hdr + payload


def _huf_stream(symbols: np.ndarray, code_val, code_bits) -> bytes:
    """One Huffman stream: symbols written in reverse order so the
    backward-reading decoder emits them forward."""
    vals = code_val[symbols].astype(np.uint64)[::-1]
    nbs = code_bits[symbols].astype(np.int64)[::-1]
    return pack_bits_lsb(vals, nbs, end_marker=True)


def _literals_raw(lits: np.ndarray) -> bytes:
    n = lits.size
    if n < 32:
        hdr = bytes([(n << 3) | 0])  # size_format 00, type raw
    elif n < 4096:
        hdr = bytes([((n & 0xF) << 4) | (1 << 2) | 0, (n >> 4) & 0xFF])
    else:
        hdr = bytes([((n & 0xF) << 4) | (3 << 2) | 0, (n >> 4) & 0xFF,
                     (n >> 12) & 0xFF])
    return hdr + lits.tobytes()


def _literals_rle(byte: int, n: int) -> bytes:
    if n < 32:
        hdr = bytes([(n << 3) | 1])
    elif n < 4096:
        hdr = bytes([((n & 0xF) << 4) | (1 << 2) | 1, (n >> 4) & 0xFF])
    else:
        hdr = bytes([((n & 0xF) << 4) | (3 << 2) | 1, (n >> 4) & 0xFF,
                     (n >> 12) & 0xFF])
    return hdr + bytes([byte])


def _literals_comp_header(regen: int, csize: int, four: bool):
    if not four:
        if regen > 1023 or csize > 1023:
            return None
        h = 2 | (0 << 2) | (regen << 4) | (csize << 14)
        return h.to_bytes(3, "little")
    if regen <= 1023 and csize <= 1023:
        h = 2 | (1 << 2) | (regen << 4) | (csize << 14)
        return h.to_bytes(3, "little")
    if regen <= 0x3FFF and csize <= 0x3FFF:
        h = 2 | (2 << 2) | (regen << 4) | (csize << 18)
        return h.to_bytes(4, "little")
    if regen <= 0x3FFFF and csize <= 0x3FFFF:
        h = 2 | (3 << 2) | (regen << 4) | (csize << 22)
        return h.to_bytes(5, "little")
    return None


# ---------------------------------------------------------------------------
# Sequences section encode
# ---------------------------------------------------------------------------

def _offset_values_with_reps(ll: np.ndarray, moff: np.ndarray,
                             rep: list) -> np.ndarray:
    """Map offsets to Offset_Values, using repeat-offset codes 1-3 when the
    offset matches the history (RFC 8878 3.1.1.3.2.1.1 update rules,
    mirrored from the decoder's resolve_offsets). `rep` is the frame-wide
    history, mutated in place (it persists across blocks)."""
    n = moff.size
    out = [0] * n
    offs, lls = moff.tolist(), ll.tolist()
    r0, r1, r2 = rep
    for i in range(n):
        off = offs[i]
        has_lit = lls[i] != 0
        if has_lit:
            if off == r0:
                out[i] = 1
                continue
            if off == r1:
                out[i] = 2
                r1, r0 = r0, off
                continue
            if off == r2:
                out[i] = 3
                r2, r1, r0 = r1, r0, off
                continue
        else:
            if off == r1:
                out[i] = 1
                r1, r0 = r0, off
                continue
            if off == r2:
                out[i] = 2
                r2, r1, r0 = r1, r0, off
                continue
            if off == r0 - 1:
                out[i] = 3
                r2, r1, r0 = r1, r0, off
                continue
        out[i] = off + 3
        r2, r1, r0 = r1, r0, off
    rep[0], rep[1], rep[2] = r0, r1, r2
    return np.array(out, dtype=np.int64)


def _seq_count_bytes(nseq: int) -> bytes:
    if nseq < 128:
        return bytes([nseq])
    if nseq < 0x7F00:
        return bytes([128 + (nseq >> 8), nseq & 0xFF])
    return bytes([255, (nseq - 0x7F00) & 0xFF, ((nseq - 0x7F00) >> 8) & 0xFF])


def _choose_table(codes: np.ndarray, max_sym: int, max_log: int,
                  default_norm, default_log):
    """Pick (mode, header_bytes, ctable) for one code stream."""
    nseq = codes.size
    hist = np.bincount(codes, minlength=max_sym + 1)
    used = np.nonzero(hist)[0]
    if used.size == 1:
        # RLE mode
        return (seq_mod.MODE_RLE, bytes([int(used[0])]),
                _rle_ctable(int(used[0])))
    predef_ok = used[-1] < default_norm.size and np.all(
        default_norm[used] != 0)
    if nseq < 32 and predef_ok:
        ct = fse.build_ctable(default_norm, default_log)
        return seq_mod.MODE_PREDEFINED, b"", ct
    # custom table
    tl = max(5, min(max_log, (int(nseq) - 1).bit_length() - 2))
    min_tl = max(1, (int(used.size) - 1).bit_length())
    tl = max(tl, min_tl)
    tl = min(tl, max_log)
    norm = fse.normalize_counts(hist, tl, nseq, int(used[-1]))
    header = fse.write_ncount(norm, tl)
    ct = fse.build_ctable(norm, tl)
    # compare with predefined cost (approx: header size vs entropy delta)
    if predef_ok:
        pd_norm = default_norm.astype(np.float64)
        pd_p = np.where(pd_norm < 0, 0.5, pd_norm) / (1 << default_log)
        cu_p = np.where(norm < 0, 0.5, norm).astype(np.float64) / (1 << tl)
        h = hist[used].astype(np.float64)
        pd_cost = -np.sum(h * np.log2(pd_p[used]))
        cu_cost = -np.sum(h * np.log2(np.maximum(cu_p[used], 1e-9))) \
            + 8 * len(header)
        if pd_cost <= cu_cost:
            ct = fse.build_ctable(default_norm, default_log)
            return seq_mod.MODE_PREDEFINED, b"", ct
    return seq_mod.MODE_FSE, header, ct


def _rle_ctable(symbol: int):
    """Encoder-side stub for RLE mode: state emits 0 bits."""
    class _RLE:
        accuracy_log = 0

        class _Enc:
            def __init__(self):
                self.state = 0

            def encode(self, sym):
                return (0, 0)

            def flush(self):
                return (0, 0)
    return _RLE()


class _EncState:
    def __init__(self, ct, first_symbol):
        if isinstance(ct, fse.CTable):
            self.enc = fse.Encoder(ct, first_symbol)
        else:
            self.enc = ct._Enc()
        self.encode = self.enc.encode
        self.flush = self.enc.flush


def _encode_sequences(ll: np.ndarray, moff: np.ndarray,
                      ml: np.ndarray, rep: list) -> bytes:
    """Emit a Sequences_Section for matches (offset in plain form)."""
    nseq = ml.size
    out = bytearray(_seq_count_bytes(nseq))
    if nseq == 0:
        return bytes(out)

    ll_codes = seq_mod.ll_code_of(ll)
    ml_codes = seq_mod.ml_code_of(ml)
    of_values = _offset_values_with_reps(ll, moff, rep)
    of_codes = seq_mod.of_code_of(of_values)

    ll_mode, ll_hdr, ll_ct = _choose_table(
        ll_codes, seq_mod.MAX_LL_CODE, seq_mod.MAX_LL_LOG,
        seq_mod.LL_DEFAULT_NORM, seq_mod.LL_DEFAULT_LOG)
    of_mode, of_hdr, of_ct = _choose_table(
        of_codes, seq_mod.MAX_OF_CODE, seq_mod.MAX_OF_LOG,
        seq_mod.OF_DEFAULT_NORM, seq_mod.OF_DEFAULT_LOG)
    ml_mode, ml_hdr, ml_ct = _choose_table(
        ml_codes, seq_mod.MAX_ML_CODE, seq_mod.MAX_ML_LOG,
        seq_mod.ML_DEFAULT_NORM, seq_mod.ML_DEFAULT_LOG)

    out.append((ll_mode << 6) | (of_mode << 4) | (ml_mode << 2))
    out += ll_hdr
    out += of_hdr
    out += ml_hdr

    # extra-bit values
    ll_bits = seq_mod.LL_BITS[ll_codes]
    ll_extra = ll - seq_mod.LL_BASE[ll_codes]
    ml_bits = seq_mod.ML_BITS[ml_codes]
    ml_extra = ml - seq_mod.ML_BASE[ml_codes]
    of_bits = of_codes
    of_extra = of_values - (np.int64(1) << of_codes)

    # the interleaved-state stream, last sequence first, as (value, nbits)
    # pairs; the per-sequence loop reads Python lists
    llc, mlc, ofc = ll_codes.tolist(), ml_codes.tolist(), of_codes.tolist()
    lle, llb = ll_extra.tolist(), ll_bits.tolist()
    mle, mlb = ml_extra.tolist(), ml_bits.tolist()
    ofe, ofb = of_extra.tolist(), of_bits.tolist()
    last = nseq - 1
    enc_ml = _EncState(ml_ct, mlc[last])
    enc_of = _EncState(of_ct, ofc[last])
    enc_ll = _EncState(ll_ct, llc[last])
    pairs = [(lle[last], llb[last]), (mle[last], mlb[last]), (ofe[last], ofb[last])]
    put = pairs.append
    of_encode, ml_encode, ll_encode = enc_of.encode, enc_ml.encode, enc_ll.encode
    for i in range(nseq - 2, -1, -1):
        put(of_encode(ofc[i]))
        put(ml_encode(mlc[i]))
        put(ll_encode(llc[i]))
        put((lle[i], llb[i]))
        put((mle[i], mlb[i]))
        put((ofe[i], ofb[i]))
    pairs.append(enc_ml.flush())
    pairs.append(enc_of.flush())
    pairs.append(enc_ll.flush())

    vals, nbs = zip(*pairs)
    vals = np.array(vals, dtype=np.uint64)
    nbs = np.array(nbs, dtype=np.int64)
    out += pack_bits_lsb(vals, nbs, end_marker=True)
    return bytes(out)


# ---------------------------------------------------------------------------
# Block + frame drivers
# ---------------------------------------------------------------------------

def compress_block_body_seqs(s: np.ndarray, mpos: np.ndarray,
                             mlen: np.ndarray, moff: np.ndarray,
                             rep: list) -> bytes | None:
    """Build a Compressed_Block body from pre-found sequences (positions
    relative to the block start; offsets may reach back past it into the
    frame window). None if expansion — the caller emits a raw block and
    must leave `rep` untouched (snapshot/restore), since the decoder's
    repeat-offset history only advances on decoded sequences."""
    n = s.size
    rep_snap = list(rep)
    if mpos.size:
        lit_starts = np.concatenate([[0], mpos + mlen])
        lit_lens = np.concatenate([mpos, [n]]) - lit_starts
        ll = lit_lens[:-1]
        # literals = all bytes not covered by matches
        keep = np.ones(n, dtype=bool)
        cover_idx = _runs_to_indices(mpos, mlen)
        keep[cover_idx] = False
        lits = s[keep]
    else:
        ll = np.empty(0, dtype=np.int64)
        lits = s
    lit_sec = _encode_literals(lits)
    seq_sec = _encode_sequences(ll, moff, mlen, rep)
    body = lit_sec + seq_sec
    if len(body) >= n:
        rep[0], rep[1], rep[2] = rep_snap
        return None
    return body


def _runs_to_indices(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    base = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    within = np.arange(total) - np.repeat(base, lengths)
    return np.repeat(starts, lengths) + within


def _level_params(level: int, n: int) -> tuple[int, int, int, int]:
    """(hashlog, depth, window_log, lazy) per compression level, as
    tpu7z's `_level_params` (compressor.py:517) gives them: the role of the
    reference's ZSTD_defaultCParameters table, chosen for this matcher."""
    nbits = max(10, (max(n, 1) - 1).bit_length())
    if level <= 1:
        hl, depth, wlog, lazy = 16, 1, 19, 0
    elif level <= 3:
        hl, depth, wlog, lazy = 17, 2, 21, 0
    elif level <= 6:
        hl, depth, wlog, lazy = 17, 3, 21, 1
    elif level <= 11:
        hl, depth, wlog, lazy = 18, 6, 22, 1
    elif level <= 16:
        hl, depth, wlog, lazy = 19, 10, 23, 2
    else:
        hl, depth, wlog, lazy = 20, 16, 24, 2
    return hl, depth, min(wlog, nbits), lazy


def compress(data: bytes, level: int = 3, checksum: bool = True,
             block_size: int = MAX_BLOCK_SIZE, window_log: int | None = None,
             device=None) -> bytes:
    """One zstd frame of `data`: one windowed parse over the whole input on
    `device` (matches reach back across block boundaries up to the
    window), then the entropy sections of each block on the host."""
    if level < -7 or level > 22:
        raise ParamError(f"zstd level {level} out of range")
    dev = resolve_device(device)
    s = np.frombuffer(bytes(data), dtype=np.uint8)
    n = s.size
    hashlog, depth, wlog, lazy = _level_params(level, n)
    if window_log is not None:
        if not 10 <= window_log <= 31:
            raise ParamError(f"zstd window log {window_log} out of range")
        wlog = window_log
    out = bytearray(write_frame_header(n, checksum=checksum))
    if n == 0:
        out += bytes([0x01, 0x00, 0x00])  # last, raw, size 0
    else:
        mpos, mlen, moff = (t.cpu().numpy() for t in find_sequences_windowed(
            s, hashlog, wlog, depth=depth, lazy=lazy, device=dev))
        with _trace.stage("zstd.entropy", torch.device("cpu")):
            out += _blocks(s, mpos, mlen, moff, block_size)
    if checksum:
        out += (xxh64_native(s) & 0xFFFFFFFF).to_bytes(4, "little")
    return bytes(out)


def _blocks(s, mpos, mlen, moff, block_size: int) -> bytes:
    """The frame's blocks from the whole input's sequences: a match that
    straddles a block boundary is cut there; a block of one repeated
    byte is an RLE block, a block that would not shrink a raw one."""
    n = s.size
    out = bytearray()
    mpos, mlen, moff = _split_at_block_boundaries(mpos, mlen, moff, block_size)
    rep = [1, 4, 8]  # repeat-offset history persists across blocks
    nblocks = -(-n // block_size)
    for b in range(nblocks):
        bs = b * block_size
        chunk = s[bs:bs + block_size]
        last = 1 if b == nblocks - 1 else 0
        sel = slice(np.searchsorted(mpos, bs, "left"),
                    np.searchsorted(mpos, bs + chunk.size, "left"))
        if np.all(chunk == chunk[0]) and chunk.size >= 8:
            bh = last | (1 << 1) | (chunk.size << 3)
            out += bh.to_bytes(3, "little")
            out.append(int(chunk[0]))
            continue
        body = compress_block_body_seqs(
            chunk, mpos[sel] - bs, mlen[sel], moff[sel], rep)
        if body is None:
            bh = last | (0 << 1) | (chunk.size << 3)
            out += bh.to_bytes(3, "little")
            out += chunk.tobytes()
        else:
            bh = last | (2 << 1) | (len(body) << 3)
            out += bh.to_bytes(3, "little")
            out += body
    return bytes(out)
