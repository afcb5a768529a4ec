"""LZ4 raw block decoder and sequence emitter (host numpy).

Format (lz4_Block_format):
  sequence := token(1) [litlen-ext 255*] literals [offset u16le]
              [matchlen-ext 255*]
  token    := (litlen:4 | matchlen-4:4), 15 in a nibble => extension bytes
"""

from __future__ import annotations

import numpy as np

MIN_MATCH = 4


class CorruptError(ValueError):
    """The input violates the LZ4 format."""


def decompress_block(src, dst_size: int | None = None,
                     cap_hint: int | None = None) -> bytes:
    """Decode one raw LZ4 block: a host loop over sequences with
    vectorized literal and match copies (period trick for overlaps).

    dst_size: the exact decoded size, enforced. cap_hint: an upper bound
    only, such as the frame's block size.
    """
    s = np.frombuffer(bytes(src), dtype=np.uint8)
    n = s.size
    if dst_size is not None:
        cap = dst_size
    elif cap_hint is not None:
        cap = cap_hint
    else:
        cap = max(64, n * 255)
    out = np.empty(cap, dtype=np.uint8)
    ip = 0
    op = 0
    while ip < n:
        token = int(s[ip]); ip += 1
        litlen = token >> 4
        if litlen == 15:
            while True:
                if ip >= n:
                    raise CorruptError("lz4: truncated literal length")
                b = int(s[ip]); ip += 1
                litlen += b
                if b != 255:
                    break
        if ip + litlen > n:
            raise CorruptError("lz4: literal run past input end")
        if op + litlen > cap:
            raise CorruptError("lz4: output overflow (literals)")
        out[op:op + litlen] = s[ip:ip + litlen]
        ip += litlen
        op += litlen
        if ip == n:
            break  # last sequence has no match part
        if ip + 2 > n:
            raise CorruptError("lz4: truncated offset")
        offset = int(s[ip]) | (int(s[ip + 1]) << 8)
        ip += 2
        if offset == 0 or offset > op:
            raise CorruptError("lz4: invalid offset")
        mlen = (token & 15) + MIN_MATCH
        if (token & 15) == 15:
            while True:
                if ip >= n:
                    raise CorruptError("lz4: truncated match length")
                b = int(s[ip]); ip += 1
                mlen += b
                if b != 255:
                    break
        if op + mlen > cap:
            raise CorruptError("lz4: output overflow (match)")
        start = op - offset
        if offset >= mlen:
            out[op:op + mlen] = out[start:start + mlen]
        else:
            # overlapping copy: output repeats with period `offset`
            period = out[start:start + offset]
            reps = -(-mlen // offset)
            out[op:op + mlen] = np.tile(period, reps)[:mlen]
        op += mlen
    if dst_size is not None and op != dst_size:
        raise CorruptError(f"lz4: decoded {op} bytes, expected {dst_size}")
    return out[:op].tobytes()


def merge_adjacent_matches(mpos: np.ndarray, mlen: np.ndarray,
                           moff: np.ndarray):
    """Merge chains of matches where one ends exactly where the next
    starts with the same offset. The device match finder caps lengths at
    ops.match.ML_CAP; merging restores arbitrarily long matches."""
    k = mpos.size
    if k == 0:
        return mpos, mlen, moff
    joins = (mpos[1:] == mpos[:-1] + mlen[:-1]) & (moff[1:] == moff[:-1])
    # group id increments where a new chain starts
    group = np.concatenate([[0], np.cumsum(~joins)])
    starts = np.full(int(group[-1]) + 1, k, dtype=np.int64)
    np.minimum.at(starts, group, np.arange(k))
    first = starts  # index of first match in each group
    total = np.zeros(first.size, dtype=np.int64)
    np.add.at(total, group, mlen)
    return mpos[first], total, moff[first]


def _lsic_count(x: np.ndarray) -> np.ndarray:
    """Number of extension bytes for a length value already >= 15."""
    return (x - 15) // 255 + 1


def _emit_sequences(s: np.ndarray, mpos: np.ndarray, mlen: np.ndarray,
                    moff: np.ndarray) -> bytes:
    """Serialize sequences: matches at mpos (sorted), literals in gaps,
    trailing literal-only sequence. Vectorized via per-sequence size
    computation, prefix-sum placement and grouped scatters.
    """
    n = s.size
    k = mpos.size
    # literal run start for sequence i = end of previous match
    lit_start = np.empty(k + 1, dtype=np.int64)
    lit_start[0] = 0
    if k:
        lit_start[1:] = mpos + mlen
    lit_len = np.empty(k + 1, dtype=np.int64)
    lit_len[:k] = mpos - lit_start[:k]
    lit_len[k] = n - lit_start[k]

    tok_lit = np.minimum(lit_len, 15)
    lit_ext = np.where(lit_len >= 15, _lsic_count(lit_len), 0)
    ml_code = np.zeros(k + 1, dtype=np.int64)
    ml_ext = np.zeros(k + 1, dtype=np.int64)
    if k:
        mcode = mlen - MIN_MATCH
        ml_code[:k] = np.minimum(mcode, 15)
        ml_ext[:k] = np.where(mcode >= 15, _lsic_count(mcode), 0)

    has_match = np.zeros(k + 1, dtype=np.int64)
    has_match[:k] = 1
    seq_size = 1 + lit_ext + lit_len + has_match * 2 + ml_ext
    seq_off = np.concatenate([[0], np.cumsum(seq_size)])
    total = int(seq_off[-1])
    out = np.zeros(total, dtype=np.uint8)

    # tokens
    out[seq_off[:-1]] = ((tok_lit << 4) | ml_code).astype(np.uint8)

    # literal-length extension bytes: lit_ext[i] bytes after the token;
    # all are 255 except the last, which is (lit_len-15) % 255
    _scatter_ext(out, seq_off[:-1] + 1, lit_ext, lit_len - 15)

    # literals
    lit_dst = seq_off[:-1] + 1 + lit_ext
    _scatter_runs(out, lit_dst, s, lit_start, lit_len)

    if k:
        # offsets (u16le) after the literals
        off_dst = (lit_dst + lit_len)[:k]
        out[off_dst] = (moff & 0xFF).astype(np.uint8)
        out[off_dst + 1] = (moff >> 8).astype(np.uint8)
        # match length extension bytes
        _scatter_ext(out, off_dst + 2, ml_ext[:k], (mlen - MIN_MATCH) - 15)
    return out.tobytes()


def _scatter_ext(out: np.ndarray, dst: np.ndarray, count: np.ndarray,
                 rem_value: np.ndarray) -> None:
    """Write `count[i]` extension bytes at dst[i]: (count-1) bytes of 255
    then rem_value[i] % 255 ... per LZ4's LSIC: value v >= 15 encodes as
    255 repeated (v-15)//255 times, then (v-15)%255.
    """
    sel = np.where(count > 0)[0]
    if sel.size == 0:
        return
    cnt = count[sel]
    starts = dst[sel]
    rem = rem_value[sel] % 255
    total = int(cnt.sum())
    # destination indices: for each i, starts[i] + [0..cnt[i])
    reps = np.repeat(starts, cnt)
    within = np.arange(total) - np.repeat(np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
    idx = reps + within
    vals = np.full(total, 255, dtype=np.uint8)
    last_pos = np.cumsum(cnt) - 1
    vals[last_pos] = rem.astype(np.uint8)
    out[idx] = vals


def _scatter_runs(out: np.ndarray, dst: np.ndarray, src: np.ndarray,
                  src_start: np.ndarray, length: np.ndarray) -> None:
    """Copy src[src_start[i] : +length[i]] to out[dst[i] : +length[i]]."""
    sel = np.where(length > 0)[0]
    if sel.size == 0:
        return
    ln = length[sel]
    total = int(ln.sum())
    base = np.concatenate([[0], np.cumsum(ln)[:-1]])
    within = np.arange(total) - np.repeat(base, ln)
    out[np.repeat(dst[sel], ln) + within] = src[np.repeat(src_start[sel], ln) + within]
