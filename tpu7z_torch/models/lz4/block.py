"""The LZ4 raw block codec on the host: decoders and the sequence emitter.

Format (lz4_Block_format):
  sequence := token(1) [litlen-ext 255*] literals [offset u16le]
              [matchlen-ext 255*]
  token    := (litlen:4 | matchlen-4:4), 15 in a nibble => extension bytes

Two decoders with one contract: `decompress_block`, which decodes through
the host library built from csrc/lz4_host.cpp whenever the decoded size or
a cap on it is known, and `decompress_block_ref`, its plain numpy twin,
which serves calls that know neither. `compress_block_native` is the same
library's greedy encoder, the host tier that benchmarks set beside the
device encoder. A failed build of the library raises.

`compress_block` and `compress_block_continuation` dispatch as tpu7z's
(tpu7z/models/lz4/block.py:339,401): the library's encoder where tpu7z
takes its own (accel 1, hashlog 16), else tpu7z's data-parallel parse
as tensor code on the device of the caller's choice (the CUDA card
unless `device` names the CPU; ops/hash_chain.py: candidates after one
`sort_rows`, exact match lengths, the pointer-doubling walk), then the
host emitter `_emit_sequences`, giving tpu7z's bytes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...device import resolve_device
from ...ops import _build, hash_chain
from ...utils import trace
from ...utils.errors import CorruptError  # noqa: F401  (re-exported)

MIN_MATCH = 4
MF_LIMIT = 12      # a match does not start within the last 12 bytes
LAST_LITERALS = 5  # the last 5 bytes are literals
MAX_OFFSET = 0xFFFF

_ERRORS = {-1: "truncated input", -2: "invalid offset", -3: "output overflow"}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("lz4_host")
        lib.lz4_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                   ctypes.c_size_t, ctypes.c_size_t]
        lib.lz4_decode.restype = ctypes.c_longlong
        for name in ("lz4_encode", "lz4_encode_region"):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_char_p, ctypes.c_size_t]
                           + [ctypes.c_size_t] * (name == "lz4_encode_region")
                           + [ctypes.c_void_p, ctypes.c_size_t])
            fn.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def _decode_native(src: bytes, window: bytes, cap: int) -> bytes:
    """Decode `src` after `window` (the output a linked block may refer
    back into) into at most `cap` bytes, by the host library."""
    w = len(window)
    buf = np.empty(w + cap, dtype=np.uint8)
    buf[:w] = np.frombuffer(window, dtype=np.uint8)
    r = _library().lz4_decode(src, len(src), buf.ctypes.data, w, w + cap)
    if r < 0:
        raise CorruptError(f"lz4: {_ERRORS[r]}")
    return buf[w:w + r].tobytes()


def decompress_block(src, dst_size: int | None = None,
                     cap_hint: int | None = None, *, window=b"") -> bytes:
    """Decode one raw LZ4 block.

    dst_size: the exact decoded size, enforced. cap_hint: an upper bound
    only, such as the frame's block size. Given either, the block decodes
    through the host library; given neither, through
    `decompress_block_ref`. window: the output before this block (at most
    the last 64 KiB of a linked-block frame), which matches may reach
    back into.
    """
    src, window = bytes(src), bytes(window)
    if dst_size is None and cap_hint is None:
        return decompress_block_ref(src, window=window)
    out = _decode_native(src, window, dst_size if dst_size is not None else cap_hint)
    if dst_size is not None and len(out) != dst_size:
        raise CorruptError(f"lz4: decoded {len(out)} bytes, expected {dst_size}")
    return out


def decompress_block_ref(src, dst_size: int | None = None,
                         cap_hint: int | None = None, *, window=b"") -> bytes:
    """`decompress_block` as a host loop over sequences with vectorized
    literal and match copies (period trick for overlaps): the plain twin
    of the library's decoder, raising where it raises."""
    s = np.frombuffer(bytes(src), dtype=np.uint8)
    hist = np.frombuffer(bytes(window), dtype=np.uint8)
    n = s.size
    if dst_size is not None:
        cap = dst_size
    elif cap_hint is not None:
        cap = cap_hint
    else:
        cap = max(64, n * 255)
    w = hist.size
    cap += w
    out = np.empty(cap, dtype=np.uint8)
    out[:w] = hist
    ip = 0
    op = w
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
    if dst_size is not None and op - w != dst_size:
        raise CorruptError(f"lz4: decoded {op - w} bytes, expected {dst_size}")
    return out[w:op].tobytes()


def compress_block_native(src) -> bytes:
    """One independent LZ4 block of `src` by the host library's greedy
    encoder (a 16-bit table of 5-byte hashes, the host tier): the bytes of
    tpu7z's host fast path, `compress_block(src)` at accel 1 and hashlog
    16. Nothing on the device path calls it."""
    raw = bytes(src)
    cap = len(raw) + len(raw) // 255 + 64
    dst = np.empty(cap, dtype=np.uint8)
    r = _library().lz4_encode(raw, len(raw), dst.ctypes.data, cap)
    if r <= 0:
        raise RuntimeError(f"lz4_encode failed on {len(raw)} bytes")
    return dst[:r].tobytes()


def compress_block_continuation_native(chunk, window) -> bytes:
    """One linked LZ4 block of `chunk` whose matches may reach back into
    `window` (the content before it, at most its last 64 KiB), by the
    host library's greedy encoder: the bytes of tpu7z's
    `compress_block_continuation(chunk, window)`."""
    s = bytes(window) + bytes(chunk)
    cap = len(chunk) + len(chunk) // 128 + 64
    dst = np.empty(cap, dtype=np.uint8)
    r = _library().lz4_encode_region(s, len(s), len(window), dst.ctypes.data, cap)
    if r <= 0:
        raise RuntimeError(f"lz4_encode_region failed on {len(chunk)} bytes")
    return dst[:r].tobytes()


def _tensor_parse(s: np.ndarray, w0: int, hashlog: int, device):
    """(mpos, mlen, moff), int64 numpy arrays: tpu7z's greedy parse of
    s[w0:] (block.py:369-396, :433-461) with s[:w0] as history, on
    `device`: candidates by a stable hash sort, their exact lengths up to
    the last literals, the walk from w0."""
    dev = resolve_device(device)
    t = torch.from_numpy(s.copy()).to(dev)
    n = t.numel()
    cand = hash_chain.find_candidates(t, hashlog)
    pos_all = torch.arange(cand.numel(), dtype=torch.int64, device=dev)
    offset = pos_all - cand
    valid = ((cand >= 0) & (offset <= MAX_OFFSET) & (pos_all >= w0)
             & (pos_all <= n - MF_LIMIT - 1))
    vidx = torch.nonzero(valid).flatten()
    mlen = torch.zeros_like(cand)
    mlen[vidx] = hash_chain.match_lengths(t, vidx, cand[vidx], (n - LAST_LITERALS) - vidx)
    valid &= mlen >= MIN_MATCH
    next_pos = torch.where(valid, pos_all + mlen, pos_all + 1)
    visited = hash_chain.greedy_walk(next_pos[w0:] - w0, n - w0)
    sel = torch.nonzero(visited[:cand.numel() - w0] & valid[w0:]).flatten() + w0
    return sel.cpu().numpy(), mlen[sel].cpu().numpy(), offset[sel].cpu().numpy()


def _emit(s: np.ndarray, mpos, mlen, moff) -> bytes:
    with trace.span("lz4.emit", size=s.size):
        return _emit_sequences(s, mpos, mlen, moff)


def compress_block(src, accel: int = 1, hashlog: int = 16, use_native: bool = True,
                   device=None) -> bytes:
    """One greedy LZ4 block of `src`, tpu7z's `compress_block`: the host
    library's encoder (`compress_block_native`) where tpu7z takes its own,
    use_native with accel 1 and hashlog 16 on a non-empty input; else
    tpu7z's data-parallel parse at `hashlog` as tensor code on `device`
    (the card unless it names the CPU), emitted on the host."""
    if use_native and accel == 1 and hashlog == 16 and len(src) > 0:
        return compress_block_native(src)
    s = np.frombuffer(bytes(src), dtype=np.uint8)
    if s.size == 0:
        return b"\x00"
    if s.size < MF_LIMIT + 1:
        return _emit_all_literal(s)
    return _emit(s, *_tensor_parse(s, 0, hashlog, device))


def compress_block_continuation(chunk, window, hashlog: int = 16, device=None) -> bytes:
    """One linked LZ4 block of `chunk` whose matches may reach back into
    `window` (the content before it, at most its last 64 KiB), tpu7z's
    `compress_block_continuation`: the host library's encoder at hashlog
    16 on a non-empty chunk, else the tensor parse from the window's end
    on `device`."""
    if hashlog == 16 and len(chunk) > 0:
        return compress_block_continuation_native(chunk, window)
    w = np.frombuffer(bytes(window), dtype=np.uint8)
    c = np.frombuffer(bytes(chunk), dtype=np.uint8)
    if c.size == 0:
        return b"\x00"
    if c.size < MF_LIMIT + 1:
        return _emit_all_literal(c)
    s = np.concatenate([w, c])
    mpos, mlen, moff = _tensor_parse(s, w.size, hashlog, device)
    return _emit(c, mpos - w.size, mlen, moff)


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


def _emit_all_literal(s: np.ndarray) -> bytes:
    empty = np.empty(0, np.int64)
    return _emit_sequences(s, empty, empty, empty)


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
