"""The LZMA1 encoder's fast parse: tpu7z/models/lzma/encoder.py.

Behavioral reference: C/LzmaEnc.c (context model :364-378, fast parse
GetOptimumFast:1976, block driver LzmaEnc_CodeOneBlock:2388), written
from the public specification. The parse is tpu7z's greedy parse from
the shared LZ matcher, as tensor code on the device of the caller's
choice (the CUDA card unless `device` names the CPU; ops/hash_chain.py):
candidates after one stable hash sort (`sort_rows` on the card), their
exact lengths up to 273, and the pointer-doubling walk. The adaptive
range coding (`LzmaEncoder.encode_chunk`) is serial within a stream and
runs on the host, as in tpu7z; LZMA2's chunks are the parallel axis.

tpu7z finds a chunk's matches over the whole prefix before the chunk's
end (`_find_matches_window(window, start, end)` over window[:end]), so
its work grows with the square of the input. The same matches come from
one pass over the input (`WindowMatcher`): a candidate of p depends only
on the bytes before p + 4, and a chunk's lengths are the whole input's
capped at its end, so only the walk runs per chunk, over the chunk's own
span. `compress_raw` and `compress_alone` without an end marker are the
host library's optimal parse (native.py), as in tpu7z.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from ...ops import hash_chain
from ...utils import trace
from ...utils.errors import ParamError
from . import native
from .decoder import _LenProbs, _Probs
from .rangecoder import RangeEncoder

MATCH_MAX = 273      # the longest LZMA match
MIN_MATCH = 4        # the shortest match the parse takes
TAIL = 8             # no match starts within the last 8 bytes of a chunk
MIN_SPAN = 16        # a chunk or prefix shorter than this gets no matches


def _encode_len(rc: RangeEncoder, lp: _LenProbs, pos_state: int, length: int):
    v = length - 2
    if v < 8:
        rc.encode_bit(lp.choice, 0, 0)
        rc.encode_tree(lp.low, pos_state << 3, 3, v)
    elif v < 16:
        rc.encode_bit(lp.choice, 0, 1)
        rc.encode_bit(lp.choice, 1, 0)
        rc.encode_tree(lp.mid, pos_state << 3, 3, v - 8)
    else:
        rc.encode_bit(lp.choice, 0, 1)
        rc.encode_bit(lp.choice, 1, 1)
        rc.encode_tree(lp.high, 0, 8, v - 16)


def _pos_slot(dist: int) -> int:
    if dist < 4:
        return dist
    nd = dist.bit_length() - 1
    return (nd << 1) | ((dist >> (nd - 1)) & 1)


class LzmaEncoder:
    """Stateful LZMA1 encoder (state persists across LZMA2 chunks)."""

    def __init__(self, lc: int = 3, lp: int = 0, pb: int = 2):
        if lc > 8 or lp > 4 or pb > 4:
            raise ParamError("lzma: bad lc/lp/pb")
        self.lc, self.lp, self.pb = lc, lp, pb
        self.reset_state()

    def reset_state(self):
        self.probs = _Probs(self.lc, self.lp)
        self.state = 0
        self.reps = [0, 0, 0, 0]

    def props_byte(self) -> int:
        return (self.pb * 5 + self.lp) * 9 + self.lc

    def encode_chunk(self, window: np.ndarray, start: int, end: int,
                     matches=None, end_marker: bool = False) -> bytes:
        """Encode window[start:end]; bytes before `start` are prior
        context (dictionary). `matches`: (mpos, mlen, mdist) of the chunk,
        arrays or tensors, by default `_find_matches_window`'s on the
        card. Returns the compressed chunk stream."""
        rc = RangeEncoder()
        probs = self.probs
        state = self.state
        rep0, rep1, rep2, rep3 = self.reps
        pb_mask = (1 << self.pb) - 1
        lp_mask = (1 << self.lp) - 1
        lc = self.lc

        if matches is None:
            matches = _find_matches_window(window, start, end)
        mpos, mlen, mdist = (_host_list(a) for a in matches)
        # bytes read by index give ints, as the Python loop wants them
        window = window if isinstance(window, bytes) else np.asarray(
            window, dtype=np.uint8).tobytes()
        mi = 0
        nm = len(mpos)

        pos = start
        while pos < end:
            while mi < nm and mpos[mi] < pos:
                mi += 1
            pos_state = pos & pb_mask
            take_match = mi < nm and mpos[mi] == pos
            if take_match:
                length = mlen[mi]
                dist = mdist[mi]  # distance-1 form
                length = min(length, end - pos)
                if length < 2:
                    take_match = False
            if not take_match:
                # literal
                rc.encode_bit(probs.is_match, (state << 4) + pos_state, 0)
                prev = window[pos - 1] if pos > 0 else 0
                lit_state = ((pos & lp_mask) << lc) + (prev >> (8 - lc))
                base = 0x300 * lit_state
                lit = probs.literal
                sym = window[pos]
                if state < 7:
                    ctx = 1
                    for i in range(7, -1, -1):
                        b = (sym >> i) & 1
                        rc.encode_bit(lit, base + ctx, b)
                        ctx = (ctx << 1) | b
                else:
                    match_byte = window[pos - rep0 - 1]
                    ctx = 1
                    i = 7
                    while i >= 0:
                        b = (sym >> i) & 1
                        match_bit = (match_byte >> i) & 1
                        rc.encode_bit(
                            lit, base + ((1 + match_bit) << 8) + ctx, b)
                        ctx = (ctx << 1) | b
                        i -= 1
                        if match_bit != b:
                            while i >= 0:
                                b = (sym >> i) & 1
                                rc.encode_bit(lit, base + ctx, b)
                                ctx = (ctx << 1) | b
                                i -= 1
                            break
                state = (0 if state < 4 else state - 3 if state < 10
                         else state - 6)
                pos += 1
                continue

            rc.encode_bit(probs.is_match, (state << 4) + pos_state, 1)
            if dist == rep0:
                # rep0 match
                rc.encode_bit(probs.is_rep, state, 1)
                rc.encode_bit(probs.is_rep_g0, state, 0)
                if length == 1:
                    rc.encode_bit(probs.is_rep0_long,
                                  (state << 4) + pos_state, 0)
                    state = 9 if state < 7 else 11
                    pos += 1
                    continue
                rc.encode_bit(probs.is_rep0_long,
                              (state << 4) + pos_state, 1)
                _encode_len(rc, probs.rep_len_coder, pos_state, length)
                state = 8 if state < 7 else 11
            elif dist in (rep1, rep2, rep3):
                rc.encode_bit(probs.is_rep, state, 1)
                rc.encode_bit(probs.is_rep_g0, state, 1)
                if dist == rep1:
                    rc.encode_bit(probs.is_rep_g1, state, 0)
                else:
                    rc.encode_bit(probs.is_rep_g1, state, 1)
                    if dist == rep2:
                        rc.encode_bit(probs.is_rep_g2, state, 0)
                    else:
                        rc.encode_bit(probs.is_rep_g2, state, 1)
                        rep3 = rep2
                    rep2 = rep1
                rep1 = rep0
                rep0 = dist
                _encode_len(rc, probs.rep_len_coder, pos_state, length)
                state = 8 if state < 7 else 11
            else:
                # new match
                rc.encode_bit(probs.is_rep, state, 0)
                rep3, rep2, rep1 = rep2, rep1, rep0
                rep0 = dist
                _encode_len(rc, probs.len_coder, pos_state, length)
                state = 7 if state < 7 else 10
                len_state = min(length - 2, 3)
                slot = _pos_slot(dist)
                rc.encode_tree(probs.pos_slot, len_state << 6, 6, slot)
                if slot >= 4:
                    nd = (slot >> 1) - 1
                    base_v = (2 | (slot & 1)) << nd
                    rem = dist - base_v
                    if slot < 14:
                        rc.encode_tree_reverse(probs.spec_pos,
                                               base_v - slot - 1, nd, rem)
                    else:
                        rc.encode_direct(rem >> 4, nd - 4)
                        rc.encode_tree_reverse(probs.align, 0, 4, rem & 15)
            pos += length

        if end_marker:
            pos_state = pos & pb_mask
            rc.encode_bit(probs.is_match, (state << 4) + pos_state, 1)
            rc.encode_bit(probs.is_rep, state, 0)
            _encode_len(rc, probs.len_coder, pos_state, 2)
            slot = 63
            rc.encode_tree(probs.pos_slot, 0, 6, slot)
            nd = (slot >> 1) - 1
            base_v = (2 | (slot & 1)) << nd
            rem = 0xFFFFFFFF - base_v
            rc.encode_direct(rem >> 4, nd - 4)
            rc.encode_tree_reverse(probs.align, 0, 4, rem & 15)
            state = 7 if state < 7 else 10

        self.probs = probs
        self.state = state
        self.reps = [rep0, rep1, rep2, rep3]
        return rc.flush()


def _host_list(a) -> list:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a).tolist()


def _tensor(window, device) -> torch.Tensor:
    if isinstance(window, torch.Tensor):
        return window.to(device)
    arr = np.frombuffer(bytes(window), dtype=np.uint8) if not isinstance(
        window, np.ndarray) else window
    return torch.from_numpy(np.array(arr, dtype=np.uint8)).to(device)


class WindowMatcher:
    """The greedy matches of any chunk of one input, from one pass over
    the input on `device` (the card unless it names the CPU): each
    position's candidate (the most recent earlier position with its hash
    and word, one stable sort) and its exact length up to 273 and the
    input's end. `matches(start, end)` caps the lengths at the chunk's
    end and walks the chunk: tpu7z's `_find_matches_window(window, start,
    end)`, which sorts and compares over window[:end] for every chunk."""

    def __init__(self, window, hashlog: int = 16, device=None):
        self.device = dev = resolve_device(device)
        s = _tensor(window, dev)
        n = s.numel()
        self.cand = cand = hash_chain.find_candidates(s, hashlog)
        pos = torch.arange(cand.numel(), dtype=torch.int64, device=dev)
        vidx = torch.nonzero((cand >= 0) & (pos <= n - TAIL)).flatten()
        self.mlen = torch.zeros_like(cand)
        self.mlen[vidx] = hash_chain.match_lengths(
            s, vidx, cand[vidx], torch.clamp(n - vidx, max=MATCH_MAX))

    def matches(self, start: int, end: int):
        """(mpos, mlen, mdist) of window[start:end], int64 tensors on the
        device: the positions the greedy walk from `start` takes a match
        at, the match lengths, the distances less one."""
        dev = self.device
        if end - start < MIN_SPAN or end < MIN_SPAN:
            empty = torch.empty(0, dtype=torch.int64, device=dev)
            return empty, empty, empty
        # matches start in [start, end - TAIL], their lengths cut at end
        stop = end - TAIL + 1
        pos = torch.arange(start, stop, dtype=torch.int64, device=dev)
        cand = self.cand[start:stop]
        mlen = torch.minimum(self.mlen[start:stop], end - pos)
        valid = (cand >= 0) & (mlen >= MIN_MATCH)
        local = torch.where(valid, pos - start + mlen, pos - start + 1)
        visited = hash_chain.greedy_walk(local, end - start)
        sel = torch.nonzero(visited[:stop - start] & valid).flatten()
        return sel + start, mlen[sel], sel + start - cand[sel] - 1


def _find_matches_window(window, start: int, end: int, hashlog: int = 16, device=None):
    """Greedy matches for window[start:end] (which may reach the bytes
    before start), tpu7z's: (mpos, mlen, mdist), int64 tensors on
    `device`, the distance in its less-one form."""
    if end - start < MIN_SPAN or end < MIN_SPAN:
        empty = torch.empty(0, dtype=torch.int64, device=resolve_device(device))
        return empty, empty, empty
    return WindowMatcher(window[:end], hashlog, device).matches(start, end)


def _dict_size(n: int) -> int:
    return max(1 << 16, 1 << (max(1, n - 1)).bit_length())


def compress_raw(data: bytes, lc: int = 3, lp: int = 0, pb: int = 2,
                 end_marker: bool = False, device=None) -> tuple[bytes, bytes]:
    """Raw LZMA1 stream: (stream, props5). Without an end marker, the
    host library's optimal parse (native.py); with one, the fast-parse
    encoder, its parse on `device` (the card unless it names the CPU)."""
    if not end_marker:
        stream, _ = native.lzma_raw_encode(data, lc=lc, lp=lp, pb=pb)
        props = bytes([(pb * 5 + lp) * 9 + lc]) + _dict_size(len(data)).to_bytes(4, "little")
        return stream, props
    enc = LzmaEncoder(lc, lp, pb)
    window = np.frombuffer(bytes(data), dtype=np.uint8)
    matches = _find_matches_window(window, 0, window.size, device=device)
    with trace.span("lzma.range_code", size=window.size):
        stream = enc.encode_chunk(window, 0, window.size, matches, end_marker=end_marker)
    props = bytes([enc.props_byte()]) + _dict_size(window.size).to_bytes(4, "little")
    return stream, props


def compress_alone(data: bytes, lc: int = 3, lp: int = 0, pb: int = 2) -> bytes:
    """The .lzma (LZMA_Alone) container: props, the u64le size, the raw
    stream."""
    stream, props = compress_raw(data, lc, lp, pb)
    return props + len(data).to_bytes(8, "little") + stream
