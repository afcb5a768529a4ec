"""The LZMA1 decoder: tpu7z/models/lzma/decoder.py.

`LzmaDecoder` decodes into one output window shared by a stream's chunks
(LZMA2 keeps the window, and the probability state unless a chunk
resets it). Its engine is the host library built from csrc/lzma_dec.cpp
(native.py); a failed build raises. The Python engine below runs where
tpu7z runs it by design, an end-marker stream of unknown size (LZMA_Alone
with size -1), and wherever the caller asks for it with native=False: it
is the library's twin in the tests. Behavior per the public LZMA
specification (C/LzmaDec.c LzmaDec_DecodeReal2).
"""

from __future__ import annotations

import numpy as np

from ...utils.errors import CorruptError
from . import native as _native
from .rangecoder import PROB_INIT, RangeDecoder

NUM_STATES = 12
MATCH_MIN_LEN = 2


class _Probs:
    """Flat adaptive-probability store with named regions."""

    def __init__(self, lc: int, lp: int):
        self.is_match = [PROB_INIT] * (NUM_STATES << 4)
        self.is_rep = [PROB_INIT] * NUM_STATES
        self.is_rep_g0 = [PROB_INIT] * NUM_STATES
        self.is_rep_g1 = [PROB_INIT] * NUM_STATES
        self.is_rep_g2 = [PROB_INIT] * NUM_STATES
        self.is_rep0_long = [PROB_INIT] * (NUM_STATES << 4)
        self.pos_slot = [PROB_INIT] * (4 * 64)
        self.spec_pos = [PROB_INIT] * 115
        self.align = [PROB_INIT] * 16
        self.len_coder = _LenProbs()
        self.rep_len_coder = _LenProbs()
        self.literal = [PROB_INIT] * (0x300 << (lc + lp))


class _LenProbs:
    def __init__(self):
        self.choice = [PROB_INIT] * 2
        self.low = [PROB_INIT] * (16 << 3)
        self.mid = [PROB_INIT] * (16 << 3)
        self.high = [PROB_INIT] * 256


def _decode_len(rc: RangeDecoder, lp: _LenProbs, pos_state: int) -> int:
    if rc.decode_bit(lp.choice, 0) == 0:
        return 2 + rc.decode_tree(lp.low, pos_state << 3, 3)
    if rc.decode_bit(lp.choice, 1) == 0:
        return 10 + rc.decode_tree(lp.mid, pos_state << 3, 3)
    return 18 + rc.decode_tree(lp.high, 0, 8)


class LzmaDecoder:
    """Stateful LZMA1 decoder over a shared output window: the host
    library's engine, or with native=False the Python one."""

    def __init__(self, lc: int, lp: int, pb: int, out_capacity: int, native: bool = True):
        if lc > 8 or lp > 4 or pb > 4:
            raise CorruptError("lzma: bad lc/lp/pb")
        self.lc, self.lp, self.pb = lc, lp, pb
        self._lib = _native.decoder() if native else None
        self._native = self._lib.tz_lzma_new(lc, lp, pb) if native else None
        if self._native is None:
            self.probs = _Probs(lc, lp)
        self.state = 0
        self.reps = [0, 0, 0, 0]
        self.out = np.zeros(out_capacity, dtype=np.uint8)
        self.pos = 0  # global window position
        self.origin = 0  # dictionary origin (LZMA2 dict reset)

    def __del__(self):
        if getattr(self, "_native", None) is not None:
            self._lib.tz_lzma_free(self._native)
            self._native = None

    def reset_state(self):
        if self._native is not None:
            self._lib.tz_lzma_reset_state(self._native)
            return
        self.probs = _Probs(self.lc, self.lp)
        self.state = 0
        self.reps = [0, 0, 0, 0]

    def dict_reset(self):
        """LZMA2 dictionary reset: position context and distance bounds
        restart at the current output position (C/Lzma2Dec.c dicPos)."""
        self.origin = self.pos
        if self._native is not None:
            self._lib.tz_lzma_set_origin(self._native, self.pos)

    def reset_props(self, lc: int, lp: int, pb: int):
        self.lc, self.lp, self.pb = lc, lp, pb
        if self._native is not None:
            self._lib.tz_lzma_reset_props(self._native, lc, lp, pb)
            self.state = 0
            self.reps = [0, 0, 0, 0]
            return
        self.reset_state()

    def _grow(self, need: int):
        if need > self.out.size:
            nb = np.zeros(max(need, self.out.size * 2), dtype=np.uint8)
            nb[: self.pos] = self.out[: self.pos]
            self.out = nb

    def decode_chunk(self, src, limit: int | None,
                     expect_end_marker: bool = False):
        """Decode until `limit` output bytes produced (or end marker when
        limit is None). Returns bytes consumed from src."""
        if self._native is not None and limit is None:
            # an end-marker stream of unknown size is decoded only from a
            # stream's start, by the Python engine from a fresh state
            self._lib.tz_lzma_free(self._native)
            self._native = None
            self.probs = _Probs(self.lc, self.lp)
            self.state = 0
            self.reps = [0, 0, 0, 0]
        if self._native is not None:
            self._grow(self.pos + limit)
            src = bytes(src)
            r = self._lib.tz_lzma_decode_chunk(self._native, src, len(src),
                                               self.out.ctypes.data, self.pos, limit)
            if r == -1:
                raise CorruptError("lzma: native decode error")
            if r == -2:
                # end marker before limit: acceptable only when expected
                if not expect_end_marker:
                    raise CorruptError("lzma: unexpected end marker")
                return len(src)
            self.pos += limit
            return int(r)
        rc = RangeDecoder(src)
        pb_mask = (1 << self.pb) - 1
        lp_mask = (1 << self.lp) - 1
        lc = self.lc
        probs = self.probs
        state = self.state
        rep0, rep1, rep2, rep3 = self.reps
        pos = self.pos
        origin = self.origin
        if limit is None:
            end = 1 << 62
        else:
            end = self.pos + limit
            self._grow(end)
        out = self.out

        while pos < end:
            if pos + 273 > out.size:
                self.pos = pos
                self._grow(pos + (1 << 20))
                out = self.out
            pos_state = (pos - origin) & pb_mask
            if rc.decode_bit(probs.is_match, (state << 4) + pos_state) == 0:
                prev = int(out[pos - 1]) if pos > origin else 0
                lit_state = ((((pos - origin) & lp_mask) << lc)
                             + (prev >> (8 - lc)))
                base = 0x300 * lit_state
                lit = probs.literal
                if state < 7:
                    sym = 1
                    while sym < 0x100:
                        sym = (sym << 1) | rc.decode_bit(lit, base + sym)
                else:
                    match_byte = int(out[pos - rep0 - 1])
                    sym = 1
                    while sym < 0x100:
                        match_bit = (match_byte >> 7) & 1
                        match_byte = (match_byte << 1) & 0xFF
                        b = rc.decode_bit(
                            lit, base + ((1 + match_bit) << 8) + sym)
                        sym = (sym << 1) | b
                        if match_bit != b:
                            while sym < 0x100:
                                sym = (sym << 1) | rc.decode_bit(lit,
                                                                 base + sym)
                            break
                out[pos] = sym & 0xFF
                pos += 1
                state = (0 if state < 4 else state - 3 if state < 10
                         else state - 6)
                continue
            if rc.decode_bit(probs.is_rep, state) == 0:
                # new match
                rep3, rep2, rep1 = rep2, rep1, rep0
                length = _decode_len(rc, probs.len_coder, pos_state)
                state = 7 if state < 7 else 10
                len_state = min(length - 2, 3)
                slot = rc.decode_tree(probs.pos_slot, len_state << 6, 6)
                if slot < 4:
                    rep0 = slot
                else:
                    nd = (slot >> 1) - 1
                    rep0 = (2 | (slot & 1)) << nd
                    if slot < 14:
                        rep0 += rc.decode_tree_reverse(
                            probs.spec_pos, rep0 - slot - 1, nd)
                    else:
                        rep0 += rc.decode_direct(nd - 4) << 4
                        rep0 += rc.decode_tree_reverse(probs.align, 0, 4)
                        if rep0 == 0xFFFFFFFF:
                            # end marker
                            if not expect_end_marker and pos != end:
                                pass  # markers are legal anywhere
                            self.state = state
                            self.reps = [0, 0, 0, 0]
                            self.pos = pos
                            return rc.pos
            else:
                if rc.decode_bit(probs.is_rep_g0, state) == 0:
                    if rc.decode_bit(probs.is_rep0_long,
                                     (state << 4) + pos_state) == 0:
                        # short rep
                        state = 9 if state < 7 else 11
                        if rep0 + 1 > pos - origin:
                            raise CorruptError("lzma: shortrep before start")
                        out[pos] = out[pos - rep0 - 1]
                        pos += 1
                        continue
                else:
                    if rc.decode_bit(probs.is_rep_g1, state) == 0:
                        dist = rep1
                    else:
                        if rc.decode_bit(probs.is_rep_g2, state) == 0:
                            dist = rep2
                        else:
                            dist = rep3
                            rep3 = rep2
                        rep2 = rep1
                    rep1 = rep0
                    rep0 = dist
                length = _decode_len(rc, probs.rep_len_coder, pos_state)
                state = 8 if state < 7 else 11
            # copy match
            if rep0 + 1 > pos - origin:
                raise CorruptError("lzma: match distance before start")
            if pos + length > end:
                raise CorruptError("lzma: match overruns chunk limit")
            start = pos - rep0 - 1
            if rep0 + 1 >= length:
                out[pos:pos + length] = out[start:start + length]
            else:
                period = rep0 + 1
                reps_n = -(-length // period)
                out[pos:pos + length] = np.tile(
                    out[start:start + period], reps_n)[:length]
            pos += length

        self.state = state
        self.reps = [rep0, rep1, rep2, rep3]
        self.pos = pos
        return rc.pos


def parse_props_byte(b: int):
    if b >= 9 * 5 * 5:
        raise CorruptError("lzma: invalid properties byte")
    lc = b % 9
    b //= 9
    lp = b % 5
    pb = b // 5
    return lc, lp, pb


def decompress_raw(src: bytes, props: bytes, out_size: int, native: bool = True) -> bytes:
    """Raw LZMA1 stream (as stored in .7z coders): props = 5 bytes
    (props byte + u32le dict size)."""
    if len(props) < 1:
        raise CorruptError("lzma: missing properties")
    lc, lp, pb = parse_props_byte(props[0])
    dec = LzmaDecoder(lc, lp, pb, out_size, native)
    dec.decode_chunk(src, out_size)
    return dec.out[:dec.pos].tobytes()


def decompress_alone(src: bytes, native: bool = True) -> bytes:
    """.lzma (LZMA_Alone) container: 13-byte header then one stream."""
    if len(src) < 13:
        raise CorruptError("lzma: truncated alone header")
    lc, lp, pb = parse_props_byte(src[0])
    usize = int.from_bytes(src[5:13], "little")
    if usize == 0xFFFFFFFFFFFFFFFF:
        # unknown size: decode until the end marker
        dec = LzmaDecoder(lc, lp, pb, 1 << 16)
        dec.decode_chunk(src[13:], None, expect_end_marker=True)
        return dec.out[: dec.pos].tobytes()
    dec = LzmaDecoder(lc, lp, pb, usize, native)
    dec.decode_chunk(src[13:], usize)
    return dec.out[:usize].tobytes()
