"""LZX decoder (CAB / CHM flavor).

A copy of tpu7z/models/lzx.py, on the host: the same bytes, lines and
errors from the same input.

Behavioral reference: CPP/7zip/Compress/LzxDecoder.cpp and the public
LZX format documentation — 16-bit-LE bitstream read MSB-first,
verbatim / aligned-offset / uncompressed block types, two-part main
tree + length tree delta-coded via a 20-symbol pretree, 3 repeated
offsets, optional x86 E8 call translation applied per 32KB frame.

The CHM reset-block protocol (ChmHandler.cpp:690-724: one 32KB output
frame per reset-table block, full state reset at reset intervals,
bitstream re-aligned at every frame boundary) is `decode_frames`.
This is a from-spec implementation, not a translation.
"""

from __future__ import annotations

import struct

from ..utils.errors import CorruptError

FRAME = 0x8000
_NUM_SLOTS = {15: 30, 16: 32, 17: 34, 18: 36, 19: 38, 20: 42, 21: 50}


def _extra_bits(slot: int) -> int:
    return max(0, min(17, (slot >> 1) - 1))


_POS_BASE = [0]
for _s in range(50):
    _POS_BASE.append(_POS_BASE[-1] + (1 << _extra_bits(_s)))


class _Bits:
    """16-bit little-endian words, bits consumed MSB-first."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.buf = 0
        self.n = 0

    def _fill(self):
        while self.n <= 16:
            if self.pos + 2 <= len(self.data):
                w = self.data[self.pos] | (self.data[self.pos + 1] << 8)
                self.pos += 2
            elif self.pos < len(self.data):
                w = self.data[self.pos]
                self.pos += 1
            else:
                w = 0
            self.buf = (self.buf << 16) | w
            self.n += 16

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        if self.n < nbits:
            self._fill()
        self.n -= nbits
        v = (self.buf >> self.n) & ((1 << nbits) - 1)
        return v

    def peek16(self) -> int:
        if self.n < 16:
            self._fill()
        return (self.buf >> (self.n - 16)) & 0xFFFF

    def drop(self, nbits: int):
        self.n -= nbits

    def align16(self):
        k = self.n % 16
        self.read(k if k else 16)

    def byte_pos(self) -> int:
        """Current position in the underlying data, accounting for
        buffered (unconsumed) bits — valid when 16-bit aligned."""
        return self.pos - self.n // 8

    def read_bytes(self, k: int) -> bytes:
        """Byte-mode read; only valid when 16-bit aligned."""
        p = self.byte_pos()
        if p + k > len(self.data):
            raise CorruptError("lzx: truncated uncompressed data")
        self.buf = 0
        self.n = 0
        self.pos = p + k
        return self.data[p:p + k]


class _Huff:
    """Canonical Huffman decoder over code lengths (max 16 bits)."""

    def __init__(self, lengths):
        self.max_len = 0
        counts = [0] * 17
        for l in lengths:
            if l:
                counts[l] += 1
                self.max_len = max(self.max_len, l)
        if self.max_len == 0:
            self.empty = True
            return
        self.empty = False
        # first code value and first symbol index per length
        code = 0
        self.limit = [0] * 18
        self.base = [0] * 18
        syms = []
        for l in range(1, 17):
            first = code
            for s, sl in enumerate(lengths):
                if sl == l:
                    syms.append(s)
            code = (code + counts[l]) << 1
            self.limit[l] = code  # 2*(first+count): exclusive, shifted
            self.base[l] = first
        total = sum(counts[l] << (16 - l) for l in range(1, 17))
        if total > (1 << 16):
            raise CorruptError("lzx: over-subscribed huffman code")
        self.syms = syms
        self.cum = [0] * 18
        c = 0
        for l in range(1, 17):
            self.cum[l] = c
            c += counts[l]

    def decode(self, bs: _Bits) -> int:
        if self.empty:
            raise CorruptError("lzx: decode from empty tree")
        v = bs.peek16()
        code = 0
        for l in range(1, 17):
            code = (code << 1) | ((v >> (16 - l)) & 1)
            if code < self.limit[l] >> 1:
                bs.drop(l)
                return self.syms[self.cum[l] + code - self.base[l]]
        raise CorruptError("lzx: bad huffman code")


def _read_lengths(bs: _Bits, prev, count):
    """Delta-coded code lengths behind a 20-symbol pretree."""
    pre = _Huff([bs.read(4) for _ in range(20)])
    out = list(prev)
    i = 0
    while i < count:
        z = pre.decode(bs)
        if z == 17:
            run = bs.read(4) + 4
            for _ in range(run):
                if i < count:
                    out[i] = 0
                    i += 1
        elif z == 18:
            run = bs.read(5) + 20
            for _ in range(run):
                if i < count:
                    out[i] = 0
                    i += 1
        elif z == 19:
            run = bs.read(1) + 4
            z2 = pre.decode(bs)
            val = (prev[i] - z2) % 17 if i < count else 0
            for _ in range(run):
                if i < count:
                    out[i] = val
                    i += 1
        else:
            out[i] = (prev[i] - z) % 17
            i += 1
    return out


class State:
    """Decoder state persisting across 32KB frames within a reset
    interval (LzxDecoder.cpp _keepHistory semantics)."""

    def __init__(self, window_bits: int):
        if window_bits not in _NUM_SLOTS:
            raise CorruptError(f"lzx: window bits {window_bits}")
        self.nslots = _NUM_SLOTS[window_bits]
        self.main_size = 256 + 8 * self.nslots
        self.reset()

    def reset(self):
        self.R = [1, 1, 1]
        self.main_levels = [0] * self.main_size
        self.len_levels = [0] * 249
        self.block_remaining = 0
        self.block_type = 0
        self.skip_byte = False
        self.header_read = False
        self.e8_size = 0
        self.main = None
        self.lent = None
        self.aligned = None


def decode_frame(state: State, data: bytes, out: bytearray,
                 frame_size: int):
    """Decode exactly `frame_size` bytes of output from `data`,
    appending to `out` (the full section so far — the match window)."""
    bs = _Bits(data)
    if not state.header_read:
        state.header_read = True
        if bs.read(1):
            state.e8_size = (bs.read(16) << 16) | bs.read(16)
    produced = 0
    while produced < frame_size:
        if state.block_remaining == 0:
            if state.skip_byte:
                state.skip_byte = False
                bs.read_bytes(1)
            state.block_type = bs.read(3)
            size = (bs.read(16) << 8) | bs.read(8)
            state.block_remaining = size
            if state.block_type == 3:  # uncompressed
                bs.align16()
                reps = bs.read_bytes(12)
                state.R = list(struct.unpack("<III", reps))
                if 0 in state.R:
                    raise CorruptError("lzx: zero rep offset")
                state.skip_byte = bool(size & 1)
                continue
            if state.block_type == 2:  # aligned offset
                state.aligned = _Huff([bs.read(3) for _ in range(8)])
            elif state.block_type != 1:
                raise CorruptError(
                    f"lzx: bad block type {state.block_type}")
            ml = _read_lengths(bs, state.main_levels[:256], 256)
            mh = _read_lengths(bs, state.main_levels[256:],
                               state.main_size - 256)
            state.main_levels = ml + mh
            state.len_levels = _read_lengths(bs, state.len_levels, 249)
            state.main = _Huff(state.main_levels)
            state.lent = _Huff(state.len_levels)
            continue

        take = min(state.block_remaining, frame_size - produced)
        if state.block_type == 3:
            out.extend(bs.read_bytes(take))
            produced += take
            state.block_remaining -= take
            continue

        # verbatim / aligned: decode symbols until `take` is produced
        end = len(out) + take
        while len(out) < end:
            sym = state.main.decode(bs)
            if sym < 256:
                out.append(sym)
                continue
            t = sym - 256
            slot = t >> 3
            lh = t & 7
            mlen = lh + 2
            if lh == 7:
                mlen += state.lent.decode(bs)
            if slot < 3:
                off = state.R[slot]
                if slot == 1:
                    state.R[1] = state.R[0]
                    state.R[0] = off
                elif slot == 2:
                    state.R[2] = state.R[0]
                    state.R[0] = off
            else:
                extra = _extra_bits(slot)
                if state.block_type == 2 and extra >= 3:
                    footer = bs.read(extra - 3) << 3
                    footer |= state.aligned.decode(bs)
                else:
                    footer = bs.read(extra)
                off = _POS_BASE[slot] + footer - 2
                state.R[2] = state.R[1]
                state.R[1] = state.R[0]
                state.R[0] = off
            if off <= 0 or off > len(out):
                raise CorruptError("lzx: match offset out of window")
            for _ in range(mlen):
                out.append(out[-off])
        actually = take - (end - len(out))
        produced += actually
        state.block_remaining -= actually
    return produced


def _e8_filter(buf: bytearray, frame_start: int, frame_len: int,
               translation_size: int):
    """Reverse x86 call translation over one output frame
    (LzxDecoder.cpp x86_Filter4)."""
    if translation_size == 0 or frame_len <= 10 or \
            frame_start >= (1 << 30):
        return
    i = frame_start
    end = frame_start + frame_len - 10
    while i < end:
        if buf[i] != 0xE8:
            i += 1
            continue
        val = int.from_bytes(buf[i + 1:i + 5], "little", signed=True)
        if -i <= val < translation_size:
            rel = val - i if val >= 0 else val + translation_size
            buf[i + 1:i + 5] = (rel & 0xFFFFFFFF).to_bytes(4, "little")
        i += 5


def decode_frames(compressed: bytes, reset_offsets, window_bits: int,
                  reset_interval: int, total_size: int) -> bytes:
    """CHM LZXC section decode: one reset-table block per 32KB output
    frame; full state reset every `reset_interval` bytes of output
    (ChmHandler.cpp extract loop)."""
    state = State(window_bits)
    out = bytearray()
    frames_per_reset = max(1, reset_interval // FRAME)
    nframes = -(-total_size // FRAME)
    for f in range(nframes):
        off = reset_offsets[f] if f < len(reset_offsets) else None
        if off is None:
            raise CorruptError("lzx: reset table too short")
        end = reset_offsets[f + 1] if f + 1 < len(reset_offsets) \
            else len(compressed)
        if f % frames_per_reset == 0:
            state.reset()
        fsize = min(FRAME, total_size - f * FRAME)
        start = len(out)
        decode_frame(state, compressed[off:end], out, fsize)
        _e8_filter(out, start, fsize, state.e8_size)
    return bytes(out[:total_size])


# ------------------------------------------------------------- encoder ---
# Superset: the reference only decodes LZX (LzxDecoder.cpp). This
# verbatim-block encoder (greedy hash matcher + canonical Huffman,
# one state-reset per 32KB frame) feeds the CHM writer and gives the
# decoder a self-check path.

class _BitWriter:
    """MSB-first bits packed into 16-bit little-endian words."""

    def __init__(self):
        self.words = []
        self.cur = 0
        self.n = 0

    def write(self, value: int, nbits: int):
        for k in range(nbits - 1, -1, -1):
            self.cur = (self.cur << 1) | ((value >> k) & 1)
            self.n += 1
            if self.n == 16:
                self.words.append(self.cur)
                self.cur = 0
                self.n = 0

    def align16(self):
        if self.n:
            self.write(0, 16 - self.n)

    def write_bytes(self, data: bytes):
        assert self.n == 0
        if len(data) % 2:
            out = bytes(self)
            self.words = []
            return out + data  # caller handles parity via skip byte
        for k in range(0, len(data), 2):
            self.words.append(data[k] | (data[k + 1] << 8))
        return None

    def __bytes__(self):
        w = list(self.words)
        if self.n:
            w.append(self.cur << (16 - self.n))
        return b"".join(struct.pack("<H", x) for x in w)


def _huff_lengths(freqs, limit: int):
    """Huffman code lengths, clamped to `limit` bits (flattening into
    a Kraft-valid code when the optimal tree is too deep)."""
    import heapq
    live = [(f, i) for i, f in enumerate(freqs) if f]
    if not live:
        return [0] * len(freqs)
    if len(live) == 1:
        # a 1-symbol code is Kraft-incomplete and rejected by strict
        # decoders (the reference Huffman builder) — pair it with a
        # never-emitted dummy symbol so both get 1-bit codes
        out = [0] * len(freqs)
        i = live[0][1]
        out[i] = 1
        out[(i + 1) % len(freqs)] = 1
        return out
    heap = [(f, [i]) for f, i in live]
    heapq.heapify(heap)
    depth = {i: 0 for _, i in live}
    while len(heap) > 1:
        f1, s1 = heapq.heappop(heap)
        f2, s2 = heapq.heappop(heap)
        for s in s1 + s2:
            depth[s] += 1
        heapq.heappush(heap, (f1 + f2, s1 + s2))
    out = [0] * len(freqs)
    for i, d in depth.items():
        out[i] = min(d, limit)
    # repair the Kraft sum after clamping: strict decoders (the
    # reference Huffman builder) demand an exactly complete code
    def kraft():
        return sum(1 << (limit - l) for l in out if l)
    while kraft() > (1 << limit):
        # deepen the shallowest deepenable symbol
        cand = min((l for l in out if 0 < l < limit), default=None)
        if cand is None:
            raise CorruptError("lzx: cannot build length-limited code")
        out[out.index(cand)] = cand + 1
    deficit = (1 << limit) - kraft()
    while deficit > 0:
        # shorten the deepest symbol whose promotion fits the deficit
        best = None
        for i, l in enumerate(out):
            if l > 1 and (1 << (limit - l)) <= deficit:
                if best is None or l > out[best]:
                    best = i
        if best is None:
            raise CorruptError("lzx: cannot complete huffman code")
        deficit -= 1 << (limit - out[best])
        out[best] -= 1
    return out


def _huff_codes(lengths):
    code = 0
    codes = [0] * len(lengths)
    for l in range(1, 17):
        for s, sl in enumerate(lengths):
            if sl == l:
                codes[s] = code
                code += 1
        code <<= 1
    return codes


def _write_lengths(bw: _BitWriter, lengths, prev=None):
    """Pretree + delta codes for a code-length vector, delta-coded
    against `prev` (zeros for a fresh state)."""
    n = len(lengths)
    if prev is None:
        prev = [0] * n
    syms = []
    i = 0
    while i < n:
        if lengths[i] == 0:
            run = 0
            while i + run < n and lengths[i + run] == 0:
                run += 1
            while run >= 20:
                take = min(run, 51)
                syms.append((18, take - 20, 5))
                run -= take
                i += take
            while run >= 4:
                take = min(run, 19)
                syms.append((17, take - 4, 4))
                run -= take
                i += take
            for _ in range(run):
                syms.append(((prev[i] - lengths[i]) % 17, None, 0))
                i += 1
        else:
            syms.append(((prev[i] - lengths[i]) % 17, None, 0))
            i += 1
    freqs = [0] * 20
    for s, _, _ in syms:
        freqs[s] += 1
    plens = _huff_lengths(freqs, 15)
    pcodes = _huff_codes(plens)
    for l in plens:
        bw.write(l, 4)
    for s, extra, ebits in syms:
        if plens[s] == 0:
            raise CorruptError("lzx: pretree missing symbol")
        bw.write(pcodes[s], plens[s])
        if ebits:
            bw.write(extra, ebits)


def _slot_for(formatted: int) -> int:
    slot = 0
    while slot + 1 < len(_POS_BASE) and _POS_BASE[slot + 1] <= formatted:
        slot += 1
    return slot


def encode_frame(data: bytes, window_bits: int = 16,
                 write_header: bool = True, prev_main=None,
                 prev_len=None, out_lens=None) -> bytes:
    """One LZX frame (<= 32KB) as a single verbatim block. Falls back
    to an uncompressed block when expansion would result.
    `write_header=False` omits the E8 bit and `prev_main`/`prev_len`
    carry the previous frame's tree lengths for continuation frames in
    keep-history streams (CAB folders). `out_lens`, when a dict, gets
    the emitted tree lengths for the caller to chain."""
    if len(data) > FRAME:
        raise CorruptError("lzx: frame too large")
    nslots = _NUM_SLOTS[window_bits]
    main_size = 256 + 8 * nslots
    window = 1 << window_bits

    # greedy hash-chain match
    tokens = []  # (is_match, literal | (mlen, offset))
    heads: dict = {}
    i = 0
    n = len(data)
    while i < n:
        best_len = 0
        best_off = 0
        if i + 3 <= n:
            key = data[i:i + 3]
            for j in reversed(heads.get(key, ())):
                if i - j > window - 2:
                    break
                l = 3
                maxl = min(n - i, 257)
                while l < maxl and data[j + l] == data[i + l]:
                    l += 1
                if l > best_len:
                    best_len, best_off = l, i - j
                    if l >= 64:
                        break
        if best_len >= 3:
            tokens.append((True, (best_len, best_off)))
            for k in range(i, min(i + best_len, n - 2)):
                heads.setdefault(data[k:k + 3], []).append(k)
            i += best_len
        else:
            tokens.append((False, data[i]))
            if i + 3 <= n:
                heads.setdefault(key, []).append(i)
            i += 1

    # symbol statistics (R-reps not used: offsets always explicit)
    main_freq = [0] * main_size
    len_freq = [0] * 249
    for is_m, t in tokens:
        if not is_m:
            main_freq[t] += 1
        else:
            mlen, off = t
            formatted = off + 2
            slot = _slot_for(formatted)
            lh = min(7, mlen - 2)
            main_freq[256 + slot * 8 + lh] += 1
            if lh == 7:
                len_freq[mlen - 9] += 1
    main_lens = _huff_lengths(main_freq, 16)
    len_lens = _huff_lengths(len_freq, 16)
    main_codes = _huff_codes(main_lens)
    len_codes = _huff_codes(len_lens)

    bw = _BitWriter()
    if write_header:
        bw.write(0, 1)                 # no E8 translation
    bw.write(1, 3)                     # verbatim block
    bw.write(n >> 8, 16)
    bw.write(n & 0xFF, 8)
    pm = prev_main if prev_main is not None else [0] * main_size
    pl = prev_len if prev_len is not None else [0] * 249
    _write_lengths(bw, main_lens[:256], pm[:256])
    _write_lengths(bw, main_lens[256:], pm[256:])
    _write_lengths(bw, len_lens, pl)
    if out_lens is not None:
        out_lens["main"] = main_lens
        out_lens["len"] = len_lens
    for is_m, t in tokens:
        if not is_m:
            bw.write(main_codes[t], main_lens[t])
        else:
            mlen, off = t
            formatted = off + 2
            slot = _slot_for(formatted)
            lh = min(7, mlen - 2)
            sym = 256 + slot * 8 + lh
            bw.write(main_codes[sym], main_lens[sym])
            if lh == 7:
                ls = mlen - 9
                bw.write(len_codes[ls], len_lens[ls])
            eb = _extra_bits(slot)
            if eb:
                bw.write(formatted - _POS_BASE[slot], eb)
    comp = bytes(bw)
    if len(comp) < n:
        return comp
    # uncompressed-block fallback (leaves tree state unchanged)
    if out_lens is not None:
        out_lens["main"] = prev_main
        out_lens["len"] = prev_len
    bw = _BitWriter()
    if write_header:
        bw.write(0, 1)
    bw.write(3, 3)
    bw.write(n >> 8, 16)
    bw.write(n & 0xFF, 8)
    bw.align16()
    raw = struct.pack("<III", 1, 1, 1) + data
    if len(raw) % 2:
        raw += b"\0"
    return bytes(bw) + raw


def encode_frames(data: bytes, window_bits: int = 16):
    """LZXC-style stream: per-frame reset, returns (compressed bytes,
    reset offsets) for the CHM ResetTable."""
    offsets = []
    out = bytearray()
    for k in range(0, max(len(data), 1), FRAME):
        offsets.append(len(out))
        out.extend(encode_frame(data[k:k + FRAME], window_bits))
        if len(out) % 2:
            out.append(0)
    return bytes(out), offsets
