"""RAR5 (algo v0) LZ decoder and a minimal fixture encoder.

A copy of tpu7z/models/rar5.py, on the host: the same bytes, lines and
errors from the same input.

Decoder semantics follow the reference behaviorally (NOT copied):
CPP/7zip/Compress/Rar5Decoder.cpp (ReadTables:1088, DecodeLZ2:1373,
ExecuteFilter:831) and the compression-info bit layout of
CPP/7zip/Archive/Rar/Rar5Handler.h:251-284. The design here is a
straightforward whole-buffer Python implementation: table-driven
canonical Huffman over an MSB-first bit reader, LZ77 with 4 repeat
offsets, then a post-pass applying the declared filters (delta /
x86-E8 / E8E9 / ARM) over the unfiltered LZ output (RAR5 filters act
at write time; the LZ window always holds unfiltered bytes).

The encoder exists so the test suite can create RAR5 streams from
scratch (RAR has no open-source encoder to ship fixtures with): one
block, full canonical Huffman tables, greedy hash matcher, optional
delta filters. Streams it produces are cross-verified against the
reference 7zz binary (which reads RAR5) in tests.

Format map (both directions):
  main table 306 = 256 literals + 256:filter + 257:rep0+lastlen
                   + 258..261 rep matches + 262..305 len slots 0..43
  dist table 64 slots, align table 16 (low 4 distance bits),
  len table 44 slots; level (pre-)table 20 symbols; all canonical,
  MSB-first, max code length 15.
"""

from __future__ import annotations

import struct

from ..utils.errors import CorruptError, UnsupportedError

MAIN_SIZE = 306
DIST_SIZE = 64
ALIGN_SIZE = 16
LEN_SIZE = 44
LEVEL_SIZE = 20
NUM_REPS = 4
SYM_FILTER = 256
SYM_REP_LASTLEN = 257
SYM_REP0 = 258
SYM_MATCH = SYM_REP0 + NUM_REPS  # 262
MAX_CODE_LEN = 15
MAX_MATCH = 4097  # len slot 43 ceiling before the far-distance bonus

FILTER_DELTA = 0
FILTER_E8 = 1
FILTER_E8E9 = 2
FILTER_ARM = 3

# extra length for far matches, indexed by distance-slot numBits
# (Rar5Decoder.cpp k_LenPlusTable: +1 @7..11, +2 @12..16, +3 @17+)
_LEN_PLUS = [0] * 7 + [1] * 5 + [2] * 5 + [3] * 24


class _BitReader:
    """MSB-first bit reader over bytes."""

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position
        self.nbits = 8 * len(data)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        if p + n > self.nbits:
            raise CorruptError("rar5: bitstream overread")
        self.pos = p + n
        b0 = p >> 3
        nbytes = ((p & 7) + n + 7) >> 3
        acc = int.from_bytes(self.data[b0:b0 + nbytes], "big")
        shift = 8 * nbytes - (p & 7) - n
        return (acc >> shift) & ((1 << n) - 1)

    def peek15(self) -> int:
        """15 bits at the cursor (zero-padded past the end)."""
        b0 = self.pos >> 3
        chunk = self.data[b0:b0 + 4]
        acc = int.from_bytes(chunk, "big") << (8 * (4 - len(chunk)))
        return (acc >> (17 - (self.pos & 7))) & 0x7FFF

    def align(self):
        self.pos = (self.pos + 7) & ~7

    def byte_aligned_read(self) -> int:
        if self.pos + 8 > self.nbits:
            raise CorruptError("rar5: truncated header")
        v = self.data[self.pos >> 3]
        self.pos += 8
        return v


def _canonical_codes(lens):
    """symbol -> (code, len), canonical by (length, symbol)."""
    counts = [0] * (MAX_CODE_LEN + 1)
    for l in lens:
        counts[l] += 1
    counts[0] = 0
    code = 0
    nextc = [0] * (MAX_CODE_LEN + 1)
    for l in range(1, MAX_CODE_LEN + 1):
        code = (code + counts[l - 1]) << 1
        nextc[l] = code
    out = {}
    for sym, l in enumerate(lens):
        if l:
            out[sym] = (nextc[l], l)
            nextc[l] += 1
    return out


class _Huff:
    """Canonical Huffman decoder: full 2^15 lookup of (sym, len)."""

    __slots__ = ("table", "empty")

    def __init__(self, lens):
        total = sum((1 << (MAX_CODE_LEN - l)) for l in lens if l)
        if total == 0:
            self.table = None
            self.empty = True
            return
        if total != 1 << MAX_CODE_LEN:
            raise CorruptError("rar5: invalid huffman table")
        self.empty = False
        table = [None] * (1 << MAX_CODE_LEN)
        for sym, (c, l) in _canonical_codes(lens).items():
            base = c << (MAX_CODE_LEN - l)
            ent = (sym, l)
            for i in range(base, base + (1 << (MAX_CODE_LEN - l))):
                table[i] = ent
        self.table = table

    def decode(self, br: _BitReader) -> int:
        if self.empty:
            raise CorruptError("rar5: decode from empty table")
        ent = self.table[br.peek15()]
        if ent is None:
            raise CorruptError("rar5: invalid huffman code")
        sym, l = ent
        if br.pos + l > br.nbits:
            raise CorruptError("rar5: bitstream overread")
        br.pos += l
        return sym


def _read_u32v(br: _BitReader) -> int:
    """Filter field: 2-bit (byte count - 1), then LE bytes."""
    nbytes = br.read(2) + 1
    v = 0
    for i in range(nbytes):
        v |= br.read(8) << (8 * i)
    return v


def _read_tables(br: _BitReader):
    # level (pre-)table: 20 4-bit lengths; 15 + nonzero nibble = zero run
    lens = []
    while len(lens) < LEVEL_SIZE:
        v = br.read(4)
        if v == 15:
            num = br.read(4)
            if num != 0:
                lens.extend([0] * (num + 2))
                continue
        lens.append(v)
    level = _Huff(lens[:LEVEL_SIZE])

    total = MAIN_SIZE + DIST_SIZE + ALIGN_SIZE + LEN_SIZE
    out = []
    while len(out) < total:
        sym = level.decode(br)
        if sym < 16:
            out.append(sym)
        else:
            base = (sym & 1) * 4
            num = base + base + 3 + br.read(base + 3)
            if sym < 18:
                if not out:
                    raise CorruptError("rar5: repeat with no previous len")
                v = out[-1]
            else:
                v = 0
            out.extend([v] * min(num, total - len(out)))
    main = _Huff(out[:MAIN_SIZE])
    dist = _Huff(out[MAIN_SIZE:MAIN_SIZE + DIST_SIZE])
    align_lens = out[MAIN_SIZE + DIST_SIZE:MAIN_SIZE + DIST_SIZE
                     + ALIGN_SIZE]
    # align bits are read through the align Huffman table UNLESS the
    # table is the trivial all-4-bit one, in which case the low 4
    # distance bits are read raw (Rar5Decoder.cpp:1317-1325)
    use_align = any(l != 4 for l in align_lens)
    align = _Huff(align_lens) if use_align else None
    lent = _Huff(out[MAIN_SIZE + DIST_SIZE + ALIGN_SIZE:total])
    return main, dist, align, use_align, lent


def _slot_to_len(br: _BitReader, slot: int) -> int:
    nbits = (slot >> 2) - 1
    return ((4 | (slot & 3)) << nbits) + br.read(nbits)


def decode(data: bytes, unp_size: int, dict_bits: int = 22) -> bytes:
    """Decode one RAR5 LZ stream (non-solid) to `unp_size` bytes."""
    br = _BitReader(data)
    out = bytearray()
    reps = [0, 0, 0, 0]
    last_len = 0
    tables = None
    filters = []  # (start, size, type, channels) in LZ coordinates
    win_limit = 1 << min(dict_bits, 40)

    while len(out) < unp_size:
        # --- block header (byte aligned) ---
        br.align()
        flags = br.byte_aligned_read()
        csum = br.byte_aligned_read() ^ flags
        num = (flags >> 3) & 3
        if num >= 3:
            raise CorruptError("rar5: bad block header")
        bsize = br.byte_aligned_read()
        csum ^= bsize
        if num >= 1:
            b = br.byte_aligned_read()
            csum ^= b
            bsize += b << 8
        if num >= 2:
            b = br.byte_aligned_read()
            csum ^= b
            bsize += b << 16
        if csum != 0x5A:
            raise CorruptError("rar5: block header checksum")
        bits7 = (flags & 7) + 1
        bsize += bits7 >> 3
        if bsize == 0:
            raise CorruptError("rar5: zero block size")
        bsize -= 1
        bits7 &= 7
        last_block = bool(flags & 0x40)
        # the block payload (incl. tables) starts after the header bytes
        end_bits = br.pos + 8 * bsize + bits7
        if flags & 0x80:
            tables = _read_tables(br)
        elif tables is None:
            raise CorruptError("rar5: first block without tables")
        main, dist_t, align_t, use_align, len_t = tables

        # --- LZ loop for this block ---
        while br.pos < end_bits and len(out) < unp_size:
            sym = main.decode(br)
            if sym < 256:
                out.append(sym)
                continue
            if sym == SYM_FILTER:
                block_start = _read_u32v(br)
                fsize = _read_u32v(br)
                ftype = br.read(3)
                channels = br.read(5) + 1 if ftype == FILTER_DELTA else 0
                filters.append((len(out) + block_start, fsize, ftype,
                                channels))
                continue
            if sym == SYM_REP_LASTLEN:
                if last_len == 0:
                    continue
                length = last_len
                dist = reps[0]
            elif sym < SYM_MATCH:  # 258..261 repeat offsets
                k = sym - SYM_REP0
                if k == 0:
                    dist = reps[0]
                else:
                    old1 = reps[1]
                    reps[1] = reps[0]
                    dist = reps[k]
                    if k >= 2:
                        reps[k] = reps[2]
                        reps[2] = old1
                    reps[0] = dist
                slot = len_t.decode(br)
                length = _slot_to_len(br, slot) if slot >= 8 else slot
                length += 2
                last_len = length
            else:  # new-offset match
                slot = sym - SYM_MATCH
                length = _slot_to_len(br, slot) if slot >= 8 else slot
                length += 2
                reps[3] = reps[2]
                reps[2] = reps[1]
                reps[1] = reps[0]
                dslot = dist_t.decode(br)
                if dslot < 4:
                    d = dslot
                else:
                    nbits = (dslot - 2) >> 1
                    d = (2 | (dslot & 1)) << nbits
                    if nbits < 4:
                        d += br.read(nbits)
                    else:
                        length += _LEN_PLUS[nbits]
                        if use_align:
                            d += br.read(nbits - 4) << 4
                            d += align_t.decode(br)
                        else:
                            d += br.read(nbits)
                d += 1
                reps[0] = d
                dist = d
                last_len = length

            if dist == 0 or dist > len(out) or dist > win_limit:
                raise CorruptError("rar5: match distance out of range")
            start = len(out) - dist
            if dist >= length:
                out += out[start:start + length]
            else:
                for k in range(length):
                    out.append(out[start + k])

        if len(out) >= unp_size:
            break
        if last_block:
            break
        br.pos = end_bits  # residual padding bits before next header

    if len(out) < unp_size:
        raise CorruptError("rar5: truncated LZ stream")
    return _apply_filters(bytes(out[:unp_size]), filters)


# --------------------------------------------------------------- filters ---

def _apply_filters(data: bytes, filters) -> bytes:
    if not filters:
        return data
    buf = bytearray(data)
    prev_end = 0
    for (start, size, ftype, channels) in filters:
        if size == 0:
            continue
        if start < prev_end or start + size > len(buf):
            raise CorruptError("rar5: bad filter range")
        prev_end = start + size
        blk = buf[start:start + size]
        if ftype == FILTER_DELTA:
            blk = _filter_delta(blk, channels)
        elif ftype in (FILTER_E8, FILTER_E8E9):
            blk = _filter_e8(blk, start, ftype == FILTER_E8E9)
        elif ftype == FILTER_ARM:
            blk = _filter_arm(blk, start)
        else:
            raise UnsupportedError(f"rar5: filter type {ftype}")
        buf[start:start + size] = blk
    return bytes(buf)


def _filter_delta(blk: bytearray, channels: int) -> bytearray:
    out = bytearray(len(blk))
    n = len(blk)
    src = 0
    for ch in range(channels):
        prev = 0
        for pos in range(ch, n, channels):
            prev = (prev - blk[src]) & 0xFF
            src += 1
            out[pos] = prev
    return out


def _filter_e8(blk: bytearray, file_off: int, e9: bool) -> bytearray:
    kfile = 1 << 24
    n = len(blk)
    i = 0
    while i < n - 4:
        b = blk[i]
        if b == 0xE8 or (e9 and b == 0xE9):
            off = (file_off + i + 1) & (kfile - 1)
            addr = struct.unpack_from("<I", blk, i + 1)[0]
            if addr < kfile:
                struct.pack_into("<I", blk, i + 1,
                                 (addr - off) & 0xFFFFFFFF)
            elif addr > (0xFFFFFFFF - off):
                struct.pack_into("<I", blk, i + 1,
                                 (addr + kfile) & 0xFFFFFFFF)
            i += 5
        else:
            i += 1
    return blk


def _filter_arm(blk: bytearray, file_off: int) -> bytearray:
    n = len(blk) & ~3
    for k in range(0, n, 4):
        if blk[k + 3] == 0xEB:
            v = struct.unpack_from("<I", blk, k)[0]
            v = (v - ((file_off + k) >> 2)) & 0x00FFFFFF
            struct.pack_into("<I", blk, k, v | 0xEB000000)
    return blk


# --------------------------------------------------------------- encoder ---

def _optimal_lens(freqs, max_len=MAX_CODE_LEN):
    """Kraft-complete canonical code lengths from frequencies."""
    import heapq
    n = len(freqs)
    syms = [s for s, f in enumerate(freqs) if f > 0]
    if not syms:
        return [0] * n
    if len(syms) == 1:
        syms.append((syms[0] + 1) % n)  # full tree needs two leaves
    heap = [(max(freqs[s], 1), s, (s,)) for s in syms]
    heapq.heapify(heap)
    depth = {s: 0 for s in syms}
    while len(heap) > 1:
        f1, t1, g1 = heapq.heappop(heap)
        f2, _, g2 = heapq.heappop(heap)
        for s in g1 + g2:
            depth[s] += 1
        heapq.heappush(heap, (f1 + f2, t1, g1 + g2))
    lens = [0] * n
    for s, d in depth.items():
        lens[s] = max(1, min(d, max_len))
    # repair Kraft after clamping (only triggers on deep trees)
    target = 1 << max_len
    while True:
        k = sum((1 << (max_len - l)) for l in lens if l)
        if k == target:
            return lens
        if k > target:
            s = max((x for x in range(n) if 0 < lens[x] < max_len),
                    key=lambda x: -lens[x])
            lens[s] += 1
        else:
            s = max((x for x in range(n) if lens[x] > 1),
                    key=lambda x: lens[x])
            if k + (1 << (max_len - lens[s])) <= target:
                lens[s] -= 1
            else:
                z = next(x for x in range(n) if lens[x] == 0)
                lens[z] = max_len


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nb = 0

    def write(self, v: int, n: int):
        if n == 0:
            return
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nb += n
        while self.nb >= 8:
            self.nb -= 8
            self.buf.append((self.acc >> self.nb) & 0xFF)
        self.acc &= (1 << self.nb) - 1

    def bitpos(self):
        return 8 * len(self.buf) + self.nb

    def final(self):
        bits = self.bitpos()
        if self.nb:
            self.write(0, 8 - self.nb)
        return bytes(self.buf), bits


def _len_to_slot(length: int):
    """length (2..4097) -> (slot, extra_bits, extra_val)."""
    v = length - 2
    if v < 8:
        return v, 0, 0
    nbits = v.bit_length() - 3
    top = v >> nbits
    return ((nbits + 1) << 2) | (top & 3), nbits, v - (top << nbits)


def _dist_to_slot(dist: int):
    """dist (1-based) -> (slot, extra_bits, extra_val)."""
    d = dist - 1
    if d < 4:
        return d, 0, 0
    nbits = d.bit_length() - 2
    top = d >> nbits
    return (nbits << 1) + (top & 1) + 2, nbits, d - (top << nbits)


def _dist_len_bonus(dist: int) -> int:
    d = dist - 1
    if d < 4:
        return 0
    return _LEN_PLUS[d.bit_length() - 2]


def encode(data: bytes, filters=()) -> bytes:
    """Minimal RAR5 LZ encoder (single block, greedy hash matcher).

    `filters` entries are (pos, size, ftype, channels) over the FINAL
    output; the input is pre-inverse-transformed so the decoder's
    filter pass reproduces `data`. Delta only (fixture use).
    """
    src = bytearray(data)
    for (pos, size, ftype, channels) in filters:
        if ftype != FILTER_DELTA:
            raise UnsupportedError("encoder supports delta filters only")
        blk = src[pos:pos + size]
        enc = bytearray(size)
        w = 0
        for ch in range(channels):
            prev = 0
            for p in range(ch, size, channels):
                enc[w] = (prev - blk[p]) & 0xFF
                prev = blk[p]
                w += 1
        src[pos:pos + size] = enc

    # greedy hash-4 matcher (new-offset matches only)
    n = len(src)
    seqs = []  # (lit_start, lit_len, match_len_encoded, dist)
    head: dict = {}
    i = 0
    lit_start = 0
    while i + 4 <= n:
        key = bytes(src[i:i + 4])
        j = head.get(key, -1)
        head[key] = i
        if j >= 0 and i - j <= (1 << 22):
            dist = i - j
            bonus = _dist_len_bonus(dist)
            length = 4
            maxl = min(n - i, MAX_MATCH + bonus)
            while length < maxl and src[j + length] == src[i + length]:
                length += 1
            # the decoder adds `bonus` for far matches: the emitted len
            # slot must carry (length - bonus) >= 2
            if length - bonus >= 2:
                seqs.append((lit_start, i - lit_start, length - bonus,
                             dist))
                i += length
                lit_start = i
                continue
        i += 1
    seqs.append((lit_start, n - lit_start, 0, 0))

    fmain = [0] * MAIN_SIZE
    fdist = [0] * DIST_SIZE
    for (ls, ll, mlen, d) in seqs:
        for k in range(ls, ls + ll):
            fmain[src[k]] += 1
        if mlen:
            fmain[SYM_MATCH + _len_to_slot(mlen)[0]] += 1
            fdist[_dist_to_slot(d)[0]] += 1
    fmain[SYM_FILTER] += len(filters)
    main_lens = _optimal_lens(fmain)
    dist_lens = _optimal_lens(fdist) if any(fdist) else [0] * DIST_SIZE
    # align table all-4s = "read low distance bits raw" (see decoder)
    all_lens = (main_lens + dist_lens + [4] * ALIGN_SIZE + [0] * LEN_SIZE)

    # level table: 16 symbols at 5 bits + 4 at 3 bits = full tree
    level_lens = [5] * 16 + [3] * 4
    level_map = _canonical_codes(level_lens)
    main_map = _canonical_codes(main_lens)
    dist_map = _canonical_codes(dist_lens)

    w = _BitWriter()
    for l in level_lens:
        w.write(l, 4)
    for l in all_lens:
        c, cl = level_map[l]
        w.write(c, cl)
    # filter declarations first (they attach at LZ position 0 + pos)
    for (pos, size, ftype, channels) in filters:
        c, cl = main_map[SYM_FILTER]
        w.write(c, cl)
        for v in (pos, size):
            nb = max(1, (v.bit_length() + 7) // 8)
            w.write(nb - 1, 2)
            for bi in range(nb):
                w.write((v >> (8 * bi)) & 0xFF, 8)
        w.write(ftype, 3)
        w.write(channels - 1, 5)
    for (ls, ll, mlen, d) in seqs:
        for k in range(ls, ls + ll):
            c, cl = main_map[src[k]]
            w.write(c, cl)
        if mlen:
            lslot, lbits, lval = _len_to_slot(mlen)
            c, cl = main_map[SYM_MATCH + lslot]
            w.write(c, cl)
            w.write(lval, lbits)
            dslot, nbits, extra = _dist_to_slot(d)
            c, cl = dist_map[dslot]
            w.write(c, cl)
            w.write(extra, nbits)

    body, total_bits = w.final()
    nbytes = len(body)
    bits7 = total_bits & 7
    # header size field S and raw-bit count braw (1..8) must satisfy:
    # decoder's blockSize = S + (braw>>3) - 1 bytes, plus (braw&7) bits
    if bits7 == 0:
        S, braw = total_bits // 8, 8
    else:
        S, braw = total_bits // 8 + 1, bits7
    del nbytes
    flags = 0x80 | 0x40 | (braw - 1)
    size_bytes = [S & 0xFF]
    if S > 0xFFFF:
        flags |= 2 << 3
        size_bytes += [(S >> 8) & 0xFF, (S >> 16) & 0xFF]
    elif S > 0xFF:
        flags |= 1 << 3
        size_bytes += [(S >> 8) & 0xFF]
    csum = 0x5A ^ flags
    for b in size_bytes:
        csum ^= b
    return bytes([flags, csum] + size_bytes) + body


def make_method_vint(method: int = 3, dict_bits: int = 22) -> int:
    """Compression-info vint: algo v0, given method and window log
    (Rar5Handler.h:262: window = 128 KiB << ((v >> 10) & 0xF))."""
    main = max(0, dict_bits - 17)
    return (method << 7) | (main << 10)
