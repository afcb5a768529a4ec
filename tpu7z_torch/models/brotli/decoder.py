"""Brotli decoder (RFC 7932), a port of tpu7z/models/brotli/decoder.py:
the same output and the same CorruptError messages for the same input.

Behavioral reference: C/brotli/br_decode.c / br_huffman.c (format
behavior only); the static dictionary, transforms and context tables are
the RFC appendix data, in .bin files next to this module (tpu7z's).

Host code: a serial bit reader, as in tpu7z. Covers the full format:
window header, uncompressed/metadata/compressed meta-blocks, simple and
complex prefix codes, block switching for the L/I/D categories, context
modes and maps with IMTF, the distance ring buffer with postfix/direct
codes, and static-dictionary word transforms.

tpu7z walks a prefix code one bit at a time and compares the code read
so far with each length's codes. Here each code is one lookup in a table
indexed by its longest code's width of stream bits (read past the end as
zeros), built so that a bit string maps to the symbol tpu7z's walk finds
first, at the shortest length, even for the over-subscribed code-length
codes tpu7z accepts; running out of input and a bit string no code
matches raise where tpu7z raises them.
"""

from __future__ import annotations

import os

from ...utils.errors import CorruptError

_HERE = os.path.dirname(__file__)
with open(os.path.join(_HERE, "dictionary.bin"), "rb") as _f:
    _DICT = _f.read()
with open(os.path.join(_HERE, "context_lut.bin"), "rb") as _f:
    _CONTEXT_LUT = _f.read()


def _load_transforms():
    with open(os.path.join(_HERE, "transforms.bin"), "rb") as f:
        raw = f.read()
    out = []
    i = 0
    while i < len(raw):
        lp = raw[i]
        pre = raw[i + 1:i + 1 + lp]
        i += 1 + lp
        typ = raw[i]
        i += 1
        ls = raw[i]
        suf = raw[i + 1:i + 1 + ls]
        i += 1 + ls
        out.append((pre, typ, suf))
    return out


_TRANSFORMS = _load_transforms()

SIZE_BITS_BY_LENGTH = (0, 0, 0, 0, 10, 10, 11, 11, 10, 10, 10, 10, 10, 9,
                       9, 8, 7, 7, 8, 7, 7, 6, 6, 5, 5)
OFFSETS_BY_LENGTH = (0, 0, 0, 0, 0, 4096, 9216, 21504, 35840, 44032,
                     53248, 63488, 74752, 87040, 93696, 100864, 104704,
                     106752, 108928, 113536, 115968, 118528, 119872,
                     121280, 122016, 122784)

_CL_ORDER = (1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_CL_PREFIX_LEN = (2, 2, 2, 3, 2, 2, 2, 4, 2, 2, 2, 3, 2, 2, 2, 4)
_CL_PREFIX_VAL = (0, 4, 3, 2, 0, 4, 3, 1, 0, 4, 3, 2, 0, 4, 3, 5)

INSERT_BASE = (0, 1, 2, 3, 4, 5, 6, 8, 10, 14, 18, 26, 34, 50, 66, 98,
               130, 194, 322, 578, 1090, 2114, 6210, 22594)
INSERT_EXTRA = (0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7, 8,
                9, 10, 12, 14, 24)
COPY_BASE = (2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 18, 22, 30, 38, 54, 70,
             102, 134, 198, 326, 582, 1094, 2118)
COPY_EXTRA = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7,
              8, 9, 10, 24)
_CMD_CELLS = ((0, 0, True), (0, 8, True), (0, 0, False), (0, 8, False),
              (8, 0, False), (8, 8, False), (0, 16, False),
              (16, 0, False), (8, 16, False), (16, 8, False),
              (16, 16, False))
BLOCK_COUNT_BASE = (1, 5, 9, 13, 17, 25, 33, 41, 49, 65, 81, 97, 113, 145,
                    177, 209, 241, 305, 369, 497, 753, 1265, 2289, 4337,
                    8433, 16625)
BLOCK_COUNT_EXTRA = (2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 6, 6,
                     7, 8, 9, 10, 11, 12, 13, 24)

# a command symbol's (insert code, copy code, implicit distance 0)
_CMD_SPLIT = tuple((_CMD_CELLS[c >> 6][0] + ((c >> 3) & 7),
                    _CMD_CELLS[c >> 6][1] + (c & 7), _CMD_CELLS[c >> 6][2])
                   for c in range(704))


class _Reader:
    __slots__ = ("data", "pos", "total")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.total = 8 * len(data)

    def bit(self) -> int:
        byte = self.pos >> 3
        if byte >= len(self.data):
            raise CorruptError("brotli: out of input")
        b = (self.data[byte] >> (self.pos & 7)) & 1
        self.pos += 1
        return b

    def bits(self, n: int) -> int:
        """n bits, LSB first; tpu7z reads them one by one and raises at
        the first past the end, so the whole read raises if any is."""
        if n == 0:
            return 0
        pos = self.pos
        if pos + n > self.total:
            raise CorruptError("brotli: out of input")
        b = pos >> 3
        v = int.from_bytes(self.data[b:b + ((pos & 7) + n + 7) // 8], "little")
        self.pos = pos + n
        return (v >> (pos & 7)) & ((1 << n) - 1)

    def align(self):
        self.pos = (self.pos + 7) & ~7


class _Huff:
    """Canonical prefix decoder, tpu7z's `_Huff` as a table: `table[w]`
    for the next `max_len` stream bits w (LSB first) is sym << 5 | length
    of the code tpu7z's bit walk finds first, or 0 where it finds none."""

    __slots__ = ("table", "max_len", "single")

    def __init__(self, lengths: dict[int, int] | list, symbols=None):
        # lengths: list aligned with symbols (or dict sym->len)
        if isinstance(lengths, dict):
            pairs = [(ln, s) for s, ln in lengths.items() if ln > 0]
        else:
            pairs = [(ln, s) for s, ln in zip(symbols, lengths) if ln > 0]
        pairs.sort()
        self.single = pairs[0][1] if len(pairs) == 1 else None
        codes = []
        code = 0
        prev_len = 0
        for ln, sym in pairs:
            code <<= (ln - prev_len)
            prev_len = ln
            codes.append((ln, code, sym))
            code += 1
        self.max_len = prev_len
        size = 1 << prev_len
        table = [0] * size
        # longest first, so a shorter code that tpu7z's walk meets first
        # overwrites; a code past its length's range never matches
        for ln, code, sym in reversed(codes):
            if code >> ln:
                continue
            rev = int(f"{code:0{ln}b}"[::-1], 2)
            table[rev::1 << ln] = [(sym << 5) | ln] * (size >> ln)
        self.table = table

    def decode(self, r: _Reader) -> int:
        if self.single is not None:
            return self.single
        pos = r.pos
        b = pos >> 3
        w = int.from_bytes(r.data[b:b + 3], "little") >> (pos & 7)
        e = self.table[w & ((1 << self.max_len) - 1)]
        if e == 0:
            # tpu7z reads max_len bits, none for an empty code, then gives up
            if self.max_len and pos + self.max_len > r.total:
                raise CorruptError("brotli: out of input")
            raise CorruptError("brotli: bad prefix code")
        pos += e & 31
        if pos > r.total:
            raise CorruptError("brotli: out of input")
        r.pos = pos
        return e >> 5


def _single(sym: int) -> _Huff:
    h = _Huff({sym: 1})
    h.single = sym  # zero-bit code
    return h


def _read_prefix_code(r: _Reader, alphabet_size: int) -> _Huff:
    hskip = r.bits(2)
    if hskip == 1:
        # simple code
        nsym = r.bits(2) + 1
        bits_needed = max(1, (alphabet_size - 1).bit_length())
        syms = [r.bits(bits_needed) for _ in range(nsym)]
        for s in syms:
            if s >= alphabet_size:
                raise CorruptError("brotli: symbol out of range")
        if len(set(syms)) != nsym:
            raise CorruptError("brotli: duplicate simple symbols")
        if nsym == 1:
            return _single(syms[0])
        if nsym == 2:
            syms.sort()
            return _Huff([1, 1], syms)
        if nsym == 3:
            # first-read symbol keeps the 1-bit code; the other two are
            # sorted (BrotliBuildSimpleHuffmanTable case semantics)
            b, c = sorted(syms[1:])
            return _Huff([1, 2, 2], [syms[0], b, c])
        # nsym == 4: tree-select
        tree = r.bit()
        if tree:
            a, b = syms[0], syms[1]
            c, d = sorted(syms[2:])
            return _Huff([1, 2, 3, 3], [a, b, c, d])
        return _Huff([2, 2, 2, 2], sorted(syms))

    # complex code: read code-length code lengths starting at hskip
    cl_lens = {}
    space = 32
    for i in range(hskip, 18):
        idx = _CL_ORDER[i]
        # static prefix code: peek 4 bits (zeros past the end), the table
        # gives (length, value); the length is skipped unchecked, as in
        # tpu7z, so the next read past the end raises
        p = r.pos
        v = 0
        for k in range(4):
            byte = p >> 3
            bit = ((r.data[byte] >> (p & 7)) & 1) if byte < len(r.data) else 0
            v |= bit << k
            p += 1
        r.pos += _CL_PREFIX_LEN[v]
        val = _CL_PREFIX_VAL[v]
        if val != 0:
            cl_lens[idx] = val
            space -= 32 >> val
            if space <= 0:
                break
    cl_huff = _Huff(cl_lens)

    lengths = {}
    space = 32768
    prev_nonzero = 8
    last_repeat_sym = 0
    repeat_count = 0
    sym = 0
    while sym < alphabet_size and space > 0:
        c = cl_huff.decode(r)
        if c < 16:
            last_repeat_sym = 0
            lengths[sym] = c
            sym += 1
            if c:
                prev_nonzero = c
                space -= 32768 >> c
        elif c == 16:
            extra = r.bits(2)
            if last_repeat_sym == 16:
                new_count = 4 * (repeat_count - 2) + 3 + extra
            else:
                new_count = 3 + extra
            delta = new_count - (repeat_count if last_repeat_sym == 16 else 0)
            last_repeat_sym = 16
            repeat_count = new_count
            for _ in range(delta):
                if sym >= alphabet_size:
                    raise CorruptError("brotli: repeat overflow")
                lengths[sym] = prev_nonzero
                sym += 1
                space -= 32768 >> prev_nonzero
        else:
            extra = r.bits(3)
            if last_repeat_sym == 17:
                new_count = 8 * (repeat_count - 2) + 3 + extra
            else:
                new_count = 3 + extra
            delta = new_count - (repeat_count if last_repeat_sym == 17 else 0)
            last_repeat_sym = 17
            repeat_count = new_count
            for _ in range(delta):
                if sym >= alphabet_size:
                    raise CorruptError("brotli: zero-repeat overflow")
                lengths[sym] = 0
                sym += 1
    if space < 0:
        raise CorruptError("brotli: over-subscribed code")
    nz = {s: ln for s, ln in lengths.items() if ln}
    if len(nz) == 1:
        return _single(next(iter(nz)))
    return _Huff(nz)


def _read_varlen_uint8(r: _Reader) -> int:
    if not r.bit():
        return 0
    n = r.bits(3)
    if n == 0:
        return 1
    return r.bits(n) + (1 << n)


def _read_block_counts(r: _Reader, huff: _Huff) -> int:
    sym = huff.decode(r)
    return BLOCK_COUNT_BASE[sym] + r.bits(BLOCK_COUNT_EXTRA[sym])


def _read_context_map(r: _Reader, size: int, ntrees: int):
    cmap = [0] * size
    if ntrees == 1:
        return cmap
    use_rle = r.bit()
    rlemax = (r.bits(4) + 1) if use_rle else 0
    huff = _read_prefix_code(r, ntrees + rlemax)
    i = 0
    while i < size:
        s = huff.decode(r)
        if s == 0:
            cmap[i] = 0
            i += 1
        elif s <= rlemax:
            run = (1 << s) + r.bits(s)
            if i + run > size:
                raise CorruptError("brotli: context map overflow")
            for _ in range(run):
                cmap[i] = 0
                i += 1
        else:
            cmap[i] = s - rlemax
            i += 1
    if r.bit():  # IMTF
        mtf = list(range(256))
        for i in range(size):
            v = cmap[i]
            val = mtf.pop(v)
            mtf.insert(0, val)
            cmap[i] = val
    return cmap


class _BlockState:
    __slots__ = ("ntypes", "type", "prev_type", "count", "type_huff",
                 "count_huff")

    def __init__(self, r: _Reader):
        self.ntypes = _read_varlen_uint8(r) + 1
        self.type = 0
        self.prev_type = 1
        if self.ntypes >= 2:
            self.type_huff = _read_prefix_code(r, self.ntypes + 2)
            self.count_huff = _read_prefix_code(r, 26)
            self.count = _read_block_counts(r, self.count_huff)
        else:
            self.type_huff = None
            self.count_huff = None
            self.count = 1 << 62

    def maybe_switch(self, r: _Reader):
        if self.count == 0:
            sym = self.type_huff.decode(r)
            if sym == 0:
                new_type = self.prev_type
            elif sym == 1:
                new_type = (self.type + 1) % self.ntypes
            else:
                new_type = sym - 2
            self.prev_type = self.type
            self.type = new_type
            self.count = _read_block_counts(r, self.count_huff)
        self.count -= 1


def _transform_word(word: bytes, transform_id: int) -> bytes:
    pre, typ, suf = _TRANSFORMS[transform_id]
    if 1 <= typ <= 9:  # omit last N
        word = word[: max(0, len(word) - typ)]
    elif 12 <= typ <= 20:  # omit first N
        word = word[typ - 11:]
    elif typ == 10:  # uppercase first (utf8-aware per RFC)
        word = _ferment(word, False)
    elif typ == 11:
        word = _ferment(word, True)
    return pre + word + suf


def _ferment(word: bytes, all_: bool) -> bytes:
    out = bytearray(word)
    i = 0
    while i < len(out):
        c = out[i]
        if c < 192:
            if 97 <= c <= 122:
                out[i] ^= 32
            i += 1
        elif c < 224:
            if i + 1 < len(out):
                out[i + 1] ^= 32
            i += 2
        else:
            if i + 2 < len(out):
                out[i + 2] ^= 5
            i += 3
        if not all_:
            break
    return bytes(out)


def decompress(src: bytes, max_out: int | None = None) -> bytes:
    """The bytes of one brotli stream (tpu7z's `decompress`)."""
    src = bytes(src)
    r = _Reader(src)
    # window bits
    if r.bit() == 0:
        wbits = 16
    else:
        n = r.bits(3)
        if n != 0:
            wbits = 17 + n
        else:
            n = r.bits(3)
            if n == 0:
                wbits = 17
            elif n == 1:
                raise CorruptError("brotli: invalid window bits")
            else:
                wbits = 8 + n
    window_size = (1 << wbits) - 16
    out = bytearray()
    dist_ring = [16, 15, 11, 4, 0]  # [0:4] ring storage, [4] = index

    while True:
        islast = r.bit()
        if islast and r.bit():  # ISLASTEMPTY
            break
        mnib_code = r.bits(2)
        if mnib_code == 3:
            # metadata block (skipped)
            if r.bit():
                raise CorruptError("brotli: reserved bit set")
            skip_bytes = r.bits(2)
            skip_len = r.bits(8 * skip_bytes)
            if skip_bytes:
                skip_len += 1
            r.align()
            r.pos += 8 * skip_len
            if islast:
                break
            continue
        mlen = 0
        for i in range(mnib_code + 4):
            mlen |= r.bits(4) << (4 * i)
        mlen += 1
        if not islast and r.bit():  # ISUNCOMPRESSED
            r.align()
            start = r.pos >> 3
            out += src[start:start + mlen]
            if len(src) < start + mlen:
                raise CorruptError("brotli: truncated uncompressed block")
            r.pos += 8 * mlen
            continue

        _decode_metablock(r, out, mlen, window_size, dist_ring)
        if max_out is not None and len(out) > max_out:
            raise CorruptError("brotli: output limit exceeded")
        if islast:
            break
    return bytes(out)


def _copy(out: bytearray, dist: int, clen: int):
    """Append out[-dist:] repeated to clen bytes (an overlapping copy)."""
    start = len(out) - dist
    if dist >= clen:
        out += out[start:start + clen]
        return
    chunk = out[start:]
    while clen > 0:
        take = min(clen, len(chunk))
        out += chunk[:take]
        clen -= take
        chunk = out[start:]


def _decode_metablock(r, out, mlen, window_size, dist_ring):
    bl_l = _BlockState(r)
    bl_i = _BlockState(r)
    bl_d = _BlockState(r)

    npostfix = r.bits(2)
    ndirect = r.bits(4) << npostfix
    postfix_mask = (1 << npostfix) - 1

    ctx_modes = [r.bits(2) for _ in range(bl_l.ntypes)]

    ntreesl = _read_varlen_uint8(r) + 1
    cmap_l = _read_context_map(r, 64 * bl_l.ntypes, ntreesl)
    ntreesd = _read_varlen_uint8(r) + 1
    cmap_d = _read_context_map(r, 4 * bl_d.ntypes, ntreesd)

    lit_huffs = [_read_prefix_code(r, 256) for _ in range(ntreesl)]
    cmd_huffs = [_read_prefix_code(r, 704) for _ in range(bl_i.ntypes)]
    dist_alpha = 16 + ndirect + (48 << npostfix)
    dist_huffs = [_read_prefix_code(r, dist_alpha) for _ in range(ntreesd)]
    lut = _CONTEXT_LUT
    # one literal type and one tree: no switch to read, no context to take
    flat = lit_huffs[0] if bl_l.ntypes == 1 and ntreesl == 1 else None

    produced = 0
    while produced < mlen:
        bl_i.maybe_switch(r)
        cmd = cmd_huffs[bl_i.type].decode(r)
        ins_code, cpy_code, implicit_dist0 = _CMD_SPLIT[cmd]
        ilen = INSERT_BASE[ins_code] + r.bits(INSERT_EXTRA[ins_code])
        clen = COPY_BASE[cpy_code] + r.bits(COPY_EXTRA[cpy_code])

        if flat is not None:
            if ilen:
                if flat.single is not None:
                    out += bytes([flat.single]) * ilen
                else:
                    _flat_literals(r, flat, out, ilen)
                produced += ilen
        else:
            for _ in range(ilen):
                bl_l.maybe_switch(r)
                p1 = out[-1] if len(out) >= 1 else 0
                p2 = out[-2] if len(out) >= 2 else 0
                base = 512 * ctx_modes[bl_l.type]
                ctx = lut[base + p1] | lut[base + 256 + p2]
                tree = cmap_l[64 * bl_l.type + ctx]
                out.append(lit_huffs[tree].decode(r))
                produced += 1
        if produced >= mlen:
            break

        max_dist = min(len(out), window_size)
        ridx = dist_ring[4]
        if implicit_dist0:
            dist = dist_ring[(ridx + 3) & 3]
            dcode = 0
        else:
            bl_d.maybe_switch(r)
            ctx = min(clen - 2, 3)
            tree = cmap_d[4 * bl_d.type + ctx]
            dcode = dist_huffs[tree].decode(r)
            if dcode < 16:
                if dcode < 4:
                    # codes 0-3: last, 2nd, 3rd, 4th most recent
                    dist = dist_ring[(ridx + 3 - dcode) & 3]
                else:
                    # 4-9: last +-{1,2,3}; 10-15: second-last +-{1,2,3};
                    # even k = minus, odd k = plus (RFC 7932 section 4)
                    base = dist_ring[(ridx + 3) & 3] if dcode < 10 \
                        else dist_ring[(ridx + 2) & 3]
                    k = dcode - 4 if dcode < 10 else dcode - 10
                    offset = 1 + (k >> 1)
                    dist = base + offset if (k & 1) else base - offset
                if dist <= 0:
                    raise CorruptError("brotli: bad ring distance")
            elif dcode < 16 + ndirect:
                dist = dcode - 16 + 1
            else:
                x = dcode - ndirect - 16
                hcode = x >> npostfix
                lcode = x & postfix_mask
                ndistbits = 1 + (hcode >> 1)
                offset = ((2 + (hcode & 1)) << ndistbits) - 4
                dist = ((offset + r.bits(ndistbits)) << npostfix) \
                    + lcode + ndirect + 1

        if dist <= max_dist:
            if dcode != 0:
                dist_ring[ridx & 3] = dist
                dist_ring[4] = (ridx + 1) & 3
            _copy(out, dist, clen)
            produced += clen
        else:
            # static dictionary reference
            if not 4 <= clen <= 24:
                raise CorruptError("brotli: bad dictionary length")
            word_id = dist - max_dist - 1
            nbits = SIZE_BITS_BY_LENGTH[clen]
            if nbits == 0:
                raise CorruptError("brotli: no dictionary for this length")
            index = word_id & ((1 << nbits) - 1)
            transform_id = word_id >> nbits
            if transform_id >= len(_TRANSFORMS):
                raise CorruptError("brotli: bad transform id")
            off = OFFSETS_BY_LENGTH[clen] + index * clen
            word = _DICT[off:off + clen]
            res = _transform_word(word, transform_id)
            out += res
            produced += len(res)


def _flat_literals(r: _Reader, h: _Huff, out: bytearray, count: int):
    """`count` literals of the one tree `h` (at least two symbols), each a
    table lookup, with `_Huff.decode`'s checks."""
    data, table, total = r.data, h.table, r.total
    mask = (1 << h.max_len) - 1
    pos = r.pos
    for _ in range(count):
        b = pos >> 3
        e = table[(int.from_bytes(data[b:b + 3], "little") >> (pos & 7)) & mask]
        if e == 0:
            r.pos = pos
            h.decode(r)   # raises tpu7z's error for this position
        pos += e & 31
        if pos > total:
            raise CorruptError("brotli: out of input")
        out.append(e >> 5)
    r.pos = pos


def decompress_mt_container(src: bytes) -> bytes:
    """Brotli-mt container (C/zstdmt/README.md): 16-byte skippable frames
    with "BR" magic wrap each worker's brotli stream. A bare stream is
    accepted too."""
    src = bytes(src)
    if len(src) >= 16 and int.from_bytes(src[:4], "little") == 0x184D2A50:
        out = []
        pos = 0
        while pos + 16 <= len(src):
            magic = int.from_bytes(src[pos:pos + 4], "little")
            hsize = int.from_bytes(src[pos + 4:pos + 8], "little")
            if magic != 0x184D2A50 or hsize != 8:
                break
            csize = int.from_bytes(src[pos + 8:pos + 12], "little")
            if src[pos + 12:pos + 14] != b"BR":
                raise CorruptError("brotli-mt: bad BR magic")
            stream = src[pos + 16:pos + 16 + csize]
            out.append(decompress(stream))
            pos += 16 + csize
        if pos >= len(src) - 15:
            return b"".join(out)
    return decompress(src)
