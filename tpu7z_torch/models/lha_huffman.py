"""LHA lh4-lh7 codec: LZSS over a 4K-64K window with per-block dynamic
Huffman tables (the format decoded by the reference's LzhDecoder,
CPP/7zip/Archive/LzhHandler.cpp + CPP/7zip/Compress/LzhDecoder.cpp;
bitstream grammar re-derived from the public LHA format).

A copy of tpu7z/models/lha_huffman.py, on the host: the same bytes, lines and
errors from the same input.

Stream grammar (MSB-first bits):
  repeat blocks until output complete:
    u16        symbol count of this block
    pt table   code-length alphabet (19 symbols, 5-bit count; 3-bit
               lengths with 7+unary extension; a 2-bit zero-skip field
               after index 2)
    c  table   literal/length alphabet (510 symbols, 9-bit count;
               lengths coded via the pt table: 0 -> one zero,
               1 -> 3+u4 zeros, 2 -> 20+u9 zeros, else len = sym - 2)
    p  table   distance-bit alphabet (np symbols, pbit-bit count, same
               3-bit+extension coding, no zero-skip)
    symbols    c < 256 literal; else match of length c - 256 + 3 with
               distance class p: dist = p < 2 ? p : (1 << (p-1)) + (p-1
               extra bits); copy from out[-dist-1]

Methods: lh4 dicbit 12, lh5 13, lh6 15, lh7 16; np = dicbit + 1,
pbit = 4 for lh4/5 else 5.
"""

from __future__ import annotations

from ..utils.errors import CorruptError

_NT = 19         # code-length alphabet
_TBIT = 5
_CBIT = 9
_NC = 510        # 256 literals + lengths 3..256
_THRESHOLD = 3
_MAXMATCH = 256

_DICBIT = {"lh4": 12, "lh5": 13, "lh6": 15, "lh7": 16}


class _BitReader:
    __slots__ = ("data", "pos", "bitbuf", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bitbuf = 0
        self.nbits = 0

    def get(self, n: int) -> int:
        while self.nbits < n:
            b = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.bitbuf = (self.bitbuf << 8) | b
            self.nbits += 8
        self.nbits -= n
        v = (self.bitbuf >> self.nbits) & ((1 << n) - 1)
        self.bitbuf &= (1 << self.nbits) - 1
        return v


class _Huff:
    """Canonical MSB-first Huffman decoder from code lengths (symbols of
    equal length ordered by index — the LHA make_table assignment)."""

    __slots__ = ("first", "base", "counts", "syms", "const_sym", "maxlen")

    def __init__(self, lengths, const_sym=None):
        self.const_sym = const_sym
        if const_sym is not None:
            return
        maxlen = max(lengths) if lengths and any(lengths) else 0
        if maxlen == 0:
            raise CorruptError("lha: empty huffman table")
        self.maxlen = maxlen
        self.counts = [0] * (maxlen + 1)
        for l in lengths:
            if l:
                self.counts[l] += 1
        self.syms = []
        for ln in range(1, maxlen + 1):
            for s, l in enumerate(lengths):
                if l == ln:
                    self.syms.append(s)
        self.first = [0] * (maxlen + 1)  # first canonical code per length
        self.base = [0] * (maxlen + 1)   # index of that code in syms
        code = 0
        idx = 0
        for ln in range(1, maxlen + 1):
            self.first[ln] = code
            self.base[ln] = idx
            code = (code + self.counts[ln]) << 1
            idx += self.counts[ln]
        if (code >> 1) > (1 << maxlen):
            raise CorruptError("lha: over-subscribed huffman table")

    def decode(self, br: _BitReader) -> int:
        if self.const_sym is not None:
            return self.const_sym
        code = 0
        for ln in range(1, self.maxlen + 1):
            code = (code << 1) | br.get(1)
            rel = code - self.first[ln]
            if 0 <= rel < self.counts[ln]:
                return self.syms[self.base[ln] + rel]
        raise CorruptError("lha: bad huffman code")


def _read_pt(br: _BitReader, nn: int, nbit: int, special: int) -> _Huff:
    n = br.get(nbit)
    if n == 0:
        return _Huff([], const_sym=br.get(nbit))
    if n > nn:
        raise CorruptError("lha: pt count out of range")
    lens = [0] * nn
    i = 0
    while i < n:
        c = br.get(3)
        if c == 7:
            while br.get(1):
                c += 1
                if c > 32:
                    raise CorruptError("lha: pt length overflow")
        lens[i] = c
        i += 1
        if i == special:
            skip = br.get(2)
            for _ in range(skip):
                if i < nn:
                    lens[i] = 0
                    i += 1
    return _Huff(lens)


def _read_c(br: _BitReader, pt: _Huff) -> _Huff:
    n = br.get(_CBIT)
    if n == 0:
        return _Huff([], const_sym=br.get(_CBIT))
    if n > _NC:
        raise CorruptError("lha: c count out of range")
    lens = [0] * _NC
    i = 0
    while i < n:
        c = pt.decode(br)
        if c <= 2:
            if c == 0:
                z = 1
            elif c == 1:
                z = br.get(4) + 3
            else:
                z = br.get(_CBIT) + 20
            if i + z > _NC:
                raise CorruptError("lha: c zero-run overflow")
            i += z
        else:
            lens[i] = c - 2
            i += 1
    return _Huff(lens)


def decode(data: bytes, out_size: int, method: str) -> bytes:
    """Decode an lh4/lh5/lh6/lh7 member payload to out_size bytes."""
    if method not in _DICBIT:
        raise CorruptError(f"lha: unknown method {method}")
    dicbit = _DICBIT[method]
    np = dicbit + 1
    pbit = 4 if dicbit <= 13 else 5
    br = _BitReader(data)
    out = bytearray()
    blockleft = 0
    ctab = ptab = None
    while len(out) < out_size:
        if blockleft == 0:
            blockleft = br.get(16)
            if blockleft == 0:
                raise CorruptError("lha: empty block")
            pt = _read_pt(br, _NT, _TBIT, 3)
            ctab = _read_c(br, pt)
            ptab = _read_pt(br, np, pbit, -1)
        blockleft -= 1
        c = ctab.decode(br)
        if c < 256:
            out.append(c)
            continue
        mlen = c - 256 + _THRESHOLD
        p = ptab.decode(br)
        if p >= np:
            raise CorruptError("lha: distance class out of range")
        dist = p if p < 2 else (1 << (p - 1)) + br.get(p - 1)
        if dist >= len(out):
            raise CorruptError("lha: distance before output start")
        start = len(out) - dist - 1
        for k in range(mlen):
            out.append(out[start + k])
        if len(out) > out_size:
            raise CorruptError("lha: output overrun")
    return bytes(out)


# ------------------------------------------------------------ encoder ---

class _BitWriter:
    __slots__ = ("out", "bitbuf", "nbits")

    def __init__(self):
        self.out = bytearray()
        self.bitbuf = 0
        self.nbits = 0

    def put(self, v: int, n: int) -> None:
        self.bitbuf = (self.bitbuf << n) | (v & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.out.append((self.bitbuf >> self.nbits) & 0xFF)
        self.bitbuf &= (1 << self.nbits) - 1

    def flush(self) -> bytes:
        if self.nbits:
            self.out.append((self.bitbuf << (8 - self.nbits)) & 0xFF)
            self.bitbuf = 0
            self.nbits = 0
        return bytes(self.out)


def _huff_lengths(freq, maxlen=16):
    """Package-merge-free length assignment: standard Huffman then
    flatten over-long codes (inputs here are tiny alphabets)."""
    import heapq
    syms = [s for s, f in enumerate(freq) if f]
    if not syms:
        return [0] * len(freq)
    if len(syms) == 1:
        lens = [0] * len(freq)
        lens[syms[0]] = 1
        return lens
    heap = [(freq[s], s, None) for s in syms]
    heapq.heapify(heap)
    nodes = []
    while len(heap) > 1:
        a = heapq.heappop(heap)
        b = heapq.heappop(heap)
        nodes.append((a, b))
        heapq.heappush(heap, (a[0] + b[0], -len(nodes), len(nodes) - 1))
    lens = [0] * len(freq)

    def walk(entry, depth):
        f, tag, idx = entry
        if idx is None:
            lens[tag] = max(1, depth)
        else:
            a, b = nodes[idx]
            walk(a, depth + 1)
            walk(b, depth + 1)

    walk(heap[0], 0)
    # flatten to maxlen (rarely needed at these alphabet sizes)
    while max(lens) > maxlen:
        over = [s for s in syms if lens[s] > maxlen]
        for s in over:
            lens[s] = maxlen
        # fix Kraft by lengthening the shortest codes
        def kraft():
            return sum(1 << (maxlen - lens[s]) for s in syms)
        for s in sorted(syms, key=lambda s: lens[s]):
            while kraft() > (1 << maxlen) and lens[s] < maxlen:
                lens[s] += 1
    return lens


def _const_fix(lens):
    """A single-symbol table is written in const form — zero the length
    so symbol emission writes no bits (decoders read none)."""
    used = [s for s, l in enumerate(lens) if l]
    if len(used) == 1:
        lens = list(lens)
        lens[used[0]] = 0
    return lens


def _canon_codes(lens):
    maxlen = max(lens) if any(lens) else 0
    codes = [0] * len(lens)
    code = 0
    for ln in range(1, maxlen + 1):
        for s, l in enumerate(lens):
            if l == ln:
                codes[s] = code
                code += 1
        code <<= 1
    return codes


def _write_pt(bw: _BitWriter, lens, nn, nbit, special) -> None:
    used = [s for s, l in enumerate(lens) if l]
    if len(used) <= 1:
        # const form: zero count + the symbol itself; its occurrences
        # consume no bits (callers zero the length, see _const_fix)
        bw.put(0, nbit)
        bw.put(used[0] if used else 0, nbit)
        return
    n = nn
    while n > 0 and lens[n - 1] == 0:
        n -= 1
    bw.put(n, nbit)
    i = 0
    while i < n:
        c = lens[i]
        if c <= 6:
            bw.put(c, 3)
        else:
            bw.put(7, 3)
            for _ in range(c - 7):
                bw.put(1, 1)
            bw.put(0, 1)
        i += 1
        if i == special:
            skip = 0
            while skip < 3 and i + skip < n and lens[i + skip] == 0:
                skip += 1
            bw.put(skip, 2)
            i += skip
    return


def _write_c(bw: _BitWriter, lens) -> None:
    n = _NC
    while n > 0 and lens[n - 1] == 0:
        n -= 1
    # pt alphabet frequencies for the meta table
    events = []  # (pt_symbol, extra_bits_value, extra_bits_n)
    i = 0
    while i < n:
        if lens[i]:
            events.append((lens[i] + 2, 0, 0))
            i += 1
            continue
        z = 0
        while i + z < n and lens[i + z] == 0:
            z += 1
        i += z
        while z > 0:
            if z >= 20:
                take = min(z, 19 + (1 << _CBIT))
                events.append((2, take - 20, _CBIT))
                z -= take
            elif z >= 3:
                take = min(z, 18)
                events.append((1, take - 3, 4))
                z -= take
            else:
                events.append((0, 0, 0))
                z -= 1
    freq = [0] * _NT
    for s, _, _ in events:
        freq[s] += 1
    ptlens = _huff_lengths(freq, maxlen=7)
    _write_pt(bw, ptlens, _NT, _TBIT, 3)  # pt table precedes the c count
    ptlens = _const_fix(ptlens)
    ptcodes = _canon_codes(ptlens)
    used = [s for s, l in enumerate(lens) if l]
    if len(used) <= 1:
        bw.put(0, _CBIT)
        bw.put(used[0] if used else 0, _CBIT)
        return
    bw.put(n, _CBIT)
    for s, v, nb in events:
        bw.put(ptcodes[s], ptlens[s])
        if nb:
            bw.put(v, nb)


def encode(data: bytes, method: str = "lh5") -> bytes:
    """Encode to the lh4-7 bitstream (single Huffman block per 64K of
    symbols; greedy hash-chain LZSS parse)."""
    if method not in _DICBIT:
        raise CorruptError(f"lha: unknown method {method}")
    dicbit = _DICBIT[method]
    window = (1 << dicbit) - 1
    np = dicbit + 1
    pbit = 4 if dicbit <= 13 else 5
    n = len(data)

    # greedy LZSS parse with a positional hash chain
    head: dict = {}
    syms = []  # (c_symbol, dist_class, extra_v, extra_n)
    i = 0
    while i < n:
        best_len = 0
        best_dist = 0
        if i + _THRESHOLD <= n:
            key = data[i:i + 3]
            for cand in reversed(head.get(key, ())):
                if i - cand > window + 1:
                    continue
                l = 0
                maxl = min(_MAXMATCH, n - i)
                while l < maxl and data[cand + l] == data[i + l]:
                    l += 1
                if l > best_len:
                    best_len = l
                    best_dist = i - cand - 1
                    if l >= _MAXMATCH:
                        break
        if best_len >= _THRESHOLD:
            c = 256 + best_len - _THRESHOLD
            d = best_dist
            if d < 2:
                syms.append((c, d, 0, 0))
            else:
                p = d.bit_length()
                syms.append((c, p, d - (1 << (p - 1)), p - 1))
            end = i + best_len
        else:
            syms.append((data[i], -1, 0, 0))
            end = i + 1
        while i < end:
            if i + 3 <= n:
                key = data[i:i + 3]
                lst = head.setdefault(key, [])
                lst.append(i)
                if len(lst) > 32:
                    del lst[0]
            i += 1

    if not data:
        return b""
    bw = _BitWriter()
    pos = 0
    while pos < len(syms):
        block = syms[pos:pos + 0xFFFF]
        pos += len(block)
        cfreq = [0] * _NC
        pfreq = [0] * np
        for c, p, _, _ in block:
            cfreq[c] += 1
            if p >= 0:
                pfreq[p] += 1
        clens = _huff_lengths(cfreq, maxlen=16)
        if not any(pfreq):
            pfreq[0] = 1  # dummy so the p table is well-formed
        plens = _huff_lengths(pfreq, maxlen=16)
        bw.put(len(block), 16)
        _write_c(bw, clens)
        _write_pt(bw, plens, np, pbit, -1)
        clens = _const_fix(clens)
        plens = _const_fix(plens)
        ccodes = _canon_codes(clens)
        pcodes = _canon_codes(plens)
        for c, p, ev, en in block:
            bw.put(ccodes[c], clens[c])
            if p >= 0:
                bw.put(pcodes[p], plens[p])
                if en:
                    bw.put(ev, en)
    return bw.flush()
