"""DEFLATE (RFC 1951), Deflate64 and gzip (RFC 1952), a port of
tpu7z/models/deflate/codec.py: the same bytes from the same input.

Behavioral reference: CPP/7zip/Compress/Deflate{Encoder,Decoder}.cpp;
written from the RFCs. The encoder is one dynamic-Huffman block a
`block_size` span (HLIT 286, HDIST 30 always), its parse the shared LZ
matcher's greedy walk at hashlog 15 within the block, as tpu7z's
`_find_matches`. The data-parallel stages run as tensor code on the
device of the caller's choice (the CUDA card unless `device` names the
CPU):

  candidates       every block a row of one `sort_rows` launch, a short
                   last block padded to a full row (ops/hash_chain.py)
  lengths, walk    `match_lengths` over the whole input (no position in a
                   row's last 3 bytes has a candidate, so no chain and no
                   panel crosses a row) and one `greedy_walk` from every
                   block's first position
  histograms       literal/length and distance counts of every block
  body             each literal one code, each match its length code,
                   extra bits, distance code and extra bits in one field,
                   every block's EOB
  bit packing      the whole stream in one `pack_bits_lsb_tensor`: blocks
                   follow one another without alignment, as tpu7z's one
                   `_LSBWriter` writes them

On the host, per block: the code lengths (package-merge), the canonical
codes and the header's fields (`_write_dynamic_header`, tpu7z's). The
decoder is tpu7z's serial inflate on the host, with its error messages.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from ...ops import hash_chain
from ...ops.bitstream import BitWriterLSB, pack_bits_lsb_tensor
from ...ops.hashing import crc32_native
from ...utils import trace
from ...utils.errors import CorruptError
from ..zstd.huffman import _package_merge

LENGTH_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51,
     59, 67, 83, 99, 115, 131, 163, 195, 227, 258], dtype=np.int64)
LENGTH_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4,
     4, 5, 5, 5, 5, 0], dtype=np.int64)
DIST_BASE = np.array(
    [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385,
     513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385,
     24577], dtype=np.int64)
DIST_EXTRA = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10,
     10, 11, 11, 12, 12, 13, 13], dtype=np.int64)
CLC_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1,
             15]

# Deflate64 (PKWARE appnote 5.2; reference DeflateDecoder.cpp
# _deflate64Mode): symbol 285 switches from literal-258 to base 3 + 16
# extra bits, and two extra distance codes extend the window to 64 KiB.
LENGTH_BASE64 = LENGTH_BASE.copy()
LENGTH_EXTRA64 = LENGTH_EXTRA.copy()
LENGTH_BASE64[28] = 3
LENGTH_EXTRA64[28] = 16
DIST_BASE64 = np.concatenate([DIST_BASE, [32769, 49153]])
DIST_EXTRA64 = np.concatenate([DIST_EXTRA, [14, 14]])

BLOCK = 1 << 17       # the default block: 128 KiB
HASHLOG = 15          # the parse's hash width (tpu7z's `_find_matches`)
MIN_BLOCK = 16        # a shorter block gets no matches
MAX_MATCH = 258
MAX_DIST = 32768
NLIT = 286            # HLIT + 257, fixed
NDIST = 30            # HDIST + 1, fixed


class _LSBReader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> int:
        v = 0
        for i in range(n):
            byte = self.pos >> 3
            if byte >= len(self.data):
                raise CorruptError("deflate: bitstream exhausted")
            v |= ((self.data[byte] >> (self.pos & 7)) & 1) << i
            self.pos += 1
        return v

    def align(self):
        self.pos = (self.pos + 7) & ~7


def _rev_bits(v: int, n: int) -> int:
    r = 0
    for _ in range(n):
        r = (r << 1) | (v & 1)
        v >>= 1
    return r


def _rev_codes(codes: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """`_rev_bits(codes[i], lens[i])` of every entry."""
    out = np.zeros_like(codes)
    for bit in range(int(lens.max())):
        moved = ((codes >> bit) & 1) << np.maximum(lens - 1 - bit, 0)
        out |= np.where(bit < lens, moved, 0)
    return out


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """RFC 1951 canonical codes (MSB-order values; write bit-reversed)."""
    max_len = int(lengths.max()) if lengths.size else 0
    bl_count = np.bincount(lengths, minlength=max_len + 1)
    bl_count[0] = 0
    codes = np.zeros(lengths.size, dtype=np.int64)
    code = 0
    next_code = np.zeros(max_len + 2, dtype=np.int64)
    for bits in range(1, max_len + 1):
        code = (code + int(bl_count[bits - 1])) << 1
        next_code[bits] = code
    for s in range(lengths.size):
        ln = int(lengths[s])
        if ln:
            codes[s] = next_code[ln]
            next_code[ln] += 1
    return codes


class _HuffDec:
    """Canonical decoder over (length, symbol) pairs, LSB-first stream."""

    def __init__(self, lengths: np.ndarray):
        self.max_len = int(lengths.max())
        codes = _canonical_codes(lengths)
        self.by_len = {}
        for s in range(lengths.size):
            ln = int(lengths[s])
            if ln:
                self.by_len.setdefault(ln, {})[int(codes[s])] = s

    def decode(self, r: _LSBReader) -> int:
        code = 0
        for ln in range(1, self.max_len + 1):
            code = (code << 1) | r.read(1)
            d = self.by_len.get(ln)
            if d is not None and code in d:
                return d[code]
        raise CorruptError("deflate: invalid huffman code")


_FIXED_LIT_LEN = np.array([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8,
                          dtype=np.int64)
_FIXED_DIST_LEN = np.full(30, 5, dtype=np.int64)


def decompress(src: bytes, max_out: int | None = None,
               deflate64: bool = False, history: bytes = b"") -> bytes:
    """Inflate a raw DEFLATE (or, with `deflate64`, Deflate64) stream on the
    host. `history` primes the LZ77 window (raw deflate continuation); the
    returned bytes exclude it. `max_out` counts history + new output when
    history is given (callers pass the sum)."""
    if deflate64:
        len_base, len_extra = LENGTH_BASE64, LENGTH_EXTRA64
        dist_base, dist_extra = DIST_BASE64, DIST_EXTRA64
        ndist = 32
    else:
        len_base, len_extra = LENGTH_BASE, LENGTH_EXTRA
        dist_base, dist_extra = DIST_BASE, DIST_EXTRA
        ndist = 30
    r = _LSBReader(src)
    out = bytearray(history)
    while True:
        bfinal = r.read(1)
        btype = r.read(2)
        if btype == 0:
            r.align()
            byte = r.pos >> 3
            if byte + 4 > len(src):
                raise CorruptError("deflate: truncated stored header")
            ln = src[byte] | (src[byte + 1] << 8)
            nln = src[byte + 2] | (src[byte + 3] << 8)
            if ln != (~nln & 0xFFFF):
                raise CorruptError("deflate: stored length mismatch")
            r.pos += 32
            byte += 4
            if byte + ln > len(src):
                raise CorruptError("deflate: truncated stored block")
            out += src[byte:byte + ln]
            r.pos += 8 * ln
        elif btype in (1, 2):
            if btype == 1:
                lit_dec = _HuffDec(_FIXED_LIT_LEN)
                dist_dec = _HuffDec(np.full(ndist, 5, dtype=np.int64)
                                    if deflate64 else _FIXED_DIST_LEN)
            else:
                hlit = r.read(5) + 257
                hdist = r.read(5) + 1
                hclen = r.read(4) + 4
                clc_len = np.zeros(19, dtype=np.int64)
                for i in range(hclen):
                    clc_len[CLC_ORDER[i]] = r.read(3)
                clc = _HuffDec(clc_len)
                all_len = np.zeros(hlit + hdist, dtype=np.int64)
                i = 0
                while i < hlit + hdist:
                    s = clc.decode(r)
                    if s < 16:
                        all_len[i] = s
                        i += 1
                    elif s == 16:
                        if i == 0:
                            raise CorruptError("deflate: repeat at start")
                        rep = 3 + r.read(2)
                        all_len[i:i + rep] = all_len[i - 1]
                        i += rep
                    elif s == 17:
                        i += 3 + r.read(3)
                    else:
                        i += 11 + r.read(7)
                if i != hlit + hdist:
                    raise CorruptError("deflate: code length overflow")
                lit_dec = _HuffDec(all_len[:hlit])
                dist_dec = _HuffDec(all_len[hlit:])
            while True:
                sym = lit_dec.decode(r)
                if sym < 256:
                    out.append(sym)
                elif sym == 256:
                    break
                else:
                    li = sym - 257
                    if li >= 29:
                        raise CorruptError("deflate: bad length symbol")
                    length = int(len_base[li]) + r.read(int(len_extra[li]))
                    ds = dist_dec.decode(r)
                    if ds >= ndist:
                        raise CorruptError("deflate: bad distance symbol")
                    dist = int(dist_base[ds]) + r.read(int(dist_extra[ds]))
                    if dist > len(out):
                        raise CorruptError("deflate: distance too far")
                    for _ in range(length):
                        out.append(out[-dist])
        else:
            raise CorruptError("deflate: reserved block type")
        if max_out is not None and len(out) > max_out:
            raise CorruptError("deflate: output limit exceeded")
        if bfinal:
            break
    return bytes(out[len(history):])


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

class _Fields:
    """What a bit writer would write, as (value, nbits) fields."""

    __slots__ = ("values", "nbits")

    def __init__(self):
        self.values = []
        self.nbits = []

    def write(self, value: int, bits: int):
        self.values.append(value & ((1 << bits) - 1))
        self.nbits.append(bits)


def _lens_from_hist(hist: np.ndarray, size: int, max_bits: int) -> np.ndarray:
    nz = np.nonzero(hist)[0]
    lens = np.zeros(size, dtype=np.int64)
    if nz.size == 1:
        lens[nz[0]] = 1
        return lens
    lens[nz] = _package_merge(hist[nz], max_bits)
    return lens


def _write_dynamic_header(w, lit_lens, dist_lens):
    hlit = 286
    hdist = 30
    all_len = np.concatenate([lit_lens, dist_lens])
    # RLE of code lengths with 16/17/18
    ops = []
    i = 0
    N = all_len.size
    while i < N:
        v = int(all_len[i])
        j = i
        while j < N and all_len[j] == v:
            j += 1
        run = j - i
        if v == 0:
            while run >= 11:
                r = min(run, 138)
                ops.append((18, r - 11, 7))
                run -= r
            while run >= 3:
                r = min(run, 10)
                ops.append((17, r - 3, 3))
                run -= r
            ops.extend([(0, None, None)] * run)
        else:
            ops.append((v, None, None))
            run -= 1
            while run >= 3:
                r = min(run, 6)
                ops.append((16, r - 3, 2))
                run -= r
            ops.extend([(v, None, None)] * run)
        i = j
    clc_hist = np.zeros(19, dtype=np.int64)
    for sym, _arg, _bits in ops:
        clc_hist[sym] += 1
    clc_lens = _lens_from_hist(clc_hist, 19, 7)
    clc_codes = _canonical_codes(clc_lens)
    # hclen: trim trailing zeros in CLC order
    order_lens = [int(clc_lens[CLC_ORDER[i]]) for i in range(19)]
    hclen = 19
    while hclen > 4 and order_lens[hclen - 1] == 0:
        hclen -= 1
    w.write(hlit - 257, 5)
    w.write(hdist - 1, 5)
    w.write(hclen - 4, 4)
    for i in range(hclen):
        w.write(order_lens[i], 3)
    for sym, arg, bits in ops:
        w.write(_rev_bits(int(clc_codes[sym]), int(clc_lens[sym])),
                int(clc_lens[sym]))
        if arg is not None:
            w.write(arg, bits)


def _find_matches(s, block_size: int):
    """(take, mlen, off) over the whole uint8 input `s`, each (n,): take[p]
    where the greedy walk of p's block takes the match at p, of length
    mlen[p] and distance off[p]: tpu7z's `_find_matches` of every block at
    once (`hash_chain.greedy_blocks`; blocks under MIN_BLOCK bytes get no
    match). No position in a block's last 3 bytes has a candidate, so
    tpu7z's `pos <= n - 4` holds wherever there is one."""
    return hash_chain.greedy_blocks(s, block_size, HASHLOG, max_offset=MAX_DIST, tail=4,
                                    end=0, min_len=3, max_len=MAX_MATCH, min_block=MIN_BLOCK)


def _codes(dev, table, values):
    """int64 `table[values]` with the numpy table moved to `dev`."""
    return torch.from_numpy(table).to(dev)[values]


def _block_tables(lit_hist, dist_hist, streams: bool = False):
    """Per block, on the host: (lit_lens, dist_lens), each (blocks, 286)
    and (blocks, 30), and the header fields of every block: tpu7z's
    `_compress_block` up to the body. With `streams` every block is a
    stream's last (BFINAL 1), else only the last block is."""
    nb = lit_hist.shape[0]
    lit_lens = np.zeros((nb, NLIT), dtype=np.int64)
    dist_lens = np.zeros((nb, NDIST), dtype=np.int64)
    headers = []
    for b in range(nb):
        lit_lens[b] = _lens_from_hist(lit_hist[b], NLIT, 15)
        if dist_hist[b].sum() == 0:
            dist_lens[b, 0] = 1
        else:
            dist_lens[b] = _lens_from_hist(np.maximum(dist_hist[b], 0), NDIST, 15)
        w = _Fields()
        w.write(1 if streams or b == nb - 1 else 0, 1)
        w.write(2, 2)
        _write_dynamic_header(w, lit_lens[b], dist_lens[b])
        headers.append(w)
    return lit_lens, dist_lens, headers


def _encode(s, block_size: int, streams: bool = False):
    """The stream of a non-empty input `s` (uint8 on its device); with
    `streams`, every block its own stream (a list of bytes): its header
    with BFINAL 1, and after its EOB a field of zero bits to its byte
    boundary."""
    dev = s.device
    n = s.numel()
    nb = -(-n // block_size)
    with trace.stage("deflate.parse", dev, size=n):
        take, mlen, off = _find_matches(s, block_size)
    with trace.stage("deflate.header", dev):
        # the literal mask: every position no taken match covers
        with trace.span("read.deflate_takes"):
            tpos = torch.nonzero(take).flatten()
        tlen, toff = mlen[tpos], off[tpos]
        edge = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        edge.index_add_(0, tpos, torch.ones_like(tpos))
        edge.index_add_(0, tpos + tlen, -torch.ones_like(tpos))
        is_lit = torch.cumsum(edge[:n], 0) == 0
        lc = torch.searchsorted(torch.from_numpy(LENGTH_BASE).to(dev), tlen, right=True) - 1
        dc = torch.searchsorted(torch.from_numpy(DIST_BASE).to(dev), toff, right=True) - 1
        with trace.span("read.deflate_literals"):
            lpos = torch.nonzero(is_lit).flatten()
        lsym = s[lpos].to(torch.int64)
        lit_idx = torch.cat([(lpos // block_size) * NLIT + lsym,
                             (tpos // block_size) * NLIT + 257 + lc])
        # on the card a bincount reads its input's least and largest value
        with trace.span("read.deflate_bincount"):
            lit_hist = torch.bincount(lit_idx, minlength=nb * NLIT).view(nb, NLIT)
        with trace.span("read.deflate_bincount"):
            dist_hist = torch.bincount((tpos // block_size) * NDIST + dc,
                                       minlength=nb * NDIST).view(nb, NDIST)
        with trace.span("read.deflate_hist"):
            hist = torch.cat([lit_hist, dist_hist], 1).cpu().numpy()
        lit_hist, dist_hist = hist[:, :NLIT].copy(), hist[:, NLIT:]
        lit_hist[:, 256] = 1
        lit_lens, dist_lens, headers = _block_tables(lit_hist, dist_hist, streams)
    with trace.stage("deflate.pack", dev):
        lit_codes = np.stack([_rev_codes(_canonical_codes(x), x) for x in lit_lens])
        dist_codes = np.stack([_rev_codes(_canonical_codes(x), x) for x in dist_lens])
        # each block's fields: its header's, one a token (a literal or a
        # match, in stream order), its EOB (and with `streams` its pad); a
        # field's index is its rank among its kind plus its block's shift
        tokens = lit_hist[:, :256].sum(1) + lit_hist[:, 257:].sum(1)
        heads = np.array([len(h.values) for h in headers], dtype=np.int64)
        tail = 2 if streams else 1
        seg = np.cumsum(heads + tokens + tail)
        seg_start = seg - (heads + tokens + tail)
        eob = seg_start + heads + tokens
        hvals = np.concatenate([h.values for h in headers]).astype(np.int64)
        hbits = np.concatenate([h.nbits for h in headers]).astype(np.int64)
        hidx = np.arange(hbits.size) + np.repeat(seg_start - (np.cumsum(heads) - heads), heads)
        values = torch.zeros(int(seg[-1]), dtype=torch.int64, device=dev)
        nbits = torch.zeros_like(values)
        for idx, v, b in ((hidx, hvals, hbits), (eob, lit_codes[:, 256], lit_lens[:, 256])):
            i = torch.from_numpy(idx).to(dev)
            values[i] = torch.from_numpy(v).to(dev)
            nbits[i] = torch.from_numpy(b).to(dev)
        tok = is_lit.clone()
        tok[tpos] = True
        with trace.span("read.deflate_tokens"):
            kpos = torch.nonzero(tok).flatten()
        kblk = kpos // block_size
        shift = torch.from_numpy(seg_start + heads - (np.cumsum(tokens) - tokens)).to(dev)
        kidx = torch.arange(kpos.numel(), dtype=torch.int64, device=dev) + shift[kblk]
        is_match = take[kpos]
        # a match's field: its length code, extra bits, distance code and
        # extra bits, at most 15 + 5 + 15 + 13 bits (tpos is the tokens'
        # order restricted to the matches)
        lcodes = torch.from_numpy(lit_codes).to(dev)
        llens = torch.from_numpy(lit_lens).to(dev)
        dcodes = torch.from_numpy(dist_codes).to(dev)
        dlens = torch.from_numpy(dist_lens).to(dev)
        mblk = tpos // block_size
        n0 = llens[mblk, 257 + lc]
        n1 = _codes(dev, LENGTH_EXTRA, lc)
        n2 = dlens[mblk, dc]
        n3 = _codes(dev, DIST_EXTRA, dc)
        mval = (lcodes[mblk, 257 + lc]
                | ((tlen - _codes(dev, LENGTH_BASE, lc)) << n0)
                | (dcodes[mblk, dc] << (n0 + n1))
                | ((toff - _codes(dev, DIST_BASE, dc)) << (n0 + n1 + n2)))
        mbits = n0 + n1 + n2 + n3
        sym = s[kpos].to(torch.int64)
        kval = lcodes[kblk, sym]
        kbits = llens[kblk, sym]
        # a boolean mask's writes read its count
        with trace.span("read.deflate_match_mask"):
            kval[is_match] = mval
        with trace.span("read.deflate_match_mask"):
            kbits[is_match] = mbits
        values[kidx] = kval
        nbits[kidx] = kbits
        if not streams:
            return _to_host(pack_bits_lsb_tensor(values, nbits))
        # each stream's pad field closes it at a byte boundary (pad fields
        # are still 0 here); one host read gives every stream's bit count
        with trace.span("read.deflate_stream_fields"):
            blk = torch.repeat_interleave(torch.arange(nb, device=dev),
                                          torch.from_numpy(seg - seg_start).to(dev))
        bits = torch.zeros(nb, dtype=torch.int64, device=dev).index_add_(0, blk, nbits)
        nbits[torch.from_numpy(seg - 1).to(dev)] = -bits & 7
        with trace.span("read.deflate_stream_ends"):
            ends = ((bits + 7) >> 3).cumsum(0).tolist()
        out = _to_host(pack_bits_lsb_tensor(values, nbits))
        return [out[a:b] for a, b in zip([0] + ends[:-1], ends)]


def _to_host(packed) -> bytes:
    """The packed stream's bytes: its copy to the host (a span `entry.d2h`)
    and `tobytes` (`entry.tobytes`)."""
    with trace.span("entry.d2h"):
        packed = packed.cpu()
    with trace.span("entry.tobytes"):
        return packed.numpy().tobytes()


def compress(data: bytes, level: int = 6, block_size: int = BLOCK, device=None) -> bytes:
    """Dynamic-Huffman DEFLATE, tpu7z's bytes: the parse, the histograms,
    the body's codes and the bit packing on `device` (the CUDA card unless
    it names the CPU), each block's code lengths and header on the host.
    `level` is ignored, as tpu7z ignores it. Spans `deflate.parse`,
    `deflate.header` and `deflate.pack` when tracing is on, under a root
    span `entry.deflate`; the input's copy to the card is `entry.h2d`, the
    stream's copy back `entry.d2h` and `entry.tobytes`, and each host read
    before it a `read.*` span."""
    with trace.span("entry.deflate", size=len(data)):
        dev = resolve_device(device)
        if len(data) == 0:
            return _empty_stream()
        with trace.span("entry.h2d"):
            s = torch.from_numpy(np.frombuffer(bytes(data), dtype=np.uint8).copy()).to(dev)
        return _encode(s, block_size)


def _empty_stream() -> bytes:
    """tpu7z's stream of no bytes: one fixed block holding its EOB."""
    w = BitWriterLSB()
    w.write(1, 1)
    w.write(1, 2)  # fixed block, just EOB
    codes = _canonical_codes(_FIXED_LIT_LEN)
    w.write(_rev_bits(int(codes[256]), 7), 7)
    return w.close()


def compress_streams(chunks, device=None) -> list:
    """One raw DEFLATE stream a chunk, each `compress(chunk)`'s bytes (one
    dynamic block, BFINAL 1, closed at a byte boundary), as a cabinet's
    MSZIP blocks hold them. Every chunk but the last must be as long as
    the first and the last no longer: the chunks are then the blocks of
    their concatenation, each a row of one `_find_matches` parse (one
    `sort_rows` launch on `device`, the CUDA card unless it names the
    CPU), and one `pack_bits_lsb_tensor` packs every stream. An empty
    chunk (only the last can be, or the only one) gets the empty stream.
    Spans `deflate.parse`, `deflate.header`, `deflate.pack`."""
    dev = resolve_device(device)
    chunks = [bytes(c) for c in chunks]
    if not chunks:
        return []
    block = len(chunks[0])
    if any(len(c) != block for c in chunks[:-1]) or len(chunks[-1]) > block:
        raise ValueError("compress_streams: every chunk but the last must be as long as the "
                         "first, and the last no longer")
    body = [c for c in chunks if c]
    out = []
    if body:
        blob = np.frombuffer(b"".join(body), dtype=np.uint8).copy()
        out = _encode(torch.from_numpy(blob).to(dev), block, streams=True)
    return out + [_empty_stream()] * (len(chunks) - len(body))


# ---------------------------------------------------------------------------
# gzip
# ---------------------------------------------------------------------------

def gzip_compress(data: bytes, level: int = 6, device=None) -> bytes:
    """tpu7z's .gz: a fixed header (no name, mtime 0, OS 255), the DEFLATE
    stream of `compress` on `device`, the CRC32 and the length. A root
    span `entry.gzip` over `compress`'s and `gzip.crc32`."""
    with trace.span("entry.gzip", size=len(data)):
        hdr = bytes([0x1F, 0x8B, 8, 0, 0, 0, 0, 0, 0, 255])
        body = compress(data, level, device=device)
        with trace.span("gzip.crc32"):
            crc = crc32_native(data)
        tail = crc.to_bytes(4, "little") + (len(data) & 0xFFFFFFFF).to_bytes(4, "little")
        return hdr + body + tail


def gzip_decompress(src: bytes) -> bytes:
    """One gzip member on the host (FEXTRA, FNAME, FCOMMENT and FHCRC
    skipped, as tpu7z skips them)."""
    if len(src) < 18 or src[0] != 0x1F or src[1] != 0x8B or src[2] != 8:
        raise CorruptError("gzip: bad header")
    flg = src[3]
    pos = 10
    if flg & 4:  # FEXTRA
        xlen = src[pos] | (src[pos + 1] << 8)
        pos += 2 + xlen
    if flg & 8:  # FNAME
        pos = src.index(b"\x00", pos) + 1
    if flg & 16:  # FCOMMENT
        pos = src.index(b"\x00", pos) + 1
    if flg & 2:  # FHCRC
        pos += 2
    data = decompress(src[pos:-8])
    want_crc = int.from_bytes(src[-8:-4], "little")
    want_len = int.from_bytes(src[-4:], "little")
    if len(data) & 0xFFFFFFFF != want_len:
        raise CorruptError("gzip: length mismatch")
    if crc32_native(data) != want_crc:
        raise CorruptError("gzip: crc mismatch")
    return data
