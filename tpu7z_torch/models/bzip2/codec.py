"""BZip2 stream codec, a port of tpu7z/models/bzip2/codec.py: the same
stream from the same input and level.

Behavioral reference: CPP/7zip/Compress/BZip2{Encoder,Decoder}.cpp and
C/BwtSort.c / C/HuffEnc.c; written from the public bzip2 format.
Pipeline: RLE1 -> BWT (bwt.py: the doubling sort as tensor code on the
card) -> MTF + RLE2 (RUNA/RUNB) -> canonical Huffman (two identical
tables, every selector 0, as tpu7z writes them), MSB-first bitstream.
RLE1, the block split, MTF/RLE2, the Huffman coding and the CRCs run on
the host, as in tpu7z; the decoder's inverse BWT runs on the card.
Spans `bzip2.rle1`, `bzip2.crc`, `bzip2.bwt`, `bzip2.mtf` and
`bzip2.huffman` on encode, `bzip2.huffman_decode`, `bzip2.mtf_decode`,
`bzip2.ibwt` and `bzip2.rle1_decode` (CRCs included) on decode.
"""

from __future__ import annotations

import numpy as np

from ...device import resolve_device
from ...ops.hashing import crc32_native
from ...utils import trace
from ...utils.errors import CorruptError
from ..zstd.huffman import _package_merge
from . import bwt as bwt_mod

_BLOCK_MAGIC = 0x314159265359
_EOS_MAGIC = 0x177245385090
# each byte with its bits in reverse order
_REFLECT = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))


def _reflect32(v: int) -> int:
    return int(f"{v:032b}"[::-1], 2)


def bz_crc32(data: bytes, crc: int = 0xFFFFFFFF) -> int:
    """bzip2's CRC (polynomial 0x04C11DB7, MSB first), tpu7z's values: the
    reflected CRC-32 of the bit-reversed bytes, reversed (`crc32_native`)."""
    return _reflect32(crc32_native(bytes(data).translate(_REFLECT), _reflect32(crc) ^ 0xFFFFFFFF))


class _MSBWriter:
    __slots__ = ("acc", "n", "out")

    def __init__(self):
        self.acc = 0
        self.n = 0
        self.out = bytearray()

    def write(self, value: int, bits: int):
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.n += bits
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.acc >> self.n) & 0xFF)
        self.acc &= (1 << self.n) - 1

    def close(self) -> bytes:
        if self.n:
            self.out.append((self.acc << (8 - self.n)) & 0xFF)
            self.acc = 0
            self.n = 0
        return bytes(self.out)


class _MSBReader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            byte = self.pos >> 3
            if byte >= len(self.data):
                raise CorruptError("bzip2: bitstream exhausted")
            bit = (self.data[byte] >> (7 - (self.pos & 7))) & 1
            v = (v << 1) | bit
            self.pos += 1
        return v


# ---------------------------------------------------------------------------
# RLE1
# ---------------------------------------------------------------------------

def _rle1_encode(data: bytes) -> bytes:
    arr = bytes(data)
    out = bytearray()
    i = 0
    n = len(arr)
    while i < n:
        run = 1
        b = arr[i]
        j = i + 1
        while j < n and arr[j] == b and run < 255 + 4:
            run += 1
            j += 1
        if run >= 4:
            out += bytes([b]) * 4
            out.append(run - 4)
        else:
            out += bytes([b]) * run
        i = j
    return bytes(out)


def _rle1_decode(data: bytes) -> bytes:
    s = bytes(data)
    out = bytearray()
    i = 0
    n = len(s)
    run = 0
    prev = -1
    while i < n:
        b = s[i]
        if run == 4:
            out += bytes([prev]) * b
            run = 0
            prev = -1
            i += 1
            continue
        if b == prev:
            run += 1
        else:
            run = 1
            prev = b
        out.append(b)
        i += 1
    return bytes(out)


# ---------------------------------------------------------------------------
# MTF + RLE2
# ---------------------------------------------------------------------------

def _mtf_rle2_encode(block: np.ndarray, used_vals: np.ndarray):
    """Returns symbol list (incl. EOB) over alphabet nUsed+2."""
    mtf = list(used_vals)
    val_to_pos = {v: i for i, v in enumerate(mtf)}
    syms = []
    zero_run = 0

    # bzip2 zero-run: n+1 in binary, LSB first, drop top 1; bit0->RUNA(0),
    # bit1->RUNB(1)
    def flush(zr):
        zr += 1
        while zr > 1:
            syms.append((zr & 1))  # 1 -> RUNB(sym 1), 0 -> RUNA(sym 0)
            zr >>= 1

    for b in block.tolist():
        p = val_to_pos[b]
        if p == 0:
            zero_run += 1
            continue
        if zero_run:
            flush(zero_run)
            zero_run = 0
        syms.append(p + 1)
        # move to front
        v = mtf.pop(p)
        mtf.insert(0, v)
        for i in range(p + 1):
            val_to_pos[mtf[i]] = i
    if zero_run:
        flush(zero_run)
    eob = used_vals.size + 1
    syms.append(eob)
    return syms


def _mtf_rle2_decode(syms, used_vals: np.ndarray, max_out: int) -> np.ndarray:
    mtf = list(used_vals)
    out = np.empty(max_out, dtype=np.uint8)
    op = 0
    zrun = 0
    zbit = 1
    for s in syms:
        if s <= 1:
            zrun += (s + 1) * zbit
            zbit <<= 1
            continue
        if zrun:
            if op + zrun > max_out:
                raise CorruptError("bzip2: block overflow (zero run)")
            out[op:op + zrun] = mtf[0]
            op += zrun
            zrun = 0
            zbit = 1
        p = s - 1
        v = mtf.pop(p)
        mtf.insert(0, v)
        if op >= max_out:
            raise CorruptError("bzip2: block overflow")
        out[op] = v
        op += 1
    if zrun:
        if op + zrun > max_out:
            raise CorruptError("bzip2: block overflow (tail run)")
        out[op:op + zrun] = mtf[0]
        op += zrun
    return out[:op]


# ---------------------------------------------------------------------------
# Huffman (canonical, MSB-first)
# ---------------------------------------------------------------------------

def _canonical_codes(lengths: np.ndarray):
    max_len = int(lengths.max())
    codes = np.zeros(lengths.size, dtype=np.uint32)
    code = 0
    for ln in range(1, max_len + 1):
        for s in range(lengths.size):
            if lengths[s] == ln:
                codes[s] = code
                code += 1
        code <<= 1
    return codes


def _decode_table(lengths: np.ndarray):
    """(limit, base, perm) table like bzip2's decoder."""
    max_len = int(lengths.max())
    min_len = int(lengths[lengths > 0].min())
    perm = []
    for ln in range(min_len, max_len + 1):
        perm.extend(np.where(lengths == ln)[0].tolist())
    count = np.bincount(lengths, minlength=max_len + 2)
    limit = np.zeros(max_len + 2, dtype=np.int64)
    base = np.zeros(max_len + 2, dtype=np.int64)
    vec = 0
    for ln in range(min_len, max_len + 1):
        vec += int(count[ln])
        limit[ln] = vec - 1
        vec <<= 1
    # base[ln] = code_of_first(ln) - cumulative_count_before(ln)
    code = 0
    cum = 0
    for ln in range(min_len, max_len + 1):
        base[ln] = code - cum
        cum += int(count[ln])
        code = (code + int(count[ln])) << 1
    return min_len, max_len, limit, base, np.array(perm, dtype=np.int64)


def _huff_decode_sym(r: _MSBReader, table):
    min_len, max_len, limit, base, perm = table
    ln = min_len
    v = r.read(min_len)
    while ln <= max_len and v > limit[ln]:
        v = (v << 1) | r.read(1)
        ln += 1
    if ln > max_len:
        raise CorruptError("bzip2: bad huffman code")
    return int(perm[v - base[ln]])


# ---------------------------------------------------------------------------
# Stream codec
# ---------------------------------------------------------------------------

def _split_blocks(rle: bytes, block_limit: int, carry_heads: bool) -> list:
    """tpu7z's block split of the RLE1 stream: cuts of `block_limit` bytes,
    each moved back to its last group boundary (a run of 4 and its count
    stay together), the rest carried into the next block. With
    `carry_heads`, a run of 1-3 bytes that a cut ends and the next bytes
    continue is carried too: it is the head of a group, and tpu7z's split
    leaves the group's rest, count byte included, to start the next block,
    where every reader decodes the count byte as a literal."""
    blocks = []
    i = 0
    while i < len(rle) or (i == 0 and len(rle) == 0):
        blocks.append(rle[i:i + block_limit])
        i += block_limit
        if i >= len(rle):
            break
    fixed = []
    carry = b""
    for at, chunk in enumerate(blocks):
        blk = carry + chunk
        nxt = blocks[at + 1][:1] if at + 1 < len(blocks) else b""
        carry = b""
        # find last safe boundary: walk from start tracking groups
        j = 0
        n = len(blk)
        last_safe = 0
        while j < n:
            b = blk[j]
            run = 1
            k = j + 1
            while k < n and blk[k] == b and run < 4:
                run += 1
                k += 1
            if run == 4:
                if k < n:
                    k += 1  # count byte
                else:
                    break  # group incomplete; carry it
            elif k == n and carry_heads and nxt == bytes([b]):
                break  # the head of a group the next block continues
            j = k
            last_safe = j
        carry = blk[last_safe:]
        fixed.append(blk[:last_safe])
    if carry:
        fixed.append(carry)
    return [b for b in fixed if b] or [b""]


def _blocks(data: bytes, block_limit: int):
    """(blocks, plains): the RLE1 stream of `data` as tpu7z splits it into
    blocks, and each block's own RLE1 decode. Where those decodes do not
    join up to `data`, tpu7z's split has cut a run group (ROADMAP.md §3)
    and its stream would decode to other bytes without an error; the
    stream is then split with the groups' heads carried, which decodes
    right. So the blocks are tpu7z's wherever tpu7z's stream is sound."""
    rle = _rle1_encode(data)
    blocks = _split_blocks(rle, block_limit, carry_heads=False)
    plains = [_rle1_decode(blk) for blk in blocks]
    if b"".join(plains) != data:
        blocks = _split_blocks(rle, block_limit, carry_heads=True)
        plains = [_rle1_decode(blk) for blk in blocks]
    return blocks, plains


def compress(data: bytes, level: int = 9, device=None) -> bytes:
    """tpu7z's .bz2 of `data` at `level` (1-9, blocks of level * 100000
    bytes of RLE1 output), each block's BWT on `device` (the CUDA card
    unless it names the CPU), the rest on the host."""
    if not 1 <= level <= 9:
        raise ValueError("bzip2 level 1..9")
    dev = resolve_device(device)
    block_limit = level * 100000
    with trace.span("bzip2.rle1", size=len(data)):
        blocks, plains = _blocks(data, block_limit)

    w = _MSBWriter()
    w.write(0x425A68, 24)  # "BZh"
    w.write(0x30 + level, 8)
    combined = 0
    for blk, plain in zip(blocks, plains):
        if not blk:
            continue
        with trace.span("bzip2.crc"):
            crc = bz_crc32(plain)
        combined = (((combined << 1) | (combined >> 31)) ^ crc) & 0xFFFFFFFF
        _write_block(w, np.frombuffer(blk, dtype=np.uint8), crc, dev)
    w.write(_EOS_MAGIC >> 24, 24)
    w.write(_EOS_MAGIC & 0xFFFFFF, 24)
    w.write(combined, 32)
    return w.close()


def _write_block(w: _MSBWriter, blk: np.ndarray, crc: int, dev):
    w.write(_BLOCK_MAGIC >> 24, 24)
    w.write(_BLOCK_MAGIC & 0xFFFFFF, 24)
    w.write(crc, 32)
    w.write(0, 1)  # not randomized
    with trace.stage("bzip2.bwt", dev, size=blk.size):
        last, ptr = bwt_mod.bwt_forward(blk.tobytes(), device=dev)
    w.write(ptr, 24)
    lastA = np.frombuffer(last, dtype=np.uint8)

    with trace.span("bzip2.mtf"):
        # the byte values present, ascending: np.unique's, without a sort
        used = np.flatnonzero(np.bincount(lastA, minlength=256)).astype(np.uint8)
        used_set = set(used.tolist())
        used_groups = np.zeros(16, dtype=bool)
        for v in used:
            used_groups[v >> 4] = True
        w.write(int("".join("1" if x else "0" for x in used_groups), 2), 16)
        for g in range(16):
            if used_groups[g]:
                bits = 0
                for k in range(16):
                    bits = (bits << 1) | (1 if (g * 16 + k) in used_set else 0)
                w.write(bits, 16)
        syms = _mtf_rle2_encode(lastA, used)

    with trace.span("bzip2.huffman"):
        alpha = used.size + 2
        nsel = max(1, -(-len(syms) // 50))
        # two identical tables (format minimum), all selectors -> 0
        hist = np.bincount(np.array(syms, dtype=np.int64), minlength=alpha)
        hist = np.maximum(hist, 1)  # every symbol needs a code (format quirk)
        lengths = _package_merge(hist, 17)
        codes = _canonical_codes(lengths)

        n_groups = 2
        w.write(n_groups, 3)
        w.write(nsel, 15)
        for _ in range(nsel):
            w.write(0, 1)  # selector MTF: 0 terminated unary => table 0
        for _g in range(n_groups):
            cur = int(lengths[0])
            w.write(cur, 5)
            for s in range(alpha):
                target = int(lengths[s])
                while cur != target:
                    w.write(1, 1)
                    if cur < target:
                        w.write(0, 1)
                        cur += 1
                    else:
                        w.write(1, 1)
                        cur -= 1
                w.write(0, 1)
        code_list = codes.tolist()
        len_list = lengths.tolist()
        for s in syms:
            w.write(code_list[s], len_list[s])


def decompress(src: bytes, device=None) -> bytes:
    """Decode a .bz2 stream: the Huffman and MTF decode and RLE1 on the
    host, each block's inverse BWT on `device` (the CUDA card unless it
    names the CPU); tpu7z's errors."""
    dev = resolve_device(device)
    if len(src) < 10 or src[:3] != b"BZh":
        raise CorruptError("bzip2: bad magic")
    level = src[3] - 0x30
    if not 1 <= level <= 9:
        raise CorruptError("bzip2: bad level digit")
    r = _MSBReader(src)
    r.pos = 32
    out_parts = []
    combined = 0
    block_limit = level * 100000
    while True:
        magic = (r.read(24) << 24) | r.read(24)
        if magic == _EOS_MAGIC:
            want = r.read(32)
            if want != combined:
                raise CorruptError("bzip2: combined crc mismatch")
            break
        if magic != _BLOCK_MAGIC:
            raise CorruptError("bzip2: bad block magic")
        crc_want = r.read(32)
        if r.read(1):
            raise CorruptError("bzip2: randomized blocks unsupported")
        ptr = r.read(24)
        with trace.span("bzip2.huffman_decode"):
            syms, used = _read_block_symbols(r, block_limit)
        with trace.span("bzip2.mtf_decode"):
            blk = _mtf_rle2_decode(syms, used, block_limit + 10)
        with trace.stage("bzip2.ibwt", dev, size=blk.size):
            orig = bwt_mod.bwt_inverse(blk.tobytes(), ptr, device=dev)
        with trace.span("bzip2.rle1_decode"):
            data = _rle1_decode(orig)
            crc = bz_crc32(data)
        if crc != crc_want:
            raise CorruptError("bzip2: block crc mismatch")
        combined = (((combined << 1) | (combined >> 31)) ^ crc) & 0xFFFFFFFF
        out_parts.append(data)
    return b"".join(out_parts)


def _read_block_symbols(r: _MSBReader, block_limit: int):
    """A block's symbol map, tables, selectors and symbols up to its EOB:
    (symbols without the EOB, the used byte values)."""
    groups16 = r.read(16)
    used = []
    for g in range(16):
        if groups16 & (1 << (15 - g)):
            bits = r.read(16)
            for k in range(16):
                if bits & (1 << (15 - k)):
                    used.append(g * 16 + k)
    used = np.array(used, dtype=np.uint8)
    if used.size == 0:
        raise CorruptError("bzip2: empty symbol map")
    alpha = used.size + 2
    n_groups = r.read(3)
    if not 2 <= n_groups <= 6:
        raise CorruptError("bzip2: bad group count")
    nsel = r.read(15)
    sel_mtf = []
    for _ in range(nsel):
        j = 0
        while r.read(1):
            j += 1
            if j >= n_groups:
                raise CorruptError("bzip2: bad selector")
        sel_mtf.append(j)
    # selector MTF decode
    order = list(range(n_groups))
    selectors = []
    for m in sel_mtf:
        v = order.pop(m)
        order.insert(0, v)
        selectors.append(v)
    tables = []
    for _g in range(n_groups):
        cur = r.read(5)
        lens = np.zeros(alpha, dtype=np.int64)
        for s in range(alpha):
            while True:
                if not r.read(1):
                    break
                if r.read(1):
                    cur -= 1
                else:
                    cur += 1
            if not 1 <= cur <= 23:
                raise CorruptError("bzip2: bad code length")
            lens[s] = cur
        tables.append(_decode_table(lens))
    eob = alpha - 1
    syms = []
    gcount = 0
    gidx = -1
    table = None
    while True:
        if gcount == 0:
            gidx += 1
            if gidx >= len(selectors):
                raise CorruptError("bzip2: out of selectors")
            table = tables[selectors[gidx]]
            gcount = 50
        gcount -= 1
        s = _huff_decode_sym(r, table)
        if s == eob:
            break
        syms.append(s)
        if len(syms) > block_limit + 10:
            raise CorruptError("bzip2: block too large")
    return syms, used
