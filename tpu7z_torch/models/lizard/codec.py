"""Lizard 2.1 codec, a port of tpu7z/models/lizard/codec.py: the same
bytes from the same input and level, the same CorruptError messages.

Behavioral reference: C/lizard/lizard_decompress.c (+ _liz.h/_lz4.h
token loops), lizard_frame.c (magic 0x184D2206, LZ4-style frame). The
compressed payload of each frame block is:

  [level byte 10..49]
  chunks until end:
    flags==0x80: uncompressed chunk: LE24 len + raw
    else (bit4 clear): five streams in order
      lengths   : LE24 size + raw              (never entropy-coded)
      offset16  : raw or HUF  (flag bit 2)     HUF: LE24 usize + LE24
      offset24  : raw or HUF  (flag bit 3)          csize + HUF block
      flags     : raw or HUF  (flag bit 1)
      literals  : raw or HUF  (flag bit 0)
    then token decode: levels 10-19 LZ4 code words, 20-49 LIZv1.

HUF streams reuse the zstd Huffman machinery (Lizard embeds a private
copy of the same format, C/lizard/liz_huf_decompress.c).

The encoder covers all four level families: 10-19 LZ4 code words,
20-29 LIZv1 code words (raw streams), 30-39/40-49 the same with each of
the off16/off24/flags/literals streams Huffman-coded where that makes it
smaller. The parses run as tensor code on the device of the caller's
choice (the CUDA card unless `device` names the CPU), every 128 KiB
chunk of the input a row of one candidate sort (`sort_rows` on the
card), a short last chunk padded to a full row:

  LZ4 code words   the greedy parse at hashlog 16 with lizard's limits:
                   offsets 8-0xFFFF, a match starting at least 32 bytes
                   and ending at least 24 bytes before the chunk's end
                   (ops/hash_chain.py `greedy_blocks`)
  LIZv1            the zstd tensor encoder's parse at hashlog 16, depth 2,
                   lazy 1 with a window of the chunk
                   (models/zstd/compressor.py `parse_blocks`), then
                   lizard's cap at 24 bytes before the chunk's end and
                   its keep rule (offset >= 8, a start at least 32 bytes
                   before the end, 16-bit offsets at least 4 long and
                   longer ones at least 16)

Token emission, the Huffman streams and the decoders run on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from ...ops import bitchain, hash_chain
from ...ops.bitstream import pack_bits_lsb
from ...ops.hashing import xxh32_native as _xxh32
from ...utils import trace
from ...utils.errors import CorruptError
from ..zstd import compressor as zc
from ..zstd import huffman as huf

MAGIC = 0x184D2206
MIN_CLEVEL = 10
MAX_CLEVEL = 49
MAX_SHORT_LITLEN = 7
MAX_SHORT_MATCHLEN = 15
LAST_LONG_OFF = 31
MM_LONGOFF = 16
BLOCK_SIZE = 1 << 17
HASHLOG = 16


def _huf_decompress(src: bytes, regen: int) -> bytes:
    """HUF_decompress semantics: tree description + 4-stream payload."""
    weights, used = huf.read_tree_description(src)
    sym, nb, table_log = huf.build_decode_table(weights)
    payload = src[used:]
    if len(payload) < 6:
        raise CorruptError("lizard: truncated huf jump table")
    s1 = payload[0] | (payload[1] << 8)
    s2 = payload[2] | (payload[3] << 8)
    s3 = payload[4] | (payload[5] << 8)
    body = payload[6:]
    parts = (body[:s1], body[s1:s1 + s2], body[s1 + s2:s1 + s2 + s3],
             body[s1 + s2 + s3:])
    n123 = (regen + 3) // 4
    counts = (n123, n123, n123, regen - 3 * n123)
    outs = []
    for part, count in zip(parts, counts):
        if count == 0:
            outs.append(np.empty(0, np.uint8))
            continue
        outs.append(bitchain.chain_decode(
            np.frombuffer(part, dtype=np.uint8), sym, nb, table_log,
            count).astype(np.uint8))
    return np.concatenate(outs).tobytes()


class _Streams:
    __slots__ = ("lengths", "off16", "off24", "flags", "literals",
                 "lp", "o16p", "o24p", "fp")

    def __init__(self):
        self.lp = self.o16p = self.o24p = self.fp = 0


def _read_stream(src: bytes, pos: int, compressed: bool):
    if not compressed:
        if pos + 3 > len(src):
            raise CorruptError("lizard: truncated stream header")
        size = int.from_bytes(src[pos:pos + 3], "little")
        if pos + 3 + size > len(src):
            raise CorruptError("lizard: truncated stream")
        return src[pos + 3:pos + 3 + size], pos + 3 + size
    if pos + 6 > len(src):
        raise CorruptError("lizard: truncated huf stream header")
    usize = int.from_bytes(src[pos:pos + 3], "little")
    csize = int.from_bytes(src[pos + 3:pos + 6], "little")
    if pos + 6 + csize > len(src):
        raise CorruptError("lizard: truncated huf stream")
    data = _huf_decompress(src[pos + 6:pos + 6 + csize], usize)
    return data, pos + 6 + csize


def _read_ext_len(st: _Streams, base: int) -> int:
    lit = st.literals
    if st.lp >= len(lit):
        raise CorruptError("lizard: missing extended length")
    v = lit[st.lp]
    if v < 254:
        st.lp += 1
        return v + base
    if v == 254:
        out = lit[st.lp + 1] | (lit[st.lp + 2] << 8)
        st.lp += 3
        return out + base
    out = lit[st.lp + 1] | (lit[st.lp + 2] << 8) | (lit[st.lp + 3] << 16)
    st.lp += 4
    return out + base


def _decode_chunk_lz4(st: _Streams, out: bytearray):
    """Lizard LZ4 code words (lizard_decompress_lz4.h semantics)."""
    flags = st.flags
    lit = st.literals
    while st.fp < len(flags):
        token = flags[st.fp]
        st.fp += 1
        litlen = token & 15
        if litlen == 15:
            litlen = _read_ext_len(st, 15)
        out += lit[st.lp:st.lp + litlen]
        st.lp += litlen
        offset = lit[st.lp] | (lit[st.lp + 1] << 8)
        st.lp += 2
        mlen = token >> 4
        if mlen == 15:
            mlen = _read_ext_len(st, 15)
        mlen += 4
        _copy_match(out, offset, mlen)
    # last literals
    out += lit[st.lp:]
    st.lp = len(lit)


def _decode_chunk_liz(st: _Streams, out: bytearray, last_off: int) -> int:
    """LIZv1 code words (lizard_decompress_liz.h semantics)."""
    flags = st.flags
    lit = st.literals
    while st.fp < len(flags):
        token = flags[st.fp]
        st.fp += 1
        if token >= 32:
            litlen = token & MAX_SHORT_LITLEN
            if litlen == MAX_SHORT_LITLEN:
                litlen = _read_ext_len(st, MAX_SHORT_LITLEN)
            out += lit[st.lp:st.lp + litlen]
            st.lp += litlen
            if (token >> 7) == 0:
                if st.o16p + 2 <= len(st.off16):
                    last_off = st.off16[st.o16p] | (st.off16[st.o16p + 1] << 8)
                    st.o16p += 2
            mlen = (token >> 3) & MAX_SHORT_MATCHLEN
            if mlen == MAX_SHORT_MATCHLEN:
                mlen = _read_ext_len(st, MAX_SHORT_MATCHLEN)
        elif token < LAST_LONG_OFF:
            mlen = token + MM_LONGOFF
            last_off = int.from_bytes(st.off24[st.o24p:st.o24p + 3], "little")
            st.o24p += 3
        else:
            mlen = _read_ext_len(st, LAST_LONG_OFF + MM_LONGOFF)
            last_off = int.from_bytes(st.off24[st.o24p:st.o24p + 3], "little")
            st.o24p += 3
        if mlen:
            _copy_match(out, last_off, mlen)
    out += lit[st.lp:]
    st.lp = len(lit)
    return last_off


def _copy_match(out: bytearray, offset: int, mlen: int):
    if offset == 0 or offset > len(out):
        raise CorruptError("lizard: bad match offset")
    start = len(out) - offset
    if offset >= mlen:
        out += out[start:start + mlen]
    else:
        chunk = out[start:]
        while mlen > 0:
            take = min(mlen, len(chunk))
            out += chunk[:take]
            mlen -= take


def decompress_block(src: bytes, max_out: int) -> bytes:
    if len(src) < 1:
        raise CorruptError("lizard: empty block")
    level = src[0]
    if not MIN_CLEVEL <= level <= MAX_CLEVEL:
        raise CorruptError(f"lizard: bad level byte {level}")
    # level families (lizard README): 10-19 fastLZ4, 20-29 LIZv1,
    # 30-39 fastLZ4+Huffman, 40-49 LIZv1+Huffman
    liz_words = (20 <= level <= 29) or (40 <= level <= 49)
    pos = 1
    out = bytearray()
    while pos < len(src):
        flags = src[pos]
        pos += 1
        if flags == 0x80:
            length = int.from_bytes(src[pos:pos + 3], "little")
            pos += 3
            out += src[pos:pos + length]
            pos += length
            continue
        if flags & 0x10:
            raise CorruptError("lizard: reserved chunk flag")
        st = _Streams()
        st.lengths, pos = _read_stream(src, pos, False)
        st.off16, pos = _read_stream(src, pos, bool(flags & 4))
        st.off24, pos = _read_stream(src, pos, bool(flags & 8))
        st.flags, pos = _read_stream(src, pos, bool(flags & 2))
        st.literals, pos = _read_stream(src, pos, bool(flags & 1))
        if liz_words:
            _decode_chunk_liz(st, out, 0)
        else:
            _decode_chunk_lz4(st, out)
        if len(out) > max_out:
            raise CorruptError("lizard: output overflow")
    return bytes(out)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _families(level: int):
    """(LIZv1 code words, Huffman-coded streams) of a level."""
    return (20 <= level <= 29) or (40 <= level <= 49), level >= 30


def _parse(s, liz_words: bool):
    """Every BLOCK_SIZE chunk's matches, positions in `s` (a uint8
    tensor): (mpos, mlen, moff) int64 numpy arrays sorted by position, as
    tpu7z's `_find_liz` (LIZv1) or `_find` (LZ4 code words) gives them
    for each chunk alone."""
    n = s.numel()
    if liz_words:
        mpos, mlen, moff = zc.parse_blocks(s, BLOCK_SIZE, HASHLOG, depth=2, lazy=1,
                                           min_block=48)
        nb = torch.clamp((mpos // BLOCK_SIZE + 1) * BLOCK_SIZE, max=n)
        # the reference decoder's fast-path end margins
        # (lizard_decompress_liz.h): keep the tail as plain literals,
        # truncate matches at the cap
        mlen = torch.minimum(mlen, (nb - 24) - mpos)
        keep = (moff >= 8) & (mpos <= nb - 32) & (
            mlen >= torch.where(moff <= 0xFFFF, 4, MM_LONGOFF))
        mpos, mlen, moff = mpos[keep], mlen[keep], moff[keep]
    else:
        # LIZARD_FAST_MIN_OFFSET 8 (the decoder's 8-byte block copies);
        # the last 32 bytes stay literals and a match ends 24 before the
        # end (lizard_decompress_lz4.h's wildcopy margins)
        take, ml, off = hash_chain.greedy_blocks(s, BLOCK_SIZE, HASHLOG, min_offset=8,
                                                 tail=32, end=24, min_len=4, min_block=16)
        mpos = torch.nonzero(take).flatten()
        mlen, moff = ml[mpos], off[mpos]
    return mpos.cpu().numpy(), mlen.cpu().numpy(), moff.cpu().numpy()


def _encode(data: bytes, level: int, dev) -> list:
    """The encoded chunk bodies of data's BLOCK_SIZE chunks (one empty
    chunk for empty data), each chunk's parse from one batched call."""
    liz_words, entropy = _families(level)
    s = np.frombuffer(data, dtype=np.uint8)
    if s.size:
        mpos, mlen, moff = _parse(torch.from_numpy(s.copy()).to(dev), liz_words)
    else:
        mpos = mlen = moff = np.empty(0, np.int64)
    starts = range(0, max(len(data), 1), BLOCK_SIZE)
    cuts = np.searchsorted(mpos, [*starts, len(data)])
    enc = _encode_chunk_liz if liz_words else _encode_chunk_lz4
    out = []
    with trace.span("lizard.emit", size=len(data)):
        for i, start in enumerate(starts):
            lo, hi = cuts[i], cuts[i + 1]
            out.append(enc(data[start:start + BLOCK_SIZE],
                           (mpos[lo:hi] - start, mlen[lo:hi], moff[lo:hi]), entropy))
    return out


def compress_block(data: bytes, level: int = 11, device=None) -> bytes:
    """tpu7z's lizard block: the level byte and every BLOCK_SIZE chunk,
    the parses on `device` (the CUDA card unless it names the CPU)."""
    dev = resolve_device(device)
    return bytes([level]) + b"".join(_encode(bytes(data), level, dev))


def _huf_compress(data: bytes):
    """HUF_compress4X payload (tree + jump table + 4 backward streams,
    liz_huf_compress.c format = zstd's): None when not smaller."""
    lits = np.frombuffer(data, np.uint8)
    if lits.size < 64:
        return None
    hist = np.bincount(lits, minlength=256)
    if np.count_nonzero(hist) < 2:
        return None
    built = huf.build_weights(hist)
    if built is None:
        return None
    weights, nsym = built
    tree = huf.write_tree_description(weights, nsym)
    if tree is None:
        return None
    code_val, code_bits, _tl = huf.build_encode_table(weights)
    n123 = (lits.size + 3) // 4
    parts = [lits[:n123], lits[n123:2 * n123],
             lits[2 * n123:3 * n123], lits[3 * n123:]]
    streams = []
    for p in parts:
        if p.size == 0:
            streams.append(b"")
            continue
        vals = code_val[p].astype(np.uint64)[::-1]
        nbs = code_bits[p].astype(np.int64)[::-1]
        streams.append(pack_bits_lsb(vals, nbs, end_marker=True))
    if any(len(s) > 0xFFFF for s in streams[:3]):
        return None
    jump = b"".join(len(x).to_bytes(2, "little") for x in streams[:3])
    payload = tree + jump + b"".join(streams)
    if len(payload) + 3 >= len(data):
        return None
    return payload


def _emit_streams(off16: bytes, off24: bytes, flags: bytes, lit: bytes,
                  entropy: bool) -> bytes:
    """Chunk body: flags byte + the 5 streams, Huffman-compressing each
    of off16/off24/flags/literals independently when `entropy` (levels
    30-49, liz_huf_compress.c) and smaller."""
    fbits = 0
    parts = []
    for bit, data in ((4, off16), (8, off24), (2, flags), (1, lit)):
        comp = _huf_compress(bytes(data)) if entropy else None
        if comp is not None:
            fbits |= bit
            parts.append(len(data).to_bytes(3, "little")
                         + len(comp).to_bytes(3, "little") + comp)
        else:
            parts.append(len(data).to_bytes(3, "little") + bytes(data))
    body = bytearray([fbits])
    body += (0).to_bytes(3, "little")       # lengths stream (unused)
    for p in parts:
        body += p
    return bytes(body)


def _encode_chunk_liz(chunk: bytes, matches, entropy: bool = False) -> bytes:
    """LIZv1 code words (lizard_compress_liz.h behavior re-derived from
    the decoder token forms): short tokens carry a 16-bit offset or
    repeat the previous one (bit 7); tokens < 31 are long-offset
    (24-bit) matches of length >= 16 with no literal run."""
    mpos, mlen, moff = matches
    flags = bytearray()
    lit = bytearray()
    off16 = bytearray()
    off24 = bytearray()
    pos = 0
    last_off = 0
    for p, ln, o in zip(mpos.tolist(), mlen.tolist(), moff.tolist()):
        litlen = p - pos
        if o == last_off or o <= 0xFFFF:
            token = min(litlen, MAX_SHORT_LITLEN) | (min(ln, MAX_SHORT_MATCHLEN) << 3)
            if o == last_off:
                token |= 0x80
            flags.append(token)
            if litlen >= MAX_SHORT_LITLEN:
                _ext_len(lit, litlen - MAX_SHORT_LITLEN)
            lit += chunk[pos:p]
            if o != last_off:
                off16 += o.to_bytes(2, "little")
            if ln >= MAX_SHORT_MATCHLEN:
                _ext_len(lit, ln - MAX_SHORT_MATCHLEN)
        else:
            # long-offset token carries no literal run: a literal-only
            # run first, as a repeat-offset token with mlen = 0
            if litlen:
                flags.append(0x80 | min(litlen, MAX_SHORT_LITLEN))
                if litlen >= MAX_SHORT_LITLEN:
                    _ext_len(lit, litlen - MAX_SHORT_LITLEN)
                lit += chunk[pos:p]
            if ln < LAST_LONG_OFF + MM_LONGOFF:
                flags.append(ln - MM_LONGOFF)
            else:
                flags.append(LAST_LONG_OFF)
                _ext_len(lit, ln - (LAST_LONG_OFF + MM_LONGOFF))
            off24 += o.to_bytes(3, "little")
        last_off = o
        pos = p + ln
    lit += chunk[pos:]
    return _emit_streams(bytes(off16), bytes(off24), bytes(flags), bytes(lit), entropy)


def _encode_chunk_lz4(chunk: bytes, matches, entropy: bool = False) -> bytes:
    mpos, mlen, moff = matches
    flags = bytearray()
    lit = bytearray()
    pos = 0
    for p, ln, o in zip(mpos.tolist(), mlen.tolist(), moff.tolist()):
        litlen = p - pos
        flags.append(min(litlen, 15) | (min(ln - 4, 15) << 4))
        if litlen >= 15:
            _ext_len(lit, litlen - 15)
        lit += chunk[pos:p]
        lit += o.to_bytes(2, "little")
        if ln - 4 >= 15:
            _ext_len(lit, ln - 4 - 15)
        pos = p + ln
    # trailing literals: no token, just append
    lit += chunk[pos:]
    return _emit_streams(b"", b"", bytes(flags), bytes(lit), entropy)


def _ext_len(buf: bytearray, v: int):
    if v < 254:
        buf.append(v)
    elif v <= 0xFFFF:
        buf.append(254)
        buf += v.to_bytes(2, "little")
    else:
        buf.append(255)
        buf += v.to_bytes(3, "little")


# --- frame layer (LZ4-style, magic 0x184D2206) -----------------------------

_BD_SIZES = {1: 128 * 1024, 4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}


def compress_frame(data: bytes, block_size: int = 1 << 17, level: int = 11,
                   device=None) -> bytes:
    """tpu7z's lizard frame: 128 KiB blocks (`block_size` is read and
    ignored, as tpu7z ignores it), content size and checksum. Every
    block's parse on `device` (the CUDA card unless it names the CPU),
    the full blocks the rows of one candidate sort. A span `lizard.emit`
    when tracing is on."""
    dev = resolve_device(device)
    data = bytes(data)
    out = bytearray()
    out += MAGIC.to_bytes(4, "little")
    flg = (1 << 6) | (1 << 5) | (1 << 3) | (1 << 2)
    bd_code = 1  # lizard block size id 1 = LIZARD_BLOCK_SIZE (128 KiB)
    bsize = _BD_SIZES[bd_code]
    hdr = bytearray([flg, bd_code << 4])
    hdr += len(data).to_bytes(8, "little")
    out += hdr
    out.append((_xxh32(bytes(hdr)) >> 8) & 0xFF)
    chunks = _encode(data, level, dev) if data else []
    for i, start in enumerate(range(0, len(data), bsize)):
        chunk = data[start:start + bsize]
        comp = bytes([level]) + chunks[i]
        if len(comp) >= len(chunk):
            out += (len(chunk) | 0x80000000).to_bytes(4, "little")
            out += chunk
        else:
            out += len(comp).to_bytes(4, "little")
            out += comp
    out += (0).to_bytes(4, "little")
    out += _xxh32(data).to_bytes(4, "little")
    return bytes(out)


def decompress_frame(src: bytes):
    if len(src) < 7:
        raise CorruptError("lizard frame: truncated")
    magic = int.from_bytes(src[:4], "little")
    if 0x184D2A50 <= magic <= 0x184D2A5F:
        size = int.from_bytes(src[4:8], "little")
        return b"", 8 + size
    if magic != MAGIC:
        raise CorruptError(f"lizard frame: bad magic {magic:#x}")
    flg = src[4]
    bd = src[5]
    c_size = bool(flg & (1 << 3))
    c_checksum = bool(flg & (1 << 2))
    b_checksum = bool(flg & (1 << 4))
    pos = 6
    content_size = None
    if c_size:
        content_size = int.from_bytes(src[pos:pos + 8], "little")
        pos += 8
    pos += 1
    bsize = _BD_SIZES.get((bd >> 4) & 7, 1 << 22)
    chunks = []
    while True:
        bhdr = int.from_bytes(src[pos:pos + 4], "little")
        pos += 4
        if bhdr == 0:
            break
        stored = bool(bhdr & 0x80000000)
        blen = bhdr & 0x7FFFFFFF
        payload = src[pos:pos + blen]
        pos += blen
        if b_checksum:
            pos += 4
        chunks.append(bytes(payload) if stored
                      else decompress_block(payload, bsize))
    data = b"".join(chunks)
    if c_checksum:
        want = int.from_bytes(src[pos:pos + 4], "little")
        if _xxh32(data) != want:
            raise CorruptError("lizard frame: content checksum mismatch")
        pos += 4
    if content_size is not None and len(data) != content_size:
        raise CorruptError("lizard frame: size mismatch")
    return data, pos


def decompress(src: bytes) -> bytes:
    src = bytes(src)
    pos = 0
    parts = []
    while pos < len(src):
        data, used = decompress_frame(src[pos:])
        parts.append(data)
        pos += used
    return b"".join(parts)
