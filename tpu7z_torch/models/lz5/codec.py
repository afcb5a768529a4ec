"""LZ5 1.5 codec, a port of tpu7z/models/lz5/codec.py: the same bytes
from the same input, the same CorruptError messages.

Behavioral reference: C/lz5/lz5.c (LZ5_decompress_generic) and
lz5frame.c (frame magic 0x184D2205, layout shared with the LZ4 frame).
Block format (MINMATCH=3):

  token bits [7..0]:
    1 o o l l m m m   short offset: 10 bits = oo<<8 | next byte
    0 0 l l l m m m   16-bit offset (LE16 follows literals)
    0 1 0 l l m m m   24-bit offset (LE24)
    0 1 1 l l m m m   repeat last offset (no offset bytes)
  lit field: 3 bits when high bits are 00, else 2 bits; 255-extension.
  match field: 3 bits + 255-extension, + MINMATCH.

The encoder emits 16-bit-offset and repeat tokens, a valid subset of the
format the reference decoder accepts. Its parse is LZ4's greedy parse
with LZ5's limits (offset <= 0xFFFF, a match starting at most
MF_LIMIT + 1 bytes before the block's end and ending LAST_LITERALS bytes
before it, at least MIN_MATCH + 1 long), as tensor code on the device of
the caller's choice (the CUDA card unless `device` names the CPU):
`compress_frame` parses every block as a row of one candidate sort
(`sort_rows` on the card), a short last block padded to a full row
(ops/hash_chain.py `greedy_blocks`). The token emission, the frame and
the decoders run on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from ...ops import hash_chain
from ...ops.hashing import xxh32_native as _xxh32
from ...utils import trace
from ...utils.errors import CorruptError

MIN_MATCH = 3
LAST_LITERALS = 5
MF_LIMIT = 12
MAGIC = 0x184D2205
HASHLOG = 16


def decompress_block(src: bytes, dst_size: int | None = None,
                     max_out: int | None = None) -> bytes:
    s = bytes(src)
    n = len(s)
    if dst_size is not None:
        cap = dst_size
    elif max_out is not None:
        cap = max_out
    else:
        cap = max(64, n * 256)
    out = bytearray(cap)
    ip = 0
    op = 0
    last_off = 1
    while ip < n:
        token = s[ip]
        ip += 1
        if token >> 6:
            litlen = (token >> 3) & 3
            if litlen == 3:
                while True:
                    b = s[ip]
                    ip += 1
                    litlen += b
                    if b != 255:
                        break
        else:
            litlen = (token >> 3) & 7
            if litlen == 7:
                while True:
                    b = s[ip]
                    ip += 1
                    litlen += b
                    if b != 255:
                        break
        if ip + litlen > n or op + litlen > cap:
            raise CorruptError("lz5: literal overrun")
        out[op:op + litlen] = s[ip:ip + litlen]
        ip += litlen
        op += litlen
        if ip >= n:
            break
        # offset
        if token >> 7:
            offset = s[ip] + (((token >> 5) & 3) << 8)
            ip += 1
        elif (token >> 6) == 0:
            offset = s[ip] | (s[ip + 1] << 8)
            ip += 2
        elif (token >> 5) == 2:
            offset = s[ip] | (s[ip + 1] << 8) | (s[ip + 2] << 16)
            ip += 3
        else:  # (token >> 5) == 3
            offset = last_off
        last_off = offset
        mlen = token & 7
        if mlen == 7:
            while True:
                b = s[ip]
                ip += 1
                mlen += b
                if b != 255:
                    break
        mlen += MIN_MATCH
        if offset == 0 or offset > op or op + mlen > cap:
            raise CorruptError("lz5: bad match")
        start = op - offset
        if offset >= mlen:
            out[op:op + mlen] = out[start:start + mlen]
        else:
            period = out[start:start + offset]
            out[op:op + mlen] = (period * (-(-mlen // offset)))[:mlen]
        op += mlen
    if dst_size is not None and op != dst_size:
        raise CorruptError(f"lz5: decoded {op}, expected {dst_size}")
    return bytes(out[:op])


def _parse(s, block_size: int):
    """(take positions, lengths, offsets) as int64 numpy arrays, positions
    in `s` (a uint8 tensor): the greedy parse of each `block_size` block,
    the matches of a block of fewer than MF_LIMIT + 1 bytes none."""
    take, mlen, off = hash_chain.greedy_blocks(
        s, block_size, HASHLOG, tail=MF_LIMIT + 1, end=LAST_LITERALS,
        min_len=MIN_MATCH + 1, min_block=MF_LIMIT + 1)
    sel = torch.nonzero(take).flatten()
    return sel.cpu().numpy(), mlen[sel].cpu().numpy(), off[sel].cpu().numpy()


def compress_block(src: bytes, device=None) -> bytes:
    """One LZ5 block: tpu7z's `compress_block`, its parse on `device`
    (the CUDA card unless it names the CPU)."""
    dev = resolve_device(device)
    s = np.frombuffer(bytes(src), dtype=np.uint8)
    n = s.size
    if n == 0:
        return b"\x00"
    empty = np.empty(0, np.int64)
    if n < MF_LIMIT + 1:
        return _emit(s, empty, empty, empty)
    mpos, mlen, moff = _parse(torch.from_numpy(s.copy()).to(dev), n)
    return _emit(s, mpos, mlen, moff)


def _emit(s: np.ndarray, mpos, mlen, moff) -> bytes:
    """Sequence emission: 16-bit offsets, repeat tokens when possible."""
    out = bytearray()
    src = s.tobytes()
    n = s.size
    pos = 0
    last_off = 1
    for p, ln, o in zip(mpos.tolist(), mlen.tolist(), moff.tolist()):
        lit = p - pos
        rep = o == last_off
        ml_code = min(ln - MIN_MATCH, 7)
        if rep:
            token = (0b011 << 5) | (min(lit, 3) << 3) | ml_code
        else:
            token = (min(lit, 7) << 3) | ml_code
        out.append(token)
        _ext(out, lit, 3 if rep else 7)
        out += src[pos:p]
        if not rep:
            out += o.to_bytes(2, "little")
        _ext(out, ln - MIN_MATCH, 7)
        last_off = o
        pos = p + ln
    lit = n - pos
    out.append(min(lit, 7) << 3)
    _ext(out, lit, 7)
    out += src[pos:]
    return bytes(out)


def _ext(out: bytearray, value: int, mask: int):
    if value >= mask:
        v = value - mask
        out += b"\xff" * (v // 255)
        out.append(v % 255)


# --- frame layer (same structure as LZ4 frame, magic 0x184D2205) ----------

_BD_SIZES = {4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}


def compress_frame(data: bytes, block_size: int = 1 << 22, device=None) -> bytes:
    """tpu7z's LZ5 frame (content size and checksum, independent blocks
    of `block_size` rounded to a frame size). Every block's parse on
    `device` (the CUDA card unless it names the CPU), the full blocks the
    rows of one candidate sort. A span `lz5.emit` when tracing is on."""
    dev = resolve_device(device)
    data = bytes(data)
    bd_code = next(c for c in (4, 5, 6, 7) if block_size <= _BD_SIZES[c])
    bsize = min(block_size, _BD_SIZES[bd_code])
    out = bytearray()
    out += MAGIC.to_bytes(4, "little")
    flg = (1 << 6) | (1 << 5) | (1 << 3) | (1 << 2)
    hdr = bytearray([flg, bd_code << 4])
    hdr += len(data).to_bytes(8, "little")
    out += hdr
    out.append((_xxh32(bytes(hdr)) >> 8) & 0xFF)
    s = np.frombuffer(data, dtype=np.uint8)
    if s.size:
        mpos, mlen, moff = _parse(torch.from_numpy(s.copy()).to(dev), bsize)
    else:
        mpos = mlen = moff = np.empty(0, np.int64)
    cuts = np.searchsorted(mpos, np.arange(0, len(data) + bsize, bsize))
    with trace.span("lz5.emit", size=len(data)):
        for i, start in enumerate(range(0, len(data), bsize)):
            chunk = s[start:start + bsize]
            lo, hi = cuts[i], cuts[i + 1]
            comp = _emit(chunk, mpos[lo:hi] - start, mlen[lo:hi], moff[lo:hi])
            if len(comp) >= chunk.size:
                out += (chunk.size | 0x80000000).to_bytes(4, "little")
                out += chunk.tobytes()
            else:
                out += len(comp).to_bytes(4, "little")
                out += comp
    out += (0).to_bytes(4, "little")
    out += _xxh32(data).to_bytes(4, "little")
    return bytes(out)


def decompress_frame(src: bytes):
    if len(src) < 7:
        raise CorruptError("lz5 frame: truncated")
    magic = int.from_bytes(src[:4], "little")
    if 0x184D2A50 <= magic <= 0x184D2A5F:
        size = int.from_bytes(src[4:8], "little")
        return b"", 8 + size
    if magic != MAGIC:
        raise CorruptError(f"lz5 frame: bad magic {magic:#x}")
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
    pos += 1  # header checksum
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
                      else decompress_block(payload, max_out=bsize))
    data = b"".join(chunks)
    if c_checksum:
        want = int.from_bytes(src[pos:pos + 4], "little")
        if _xxh32(data) != want:
            raise CorruptError("lz5 frame: content checksum mismatch")
        pos += 4
    if content_size is not None and len(data) != content_size:
        raise CorruptError("lz5 frame: size mismatch")
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
