"""The LZMA2 chunk layer: tpu7z/models/lzma/lzma2.py.

Behavioral reference: C/Lzma2Enc.c (chunk control bytes, :313-320 block
sizing) and C/Lzma2Dec.c, from the public LZMA2 format:

  control 0x00                end of stream
  control 0x01 / 0x02         uncompressed chunk (dict reset / no reset)
                              + u16be (size-1) + raw bytes
  control 0x80|u(5 bits hi)   LZMA chunk: u16be low bits of (usize-1),
                              u16be (csize-1); reset mode in bits 5-6:
                              0 none, 1 state, 2 state+props byte,
                              3 state+props+dict

`compress` is the host library's optimal parse (native.py), one stream
or shards that each reset the dictionary; `compress_chunks` is tpu7z's
fast-parse chunk sequence, its parse on the card (encoder.py); and
`decompress` reads any stream through the host range decoder.
"""

from __future__ import annotations

import numpy as np

from ...utils import trace
from ...utils.errors import CorruptError
from . import native
from .decoder import LzmaDecoder, parse_props_byte
from .encoder import LzmaEncoder, WindowMatcher

CHUNK_MAX = 1 << 21  # max uncompressed bytes per LZMA2 chunk (format: 2MB)


def decompress(src: bytes, out_size: int | None = None) -> bytes:
    """Decode an LZMA2 stream (sequence of chunks until control 0)."""
    pos = 0
    dec: LzmaDecoder | None = None
    out_parts_size = 0
    cap = out_size if out_size is not None else max(1 << 16, len(src) * 4)
    # single contiguous window (LZMA2 matches may span chunks)
    while True:
        if pos >= len(src):
            raise CorruptError("lzma2: missing end-of-stream control")
        ctrl = src[pos]
        pos += 1
        if ctrl == 0:
            break
        if ctrl in (1, 2):
            if pos + 2 > len(src):
                raise CorruptError("lzma2: truncated uncompressed header")
            usize = ((src[pos] << 8) | src[pos + 1]) + 1
            pos += 2
            if pos + usize > len(src):
                raise CorruptError("lzma2: truncated uncompressed chunk")
            if dec is None:
                dec = LzmaDecoder(0, 0, 0, max(cap, usize))
            if ctrl == 1:  # uncompressed chunk WITH dictionary reset
                dec.dict_reset()
            dec._grow(dec.pos + usize)
            dec.out[dec.pos:dec.pos + usize] = np.frombuffer(
                src[pos:pos + usize], dtype=np.uint8)
            dec.pos += usize
            # coder state is invalid after an uncompressed chunk; a valid
            # stream's next compressed chunk declares a state reset. The
            # contiguous window keeps all bytes, which is a superset of
            # dict-reset semantics (offsets of valid streams stay legal).
            pos += usize
            continue
        if ctrl < 0x80:
            raise CorruptError(f"lzma2: bad control byte {ctrl:#x}")
        usize = (((ctrl & 0x1F) << 16)
                 | (src[pos] << 8) | src[pos + 1]) + 1
        csize = ((src[pos + 2] << 8) | src[pos + 3]) + 1
        pos += 4
        reset = (ctrl >> 5) & 3
        if reset >= 2:
            if pos >= len(src):
                raise CorruptError("lzma2: missing props byte")
            lc, lp, pb = parse_props_byte(src[pos])
            pos += 1
            if dec is None:
                dec = LzmaDecoder(lc, lp, pb, max(cap, usize))
            else:
                dec.reset_props(lc, lp, pb)
            if reset == 3:
                dec.dict_reset()
        else:
            if dec is None:
                raise CorruptError("lzma2: first chunk must set props")
            if reset == 1:
                dec.reset_state()
        if pos + csize > len(src):
            raise CorruptError("lzma2: truncated chunk")
        dec._grow(dec.pos + usize)
        consumed = dec.decode_chunk(src[pos:pos + csize], usize)
        pos += csize
    if dec is None:
        return b""
    if out_size is not None and dec.pos != out_size:
        raise CorruptError("lzma2: size mismatch")
    return dec.out[: dec.pos].tobytes()


def compress_chunks(data: bytes, lc: int = 3, lp: int = 0, pb: int = 2,
                    chunk_size: int = 1 << 16, device=None) -> bytes:
    """Encode one LZMA2 chunk sequence (no trailing end marker): first
    chunk resets dict+state+props, later chunks continue state.

    Chunks are 64 KiB of input: the LZMA2 compressed-size field is u16,
    so any chunk whose stream exceeds 64 KiB would have to be STORED —
    with 64 KiB input that case coincides with comp >= usize, which is
    stored anyway. Chunk boundaries keep state and dictionary (reset=0),
    so the only cost is the 5-byte header + range-coder flush per chunk.

    The parse runs on `device` (the card unless it names the CPU): one
    `WindowMatcher` over the input, then each chunk's walk; the range
    coding runs on the host (span `lzma.range_code`)."""
    window = np.frombuffer(bytes(data), dtype=np.uint8)
    n = window.size
    raw = window.tobytes()
    matcher = WindowMatcher(window, device=device)
    out = bytearray()
    enc = LzmaEncoder(lc, lp, pb)
    start = 0
    need_reset = 2  # 0 none, 1 state, 2 state+props (first: +dict -> 3)
    first = True
    while start < n:
        end = min(start + min(chunk_size, CHUNK_MAX), n)
        usize = end - start
        if need_reset:
            enc.reset_state()
        matches = matcher.matches(start, end)
        with trace.span("lzma.range_code", size=usize):
            comp = enc.encode_chunk(raw, start, end, matches)
        if len(comp) >= usize or len(comp) > 0xFFFF + 1:
            # uncompressed chunks carry at most 64K each (u16 size field)
            p = start
            while p < end:
                e2 = min(p + 0x10000, end)
                out.append(1 if first else 2)
                out += (e2 - p - 1).to_bytes(2, "big")
                out += window[p:e2].tobytes()
                first = False
                p = e2
            # state invalid now; keep 2 until props have been declared once
            need_reset = max(need_reset, 1)
        else:
            reset = 3 if first else need_reset
            ctrl = 0x80 | (reset << 5) | ((usize - 1) >> 16)
            out.append(ctrl)
            out += ((usize - 1) & 0xFFFF).to_bytes(2, "big")
            out += (len(comp) - 1).to_bytes(2, "big")
            if reset >= 2:
                out.append(enc.props_byte())
            out += comp
            need_reset = 0
        start = end
        first = False
    return bytes(out)


def compress(data: bytes, lc: int = 3, lp: int = 0, pb: int = 2,
             chunk_size: int = 1 << 16, shard_size: int | None = None,
             level: int = 9) -> bytes:
    """Encode a complete LZMA2 stream by the host library's optimal parse
    (csrc/lzma_enc.cpp, chunks of 64 KiB whatever `chunk_size` says, as
    in tpu7z). With shard_size, the input splits into dict-independent
    shards (each starts with a full reset chunk), the MtCoder/Lzma2Enc
    block model (C/Lzma2Enc.c:313-320), concatenated in order."""
    return native.lzma2_encode(data, level=level, lc=lc, lp=lp, pb=pb,
                               shard_size=shard_size or 0)
