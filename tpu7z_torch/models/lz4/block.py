"""LZ4 raw block decoder (host numpy).

Format (lz4_Block_format):
  sequence := token(1) [litlen-ext 255*] literals [offset u16le]
              [matchlen-ext 255*]
  token    := (litlen:4 | matchlen-4:4), 15 in a nibble => extension bytes
"""

from __future__ import annotations

import numpy as np

MIN_MATCH = 4


class CorruptError(ValueError):
    """The input violates the LZ4 format."""


def decompress_block(src, dst_size: int | None = None,
                     cap_hint: int | None = None) -> bytes:
    """Decode one raw LZ4 block: a host loop over sequences with
    vectorized literal and match copies (period trick for overlaps).

    dst_size: the exact decoded size, enforced. cap_hint: an upper bound
    only, such as the frame's block size.
    """
    s = np.frombuffer(bytes(src), dtype=np.uint8)
    n = s.size
    if dst_size is not None:
        cap = dst_size
    elif cap_hint is not None:
        cap = cap_hint
    else:
        cap = max(64, n * 255)
    out = np.empty(cap, dtype=np.uint8)
    ip = 0
    op = 0
    while ip < n:
        token = int(s[ip]); ip += 1
        litlen = token >> 4
        if litlen == 15:
            while True:
                if ip >= n:
                    raise CorruptError("lz4: truncated literal length")
                b = int(s[ip]); ip += 1
                litlen += b
                if b != 255:
                    break
        if ip + litlen > n:
            raise CorruptError("lz4: literal run past input end")
        if op + litlen > cap:
            raise CorruptError("lz4: output overflow (literals)")
        out[op:op + litlen] = s[ip:ip + litlen]
        ip += litlen
        op += litlen
        if ip == n:
            break  # last sequence has no match part
        if ip + 2 > n:
            raise CorruptError("lz4: truncated offset")
        offset = int(s[ip]) | (int(s[ip + 1]) << 8)
        ip += 2
        if offset == 0 or offset > op:
            raise CorruptError("lz4: invalid offset")
        mlen = (token & 15) + MIN_MATCH
        if (token & 15) == 15:
            while True:
                if ip >= n:
                    raise CorruptError("lz4: truncated match length")
                b = int(s[ip]); ip += 1
                mlen += b
                if b != 255:
                    break
        if op + mlen > cap:
            raise CorruptError("lz4: output overflow (match)")
        start = op - offset
        if offset >= mlen:
            out[op:op + mlen] = out[start:start + mlen]
        else:
            # overlapping copy: output repeats with period `offset`
            period = out[start:start + offset]
            reps = -(-mlen // offset)
            out[op:op + mlen] = np.tile(period, reps)[:mlen]
        op += mlen
    if dst_size is not None and op != dst_size:
        raise CorruptError(f"lz4: decoded {op} bytes, expected {dst_size}")
    return out[:op].tobytes()
