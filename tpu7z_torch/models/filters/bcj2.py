"""BCJ2: 4-stream x86 branch converter (encoder side), a copy of
tpu7z/models/filters/bcj2.py, on the host: each branch's choice feeds the
next through the range coder.

Behavioral reference: C/Bcj2Enc.c / C/Bcj2.h (stream layout: main, call,
jump, range-coded selector bits; probability contexts: jcc=0, E9=1,
E8=2+previous byte). The decoder lives in containers/sevenzip/reader.py
(_bcj2_decode); this encoder mirrors it exactly.

The selector probabilities make conversion choices free: any policy
decodes correctly. We convert branches whose target MSB is 0x00/0xFF
(the same heuristic as the one-stream x86 filter).
"""

from __future__ import annotations

from ..lzma.rangecoder import PROB_INIT, RangeEncoder


def _prob_index(b: int, prev: int) -> int:
    if b == 0xE8:
        return 2 + prev
    if b == 0xE9:
        return 1
    return 0  # jcc


def bcj2_encode(data: bytes):
    """Returns (main, call, jump, rc) streams."""
    main = bytearray()
    call = bytearray()
    jump = bytearray()
    probs = [PROB_INIT] * (2 + 256)
    rc = RangeEncoder()
    n = len(data)
    i = 0
    prev = 0
    while i < n:
        b = data[i]
        main.append(b)
        is_branch = ((b & 0xFE) == 0xE8
                     or (prev == 0x0F and (b & 0xF0) == 0x80))
        if is_branch:
            idx = _prob_index(b, prev)
            if i + 5 <= n and data[i + 4] in (0x00, 0xFF):
                rc.encode_bit(probs, idx, 1)
                rel = int.from_bytes(data[i + 1:i + 5], "little")
                absv = (rel + i + 5) & 0xFFFFFFFF
                (call if b == 0xE8 else jump).extend(
                    absv.to_bytes(4, "big"))
                i += 5
                prev = (rel >> 24) & 0xFF
                continue
            rc.encode_bit(probs, idx, 0)
        prev = b
        i += 1
    return bytes(main), bytes(call), bytes(jump), rc.flush()
