""".Z (Unix compress) LZW codec, a port of tpu7z/models/z_lzw.py: the
same bytes and the same CorruptError messages. Host code: LZW is a
serial dictionary coder. The encoder keys its table by (prefix code,
next byte), the same table as tpu7z's keyed by strings.

Behavioral reference: CPP/7zip/Compress/ZDecoder.cpp — header 1F 9D,
prop byte = maxbits(9..16) | 0x80 block-mode flag; codes are LSB-first
in groups of `numBits` bytes (8 codes); the remainder of a group is
discarded when the code width grows or a CLEAR (256) resets the table
(:91-121,:146-151: width grows after head passes 1<<numBits). Encoder
emits CLEAR when the table fills, mirroring the decoder's state machine
exactly so the group padding stays in sync.
"""

from __future__ import annotations

from ..utils.errors import CorruptError

MIN_BITS = 9
MAX_BITS = 16
CLEAR = 256


def compress(data: bytes, maxbits: int = MAX_BITS) -> bytes:
    if not MIN_BITS <= maxbits <= MAX_BITS:
        raise CorruptError("z: bad maxbits")
    out = bytearray([0x1F, 0x9D, 0x80 | maxbits])
    num_items = 1 << maxbits

    acc = 0
    nacc = 0
    section_codes = 0

    def put(code: int, nbits: int):
        nonlocal acc, nacc, section_codes
        acc |= code << nacc
        nacc += nbits
        section_codes += 1
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    def pad_group(nbits: int):
        # decoder discards the rest of the numBits-byte group at width
        # change / clear: emit zero codes up to the 8-code boundary
        nonlocal acc, nacc, section_codes
        while section_codes % 8 != 0:
            put(0, nbits)
        if nacc:
            out.append(acc & 0xFF)
            acc = 0
            nacc = 0
        section_codes = 0

    table = {}           # (prefix code << 8) | byte -> code
    head = 257
    nbits = MIN_BITS
    cur = -1             # the code of the string read so far, -1 if none
    for byte in bytes(data):
        if cur < 0:
            cur = byte
            continue
        key = (cur << 8) | byte
        nxt = table.get(key)
        if nxt is not None:
            cur = nxt
            continue
        put(cur, nbits)
        if head < num_items:
            table[key] = head
            head += 1
            if head > (1 << nbits) and nbits < maxbits:
                pad_group(nbits)
                nbits += 1
        elif head == num_items:
            # table full: clear and restart (decoder: head=257, 9 bits)
            put(CLEAR, nbits)
            pad_group(nbits)
            table = {}
            head = 257
            nbits = MIN_BITS
        cur = byte
    if cur >= 0:
        put(cur, nbits)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def decompress(src: bytes) -> bytes:
    if len(src) < 3 or src[0] != 0x1F or src[1] != 0x9D:
        raise CorruptError("z: bad magic")
    prop = src[2]
    if prop & 0x60:
        raise CorruptError("z: reserved prop bits")
    maxbits = prop & 0x1F
    if not MIN_BITS <= maxbits <= MAX_BITS:
        raise CorruptError("z: bad maxbits")
    num_items = 1 << maxbits
    block_mode = bool(prop & 0x80)
    block_symbol = 256 if block_mode else (1 << MAX_BITS)

    parents = [0] * num_items
    suffixes = [0] * num_items
    out = bytearray()
    pos = 3
    nbits = MIN_BITS
    head = 257 if block_mode else 256
    need_prev = False
    group = b""
    bit_pos = 0
    while True:
        if bit_pos >= len(group) * 8:
            group = src[pos:pos + nbits]
            pos += len(group)
            bit_pos = 0
            if not group:
                break
        byte_pos = bit_pos >> 3
        chunk = group[byte_pos:byte_pos + 3]
        symbol = int.from_bytes(chunk + b"\x00" * (3 - len(chunk)),
                                "little")
        symbol = (symbol >> (bit_pos & 7)) & ((1 << nbits) - 1)
        bit_pos += nbits
        if bit_pos > len(group) * 8:
            break
        if symbol >= head:
            raise CorruptError("z: code out of range")
        if symbol == block_symbol:
            group = b""
            bit_pos = 0
            nbits = MIN_BITS
            head = 257
            need_prev = False
            continue
        cur = symbol
        stack = bytearray()
        while cur >= 256:
            stack.append(suffixes[cur])
            cur = parents[cur]
        stack.append(cur)
        if need_prev:
            suffixes[head - 1] = cur
            if symbol == head - 1:
                stack[0] = cur
        out += bytes(reversed(stack))
        if head < num_items:
            need_prev = True
            parents[head] = symbol
            head += 1
            if head > (1 << nbits) and nbits < maxbits:
                group = b""
                bit_pos = 0
                nbits += 1
        else:
            need_prev = False
    return bytes(out)
