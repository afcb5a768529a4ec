"""Zstd Literals_Section decode/encode.

Behavioral reference: RFC 8878 section 3.1.1.3.1 and
C/zstd/zstd_decompress_block.c ZSTD_decodeLiteralsBlock:134. Four-stream
Huffman decode runs through the pointer-doubling bit-chain kernel: the 4
streams are independent chains — the same structure the reference exploits
with ILP (huf_decompress.c:602), here exploited as data parallelism.
"""

from __future__ import annotations

import numpy as np

from ...ops import bitchain
from ...utils.errors import CorruptError
from . import huffman

TYPE_RAW = 0
TYPE_RLE = 1
TYPE_COMPRESSED = 2
TYPE_TREELESS = 3


class LiteralsState:
    """Carries the Huffman table across blocks (Treeless mode)."""

    __slots__ = ("dtable",)

    def __init__(self):
        self.dtable = None  # (sym, nbits, table_log)


def decode(src: bytes, state: LiteralsState):
    """Decode a literals section. Returns (literals bytes-array, consumed)."""
    if len(src) < 1:
        raise CorruptError("literals: empty section")
    b0 = src[0]
    ltype = b0 & 3
    size_format = (b0 >> 2) & 3

    if ltype in (TYPE_RAW, TYPE_RLE):
        if size_format in (0, 2):
            regen = b0 >> 3
            hdr = 1
        elif size_format == 1:
            if len(src) < 2:
                raise CorruptError("literals: truncated header")
            regen = (b0 >> 4) | (src[1] << 4)
            hdr = 2
        else:
            if len(src) < 3:
                raise CorruptError("literals: truncated header")
            regen = (b0 >> 4) | (src[1] << 4) | (src[2] << 12)
            hdr = 3
        if ltype == TYPE_RAW:
            if len(src) < hdr + regen:
                raise CorruptError("literals: truncated raw literals")
            return np.frombuffer(src[hdr:hdr + regen], dtype=np.uint8), hdr + regen
        if len(src) < hdr + 1:
            raise CorruptError("literals: truncated RLE byte")
        return np.full(regen, src[hdr], dtype=np.uint8), hdr + 1

    # Compressed / Treeless
    if size_format == 0:
        if len(src) < 3:
            raise CorruptError("literals: truncated header")
        h = b0 | (src[1] << 8) | (src[2] << 16)
        regen = (h >> 4) & 0x3FF
        csize = (h >> 14) & 0x3FF
        hdr = 3
        streams = 1
    elif size_format == 1:
        if len(src) < 3:
            raise CorruptError("literals: truncated header")
        h = b0 | (src[1] << 8) | (src[2] << 16)
        regen = (h >> 4) & 0x3FF
        csize = (h >> 14) & 0x3FF
        hdr = 3
        streams = 4
    elif size_format == 2:
        if len(src) < 4:
            raise CorruptError("literals: truncated header")
        h = b0 | (src[1] << 8) | (src[2] << 16) | (src[3] << 24)
        regen = (h >> 4) & 0x3FFF
        csize = (h >> 18) & 0x3FFF
        hdr = 4
        streams = 4
    else:
        if len(src) < 5:
            raise CorruptError("literals: truncated header")
        h = (b0 | (src[1] << 8) | (src[2] << 16) | (src[3] << 24)
             | (src[4] << 32))
        regen = (h >> 4) & 0x3FFFF
        csize = (h >> 22) & 0x3FFFF
        hdr = 5
        streams = 4
    if len(src) < hdr + csize:
        raise CorruptError("literals: truncated compressed literals")
    payload = src[hdr:hdr + csize]

    if ltype == TYPE_COMPRESSED:
        weights, used = huffman.read_tree_description(payload)
        sym, nb, table_log = huffman.build_decode_table(weights)
        state.dtable = (sym, nb, table_log)
        payload = payload[used:]
    else:
        if state.dtable is None:
            raise CorruptError("literals: treeless block without table")
        sym, nb, table_log = state.dtable

    if streams == 1:
        lit = bitchain.chain_decode(
            np.frombuffer(payload, dtype=np.uint8), sym, nb, table_log, regen)
    else:
        if len(payload) < 6:
            raise CorruptError("literals: missing jump table")
        s1 = payload[0] | (payload[1] << 8)
        s2 = payload[2] | (payload[3] << 8)
        s3 = payload[4] | (payload[5] << 8)
        body = payload[6:]
        if s1 + s2 + s3 > len(body):
            raise CorruptError("literals: jump table exceeds payload")
        parts = (body[:s1], body[s1:s1 + s2], body[s1 + s2:s1 + s2 + s3],
                 body[s1 + s2 + s3:])
        n123 = (regen + 3) // 4
        n4 = regen - 3 * n123
        if n4 < 0:
            raise CorruptError("literals: invalid stream split")
        outs = []
        for part, count in zip(parts, (n123, n123, n123, n4)):
            if count == 0:
                outs.append(np.empty(0, dtype=np.uint8))
                continue
            outs.append(bitchain.chain_decode(
                np.frombuffer(part, dtype=np.uint8), sym, nb, table_log,
                count).astype(np.uint8))
        lit = np.concatenate(outs)
    return lit.astype(np.uint8), hdr + csize
