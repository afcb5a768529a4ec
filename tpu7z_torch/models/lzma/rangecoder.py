"""The LZMA binary range coder, in Python: tpu7z/models/lzma/rangecoder.py.

An 11-bit adaptive probability a bit (kNumBitModelTotalBits), adapted by
5 bits (kNumMoveBits), renormalized below 2**24; the encoder propagates
carries through a cache byte and a count of pending 0xFF bytes (the
public LZMA specification; C/LzmaDec.c, C/LzmaEnc.c:359). The model is
serial within a stream, so it runs on the host; LZMA2's chunks are the
parallel axis (lzma2.py). `RangeEncoder` serves the fast-parse encoder
(encoder.py); `RangeDecoder` is the Python decoder's (decoder.py), the
twin of the host library's.
"""

from __future__ import annotations

from ...utils.errors import CorruptError

K_TOP = 1 << 24
PROB_INIT = 1024  # 2048 / 2
NUM_MOVE_BITS = 5
NUM_BIT_MODEL_TOTAL_BITS = 11
BIT_MODEL_TOTAL = 1 << NUM_BIT_MODEL_TOTAL_BITS


class RangeDecoder:
    __slots__ = ("data", "pos", "range", "code")

    def __init__(self, data, pos: int = 0):
        self.data = data
        if pos + 5 > len(data):
            raise CorruptError("lzma: truncated range coder init")
        if data[pos] != 0:
            raise CorruptError("lzma: nonzero first range byte")
        self.range = 0xFFFFFFFF
        self.code = int.from_bytes(data[pos + 1:pos + 5], "big")
        self.pos = pos + 5

    def _normalize(self):
        if self.range < K_TOP:
            if self.pos < len(self.data):
                b = self.data[self.pos]
            else:
                if self.pos > len(self.data) + 16:
                    raise CorruptError("lzma: stream exhausted")
                b = 0  # allow bounded overread at stream end
            self.pos += 1
            self.range = (self.range << 8) & 0xFFFFFFFF
            self.code = ((self.code << 8) | b) & 0xFFFFFFFF

    def decode_bit(self, probs, idx: int) -> int:
        p = probs[idx]
        bound = (self.range >> NUM_BIT_MODEL_TOTAL_BITS) * p
        if self.code < bound:
            self.range = bound
            probs[idx] = p + ((BIT_MODEL_TOTAL - p) >> NUM_MOVE_BITS)
            self._normalize()
            return 0
        self.range -= bound
        self.code -= bound
        probs[idx] = p - (p >> NUM_MOVE_BITS)
        self._normalize()
        return 1

    def decode_direct(self, nbits: int) -> int:
        res = 0
        for _ in range(nbits):
            self.range >>= 1
            self.code -= self.range
            if self.code < 0:
                self.code += self.range
                bit = 0
            else:
                bit = 1
            self._normalize()
            res = (res << 1) + bit
        return res

    def decode_tree(self, probs, base: int, nbits: int) -> int:
        """Normal bit tree: returns symbol in [0, 2^nbits)."""
        m = 1
        for _ in range(nbits):
            m = (m << 1) + self.decode_bit(probs, base + m)
        return m - (1 << nbits)

    def decode_tree_reverse(self, probs, base: int, nbits: int) -> int:
        m = 1
        sym = 0
        for i in range(nbits):
            b = self.decode_bit(probs, base + m)
            m = (m << 1) + b
            sym |= b << i
        return sym

    @property
    def finished(self) -> bool:
        return self.code == 0


class RangeEncoder:
    __slots__ = ("low", "range", "cache", "cache_size", "out")

    def __init__(self):
        self.low = 0
        self.range = 0xFFFFFFFF
        self.cache = 0
        self.cache_size = 1
        self.out = bytearray()

    def _shift_low(self):
        if self.low < 0xFF000000 or self.low > 0xFFFFFFFF:
            carry = self.low >> 32
            self.out.append((self.cache + carry) & 0xFF)
            for _ in range(self.cache_size - 1):
                self.out.append((0xFF + carry) & 0xFF)
            self.cache_size = 0
            self.cache = (self.low >> 24) & 0xFF
        self.cache_size += 1
        self.low = (self.low << 8) & 0xFFFFFFFF

    def encode_bit(self, probs, idx: int, bit: int):
        p = probs[idx]
        bound = (self.range >> NUM_BIT_MODEL_TOTAL_BITS) * p
        if bit == 0:
            self.range = bound
            probs[idx] = p + ((BIT_MODEL_TOTAL - p) >> NUM_MOVE_BITS)
        else:
            self.low += bound
            self.range -= bound
            probs[idx] = p - (p >> NUM_MOVE_BITS)
        while self.range < K_TOP:
            self.range = (self.range << 8) & 0xFFFFFFFF
            self._shift_low()

    def encode_direct(self, value: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.range >>= 1
            if (value >> i) & 1:
                self.low += self.range
            while self.range < K_TOP:
                self.range = (self.range << 8) & 0xFFFFFFFF
                self._shift_low()

    def encode_tree(self, probs, base: int, nbits: int, sym: int):
        m = 1
        for i in range(nbits - 1, -1, -1):
            b = (sym >> i) & 1
            self.encode_bit(probs, base + m, b)
            m = (m << 1) + b

    def encode_tree_reverse(self, probs, base: int, nbits: int, sym: int):
        m = 1
        for _ in range(nbits):
            b = sym & 1
            sym >>= 1
            self.encode_bit(probs, base + m, b)
            m = (m << 1) + b

    def flush(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)
