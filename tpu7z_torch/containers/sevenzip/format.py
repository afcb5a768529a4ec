""".7z format constants and primitive readers/writers, a copy of
tpu7z/containers/sevenzip/format.py.

Behavioral reference: DOC/7zFormat.txt, CPP/7zip/Archive/7z/7zHeader.h
(signature :11, NID enum :52-95, method ids :101-132). Written from the
format specification.
"""

from __future__ import annotations

from ...utils.errors import CorruptError

SIGNATURE = b"7z\xbc\xaf\x27\x1c"

# NIDs (7zHeader.h NID enum)
K_END = 0x00
K_HEADER = 0x01
K_ARCHIVE_PROPERTIES = 0x02
K_ADDITIONAL_STREAMS = 0x03
K_MAIN_STREAMS = 0x04
K_FILES_INFO = 0x05
K_PACK_INFO = 0x06
K_UNPACK_INFO = 0x07
K_SUBSTREAMS_INFO = 0x08
K_SIZE = 0x09
K_CRC = 0x0A
K_FOLDER = 0x0B
K_CODERS_UNPACK_SIZE = 0x0C
K_NUM_UNPACK_STREAM = 0x0D
K_EMPTY_STREAM = 0x0E
K_EMPTY_FILE = 0x0F
K_ANTI = 0x10
K_NAME = 0x11
K_CTIME = 0x12
K_ATIME = 0x13
K_MTIME = 0x14
K_WIN_ATTRIB = 0x15
K_COMMENT = 0x16
K_ENCODED_HEADER = 0x17
K_START_POS = 0x18
K_DUMMY = 0x19

# Method IDs (7zHeader.h:101-132 + DOC/Methods.txt)
M_COPY = 0x00
M_DELTA = 0x03
M_BCJ_X86 = 0x04      # alias of 0x03030103 used by modern 7-Zip
M_ARM64 = 0x0A
M_RISCV = 0x0B
M_LZMA2 = 0x21
M_SWAP2 = 0x020302
M_SWAP4 = 0x020304
M_LZMA = 0x030101
M_PPMD = 0x030401
M_BCJ = 0x03030103
M_BCJ2 = 0x0303011B
M_PPC = 0x03030205
M_IA64 = 0x03030401
M_ARM = 0x03030501
M_ARMT = 0x03030701
M_SPARC = 0x03030805
M_DEFLATE = 0x040108
M_DEFLATE64 = 0x040109
M_BZIP2 = 0x040202
M_AES256 = 0x06F10701
M_ZSTD = 0x4F71101
M_BROTLI = 0x4F71102
M_LZ4 = 0x4F71104
M_LZ5 = 0x4F71105
M_LIZARD = 0x4F71106
M_FLZMA2 = 0x4F71102  # fork registers flzma2 as alias of 0x21; keep 0x21


class ByteReader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise CorruptError("7z: header truncated")
        b = self.data[self.pos]
        self.pos += 1
        return b

    def bytes(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise CorruptError("7z: header truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def number(self) -> int:
        """7z variable-length number (DOC/7zFormat.txt REAL_UINT64)."""
        first = self.byte()
        mask = 0x80
        value = 0
        for i in range(8):
            if (first & mask) == 0:
                value |= (first & (mask - 1)) << (8 * i)
                return value
            value |= self.byte() << (8 * i)
            mask >>= 1
        return value

    def u32(self) -> int:
        return int.from_bytes(self.bytes(4), "little")

    def u64(self) -> int:
        return int.from_bytes(self.bytes(8), "little")

    def bitfield(self, count: int) -> list[bool]:
        bits = []
        b = 0
        mask = 0
        for _ in range(count):
            if mask == 0:
                b = self.byte()
                mask = 0x80
            bits.append(bool(b & mask))
            mask >>= 1
        return bits

    def bool_vector_opt(self, count: int) -> list[bool]:
        """allAreDefined byte then bitfield when not all defined."""
        all_defined = self.byte()
        if all_defined:
            return [True] * count
        return self.bitfield(count)


class ByteWriter:
    def __init__(self):
        self.out = bytearray()

    def byte(self, b: int):
        self.out.append(b & 0xFF)

    def raw(self, data: bytes):
        self.out += data

    def number(self, value: int):
        """Inverse of ByteReader.number."""
        if value < 0:
            raise ValueError("negative number")
        # minimal number of extra bytes n: capacity (7-n)+8n bits
        for n in range(8):
            limit_high = 1 << (8 - n - 1)  # bits available in first byte
            if value < (limit_high << (8 * n)):
                first = 0
                for k in range(n):
                    first |= 0x80 >> k
                first |= value >> (8 * n)
                self.byte(first)
                for k in range(n):
                    self.byte((value >> (8 * k)) & 0xFF)
                return
        self.byte(0xFF)
        for k in range(8):
            self.byte((value >> (8 * k)) & 0xFF)

    def u32(self, v: int):
        self.out += v.to_bytes(4, "little")

    def u64(self, v: int):
        self.out += v.to_bytes(8, "little")

    def bitfield(self, bits: list[bool]):
        b = 0
        mask = 0x80
        for bit in bits:
            if bit:
                b |= mask
            mask >>= 1
            if mask == 0:
                self.byte(b)
                b = 0
                mask = 0x80
        if mask != 0x80:
            self.byte(b)

    def getvalue(self) -> bytes:
        return bytes(self.out)
