"""XXH32, the .lz4 frame's checksum, and XXH64, whose low 32 bits are the
.zst frame's, written against the public xxHash specification, twice
each: `xxh32` and `xxh64` in Python (the spec's twins; `xxh32` serves
the .lz4 frames' 2- to 10-byte header checksums, so importing a frame
module builds nothing) and `xxh32_native` and `xxh64_native`, the host
library built from csrc/xxh32.cpp (the content checksums, over whole
inputs). CRC-32 (zlib's) and CRC-64 (the .xz check), twice each:
`crc32` and `crc64`, table-driven Python as tpu7z/ops/hashing.py:153-224
has them (the twins), and `crc32_native` and `crc64_native`, the host
library built from csrc/crc.cpp (the .xz container's checks)."""

from __future__ import annotations

import ctypes

import numpy as np

from . import _build

_P32_1 = 0x9E3779B1
_P32_2 = 0x85EBCA77
_P32_3 = 0xC2B2AE3D
_P32_4 = 0x27D4EB2F
_P32_5 = 0x165667B1
_M32 = 0xFFFFFFFF

_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_P64_4 = 0x85EBCA77C2B2AE63
_P64_5 = 0x27D4EB2F165667C5
_M64 = 0xFFFFFFFFFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data, seed: int = 0) -> int:
    data = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(
        data, np.ndarray) else data
    n = data.size
    nstripes = n // 16
    if nstripes > 0:
        words = data[: nstripes * 16].view("<u4").reshape(nstripes, 4)
        v = [
            (seed + _P32_1 + _P32_2) & _M32,
            (seed + _P32_2) & _M32,
            seed & _M32,
            (seed - _P32_1) & _M32,
        ]
        w = words.astype(np.uint64)
        for i in range(nstripes):
            row = w[i]
            for lane in range(4):
                v[lane] = (_rotl32((v[lane] + int(row[lane]) * _P32_2) & _M32, 13)
                           * _P32_1) & _M32
        h = (_rotl32(v[0], 1) + _rotl32(v[1], 7) + _rotl32(v[2], 12)
             + _rotl32(v[3], 18)) & _M32
    else:
        h = (seed + _P32_5) & _M32
    h = (h + n) & _M32
    pos = nstripes * 16
    while pos + 4 <= n:
        lane = int(data[pos]) | (int(data[pos + 1]) << 8) | \
            (int(data[pos + 2]) << 16) | (int(data[pos + 3]) << 24)
        h = (h + lane * _P32_3) & _M32
        h = (_rotl32(h, 17) * _P32_4) & _M32
        pos += 4
    while pos < n:
        h = (h + int(data[pos]) * _P32_5) & _M32
        h = (_rotl32(h, 11) * _P32_1) & _M32
        pos += 1
    h ^= h >> 15
    h = (h * _P32_2) & _M32
    h ^= h >> 13
    h = (h * _P32_3) & _M32
    h ^= h >> 16
    return h


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _xxh64_round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P64_2) & _M64
    return (_rotl64(acc, 31) * _P64_1) & _M64


def _xxh64_merge(h: int, acc: int) -> int:
    h ^= _xxh64_round(0, acc)
    return ((h * _P64_1) + _P64_4) & _M64


def xxh64(data, seed: int = 0) -> int:
    data = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(
        data, np.ndarray) else data
    n = data.size
    nstripes = n // 32
    if nstripes > 0:
        words = data[: nstripes * 32].view("<u8").reshape(nstripes, 4)
        v = [
            (seed + _P64_1 + _P64_2) & _M64,
            (seed + _P64_2) & _M64,
            seed & _M64,
            (seed - _P64_1) & _M64,
        ]
        for i in range(nstripes):
            row = words[i]
            for lane in range(4):
                v[lane] = _xxh64_round(v[lane], int(row[lane]))
        h = (_rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12)
             + _rotl64(v[3], 18)) & _M64
        for lane in range(4):
            h = _xxh64_merge(h, v[lane])
    else:
        h = (seed + _P64_5) & _M64
    h = (h + n) & _M64
    pos = nstripes * 32
    while pos + 8 <= n:
        k = int.from_bytes(bytes(data[pos:pos + 8]), "little")
        h ^= _xxh64_round(0, k)
        h = (_rotl64(h, 27) * _P64_1 + _P64_4) & _M64
        pos += 8
    if pos + 4 <= n:
        k = int.from_bytes(bytes(data[pos:pos + 4]), "little")
        h ^= (k * _P64_1) & _M64
        h = (_rotl64(h, 23) * _P64_2 + _P64_3) & _M64
        pos += 4
    while pos < n:
        h ^= (int(data[pos]) * _P64_5) & _M64
        h = (_rotl64(h, 11) * _P64_1) & _M64
        pos += 1
    h ^= h >> 33
    h = (h * _P64_2) & _M64
    h ^= h >> 29
    h = (h * _P64_3) & _M64
    h ^= h >> 32
    return h


def _make_crc32_table() -> np.ndarray:
    table = np.empty((8, 256), dtype=np.uint32)
    poly = np.uint32(0xEDB88320)
    t0 = np.empty(256, dtype=np.uint32)
    for i in range(256):
        c = np.uint32(i)
        for _ in range(8):
            c = (c >> np.uint32(1)) ^ (poly if (c & np.uint32(1)) else np.uint32(0))
        t0[i] = c
    table[0] = t0
    for k in range(1, 8):
        table[k] = (table[k - 1] >> np.uint32(8)) ^ t0[table[k - 1] & np.uint32(0xFF)]
    return table


def _make_crc64_table() -> np.ndarray:
    table = np.empty((8, 256), dtype=np.uint64)
    poly = np.uint64(0xC96C5795D7870F42)
    t0 = np.empty(256, dtype=np.uint64)
    for i in range(256):
        c = np.uint64(i)
        for _ in range(8):
            c = (c >> np.uint64(1)) ^ (poly if (c & np.uint64(1)) else np.uint64(0))
        t0[i] = c
    table[0] = t0
    for k in range(1, 8):
        table[k] = (table[k - 1] >> np.uint64(8)) ^ t0[table[k - 1] & np.uint64(0xFF)]
    return table


_CRC32_TABLE = _make_crc32_table()
_CRC64_TABLE = _make_crc64_table()


def crc32(data, crc: int = 0) -> int:
    """CRC-32/ISO-HDLC, equal to zlib.crc32: slice-by-8 table lookups."""
    data = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(
        data, np.ndarray) else data
    c = np.uint32(crc ^ 0xFFFFFFFF)
    t = _CRC32_TABLE
    n = data.size
    n8 = n & ~7
    if n8:
        words = data[:n8].reshape(-1, 8)
        for i in range(words.shape[0]):
            row = words[i]
            lo = np.uint32(int(c)
                           ^ (int(row[0]) | (int(row[1]) << 8)
                              | (int(row[2]) << 16) | (int(row[3]) << 24)))
            c = (t[7][lo & np.uint32(0xFF)]
                 ^ t[6][(lo >> np.uint32(8)) & np.uint32(0xFF)]
                 ^ t[5][(lo >> np.uint32(16)) & np.uint32(0xFF)]
                 ^ t[4][(lo >> np.uint32(24)) & np.uint32(0xFF)]
                 ^ t[3][row[4]] ^ t[2][row[5]] ^ t[1][row[6]] ^ t[0][row[7]])
    for b in data[n8:]:
        c = (c >> np.uint32(8)) ^ t[0][(c ^ np.uint32(b)) & np.uint32(0xFF)]
    return int(c ^ np.uint32(0xFFFFFFFF))


def crc64(data, crc: int = 0) -> int:
    """CRC-64/XZ (ECMA-182 reflected), the .xz container's check."""
    data = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(
        data, np.ndarray) else data
    c = np.uint64(crc ^ _M64)
    t = _CRC64_TABLE
    for b in data:
        c = (c >> np.uint64(8)) ^ t[0][(c ^ np.uint64(b)) & np.uint64(0xFF)]
    return int(c ^ np.uint64(_M64))


_native = {}


def _function(name: str, width, library: str = "xxh32"):
    fn = _native.get(name)
    if fn is None:
        fn = getattr(_build.load(library), name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, width]
        fn.restype = width
        _native[name] = fn
    return fn


def _buffer(data):
    return (np.ascontiguousarray(data, dtype=np.uint8) if isinstance(data, np.ndarray)
            else np.frombuffer(data, dtype=np.uint8))


def xxh32_native(data, seed: int = 0) -> int:
    """XXH32 of `data` (bytes-like, or a uint8 array) by the host library
    built from csrc/xxh32.cpp with the host C++ compiler; equal to
    `xxh32`. A failed build raises."""
    buf = _buffer(data)
    return _function("tz_xxh32", ctypes.c_uint32)(buf.ctypes.data, buf.size, seed & _M32)


class XXH32Stream:
    """XXH32 of bytes given in pieces (`update`), by the same host library
    (csrc/xxh32.cpp's streaming form): `digest()` equals `xxh32_native`
    of the pieces joined."""

    def __init__(self, seed: int = 0):
        lib = _build.load("xxh32")
        if "stream" not in _native:
            lib.tz_xxh32_state_size.argtypes = []
            lib.tz_xxh32_state_size.restype = ctypes.c_size_t
            for name, args, res in (("tz_xxh32_reset", [ctypes.c_void_p, ctypes.c_uint32], None),
                                    ("tz_xxh32_update",
                                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t], None),
                                    ("tz_xxh32_digest", [ctypes.c_void_p], ctypes.c_uint32)):
                getattr(lib, name).argtypes = args
                getattr(lib, name).restype = res
            _native["stream"] = lib
        self._lib = lib
        self._state = ctypes.create_string_buffer(lib.tz_xxh32_state_size())
        lib.tz_xxh32_reset(self._state, seed & _M32)

    def update(self, data) -> None:
        buf = _buffer(data)
        self._lib.tz_xxh32_update(self._state, buf.ctypes.data, buf.size)

    def digest(self) -> int:
        return self._lib.tz_xxh32_digest(self._state)


def xxh64_native(data, seed: int = 0) -> int:
    """XXH64 of `data` by the same library (csrc/xxh64.h); equal to
    `xxh64`."""
    buf = _buffer(data)
    return _function("tz_xxh64", ctypes.c_uint64)(buf.ctypes.data, buf.size, seed & _M64)


def crc32_native(data, crc: int = 0) -> int:
    """CRC-32 of `data` continuing `crc` by the host library built from
    csrc/crc.cpp; equal to `crc32` and zlib.crc32. A failed build raises."""
    buf = _buffer(data)
    return _function("tz_crc32", ctypes.c_uint32, "crc")(buf.ctypes.data, buf.size, crc & _M32)


def crc64_native(data, crc: int = 0) -> int:
    """CRC-64/XZ of `data` continuing `crc` by the same library; equal to
    `crc64`."""
    buf = _buffer(data)
    return _function("tz_crc64", ctypes.c_uint64, "crc")(buf.ctypes.data, buf.size, crc & _M64)
