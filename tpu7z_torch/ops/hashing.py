"""XXH32, the .lz4 frame's checksum, written against the public xxHash
specification, twice: `xxh32` in Python (the spec's twin, used for the
frames' 2- to 10-byte header checksums, so importing the frame module
builds nothing) and `xxh32_native`, the host library built from
csrc/xxh32.cpp (the content checksums, over whole inputs)."""

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


_native = None


def xxh32_native(data, seed: int = 0) -> int:
    """XXH32 of `data` (bytes-like, or a uint8 array) by the host library
    built from csrc/xxh32.cpp with the host C++ compiler; equal to
    `xxh32`. A failed build raises."""
    global _native
    if _native is None:
        fn = _build.load("xxh32").tz_xxh32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32]
        fn.restype = ctypes.c_uint32
        _native = fn
    buf = (np.ascontiguousarray(data, dtype=np.uint8) if isinstance(data, np.ndarray)
           else np.frombuffer(data, dtype=np.uint8))
    return _native(buf.ctypes.data, buf.size, seed & _M32)
