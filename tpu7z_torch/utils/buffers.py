"""Byte-buffer model of the host codecs: numpy uint8 arrays inside,
Python `bytes` at API boundaries.

A copy of tpu7z/utils/buffers.py, on the host: the same bytes and errors
from the same input.
"""

from __future__ import annotations

import numpy as np


def as_u8(data) -> np.ndarray:
    """View input bytes-like as a numpy uint8 array (zero-copy when possible)."""
    if isinstance(data, np.ndarray):
        if data.dtype != np.uint8:
            raise TypeError(f"expected uint8 array, got {data.dtype}")
        return data
    return np.frombuffer(data, dtype=np.uint8)


def concat_bytes(chunks) -> bytes:
    out = bytearray()
    for c in chunks:
        out += bytes(c)
    return bytes(out)


class ByteBuffer:
    """Growable output byte buffer with amortized append.

    Replaces the reference's COutBuffer (CPP/7zip/Common/OutBuffer.h) on the
    host serialization path.
    """

    def __init__(self, initial: int = 1 << 16):
        self._buf = np.empty(initial, dtype=np.uint8)
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def _reserve(self, extra: int) -> None:
        need = self._len + extra
        if need > self._buf.size:
            new_size = max(need, self._buf.size * 2)
            nb = np.empty(new_size, dtype=np.uint8)
            nb[: self._len] = self._buf[: self._len]
            self._buf = nb

    def append_byte(self, b: int) -> None:
        self._reserve(1)
        self._buf[self._len] = b & 0xFF
        self._len += 1

    def append(self, data) -> None:
        arr = as_u8(data)
        self._reserve(arr.size)
        self._buf[self._len : self._len + arr.size] = arr
        self._len += arr.size

    def append_u16le(self, v: int) -> None:
        self._reserve(2)
        self._buf[self._len] = v & 0xFF
        self._buf[self._len + 1] = (v >> 8) & 0xFF
        self._len += 2

    def append_u32le(self, v: int) -> None:
        self._reserve(4)
        for i in range(4):
            self._buf[self._len + i] = (v >> (8 * i)) & 0xFF
        self._len += 4

    def append_u64le(self, v: int) -> None:
        self._reserve(8)
        for i in range(8):
            self._buf[self._len + i] = (v >> (8 * i)) & 0xFF
        self._len += 8

    def getvalue(self) -> bytes:
        return self._buf[: self._len].tobytes()

    def array(self) -> np.ndarray:
        return self._buf[: self._len]
