"""The host zstd codec: ctypes bindings of the libraries built from
csrc/zstd_enc.cpp and csrc/zstd_dec.cpp (tpu7z/native/__init__.py:144-175
binds the same entry points). Each call releases the GIL, so threads run
jobs and frames side by side (parallel/zstd_jobs.py, parallel/decode.py).

A failed build raises, and so does an encoder that returns no bytes; the
decoder returns None where the library refuses its input (a corrupt frame,
a dictionary ID), and `frame.decompress` then hands the input to the plain
decoder, which decodes it or raises, as tpu7z does.
"""

from __future__ import annotations

import ctypes

from ...ops import _build

_P = ctypes.c_void_p
_SZ = ctypes.c_size_t
_I = ctypes.c_int
_libs: dict = {}


def _encoder():
    lib = _libs.get("enc")
    if lib is None:
        lib = _build.load("zstd_enc")
        lib.tz_zstd_encode.argtypes = [ctypes.c_char_p, _SZ, _P, _SZ, _I, _I]
        lib.tz_zstd_encode.restype = ctypes.c_longlong
        lib.tz_zstd_encode_job.argtypes = [ctypes.c_char_p, _SZ, _SZ, ctypes.c_uint64,
                                           _I, _I, _I, _P, _SZ]
        lib.tz_zstd_encode_job.restype = ctypes.c_longlong
        _libs["enc"] = lib
    return lib


def _decoder():
    lib = _libs.get("dec")
    if lib is None:
        lib = _build.load("zstd_dec")
        lib.tz_zstd_decode_alloc.argtypes = [ctypes.c_char_p, _SZ,
                                             ctypes.POINTER(_P), _I]
        lib.tz_zstd_decode_alloc.restype = ctypes.c_longlong
        lib.tz_buf_free.argtypes = [_P]
        lib.tz_buf_free.restype = None
        _libs["dec"] = lib
    return lib


def _bound(n: int) -> int:
    return n + n // 2 + 4096


def zstd_encode(data: bytes, level: int = 3, checksum: bool = True) -> bytes:
    """One zstd frame of `data` by the host encoder."""
    data = bytes(data)
    buf = ctypes.create_string_buffer(_bound(len(data)))
    r = _encoder().tz_zstd_encode(data, len(data), buf, len(buf), int(level),
                                  1 if checksum else 0)
    if r <= 0:
        raise RuntimeError(f"tz_zstd_encode failed ({r}) on {len(data)} bytes")
    return buf.raw[:r]


def zstd_encode_job(seg: bytes, prefix_len: int, total_size: int, level: int,
                    kind: int, checksum: bool = True) -> bytes:
    """The blocks of one zstdmt job: `seg` is the job's window prefix
    (`prefix_len` bytes, a multiple of 128 KiB) and its own bytes; `kind`
    bit 1 writes the frame header for `total_size`, bit 0 marks the last
    block. Releases the GIL."""
    cap = _bound(len(seg) - prefix_len)
    buf = ctypes.create_string_buffer(cap)
    r = _encoder().tz_zstd_encode_job(seg, len(seg), prefix_len, total_size, int(level),
                                      kind, 1 if checksum else 0, buf, cap)
    if r <= 0:
        raise RuntimeError(f"tz_zstd_encode_job failed ({r}) on {len(seg)} bytes")
    return buf.raw[:r]


def zstd_decode(data: bytes, verify_checksum: bool = True):
    """The content of a concatenation of zstd frames (skippable ones
    included) by the host decoder, or None where it refuses the input."""
    lib = _decoder()
    out = _P()
    r = lib.tz_zstd_decode_alloc(bytes(data), len(data), ctypes.byref(out),
                                 1 if verify_checksum else 0)
    if r < 0:
        return None
    try:
        return ctypes.string_at(out, r)
    finally:
        lib.tz_buf_free(out)
