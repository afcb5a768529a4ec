"""The host LZMA codec: ctypes bindings of the libraries built from
csrc/lzma_enc.cpp (the optimal-parse LZMA1/LZMA2 encoder) and
csrc/lzma_dec.cpp (the range decoder), the entry points
tpu7z/native/__init__.py binds. Each call releases the GIL, so threads
decode independent LZMA2 spans side by side (parallel/decode.py).

A failed build raises, and so does an encoder that returns an error.
"""

from __future__ import annotations

import ctypes

from ...ops import _build

_P = ctypes.c_void_p
_SZ = ctypes.c_size_t
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_libs: dict = {}


def _encoder():
    lib = _libs.get("enc")
    if lib is None:
        lib = _build.load("lzma_enc")
        lib.tz_lzma2_encode.argtypes = [ctypes.c_char_p, _SZ, _P, _SZ, _I, _I, _I, _I,
                                        ctypes.c_uint]
        lib.tz_lzma2_encode.restype = ctypes.c_longlong
        lib.tz_lzma_raw_encode.argtypes = [ctypes.c_char_p, _SZ, _P, _SZ, _I, _I, _I, _I,
                                           ctypes.POINTER(ctypes.c_uint8)]
        lib.tz_lzma_raw_encode.restype = ctypes.c_longlong
        _libs["enc"] = lib
    return lib


def decoder():
    """The range decoder's library: tz_lzma_new, tz_lzma_free,
    tz_lzma_reset_state, tz_lzma_reset_props, tz_lzma_set_origin and
    tz_lzma_decode_chunk."""
    lib = _libs.get("dec")
    if lib is None:
        lib = _build.load("lzma_dec")
        lib.tz_lzma_new.argtypes = [_I, _I, _I]
        lib.tz_lzma_new.restype = _P
        lib.tz_lzma_free.argtypes = [_P]
        lib.tz_lzma_free.restype = None
        lib.tz_lzma_reset_state.argtypes = [_P]
        lib.tz_lzma_reset_state.restype = None
        lib.tz_lzma_reset_props.argtypes = [_P, _I, _I, _I]
        lib.tz_lzma_reset_props.restype = None
        lib.tz_lzma_set_origin.argtypes = [_P, _U64]
        lib.tz_lzma_set_origin.restype = None
        lib.tz_lzma_decode_chunk.argtypes = [_P, ctypes.c_char_p, _SZ, _P, _U64, _U64]
        lib.tz_lzma_decode_chunk.restype = ctypes.c_longlong
        _libs["dec"] = lib
    return lib


def _bound(n: int) -> int:
    return n + (n >> 2) + 4096


def lzma2_encode(data: bytes, level: int = 9, lc: int = 3, lp: int = 0, pb: int = 2,
                 shard_size: int = 0) -> bytes:
    """A whole LZMA2 stream of `data` (its end control included) by the
    host encoder; with shard_size, shards that each begin with a full
    reset, one after another."""
    data = bytes(data)
    buf = ctypes.create_string_buffer(_bound(len(data)))
    r = _encoder().tz_lzma2_encode(data, len(data), buf, len(buf), int(level), lc, lp, pb,
                                   shard_size)
    if r <= 0:
        raise RuntimeError(f"tz_lzma2_encode failed ({r}) on {len(data)} bytes")
    return buf.raw[:r]


def lzma_raw_encode(data: bytes, level: int = 9, lc: int = 3, lp: int = 0, pb: int = 2):
    """(stream, props byte): one raw LZMA1 stream of `data`, without an
    end marker, by the host encoder."""
    data = bytes(data)
    buf = ctypes.create_string_buffer(_bound(len(data)))
    props = ctypes.c_uint8(0)
    r = _encoder().tz_lzma_raw_encode(data, len(data), buf, len(buf), int(level), lc, lp, pb,
                                      ctypes.byref(props))
    if r < 0:
        raise RuntimeError(f"tz_lzma_raw_encode failed ({r}) on {len(data)} bytes")
    return buf.raw[:r], props.value
