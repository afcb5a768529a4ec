"""Codec registry, a port of tpu7z/models/registry.py: the
RegisterCodec/ICompressCoder analog (CPP/7zip/Common/RegisterCodec.h:22-104,
CPP/7zip/ICoder.h).

Maps method names to stream codecs, each a (compress, decompress) pair
over whole byte streams, with tpu7z's name, 7z method ID and levels.
bzip2, deflate, gzip, brotli, lz5, lizard and lzip take `device=` (the
CUDA card unless it names the CPU) for their tensor stages; z is host
code. The port registers every codec tpu7z's registry has.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..utils.errors import UnsupportedError


@dataclass(frozen=True)
class CodecInfo:
    name: str
    method_id: int
    compress: Callable
    decompress: Callable
    levels: tuple  # (min, max)


def _lz4_c(data, level=1, **kw):
    from .lz4 import frame
    return frame.compress_frame(data)


def _lz4_d(data, **kw):
    from .lz4 import frame
    return frame.decompress(data)


def _zstd_c(data, level=3, **kw):
    from .zstd import frame
    return frame.compress(data, level=min(level, 22), **kw)


def _zstd_d(data, **kw):
    from .zstd import frame
    return frame.decompress(data)


def _lzma2_c(data, level=5, **kw):
    from .lzma import lzma2
    return lzma2.compress(data, level=level)


def _lzma2_d(data, out_size=None, **kw):
    from .lzma import lzma2
    return lzma2.decompress(data, out_size)


def _bzip2_c(data, level=9, device=None, **kw):
    from . import bzip2
    return bzip2.compress(data, level=max(1, min(level, 9)), device=device)


def _bzip2_d(data, device=None, **kw):
    from . import bzip2
    return bzip2.decompress(data, device=device)


def _deflate_c(data, level=6, device=None, **kw):
    from . import deflate
    return deflate.compress(data, device=device)


def _deflate_d(data, out_size=None, **kw):
    from . import deflate
    return deflate.decompress(data, max_out=out_size)


def _gzip_c(data, level=6, device=None, **kw):
    from . import deflate
    return deflate.gzip_compress(data, device=device)


def _gzip_d(data, **kw):
    from . import deflate
    return deflate.gzip_decompress(data)


def _xz_c(data, level=5, **kw):
    from ..containers import xz
    return xz.compress(data)


def _xz_d(data, **kw):
    from ..containers import xz
    return xz.decompress(data)


def _brotli_c(data, level=5, device=None, **kw):
    from . import brotli
    return brotli.compress_mt_container(data, quality=min(level, 11), device=device)


def _brotli_d(data, **kw):
    from . import brotli
    return brotli.decompress_mt_container(data)


def _lz5_c(data, level=1, device=None, **kw):
    from . import lz5
    return lz5.compress_frame(data, device=device)


def _lz5_d(data, **kw):
    from . import lz5
    return lz5.decompress(data)


def _lizard_c(data, level=11, device=None, **kw):
    from . import lizard
    if not 10 <= level <= 49:
        # 7z-style levels 1..9 map into the LIZv1 family
        level = 20 + max(1, min(level, 9))
    return lizard.compress_frame(data, level=level, device=device)


def _lizard_d(data, **kw):
    from . import lizard
    return lizard.decompress(data)


def _z_c(data, level=16, **kw):
    from . import z_lzw
    return z_lzw.compress(data, maxbits=max(9, min(level, 16)))


def _z_d(data, **kw):
    from . import z_lzw
    return z_lzw.decompress(data)


def _lzip_c(data, level=5, device=None, **kw):
    from ..containers import lzip
    return lzip.compress(data, device=device)


def _lzip_d(data, **kw):
    from ..containers import lzip
    return lzip.decompress(data)


def _copy(data, **kw):
    return data


CODECS: dict[str, CodecInfo] = {}


def _traced(name: str, op: str, fn: Callable) -> Callable:
    """Wrap a codec entry point in a trace span (utils/trace.py): one hook
    for every codec, no cost while no trace callback is attached."""
    def wrapped(data, *a, **kw):
        from ..utils import trace as _trace
        if not _trace.enabled():
            return fn(data, *a, **kw)
        with _trace.span(f"{name}.{op}", size=len(data), level=kw.get("level")):
            return fn(data, *a, **kw)
    wrapped.__name__ = f"{name}_{op}"
    wrapped.__wrapped__ = fn
    return wrapped


def _register(name, mid, c, d, levels=(1, 9), traced=True):
    """traced=False for a codec whose own entry points open its spans."""
    if traced:
        c, d = _traced(name, "compress", c), _traced(name, "decompress", d)
    CODECS[name] = CodecInfo(name, mid, c, d, levels)


_register("copy", 0x00, _copy, _copy, (0, 0))
_register("lz4", 0x4F71104, _lz4_c, _lz4_d, (1, 12))
# models/zstd/frame.py opens the zstd.compress and zstd.decompress spans
_register("zstd", 0x4F71101, _zstd_c, _zstd_d, (1, 22), traced=False)
_register("lzma2", 0x21, _lzma2_c, _lzma2_d, (1, 9))
_register("bzip2", 0x040202, _bzip2_c, _bzip2_d, (1, 9))
_register("deflate", 0x040108, _deflate_c, _deflate_d, (1, 9))
# xz and gzip are container formats, not 7z coders: method_id 0 means
# they are not addressable from a 7z folder, as in tpu7z
_register("xz", 0, _xz_c, _xz_d, (1, 9))
_register("gzip", 0, _gzip_c, _gzip_d, (1, 9))
_register("brotli", 0x4F71102, _brotli_c, _brotli_d, (0, 11))
# lzip is a container-level format like xz and gzip
_register("lzip", 0, _lzip_c, _lzip_d, (1, 9))
_register("z", 0x30500, _z_c, _z_d, (9, 16))
_register("lz5", 0x4F71105, _lz5_c, _lz5_d, (1, 15))
_register("lizard", 0x4F71106, _lizard_c, _lizard_d, (10, 49))


def get_codec(name: str) -> CodecInfo:
    try:
        return CODECS[name.lower()]
    except KeyError:
        raise UnsupportedError(f"unknown codec {name!r}; available: {sorted(CODECS)}")
