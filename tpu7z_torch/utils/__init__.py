from .errors import (
    TpuzError,
    CorruptError,
    UnsupportedError,
    DstTooSmallError,
    ParamError,
)
from .buffers import ByteBuffer, concat_bytes

__all__ = [
    "TpuzError",
    "CorruptError",
    "UnsupportedError",
    "DstTooSmallError",
    "ParamError",
    "ByteBuffer",
    "concat_bytes",
]
