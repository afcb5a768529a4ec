"""Zstandard (RFC 8878): the host codec, the tensor encoder and the plain
decoder (tpu7z/models/zstd)."""

from .frame import compress, decompress, decompress_frame

__all__ = ["compress", "decompress", "decompress_frame"]
