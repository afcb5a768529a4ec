"""LZMA and LZMA2 (tpu7z/models/lzma): the host codec, the Python range
coder and decoder, and the fast-parse encoder whose parse runs on the
card."""

from .decoder import decompress_alone, decompress_raw
from .encoder import compress_alone, compress_raw

__all__ = ["decompress_raw", "decompress_alone", "compress_raw", "compress_alone"]
