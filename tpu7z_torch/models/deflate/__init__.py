"""DEFLATE, Deflate64 and gzip (tpu7z/models/deflate): the encoder's parse,
histograms, body and bit packing as tensor code on the card, the inflate
on the host."""

from .codec import compress, decompress, gzip_compress, gzip_decompress

__all__ = ["compress", "decompress", "gzip_compress", "gzip_decompress"]
