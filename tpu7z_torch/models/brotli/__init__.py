"""Brotli (tpu7z/models/brotli): the encoder's parse, commands, histograms
and bit packing as tensor code on the card, the decoder on the host."""

from .decoder import decompress, decompress_mt_container
from .encoder import compress, compress_mt_container

__all__ = ["decompress", "decompress_mt_container", "compress",
           "compress_mt_container"]
