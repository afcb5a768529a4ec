"""LZ5 (tpu7z/models/lz5): the parse as tensor code on the card, the
token emission, the frame and the decoder on the host."""

from .codec import (compress_block, compress_frame, decompress,
                    decompress_block, decompress_frame)

__all__ = ["compress_block", "decompress_block", "compress_frame",
           "decompress_frame", "decompress"]
