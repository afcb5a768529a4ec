"""Lizard (tpu7z/models/lizard): both parses as tensor code on the card,
the token emission, the Huffman streams, the frame and the decoder on
the host."""

from .codec import compress_frame, decompress, decompress_frame

__all__ = ["compress_frame", "decompress_frame", "decompress"]
