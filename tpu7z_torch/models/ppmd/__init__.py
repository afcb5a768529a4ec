"""PPMd on the host: var.H for .7z folders (ppmd7), var.I for .zip
method 98 (ppmd8). The models are pointer-serial, so nothing in them runs
on the card."""

from .ppmd7 import decompress, compress

__all__ = ["decompress", "compress"]
