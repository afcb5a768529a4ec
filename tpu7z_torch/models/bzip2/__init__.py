"""BZip2 (tpu7z/models/bzip2): the block sort and its inverse as tensor code
on the card through `sort_rows`, the rest of the codec on the host."""

from .codec import compress, decompress

__all__ = ["compress", "decompress"]
