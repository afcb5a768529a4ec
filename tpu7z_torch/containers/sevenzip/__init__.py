from .reader import SevenZipReader
from .writer import write_archive

__all__ = ["SevenZipReader", "write_archive"]
