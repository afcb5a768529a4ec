"""The port's squashfs (tpu7z_torch/containers/squashfs.py) against
tpu7z's: the same image bytes from the same files for each block codec
the writer takes (zstd, zlib, lz4), the same files from each image, xz
and LZMA blocks included, and the same errors for corrupt and
unsupported images."""

import lzma as std_lzma
import struct

import pytest

from tests.torch_parity import flipped, noise, same, text
from tpu7z.containers import squashfs as jsq
from tpu7z_torch.containers import squashfs as tsq

FILES = {
    "a.txt": text(12000, 1),
    "big.bin": noise(3 * (1 << 17) + 777, 2),   # three full blocks and a tail
    "mixed.dat": text(150000, 3) + noise(5000, 4),
    "d/e/nested.txt": text(700, 5),
    "empty": b"",
}
METHODS = {"zstd": tsq.M_ZSTD, "zlib": tsq.M_ZLIB, "lz4": tsq.M_LZ4}


@pytest.mark.parametrize("method", METHODS)
def test_writer_equals_tpu7z(method):
    img = same(jsq.write_squashfs, tsq.write_squashfs, FILES, method=METHODS[method])[1]
    assert same(jsq.read_squashfs, tsq.read_squashfs, img) == ("ok", FILES)


@pytest.mark.parametrize("block_log", [12, 17, 20])
def test_block_sizes_equal_tpu7z(block_log):
    files = {"f.bin": text(70000, 6), "g.bin": noise(9000, 7)}
    img = same(jsq.write_squashfs, tsq.write_squashfs, files, block_log=block_log)[1]
    assert same(jsq.read_squashfs, tsq.read_squashfs, img) == ("ok", files)


def test_many_files_multiblock_metadata_equal_tpu7z():
    many = {f"f{i:04d}": (b"x%d" % i) * 40 for i in range(400)}
    img = same(jsq.write_squashfs, tsq.write_squashfs, many)[1]
    assert same(jsq.read_squashfs, tsq.read_squashfs, img) == ("ok", many)


def _stdlib_blocks(monkeypatch, method):
    """tpu7z's writer with xz or LZMA-alone blocks from the stdlib (it
    writes neither itself): the readers' other two codecs."""
    real = jsq._compress

    def compress(m, data):
        if m == jsq.M_XZ:
            return std_lzma.compress(data, format=std_lzma.FORMAT_XZ, check=std_lzma.CHECK_CRC32)
        if m == jsq.M_LZMA:
            return std_lzma.compress(data, format=std_lzma.FORMAT_ALONE)
        return real(m, data)
    monkeypatch.setattr(jsq, "_compress", compress)


@pytest.mark.parametrize("method", ["xz", "lzma"])
def test_xz_and_lzma_blocks_read_as_tpu7z(monkeypatch, method):
    files = {"one.txt": text(6000, 8), "two.bin": noise(300, 9)}
    _stdlib_blocks(monkeypatch, jsq.M_XZ if method == "xz" else jsq.M_LZMA)
    img = jsq.write_squashfs(files, method=jsq.M_XZ if method == "xz" else jsq.M_LZMA,
                             block_log=12)
    assert same(jsq.read_squashfs, tsq.read_squashfs, img) == ("ok", files)


@pytest.mark.parametrize("case,error", [
    ("magic", "CorruptError"), ("version", "UnsupportedError"),
    ("block_log", "CorruptError"), ("method", "UnsupportedError"),
    ("lzo", "UnsupportedError"), ("truncated", "CorruptError"),
    ("inode_table", "CorruptError")])
def test_corrupt_and_unsupported_as_tpu7z(case, error):
    img = tsq.write_squashfs({"a.txt": text(5000, 10), "b": noise(100, 11)})
    used = struct.unpack_from("<Q", img, 40)[0]      # bytes_used, before the padding
    bad = {"magic": lambda: flipped(img, 0),
           "version": lambda: img[:28] + b"\x03\x00" + img[30:],
           "block_log": lambda: img[:22] + b"\x10\x00" + img[24:],
           "method": lambda: img[:20] + b"\x09\x00" + img[22:],
           "lzo": lambda: img[:20] + b"\x03\x00" + img[22:],
           "truncated": lambda: img[:used - 40],
           "inode_table": lambda: flipped(img, 64, 0x40)}[case]()
    assert same(jsq.read_squashfs, tsq.read_squashfs, bad)[0] == error
