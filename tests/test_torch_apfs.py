"""The port's APFS (tpu7z_torch/containers/apfs.py) against tpu7z's: the
same image bytes from the same files at each block size, the same files
from each image, the same Fletcher-64 sums, and the same errors for
corrupt and unsupported images."""

import struct

import pytest

from tests.torch_parity import flipped, noise, same, text
from tpu7z.containers import apfs as japfs
from tpu7z_torch.containers import apfs as tapfs

FILES = {"a.txt": text(2500, 1), "sub.bin": bytes(range(200)), "empty": b"",
         "big.dat": text(200000, 2), "rand": noise(9000, 3)}


@pytest.mark.parametrize("bs", [4096, 8192])
@pytest.mark.parametrize("nfiles", [0, 12, 30], ids=["files", "twelve", "thirty"])
def test_writer_equals_tpu7z(nfiles, bs):
    """tpu7z's writer puts each tree in one block: past about 20 files at
    4 KiB blocks its own reader refuses the image. The port writes the
    same bytes and refuses them alike."""
    files = {f"f{i:02d}": bytes([i]) * (i * 53 + 1) for i in range(nfiles)} or FILES
    img = same(japfs.write_apfs, tapfs.write_apfs, files, bs=bs)[1]
    assert same(japfs.is_apfs, tapfs.is_apfs, img) == ("ok", True)
    got = same(japfs.read_apfs, tapfs.read_apfs, img)
    assert got == (("CorruptError", "apfs: object checksum mismatch")
                   if (nfiles, bs) == (30, 4096) else ("ok", files))


@pytest.mark.parametrize("n", [0, 8, 4096, 4099])
def test_fletcher64_equals_tpu7z(n):
    """Over whole 32-bit words; a tail of 1-3 bytes fails in both."""
    assert same(japfs.fletcher64, tapfs.fletcher64, noise(n, 4))[0] == ("ok" if n % 4 == 0
                                                                          else "error")


@pytest.mark.parametrize("case,error", [
    ("checksum", "CorruptError"), ("signature", "CorruptError"), ("block_size", "CorruptError"),
    ("no_volume", "UnsupportedError"), ("truncated", "CorruptError"),
    ("zeros", "CorruptError")])
def test_corrupt_and_unsupported_as_tpu7z(case, error):
    img = tapfs.write_apfs({"a.txt": text(3000, 5), "b": noise(100, 6)})

    def resum(block: bytes) -> bytes:
        """Block 0 with its object checksum made right again."""
        body = block[8:4096]
        return struct.pack("<Q", tapfs.fletcher64(body)) + body + block[4096:]
    bad = {"checksum": lambda: flipped(img, 64, 0x55),
           "signature": lambda: resum(flipped(img, 32)),
           "block_size": lambda: resum(img[:36] + struct.pack("<I", 1000) + img[40:]),
           "no_volume": lambda: resum(img[:0xB8] + bytes(8) + img[0xC0:]),
           "truncated": lambda: img[:4096 * 2],
           "zeros": lambda: bytes(8192)}[case]()
    assert same(japfs.read_apfs, tapfs.read_apfs, bad)[0] == error
