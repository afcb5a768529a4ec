"""The port's FAT and UDF (tpu7z_torch/containers/{fat,udf}.py) against
tpu7z's: the same image bytes from the same files, the same files from
each image, a FAT16 image inside a VHD as the CLI's `a -tvhd` wraps one,
and the same errors for corrupt images. Where tpu7z's UDF writer puts
its anchor over file data, the port's image differs and reads back."""

import struct

import pytest

from tests.torch_parity import flipped, noise, outcome, same, text
from tpu7z.containers import disk as jdisk
from tpu7z.containers import fat as jfat
from tpu7z.containers import udf as judf
from tpu7z_torch.containers import disk as tdisk
from tpu7z_torch.containers import fat as tfat
from tpu7z_torch.containers import udf as tudf

FAT_FILES = {"HELLO.TXT": text(1500, 1), "B.BIN": bytes(range(256)) * 40,
             "BIG.DAT": noise(200000, 2), "EMPTY": b"", "long file name.text": text(99, 3)}
UDF_FILES = {"readme.txt": text(3600, 4), "empty.bin": b"", "rand.dat": noise(5000, 5),
             "big.dat": text(300000, 6)}
MANY = {f"f{i:03d}.bin": bytes([i]) * (i * 37 + 1) for i in range(40)}


@pytest.mark.parametrize("files", [FAT_FILES, MANY, {"ONE": b"1"}], ids=["files", "many", "one"])
def test_fat16_writer_equals_tpu7z(files):
    img = same(jfat.write_fat16, tfat.write_fat16, files)[1]
    assert same(jfat.is_fat, tfat.is_fat, img) == ("ok", True)
    got = same(jfat.read_fat, tfat.read_fat, img)
    assert got[0] == "ok"
    assert same(jfat.write_fat16, tfat.write_fat16, files, label=b"OTHER")[0] == "ok"


def test_fat_in_vhd_equals_tpu7z():
    img = jfat.write_fat16(FAT_FILES)
    vhd = same(jdisk.write_vhd_fixed, tdisk.write_vhd_fixed, img)[1]
    inner = same(jdisk.read_vhd, tdisk.read_vhd, vhd)[1]["disk.img"]
    assert same(jfat.read_fat, tfat.read_fat, inner)[0] == "ok"


@pytest.mark.parametrize("files", [UDF_FILES, MANY], ids=["files", "many"])
def test_udf_writer_equals_tpu7z(files):
    img = same(judf.write_udf, tudf.write_udf, files)[1]
    assert same(judf.is_udf, tudf.is_udf, img) == ("ok", True)
    assert same(judf.read_udf, tudf.read_udf, img) == ("ok", files)


@pytest.mark.parametrize("case", ["small", "bytes_per_sector", "sectors_per_cluster",
                                  "geometry", "zeros"])
def test_fat_corrupt_as_tpu7z(case):
    img = tfat.write_fat16({"A.TXT": text(3000, 7)})
    bad = {"small": lambda: img[:100],
           "bytes_per_sector": lambda: img[:11] + struct.pack("<H", 100) + img[13:],
           "sectors_per_cluster": lambda: img[:13] + b"\x03" + img[14:],
           "geometry": lambda: img[:14] + struct.pack("<H", 0) + img[16:],
           "zeros": lambda: b"\0" * 1024}[case]()
    assert same(jfat.read_fat, tfat.read_fat, bad)[0] == "CorruptError"


@pytest.mark.parametrize("case", ["anchor", "not_udf", "nsr", "partition", "file_entry"])
def test_udf_corrupt_as_tpu7z(case):
    img = tudf.write_udf({"a.txt": b"hello" * 100, "b": noise(3000, 8)})
    bad = {"anchor": lambda: flipped(img, 256 * 2048),
           "not_udf": lambda: b"\0" * (40 * 2048),
           "nsr": lambda: flipped(img, 17 * 2048 + 1),
           "partition": lambda: flipped(img, 32 * 2048 + 1),
           "file_entry": lambda: flipped(img, 41 * 2048 + 1)}[case]()
    assert same(judf.read_udf, tudf.read_udf, bad)[0] == "CorruptError"


@pytest.mark.parametrize("case", ["data_over_anchor", "entries_over_anchor"])
def test_udf_clear_of_the_anchor_where_tpu7z_overwrites(case):
    """tpu7z writes the anchor over sector 256 whatever lies there: a file's
    data about 420 KiB in, or the 215th file entry. Its image then reads
    back other bytes, or fails; the port's starts that extent or entry
    past the anchor and reads back what was written."""
    files = ({"a.bin": text(600000, 9), "b.bin": noise(5000, 10)} if case == "data_over_anchor"
             else {f"f{i:03d}": bytes([i % 256]) * 3 for i in range(230)})
    ref = outcome(judf.read_udf, judf.write_udf(files))
    assert ref != ("ok", files)
    img = tudf.write_udf(files)
    assert tudf.read_udf(img) == files and judf.read_udf(img) == files
