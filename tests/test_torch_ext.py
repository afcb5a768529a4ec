"""The port's ext reader (tpu7z_torch/containers/ext.py) against tpu7z's,
on the ext2, ext3 and ext4 images `mke2fs -d` makes of one seeded tree
(tests/test_ext.py's layout and sizes), and the same errors for corrupt
and unsupported images."""

import os
import shutil
import struct
import subprocess

import pytest

from tests.torch_parity import flipped, noise, same, text
from tpu7z.containers import ext as jext
from tpu7z_torch.containers import ext as text_

MKE2FS = shutil.which("mke2fs") or "/usr/sbin/mke2fs"
needs_mke2fs = pytest.mark.skipif(not os.path.exists(MKE2FS), reason="no mke2fs")
TREE = {"a.txt": text(10000, 1), "d1/d2/deep.bin": noise(50000, 2),
        "sparse": bytes(80000), "d1/empty": b"", "d1/mid.txt": text(300000, 3)}


def make_image(tmp_path, fstype, bs, nblocks, tree=TREE):
    """mke2fs -d of `tree` as tests/test_ext.py makes its images."""
    root = tmp_path / "tree"
    for rel, data in tree.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(data)
    img = tmp_path / f"img.{fstype}"
    r = subprocess.run([MKE2FS, "-q", "-t", fstype, "-b", str(bs), "-d", str(root), "-N", "64",
                        "-E", "root_owner=0:0", str(img), str(nblocks)],
                       capture_output=True, env=dict(os.environ, E2FSPROGS_FAKE_TIME="1"))
    if r.returncode != 0:
        pytest.skip(f"mke2fs failed: {r.stderr.decode()[:100]}")
    return img.read_bytes()


@needs_mke2fs
@pytest.mark.parametrize("fstype,bs,nblocks", [("ext2", 1024, 2048), ("ext3", 1024, 2048),
                                               ("ext4", 4096, 512), ("ext4", 1024, 4096)])
def test_mke2fs_images_read_as_tpu7z(tmp_path, fstype, bs, nblocks):
    got = same(jext.read_ext, text_.read_ext, make_image(tmp_path, fstype, bs, nblocks))
    assert got[0] == "ok"
    assert {k: v for k, v in got[1].items() if not k.endswith("/")} == TREE


@needs_mke2fs
@pytest.mark.parametrize("case,error", [
    ("small", "CorruptError"), ("magic", "CorruptError"),
    ("compressed", "UnsupportedError"), ("inode_table", "CorruptError")])
def test_corrupt_and_unsupported_as_tpu7z(tmp_path, case, error):
    img = make_image(tmp_path, "ext2", 1024, 2048, {"a.txt": text(3000, 4)})
    incompat = struct.unpack_from("<I", img, 1024 + 96)[0]
    bad = {"small": lambda: img[:2000],
           "magic": lambda: flipped(img, 1080),
           "compressed": lambda: img[:1120] + struct.pack("<I", incompat | 1) + img[1124:],
           # the first group's inode table moved past the image's end
           "inode_table": lambda: img[:2048 + 8] + struct.pack("<I", 1 << 20)
           + img[2048 + 12:]}[case]()
    assert same(jext.read_ext, text_.read_ext, bad)[0] == error
