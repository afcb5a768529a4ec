"""The port's cpio, ar and rpm (tpu7z_torch/containers/{cpio,ar,rpm}.py)
against tpu7z's: the same archive bytes from the same files, the same
files from tpu7z's archives and from the other cpio layouts and
binutils' ar, an rpm's payload under each compressor (bzip2's inverse
BWT on the CPU here, `device="cpu"`), and the same errors."""

import bz2
import lzma as std_lzma
import shutil
import struct
import subprocess
import zlib

import pytest

from tests.torch_parity import flipped, noise, same, text
from tpu7z.containers import ar as jar
from tpu7z.containers import cpio as jcpio
from tpu7z.containers import rpm as jrpm
from tpu7z.models.zstd import frame as jzstd
from tpu7z_torch.containers import ar as tar_
from tpu7z_torch.containers import cpio as tcpio
from tpu7z_torch.containers import rpm as trpm

FILES = {
    "alpha.txt": text(3000, 1),
    "beta.bin": bytes(range(256)),
    "a-very-long-file-name-over-sixteen-chars.dat": noise(777, 2),
    "odd": b"x",
    "empty": b"",
}


@pytest.mark.parametrize("kind", ["cpio", "ar"])
def test_writers_equal_tpu7z(kind):
    ref, port = (jcpio, tcpio) if kind == "cpio" else (jar, tar_)
    blob = same(getattr(ref, f"write_{kind}"), getattr(port, f"write_{kind}"), FILES)[1]
    assert same(getattr(ref, f"read_{kind}"), getattr(port, f"read_{kind}"), blob) == \
        ("ok", FILES)


def _odc(files):
    """The portable ASCII cpio layout (070707, octal fields)."""
    out = bytearray()
    for name, content in [*files.items(), ("TRAILER!!!", b"")]:
        nb = name.encode() + b"\0"
        mode = 0o100644 if content or name != "TRAILER!!!" else 0
        out += (b"070707" + b"%06o" % 0 + b"%06o" % 1 + b"%06o" % mode + b"%06o" % 0 * 2
                + b"%06o" % 1 + b"%06o" % 0 + b"%011o" % 0 + b"%06o" % len(nb)
                + b"%011o" % len(content)) + nb + content
    return bytes(out)


def _binary(files, little=True):
    """The old binary cpio layout (0x71C7, 13 u16 fields), either byte order."""
    out = bytearray()
    fmt = "<13H" if little else ">13H"
    for name, content in [*files.items(), ("TRAILER!!!", b"")]:
        nb = name.encode() + b"\0"
        out += struct.pack(fmt, 0o70707, 0, 1, 0o100644, 0, 0, 1, 0, 0, 0, len(nb),
                           len(content) >> 16, len(content) & 0xFFFF)
        out += nb + bytes(len(nb) & 1) + content + bytes(len(content) & 1)
    return bytes(out)


@pytest.mark.parametrize("layout", ["odc", "binary_le", "binary_be"])
def test_other_cpio_layouts_read_as_tpu7z(layout):
    files = {"one.txt": text(1001, 3), "sub/two.bin": noise(70000, 4), "e": b""}
    blob = {"odc": _odc, "binary_le": _binary,
            "binary_be": lambda f: _binary(f, little=False)}[layout](files)
    assert same(jcpio.read_cpio, tcpio.read_cpio, blob) == ("ok", files)


@pytest.mark.skipif(shutil.which("ar") is None, reason="no binutils ar")
def test_binutils_ar_read_as_tpu7z(tmp_path):
    names = ["m1.txt", "m2_with_a_much_longer_name_indeed.txt", "odd.bin"]
    for i, n in enumerate(names):
        (tmp_path / n).write_bytes(text(100 + 57 * i, 5 + i))
    subprocess.run(["ar", "rc", "sys.a", *names], cwd=tmp_path, check=True)
    got = same(jar.read_ar, tar_.read_ar, (tmp_path / "sys.a").read_bytes())
    assert got[0] == "ok" and {n: (tmp_path / n).read_bytes() for n in names} == got[1]


def _rpm(payload: bytes, compressor: bytes) -> bytes:
    """An rpm as tests/test_unix_archives.py builds one, with the payload
    compressor named."""
    def header(entries):
        idx, store = b"", b""
        for tag, typ, data, count in entries:
            idx += struct.pack(">IIII", tag, typ, len(store), count)
            store += data
        return struct.pack(">IIII", 0x8EADE801, 0, len(entries), len(store)) + idx + store

    lead = (struct.pack(">IBB", 0xEDABEEDB, 3, 0) + struct.pack(">HH", 0, 1)
            + b"t-1.0\x00".ljust(66, b"\x00") + struct.pack(">HH", 1, 5) + b"\x00" * 16)
    out = bytearray(lead) + header([(1000, 4, struct.pack(">I", 0), 1)])
    out += bytes((-len(out)) % 8)
    out += header([(1125, 6, compressor + b"\x00", 1), (1124, 6, b"cpio\x00", 1)])
    return bytes(out + payload)


def _gzip(body):
    c = zlib.compressobj(9, zlib.DEFLATED, 31)
    return c.compress(body) + c.flush()


INNER = {"./usr/bin/x": text(20000, 6), "./etc/c": b"k=v\n", "./usr/share/blob": noise(3000, 7)}
PAYLOADS = {
    "gzip": _gzip,
    "zstd": lambda b: jzstd.compress(b, level=3),
    "xz": lambda b: std_lzma.compress(b),
    "lzma": lambda b: std_lzma.compress(b, check=std_lzma.CHECK_NONE),
    "bzip2": lambda b: bz2.compress(b, 9),
}


@pytest.mark.parametrize("compressor", PAYLOADS)
def test_rpm_payloads_read_as_tpu7z(compressor):
    blob = _rpm(PAYLOADS[compressor](jcpio.write_cpio(INNER)), compressor.encode())
    got = same(jrpm.read_rpm, trpm.read_rpm, blob, port_kw={"device": "cpu"})
    assert got == ("ok", {k[2:]: v for k, v in INNER.items()})


@pytest.mark.parametrize("case,error", [
    ("lead", "CorruptError"), ("header_magic", "CorruptError"),
    ("truncated_store", "CorruptError"), ("truncated_index", "error"),
    ("compressor", "UnsupportedError"),
    ("payload", "error"), ("cpio", "CorruptError")])
def test_rpm_corrupt_and_unsupported_as_tpu7z(case, error):
    body = jcpio.write_cpio(INNER)
    good = _rpm(_gzip(body), b"gzip")
    bad = {"lead": lambda: flipped(good, 1),
           "header_magic": lambda: flipped(good, 96),
           "truncated_store": lambda: good[:130],
           "truncated_index": lambda: good[:120],
           "compressor": lambda: _rpm(_gzip(body), b"lzo"),
           "payload": lambda: _rpm(flipped(_gzip(body), 40), b"gzip"),
           "cpio": lambda: _rpm(_gzip(b"garbage!" * 20), b"gzip")}[case]()
    assert same(jrpm.read_rpm, trpm.read_rpm, bad, port_kw={"device": "cpu"})[0] == error


@pytest.mark.parametrize("case,error", [
    ("cpio_magic", "CorruptError"), ("cpio_truncated", "CorruptError"),
    ("ar_magic", "CorruptError"), ("ar_truncated", "CorruptError")])
def test_cpio_ar_corrupt_as_tpu7z(case, error):
    kind = case.split("_")[0]
    ref, port = (jcpio, tcpio) if kind == "cpio" else (jar, tar_)
    blob = getattr(ref, f"write_{kind}")(FILES)
    bad = flipped(blob, 0) if case.endswith("magic") else blob[:len(blob) // 2]
    assert same(getattr(ref, f"read_{kind}"), getattr(port, f"read_{kind}"), bad)[0] == error
